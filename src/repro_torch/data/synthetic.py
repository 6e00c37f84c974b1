"""Synthetic datasets: the paper's Gaussian benchmark and generic mixtures."""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["gaussian_mixture", "franti_s1_like", "planted_subspaces"]


def gaussian_mixture(
    n: int,
    k: int,
    d: int,
    *,
    spread: float = 0.04,
    box: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``n`` points from ``k`` isotropic Gaussians with centers uniform in a box.

    Returns (points (n, d), centers (k, d), labels (n,)).
    """
    rng = rng or np.random.default_rng(0)
    centers = rng.uniform(-box, box, size=(k, d))
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + rng.normal(scale=spread * box, size=(n, d))
    return pts.astype(np.float32), centers.astype(np.float32), labels


def franti_s1_like(
    n: int = 5000, k: int = 15, *, rng: Optional[np.random.Generator] = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """2-D, 15-cluster Gaussian set mimicking the Fränti–Virmajoki S-sets used
    in the paper's Figure 1 (n = 5000, k = 15, moderately overlapping)."""
    rng = rng or np.random.default_rng(42)
    # Grid-jittered centers in [0, 1]² like the S1 layout.
    gx, gy = np.meshgrid(np.linspace(0.12, 0.88, 4), np.linspace(0.12, 0.88, 4))
    centers = np.stack([gx.ravel(), gy.ravel()], axis=1)[:k]
    centers = centers + rng.uniform(-0.05, 0.05, centers.shape)
    labels = rng.integers(0, k, size=n)
    pts = centers[labels] + rng.normal(scale=0.035, size=(n, 2))
    return pts.astype(np.float32), centers.astype(np.float32), labels


def planted_subspaces(
    n: int,
    k: int,
    d: int,
    r: int,
    *,
    noise: float = 0.02,
    rng: Optional[np.random.Generator] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Points near ``k`` random r-dimensional affine subspaces (for Alg 2/3 tests)."""
    rng = rng or np.random.default_rng(0)
    pts, labels = [], []
    for c in range(k):
        basis, _ = np.linalg.qr(rng.normal(size=(d, r)))
        offset = rng.uniform(-1, 1, size=(d,))
        m = n // k + (1 if c < n % k else 0)
        coords = rng.normal(size=(m, r)) * 2.0
        p = coords @ basis.T + offset + rng.normal(scale=noise, size=(m, d))
        pts.append(p)
        labels.extend([c] * m)
    return np.concatenate(pts).astype(np.float32), np.asarray(labels)
