"""Algorithm 2 — straggler-resilient (r, k)-subspace clustering (paper §3.3.1).

Workers send ε-coresets of their shards; the coordinator forms the
b-reweighted union (a 2(ε+δ)-coreset of P by Lemma 3') and runs an
α-approximate (r, k)-subspace solver on it.  Theorem 4:
cost(P, Ĉ) ≤ α(1+8δ)·OPT.

The local solver here is a k-subspace Lloyd ("k-flats"): assign each point to
the subspace with least squared residual, refit each subspace by weighted
PCA of its members.  ``r = 0`` degenerates to k-means (centers = weighted
means), covering the paper's remark that (r, k)-subspace clustering subsumes
k-means (r=0) and PCA (k=1).

The residuals and the refit materialize (k, n, d) temporaries, as the
reference does; the eigendecompositions and matrix products are library
calls (``torch.linalg.eigh``, ``torch.einsum``), as the reference leaves
them to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from . import kmeans
from .aggregation import weighted_union
from .assignment import Assignment
from .coreset import sensitivity_coreset
from .kmedian import pack_local_shards
from .recovery import RecoveryResult, solve_recovery

__all__ = [
    "SubspaceClustering",
    "subspace_residual_sq",
    "subspace_cost",
    "lloyd_subspace",
    "resilient_subspace_clustering",
    "ResilientSubspaceOutput",
]

_EPS = 1e-12


class SubspaceClustering(NamedTuple):
    bases: torch.Tensor  # (k, d, r) orthonormal columns
    means: torch.Tensor  # (k, d) affine offsets
    cost: torch.Tensor   # scalar


def subspace_residual_sq(x, bases, means):
    """(n, k) squared residuals of each point to each affine r-subspace."""
    xc = x[None, :, :] - means[:, None, :]  # (k, n, d)
    proj = torch.einsum("knd,kdr->knr", xc, bases)
    res = torch.sum(xc * xc, dim=-1) - torch.sum(proj * proj, dim=-1)  # (k, n)
    return torch.clamp_min(res.T, 0.0)


def subspace_cost(x, bases, means, *, weights=None):
    w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device) if weights is None else weights
    res = subspace_residual_sq(x, bases, means)
    return torch.sum(w * torch.min(res, dim=1).values)


def _weighted_pca_per_cluster(x, w, idx, k: int, r: int, prev_bases, prev_means):
    """Refit each cluster's affine subspace by weighted PCA (top-r eigh)."""
    n, d = x.shape
    onehot = (idx[:, None] == torch.arange(k, device=x.device)[None, :]).float() * w[:, None]
    tot = torch.sum(onehot, dim=0)  # (k,)
    means = (onehot.T @ x) / torch.clamp_min(tot, _EPS)[:, None]  # (k, d)
    xc = x[None, :, :] - means[:, None, :]  # (k, n, d)
    cov = torch.einsum("kn,knd,kne->kde", onehot.T, xc, xc)  # (k, d, d)
    _, evecs = torch.linalg.eigh(cov)  # ascending, as jnp.linalg.eigh
    # evecs[..., -0:] would be every column: r = 0 needs its own branch.
    bases = evecs[:, :, -r:] if r > 0 else torch.zeros((k, d, 0), dtype=x.dtype, device=x.device)
    keep = (tot > _EPS)[:, None, None]
    bases = torch.where(keep, bases, prev_bases)
    means = torch.where(keep[:, :, 0], means, prev_means)
    return bases, means


def lloyd_subspace(
    x: torch.Tensor,
    k: int,
    r: int,
    *,
    weights: Optional[torch.Tensor] = None,
    iters: int = 15,
    generator: Optional[torch.Generator] = None,
) -> SubspaceClustering:
    """k-subspace Lloyd on weighted data (α-approximate local/coordinator
    solver).  Seeds with k-means++ centers (drawn from ``generator``) and
    their local PCA directions."""
    n, d = x.shape
    x = x.float()
    w = torch.ones(n, dtype=torch.float32, device=x.device) if weights is None else weights.float()
    centers = kmeans.plusplus_init(x, k, weights=w, generator=generator)
    idx0 = torch.argmin(
        torch.sum((x[:, None, :] - centers[None, :, :]) ** 2, dim=-1), dim=1
    ).to(torch.int32)
    bases0 = torch.zeros((k, d, r), dtype=x.dtype, device=x.device)
    bases, means = _weighted_pca_per_cluster(x, w, idx0, k, r, bases0, centers)
    for _ in range(iters):
        idx = torch.argmin(subspace_residual_sq(x, bases, means), dim=1).to(torch.int32)
        bases, means = _weighted_pca_per_cluster(x, w, idx, k, r, bases, means)
    return SubspaceClustering(bases=bases, means=means, cost=subspace_cost(x, bases, means, weights=w))


@dataclasses.dataclass
class ResilientSubspaceOutput:
    bases: np.ndarray
    means: np.ndarray
    cost: float
    recovery: RecoveryResult
    coreset_points: np.ndarray
    coreset_weights: np.ndarray


def resilient_subspace_clustering(
    points: np.ndarray,
    r: int,
    k: int,
    assignment: Assignment,
    alive: np.ndarray,
    *,
    coreset_size: int = 256,
    recovery_method: str = "auto",
    seed: int = 0,
    device=None,
) -> ResilientSubspaceOutput:
    """Paper Algorithm 2, end to end (coreset flavour), on ``device`` (the
    card by default).  The recovery solve and the packing run on the host."""
    device = resolve_device(device)
    points = np.asarray(points, dtype=np.float32)
    alive = np.asarray(alive, dtype=bool)
    rec = solve_recovery(assignment, alive, method=recovery_method)
    xs, ws = pack_local_shards(points, assignment)
    s = xs.shape[0]
    cs = sensitivity_coreset(
        torch.from_numpy(xs).to(device), max(k, 1), coreset_size,
        weights=torch.from_numpy(ws).to(device),
        generator=torch.Generator(device=device).manual_seed(seed),
    )
    pts_s, wts_s = cs.points.cpu().numpy(), cs.weights.cpu().numpy()
    y, wy = weighted_union(
        [pts_s[i] for i in range(s)], [wts_s[i] for i in range(s)], rec.b_full, alive=alive,
    )
    sol = lloyd_subspace(
        torch.from_numpy(y).to(device), k, r,
        weights=torch.as_tensor(wy, dtype=torch.float32, device=device),
        generator=torch.Generator(device=device).manual_seed(seed + 1),
    )
    full_cost = float(subspace_cost(torch.from_numpy(points).to(device), sol.bases, sol.means))
    return ResilientSubspaceOutput(
        bases=sol.bases.cpu().numpy(), means=sol.means.cpu().numpy(), cost=full_cost,
        recovery=rec, coreset_points=y, coreset_weights=wy,
    )
