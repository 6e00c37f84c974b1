"""Plain PyTorch oracles for the pairwise-distance kernels.

``pairwise_sqdist_ref`` and ``assign_min_ref`` are computed exactly as the
reference package's ``pairwise_dist/ref.py``: the ‖x‖² + ‖c‖² − 2·x·cᵀ
decomposition, clamped at 0, then a first-occurrence argmin.  Both take
(n, d) or batched (B, n, d) inputs.  ``min_dist_update_ref`` is the oracle
of the seeding's one-center step, which the reference package has no twin
of: the direct difference, batched only.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["PAD_DIST", "SCORE_FLOOR", "pairwise_sqdist_ref", "assign_min_ref", "min_dist_update_ref"]

# Positive, finite "+inf"-like distance: the running minimum's start and the
# value of masked center columns.  Finite, so no inf − inf can occur.
PAD_DIST = 3.4e38

# The least w·score whose log a real point's seeding logit takes, so a
# point at distance 0 keeps a finite logit: ``core.kmeans._EPS`` is this
# constant, and ``csrc/min_dist_update.cu``'s FLOOR its copy.
SCORE_FLOOR = 1e-12


def pairwise_sqdist_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances (…, n, k) f32, clamped at 0."""
    x = x.float()
    c = c.float()
    x2 = torch.sum(x * x, dim=-1, keepdim=True)  # (…, n, 1)
    c2 = torch.sum(c * c, dim=-1).unsqueeze(-2)  # (…, 1, k)
    d2 = x2 + c2 - 2.0 * (x @ c.transpose(-1, -2))
    return torch.clamp_min(d2, 0.0)


def assign_min_ref(
    x: torch.Tensor, c: torch.Tensor, k_valid: Optional[int] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest center: (idx (…, n) i32, dist (…, n) f32).

    Columns ≥ ``k_valid`` are masked to ``PAD_DIST`` by index; ties go to
    the earliest column (``torch.min`` returns the first occurrence).
    """
    d2 = pairwise_sqdist_ref(x, c)
    k = d2.shape[-1]
    if k_valid is not None and k_valid < k:
        col = torch.arange(k, device=d2.device)
        d2 = torch.where(col < k_valid, d2, torch.full_like(d2, PAD_DIST))
    if k == 0:
        shape = d2.shape[:-1]
        return (
            torch.zeros(shape, dtype=torch.int32, device=d2.device),
            torch.full(shape, PAD_DIST, dtype=torch.float32, device=d2.device),
        )
    dist, idx = torch.min(d2, dim=-1)
    return idx.to(torch.int32), dist


def min_dist_update_ref(
    x: torch.Tensor, c: torch.Tensor, d2: torch.Tensor, w: torch.Tensor, median: bool
) -> torch.Tensor:
    """One step of the ++ seeding for x (B, n, d), the new centers c (B, d),
    the running squared distances d2 (B, n) and the weights w (B, n):
    d2 ← min(d2, ‖x − c‖²) in place, and the logits (B, n) of drawing each
    row, log(max(w·score, SCORE_FLOOR)) with score √d2 (``median``) or d2,
    exactly −inf where w = 0."""
    dist = torch.sum((x.float() - c.float().unsqueeze(-2)) ** 2, dim=-1)
    torch.minimum(d2, dist, out=d2)
    score = torch.sqrt(torch.clamp_min(d2, 0.0)) if median else d2
    return torch.where(
        w > 0, torch.log(torch.clamp_min(w * score, SCORE_FLOOR)), torch.full_like(w, -torch.inf)
    )
