"""Plain PyTorch oracle for the nearest-center assignment kernel.

Computed exactly as the reference package's ``pairwise_dist/ref.py``: the
‖x‖² + ‖c‖² − 2·x·cᵀ decomposition, clamped at 0, then a first-occurrence
argmin.  Both functions take (n, d) or batched (B, n, d) inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["PAD_DIST", "pairwise_sqdist_ref", "assign_min_ref"]

# Positive, finite "+inf"-like distance: the running minimum's start and the
# value of masked center columns.  Finite, so no inf − inf can occur.
PAD_DIST = 3.4e38


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
