"""Plain PyTorch oracle for the weighted segment-sum kernel.

The same one-hot product as the reference package's
``weighted_segsum/ref.py``; takes (n, d) or batched (B, n, d) inputs.
"""

from __future__ import annotations

import torch

__all__ = ["weighted_segsum_ref"]


def weighted_segsum_ref(
    x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """sums[c] = Σ_{idx_i = c} w_i·x_i (…, k, d) f32 and totals[c] = Σ w_i
    (…, k) f32.  A row whose idx lies outside [0, k) adds nothing."""
    x = x.float()
    w = w.float()
    cols = torch.arange(k, device=x.device, dtype=idx.dtype)
    oh = (idx.unsqueeze(-1) == cols).float() * w.unsqueeze(-1)  # (…, n, k)
    return oh.transpose(-1, -2) @ x, torch.sum(oh, dim=-2)
