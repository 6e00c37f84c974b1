"""Public weighted segment sum: ``weighted_segsum``.

Implementations (see :mod:`repro_torch.kernels.dispatch`): ``cuda``, the
hand-written deterministic kernel, for CUDA tensors; ``torch_ref``, the plain
one-hot version, for CPU tensors and for explicit comparison.
"""

from __future__ import annotations

import torch

from .. import dispatch
from . import kernel as _kernel
from . import ref as _ref

__all__ = ["weighted_segsum"]

dispatch.register_impl("weighted_segsum", "cuda", _kernel.weighted_segsum_cuda)
dispatch.register_impl("weighted_segsum", "torch_ref", _ref.weighted_segsum_ref)


def weighted_segsum(
    x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, k: int, *, impl: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster weighted sums (…, k, d) and totals (…, k), f32.

    ``x`` (n, d), ``w`` (n,), ``idx`` (n,) or batched (B, n, d), (B, n),
    (B, n).  A row whose idx lies outside [0, k) adds nothing.
    """
    if x.dim() not in (2, 3) or w.shape != x.shape[:-1] or idx.shape != x.shape[:-1]:
        raise ValueError(f"weighted_segsum: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}, idx {tuple(idx.shape)}")
    name, fn = dispatch.resolve("weighted_segsum", impl, x, w, idx)
    if name == "torch_ref":
        return fn(x, w, idx, k)
    single = x.dim() == 2
    xb = x.float().contiguous()
    wb = w.float().contiguous()
    ib = idx.to(torch.int32).contiguous()
    if single:
        xb, wb, ib = xb.unsqueeze(0), wb.unsqueeze(0), ib.unsqueeze(0)
    sums, totals = fn(xb, wb, ib, k)
    return (sums[0], totals[0]) if single else (sums, totals)
