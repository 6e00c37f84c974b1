"""Public nearest-center assignment: ``assign_min``.

Implementations (see :mod:`repro_torch.kernels.dispatch`): ``cuda``, the
hand-written kernel, for CUDA tensors; ``torch_ref``, the plain version, for
CPU tensors and for explicit comparison.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import dispatch
from . import kernel as _kernel
from . import ref as _ref

__all__ = ["assign_min"]

dispatch.register_impl("assign_min", "cuda", _kernel.assign_min_cuda)
dispatch.register_impl("assign_min", "torch_ref", _ref.assign_min_ref)


def assign_min(
    x: torch.Tensor, c: torch.Tensor, *, k_valid: Optional[int] = None, impl: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-center assignment: (idx i32, squared dist f32).

    ``x`` (n, d) with ``c`` (k, d), or batched ``x`` (B, n, d) with
    ``c`` (B, k, d).  ``k_valid`` (default: all) is how many leading centers
    are real; the rest are masked by index.
    """
    if x.dim() not in (2, 3) or c.dim() != x.dim():
        raise ValueError(f"assign_min: expected (n, d)/(k, d) or (B, n, d)/(B, k, d), got {tuple(x.shape)}, {tuple(c.shape)}")
    if x.shape[-1] != c.shape[-1] or (x.dim() == 3 and x.shape[0] != c.shape[0]):
        raise ValueError(f"assign_min: shapes {tuple(x.shape)} and {tuple(c.shape)} do not match")
    k = c.shape[-2]
    kv = k if k_valid is None else int(k_valid)
    name, fn = dispatch.resolve("assign_min", impl, x, c)
    if name == "torch_ref":
        return fn(x, c, kv)
    single = x.dim() == 2
    xb = x.float().contiguous()
    cb = c.float().contiguous()
    if single:
        xb, cb = xb.unsqueeze(0), cb.unsqueeze(0)
    idx, dist = fn(xb, cb, kv)
    return (idx[0], dist[0]) if single else (idx, dist)
