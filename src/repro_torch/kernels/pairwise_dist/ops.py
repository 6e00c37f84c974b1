"""Public pairwise-distance ops: ``assign_min`` (nearest center) and
``pairwise_sqdist`` (the full squared-distance matrix).

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

__all__ = ["assign_min", "pairwise_sqdist"]

dispatch.register_impl("assign_min", "cuda", _kernel.assign_min_cuda)
dispatch.register_impl("assign_min", "torch_ref", _ref.assign_min_ref)
dispatch.register_impl("pairwise_sqdist", "cuda", _kernel.pairwise_sqdist_cuda)
dispatch.register_impl("pairwise_sqdist", "torch_ref", _ref.pairwise_sqdist_ref)


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


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """Squared Euclidean distance matrix (n, k) f32, clamped at 0:
    ‖x‖² + ‖c‖² − 2·x·cᵀ for ``x`` (n, d) and ``c`` (k, d), both float32
    with d > 0.  On a CUDA device both must be contiguous."""
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"pairwise_sqdist: expected (n, d) and (k, d), got {tuple(x.shape)}, {tuple(c.shape)}")
    if x.shape[1] == 0:
        raise ValueError("pairwise_sqdist: d must be positive")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"pairwise_sqdist: expected float32, got {x.dtype}, {c.dtype}")
    _, fn = dispatch.resolve("pairwise_sqdist", impl, x, c)
    return fn(x, c)
