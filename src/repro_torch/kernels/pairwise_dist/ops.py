"""Public pairwise-distance ops: ``assign_min`` (nearest center),
``pairwise_sqdist`` (the full squared-distance matrix) and
``min_dist_update`` (one step of the ++ seeding's running minimum).

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

__all__ = ["assign_min", "min_dist_update", "pairwise_sqdist"]

dispatch.register_impl("assign_min", "cuda", _kernel.assign_min_cuda)
dispatch.register_impl("assign_min", "torch_ref", _ref.assign_min_ref)
dispatch.register_impl("pairwise_sqdist", "cuda", _kernel.pairwise_sqdist_cuda)
dispatch.register_impl("pairwise_sqdist", "torch_ref", _ref.pairwise_sqdist_ref)
dispatch.register_impl("min_dist_update", "cuda", _kernel.min_dist_update_cuda)
dispatch.register_impl("min_dist_update", "torch_ref", _ref.min_dist_update_ref)


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


def min_dist_update(
    x: torch.Tensor, c: torch.Tensor, d2: torch.Tensor, w: torch.Tensor, *, median: bool, impl: str = "auto"
) -> torch.Tensor:
    """Fold one new center a batch into the running squared distances, in
    place, and give the logits of the next ++ draw.

    ``x`` (B, n, d), ``c`` (B, d), ``d2`` and ``w`` (B, n), all float32:
    ``d2`` becomes min(d2, ‖x − c‖²) and the result (B, n) is
    log(max(w·score, 1e-12)) with score √d2 (``median``) or d2, exactly
    −inf where w = 0.  The distance is the direct difference, so a chosen
    point reads exactly 0.
    """
    if x.dim() != 3 or c.shape != (x.shape[0], x.shape[2]) or d2.shape != x.shape[:2] or w.shape != x.shape[:2]:
        raise ValueError(
            f"min_dist_update: expected x (B, n, d), c (B, d), d2 and w (B, n), got {tuple(x.shape)}, "
            f"{tuple(c.shape)}, {tuple(d2.shape)}, {tuple(w.shape)}")
    if d2.dtype != torch.float32:
        raise TypeError(f"min_dist_update: d2 must be float32, got {d2.dtype}")
    _, fn = dispatch.resolve("min_dist_update", impl, x, c, d2, w)
    return fn(x, c, d2, w, median)
