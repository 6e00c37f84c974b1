"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention_kernel_call``
of ``src/repro/kernels/flash_attention/kernel.py``.  Bound on an H100 at the
prefill shape: the causal 4·B·H·dh·T(T+1)/2 operations against the bf16
tensor cores (0.139 ms); with p split into two bf16 pieces the p·v half runs
twice, so the tensor cores need 1.5 × that (0.208 ms).

The source holds two kernels; :func:`route` picks one from the dtype and
head_dim alone:

* ``tma-wgmma`` (bf16 at head_dim 64 and 128, every served config): one
  block of three warpgroups per (128-row query tile, head, batch).  A
  producer warp loads q once and k/v tiles of 64 keys by TMA through a
  four-stage shared-memory ring (full/empty mbarriers); two consumer
  warpgroups of 64 rows run q·kᵀ and p·v as ``wgmma`` (v read through the
  transpose bit), each with the softmax of one tile beside the p·v of the
  one before, taking turns on the tensor cores.
* ``mma-sync`` (f32 at every head_dim, bf16 at 16 and 32): one block of 4
  warps per 64-row query tile, ``mma.sync`` m16n8k16 bf16 products, f32
  inputs split into three bf16 pieces.

See the source's header for the numerics.

The wrapper checks device, dtype, shapes, the GQA grouping and the strides,
allocates the output, launches on the current stream without
synchronising, and raises if the launch failed.  Its output carries no
gradient, so it raises when autograd would record the call (grad mode on
and an input requiring grad): a differentiable call goes through
``ops.FlashAttentionFn``, whose forward is this wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import LaunchCounter

__all__ = ["HEAD_DIMS", "ROUTES", "counter", "flash_attention_cuda", "route"]

counter = LaunchCounter("flash_attention")

HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernels are instantiated for
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# route -> the C entry point of csrc/flash_attention.cu that launches it
ROUTES = {"tma-wgmma": "flash_attention_tma_launch", "mma-sync": "flash_attention_launch"}


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel for this dtype and head width: ``"tma-wgmma"`` for bf16 at
    64 and 128, ``"mma-sync"`` for f32 at every width and bf16 at 16 and 32.
    Raises on anything else."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda: expected bf16 or f32, got {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {dh} not in {HEAD_DIMS}")
    return "tma-wgmma" if dtype == torch.bfloat16 and dh in (64, 128) else "mma-sync"


_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(path: str):
    fn = getattr(_build.load("flash_attention"), ROUTES[path])
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, ctypes.c_float, _I, _P]
    fn.restype = _I
    return fn


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, scale: float
) -> torch.Tensor:
    """q (B, T, H, dh), k and v (B, S, KV, dh) CUDA tensors of one dtype
    (bf16 or f32), unit stride over dh → o (B, T, H, dh) contiguous."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention_cuda: the raw kernel has no gradient and would drop it; "
                           "call ops.flash_attention (its autograd Function) instead")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention_cuda: q, k, v must share one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: expected bf16 or f32 for all three, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda: bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or KV == 0 or H % KV != 0:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match (H % KV == 0)")
    path = route(q.dtype, dh)
    if B > 65535 or H > 65535 or max(T, S) >= 2**31:
        raise ValueError(f"flash_attention_cuda: shape {(B, T, S, H, KV, dh)} exceeds the launch limits")
    vec = 16 // q.element_size()  # the kernel reads 16 bytes at a time
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"flash_attention_cuda: {name} needs unit stride over head_dim, other strides "
                f"multiples of {vec} and a 16-byte aligned start; got strides {t.stride()}")
    o = torch.empty((B, T, H, dh), dtype=q.dtype, device=q.device)
    if B == 0 or T == 0 or H == 0:
        return o
    if S == 0:
        return o.zero_()  # no key at all: every row is a row with no valid key
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v) for i in range(3)))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib(path)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPES[q.dtype],
            B, T, S, H, KV, dh, ctypes.cast(strides, _P), float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    counter.count += 1
    return o
