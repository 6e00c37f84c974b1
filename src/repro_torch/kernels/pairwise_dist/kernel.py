"""Wrappers of the three CUDA pairwise-distance kernels.

* ``assign_min_cuda`` launches the nearest-center kernel
  (``csrc/assign_min.cu``), which replaces the Pallas TPU kernel
  ``_assign_kernel`` / ``assign_min_kernel_call`` of
  ``src/repro/kernels/pairwise_dist/kernel.py``.  It runs x·cᵀ on the TF32
  tensor cores as 3xTF32 (each fp32 operand split once into two TF32
  pieces as it is staged, three ``wgmma`` products summed in fp32), so
  distances keep fp32 accuracy; 128 rows × 256 centers per block where
  k_valid > 128 (128 centers otherwise), d staged in 32-column chunks
  through two shared-memory buffers while the products of the previous
  chunk run, norms summed in fp32 from the staged values, and the (n, k)
  matrix never written.  Bound on an H100: the three passes of
  2·B·n·k·d operations against the 495 TFLOP/s TF32 peak (0.84 ms at
  Algorithm 1's local-solve shape; one fp32 CUDA-core pass would need
  2.07 ms).  See the source's header for the tie rule.
* ``pairwise_sqdist_cuda`` launches the full squared-distance kernel
  (``csrc/pairwise_sqdist.cu``), which replaces ``_sqdist_kernel`` /
  ``pairwise_sqdist_kernel_call`` of the same file.  The 3xTF32 ``wgmma``
  tile of ``assign_min`` (the shared helpers are in ``csrc/tf32_tile.cuh``),
  in persistent blocks that walk the (row tile, center tile) pairs; each
  clamped tile goes through shared memory to device memory by TMA stores
  (16-byte-aligned rows) or coalesced 4-byte stores, the stores of one tile
  draining while the next one multiplies.  Bound: the bytes of the (n, k)
  output (0.46 ms at 1M × 256), above the 3xTF32 operations (0.40 ms).
* ``min_dist_update_cuda`` launches the seeding's one-center step
  (``csrc/min_dist_update.cu``), which replaces no TPU kernel: each of the
  k − 1 steps of the ++ seeding folds the one new center into a running
  minimum, where the reference's loop runs ``assign_min`` over every center
  slot.  Direct fp32 differences, 16-byte streamed loads of x, the min and
  the logit fused.  Bound: the bytes, x read once (0.63 ms at the local
  solve's (10, 400000, 128)).

Each wrapper checks shapes, dtype, device and contiguity, allocates the
outputs, launches on the current stream without synchronising, raises if
the launch failed, and counts its launches in its own ``LaunchCounter``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import LaunchCounter

__all__ = [
    "assign_min_cuda", "counter", "min_dist_counter", "min_dist_update_cuda", "pairwise_sqdist_cuda",
    "sqdist_counter",
]

counter = LaunchCounter("assign_min")
sqdist_counter = LaunchCounter("pairwise_sqdist")
min_dist_counter = LaunchCounter("min_dist_update")

# The widest row whose center a block stages in its 48 KB of static-limit
# shared memory.
MIN_DIST_MAX_D = 12288

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _lib():
    lib = _build.load("assign_min")
    fn = lib.assign_min_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def assign_min_cuda(
    x: torch.Tensor, c: torch.Tensor, k_valid: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, n, d), c (B, k, d) fp32 contiguous CUDA tensors →
    (idx (B, n) i32, dist (B, n) f32)."""
    if x.device.type != "cuda" or c.device != x.device:
        raise ValueError(f"assign_min_cuda: x and c must share one CUDA device, got {x.device}, {c.device}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"assign_min_cuda: expected float32, got {x.dtype}, {c.dtype}")
    if x.dim() != 3 or c.dim() != 3 or x.shape[0] != c.shape[0] or x.shape[2] != c.shape[2]:
        raise ValueError(f"assign_min_cuda: bad shapes x {tuple(x.shape)}, c {tuple(c.shape)}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("assign_min_cuda: x and c must be contiguous")
    B, n, d = x.shape
    k = c.shape[1]
    if not 0 <= k_valid <= k:
        raise ValueError(f"assign_min_cuda: k_valid={k_valid} outside [0, {k}]")
    if B > 65535 or max(n, k, d) >= 2**31:
        raise ValueError(f"assign_min_cuda: shape {(B, n, k, d)} exceeds the launch limits")
    idx = torch.empty((B, n), dtype=torch.int32, device=x.device)
    dist = torch.empty((B, n), dtype=torch.float32, device=x.device)
    if B == 0 or n == 0:
        return idx, dist
    if d == 0:
        raise ValueError("assign_min_cuda: d must be positive")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(
            x.data_ptr(), c.data_ptr(), idx.data_ptr(), dist.data_ptr(),
            B, n, k, d, int(k_valid), stream,
        )
    if err != 0:
        raise RuntimeError(f"assign_min kernel launch failed: CUDA error {err}")
    counter.count += 1
    return idx, dist


def _sqdist_lib():
    lib = _build.load("pairwise_sqdist")
    fn = lib.pairwise_sqdist_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def pairwise_sqdist_cuda(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x (n, d), c (k, d) fp32 contiguous CUDA tensors → (n, k) f32."""
    if x.device.type != "cuda" or c.device != x.device:
        raise ValueError(f"pairwise_sqdist_cuda: x and c must share one CUDA device, got {x.device}, {c.device}")
    if x.dtype != torch.float32 or c.dtype != torch.float32:
        raise TypeError(f"pairwise_sqdist_cuda: expected float32, got {x.dtype}, {c.dtype}")
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"pairwise_sqdist_cuda: bad shapes x {tuple(x.shape)}, c {tuple(c.shape)}")
    if not (x.is_contiguous() and c.is_contiguous()):
        raise ValueError("pairwise_sqdist_cuda: x and c must be contiguous")
    n, d = x.shape
    k = c.shape[0]
    if d == 0:
        raise ValueError("pairwise_sqdist_cuda: d must be positive")
    if max(n, k, d) >= 2**31 or -(-k // 64) > 65535:
        raise ValueError(f"pairwise_sqdist_cuda: shape {(n, k, d)} exceeds the launch limits")
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0 or k == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _sqdist_lib()(x.data_ptr(), c.data_ptr(), out.data_ptr(), n, k, d, stream)
    if err != 0:
        raise RuntimeError(f"pairwise_sqdist kernel launch failed: CUDA error {err}")
    sqdist_counter.count += 1
    return out


def _min_dist_lib():
    lib = _build.load("min_dist_update")
    fn = lib.min_dist_update_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _P]
    fn.restype = _I
    return fn


def min_dist_update_cuda(
    x: torch.Tensor, c: torch.Tensor, d2: torch.Tensor, w: torch.Tensor, median: bool
) -> torch.Tensor:
    """x (B, n, d) contiguous, c (B, d) with unit column stride (a column
    of the seeding's (B, k, d) centers), d2 and w (B, n) contiguous, all
    fp32 on one CUDA device → logits (B, n) f32; d2 updated in place."""
    tensors = (x, c, d2, w)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"min_dist_update_cuda: every tensor must lie on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"min_dist_update_cuda: expected float32, got {[t.dtype for t in tensors]}")
    if x.dim() != 3 or c.shape != (x.shape[0], x.shape[2]) or d2.shape != x.shape[:2] or w.shape != x.shape[:2]:
        raise ValueError(f"min_dist_update_cuda: bad shapes x {tuple(x.shape)}, c {tuple(c.shape)}, "
                         f"d2 {tuple(d2.shape)}, w {tuple(w.shape)}")
    if not (x.is_contiguous() and d2.is_contiguous() and w.is_contiguous()) or (c.numel() and c.stride(1) != 1):
        raise ValueError("min_dist_update_cuda: x, d2 and w must be contiguous and c's rows unit-strided")
    B, n, d = x.shape
    if d == 0:
        raise ValueError("min_dist_update_cuda: d must be positive")
    if B > 65535 or n >= 2**31 or d > MIN_DIST_MAX_D:
        raise ValueError(f"min_dist_update_cuda: shape {(B, n, d)} exceeds the launch limits "
                         f"(B ≤ 65535, d ≤ {MIN_DIST_MAX_D})")
    logits = torch.empty((B, n), dtype=torch.float32, device=x.device)
    if B == 0 or n == 0:
        return logits
    # 16-byte loads where every row of x and c starts on a 16-byte boundary.
    vec = d % 4 == 0 and x.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0 and (B == 1 or c.stride(0) % 4 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _min_dist_lib()(
            x.data_ptr(), c.data_ptr(), d2.data_ptr(), w.data_ptr(), logits.data_ptr(),
            B, n, d, c.stride(0), int(bool(median)), int(vec), stream,
        )
    if err != 0:
        raise RuntimeError(f"min_dist_update kernel launch failed: CUDA error {err}")
    min_dist_counter.count += 1
    return logits
