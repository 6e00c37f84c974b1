"""Wrapper of the CUDA weighted segment-sum kernel (``csrc/weighted_segsum.cu``).

Replaces the Pallas TPU kernel ``_segsum_kernel`` /
``weighted_segsum_kernel_call`` of ``src/repro/kernels/weighted_segsum/kernel.py``.
Bound on an H100: the B·n·(d+2)·4 bytes of the rows against 3.35 TB/s.  The
kernel is deterministic (no float atomics): one block per chunk of rows
keeps the whole (k, d+1) accumulator in shared memory (a slice of its
columns where it does not fit), the rows stream in by bulk asynchronous
copies, each (cluster, column) is summed in row order by the one thread
that owns the column, then a fixed-order sum over chunks.  See the
source's header.

The wrapper checks shapes, dtype, device and contiguity, allocates the
outputs and the (B, chunks, k, d+1) workspace, launches on the current
stream without synchronising, and raises if the launch failed.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..dispatch import LaunchCounter

__all__ = ["ROWS_PER_CHUNK", "weighted_segsum_cuda", "counter"]

counter = LaunchCounter("weighted_segsum")

# Rows one block walks in order.  The workspace is (d+1)·k·4 bytes per chunk,
# about an eighth of the rows' own bytes at the shapes of Algorithm 1; the
# chunks' sequential sums stay within 1e-5 of Σ|w·x| at this length
# (tests/test_torch_segsum_order.py emulates the order).
ROWS_PER_CHUNK = 2048

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("weighted_segsum")
    fn = lib.weighted_segsum_launch
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def weighted_segsum_cuda(
    x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, n, d) f32, w (B, n) f32, idx (B, n) i32, contiguous CUDA tensors
    → (sums (B, k, d) f32, totals (B, k) f32)."""
    if x.device.type != "cuda" or w.device != x.device or idx.device != x.device:
        raise ValueError("weighted_segsum_cuda: x, w and idx must share one CUDA device")
    if x.dtype != torch.float32 or w.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"weighted_segsum_cuda: expected f32/f32/i32, got {x.dtype}/{w.dtype}/{idx.dtype}")
    if x.dim() != 3 or w.shape != x.shape[:2] or idx.shape != x.shape[:2]:
        raise ValueError(f"weighted_segsum_cuda: bad shapes x {tuple(x.shape)}, w {tuple(w.shape)}, idx {tuple(idx.shape)}")
    if not (x.is_contiguous() and w.is_contiguous() and idx.is_contiguous()):
        raise ValueError("weighted_segsum_cuda: x, w and idx must be contiguous")
    B, n, d = x.shape
    k = int(k)
    if k < 0 or B > 65535 or max(n, k, d) >= 2**31:
        raise ValueError(f"weighted_segsum_cuda: shape {(B, n, k, d)} outside the launch limits")
    if B == 0 or n == 0 or k == 0 or d == 0:  # nothing to add
        return (torch.zeros((B, k, d), dtype=torch.float32, device=x.device),
                torch.zeros((B, k), dtype=torch.float32, device=x.device))
    # The reduce pass writes every element of both outputs.
    sums = torch.empty((B, k, d), dtype=torch.float32, device=x.device)
    totals = torch.empty((B, k), dtype=torch.float32, device=x.device)
    chunks = -(-n // ROWS_PER_CHUNK)
    ws = torch.empty((B, chunks, k, d + 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib()(
            x.data_ptr(), w.data_ptr(), idx.data_ptr(), ws.data_ptr(),
            sums.data_ptr(), totals.data_ptr(), B, n, d, k, ROWS_PER_CHUNK, chunks, stream,
        )
    if err != 0:
        raise RuntimeError(f"weighted_segsum kernel launch failed: CUDA error {err}")
    counter.count += 1
    return sums, totals
