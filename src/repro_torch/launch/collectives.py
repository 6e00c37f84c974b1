"""The collectives of the LM mesh: a sum over mesh axes and a gather over
one axis along a dimension (the reference's ``jax.lax.psum`` and
``jax.lax.all_gather(..., tiled=True)`` inside ``shard_map``, and the
all-gathers GSPMD inserts), and a chain that carries a sequential sum
across the ranks of an axis (the MoE combine, ``models.moe``).

The sum runs as ``all_reduce`` on the axis's process group, the gather
and the chain as ``broadcast``: gloo carries ``all_reduce`` and
``broadcast`` on CUDA tensors but not ``all_gather``
(``launch/distributed.py``), and ranks that share one card can only be
gloo ranks.  A gather broadcasts each rank's block to the others, which
moves half the bytes of an ``all_reduce`` of the zero-padded whole (the
executor's ``map_nodes`` gather) and copies bits.  A sum of bf16 or f16
partials runs in f32 and rounds once, which at two ranks is the
reference's bf16 ``psum`` bit for bit.  Every rank of the group receives
the same bits.  An axis of size 1 moves nothing: the tensor comes back as
it is.

:data:`STATS` counts the calls that moved data and their bytes, by kind;
``STATS.timing`` (a dict, ``None`` by default) accumulates their seconds
with the device synchronised around each call.
"""

from __future__ import annotations

import time
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["STATS", "chain", "gather", "gather_axes", "psum", "pmean"]


class _Stats:
    def __init__(self):
        self.timing: Optional[dict] = None
        self.reset()

    def reset(self) -> None:
        self.calls: dict = {}
        self.bytes: dict = {}
        if self.timing is not None:
            self.timing.clear()

    def add(self, kind: str, nbytes: int) -> None:
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes


STATS = _Stats()


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _run(kind: str, t: torch.Tensor, op) -> None:
    """Run the collective ``op`` on t, counted (and timed) under ``kind``."""
    STATS.add(kind, t.numel() * t.element_size())
    if STATS.timing is None:
        op()
        return
    sync = torch.cuda.synchronize if t.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    op()
    sync()
    STATS.timing[kind] = STATS.timing.get(kind, 0.0) + time.perf_counter() - t0


def _all_reduce(t: torch.Tensor, group, kind: str) -> None:
    _run(kind, t, lambda: dist.all_reduce(t, group=group))


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The sum of x over the ranks of ``axes`` (a name or a tuple of
    names), in x's dtype; bf16 and f16 sum in f32 and round once."""
    live = [a for a in _axes(axes) if mesh is not None and mesh.shape.get(a, 1) > 1]
    if not live:
        return x
    low = x.dtype in (torch.bfloat16, torch.float16)
    acc = x.float() if low else x.clone()
    for a in live:
        _all_reduce(acc, mesh.group(a), "sum")
    return acc.to(x.dtype) if low else acc


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of x over the ranks of ``axes``."""
    n = 1
    for a in _axes(axes):
        n *= mesh.shape.get(a, 1) if mesh is not None else 1
    return x if n == 1 else psum(x, mesh, axes) / n


def gather(x: torch.Tensor, mesh, axis: Optional[str], dim: int) -> torch.Tensor:
    """x's blocks of every rank of ``axis`` concatenated along ``dim`` in
    the order of their coordinates (``all_gather(tiled=True)``): one
    ``broadcast`` from each rank."""
    n = mesh.shape.get(axis, 1) if (mesh is not None and axis is not None) else 1
    if n == 1:
        return x
    group, r = mesh.group(axis), mesh.coord(axis)
    parts = [x.contiguous() if j == r else torch.empty_like(x, memory_format=torch.contiguous_format)
             for j in range(n)]
    for j, part in enumerate(parts):
        _run("gather", part, lambda: dist.broadcast(part, src=dist.get_global_rank(group, j), group=group))
    return torch.cat(parts, dim=dim)


def chain(fn, x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """``fn`` applied by each rank of ``axis`` in the order of their
    coordinates, each to the previous rank's result (rank 0 to x), the last
    result returned on every rank: a sequential sum carried across the
    ranks, one ``broadcast`` a rank."""
    n = mesh.shape.get(axis, 1) if (mesh is not None and axis is not None) else 1
    if n == 1:
        return fn(x)
    group, r = mesh.group(axis), mesh.coord(axis)
    x = x.contiguous()
    for j in range(n):
        if j == r:
            x = fn(x).contiguous()
        _run("chain", x, lambda: dist.broadcast(x, src=dist.get_global_rank(group, j), group=group))
    return x


def gather_axes(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """x gathered along ``dim`` over several axes, the first the outermost
    (the rows of a batch split over ``("pod", "data")``, row-major)."""
    for a in reversed(_axes(axes)):
        x = gather(x, mesh, a, dim)
    return x
