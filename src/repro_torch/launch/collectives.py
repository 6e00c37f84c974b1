"""The collectives of the LM mesh: a sum over mesh axes and a gather over
one axis along a dimension (the reference's ``jax.lax.psum`` and
``jax.lax.all_gather(..., tiled=True)`` inside ``shard_map``, and the
all-gathers GSPMD inserts), and a chain that carries a sequential sum
across the ranks of an axis (the MoE combine, ``models.moe``).

The sum runs as ``all_reduce`` on the axis's process group, the gather
and the chain as ``broadcast``: gloo carries ``all_reduce`` and
``broadcast`` on CUDA tensors but not ``all_gather`` or
``reduce_scatter`` (``launch/distributed.py``), and ranks that share one
card can only be gloo ranks.  A gather broadcasts each rank's block to the
others, which moves half the bytes of an ``all_reduce`` of the
zero-padded whole (the executor's ``map_nodes`` gather) and copies bits.
A sum of bf16 or f16 partials runs in f32 and rounds once, which at two
ranks is the reference's bf16 ``psum`` bit for bit.  :func:`pmax` (an
``all_reduce`` with ``MAX``) joins the partial maxima of a quantization
block that two ranks' columns share (``train.compression``).  Every rank of the
group receives the same bits.  An axis of size 1 moves nothing: the tensor
comes back as it is.

**Gradients.**  With grad mode on, each collective on a floating-point
tensor is a ``torch.autograd.Function`` whose backward is a collective on
the same axis's group, or none.  The convention follows the axis's role,
as GSPMD's transposes do for the reference:

* **Batch axes** (``pod``, ``data``: every rank its own rows) take
  shard_map's unreplicated transposes.  Each rank backpropagates its
  share of the global loss, ``loss / nd`` over nd data shards, and a value
  that the data shards hold alike carries a part of its cotangent on each;
  the parts sum to the whole.  A sum's backward is a sum (``sum_bwd``); a
  gather's is the sum of the cotangents over the axis, then the rank's
  block, a reduce-scatter run as ``all_reduce`` + ``narrow`` (gloo on CUDA
  tensors has no ``reduce_scatter``; ``gather_bwd``): the FSDP reduction of
  a gathered weight's gradient into its block.
* **The model axis** (``model``: every rank the same rows, its own heads,
  columns or experts) takes Megatron's rule: a value that the model ranks
  hold alike carries the WHOLE cotangent on each, so the replicated
  computations run the meshless arithmetic.  A gather's backward is the
  rank's block of the cotangent, no collective; a sum's backward is the
  identity.  Where a replicated value enters a region in which each rank
  reads its own part, the parts of its cotangent are summed:
  :func:`enter` (identity forward, ``all_reduce`` backward,
  ``enter_bwd``) before a rank's slice of a replicated tensor (its KV
  heads under GQA, the sLSTM's recurrent heads, its experts' combine
  weights and tokens), and :func:`split_linear` for ``x @ w`` with the
  rank's columns ``w``, whose backward gathers the cotangent and ``w``
  over the axis and forms ``dy @ wᵀ`` whole (``split_bwd``): the
  meshless product, where a sum of the ranks' partial products would round
  twice, and in bf16 the extra roundings grow through the layers.
* The chain's steps are broadcasts: an inner step's output is read by one
  rank (the next in the chain), so its backward sums the cotangents to the
  step's source (``chain_bwd``); the last step's output is replicated, so
  its source keeps its own cotangent and the others get zero.  The
  backward runs the chain reversed.

A parameter block's gradient is then summed over the batch axes its spec
does not split (``train.train_step``, kind ``grad_sum``); the model ranks
already hold the whole.

**Order.**  gloo's collectives block until every rank of the group joins,
so every rank must issue the same collectives in the same order, backward
too, where autograd decides the order.  :func:`sequence` opens a chain of
0-dim tokens: each collective takes the current token as an input and
gives the next as an output, so its backward needs the token's gradient
from the next collective's backward.  The backwards therefore run in the
reverse of the forward's order on every rank, and every one of them runs,
even on a rank where a collective's output does not reach the loss (a
model rank whose experts received no token, a chain step that a rank only
passes on): ``models.transformer.forward_train`` folds the last token into
its output with weight 0.  The Function runs on every floating-point
input, whether or not it requires grad, since that is the same on every
rank.

:data:`STATS` counts the calls that moved data and their bytes, by kind;
``STATS.timing`` (a dict, ``None`` by default) accumulates their seconds
with the device synchronised around each call.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["STATS", "MODEL", "chain", "enter", "gather", "gather_axes", "live_axes", "pmax", "psum", "pmean",
           "sequence", "sequence_token", "split_linear"]

MODEL = "model"  # the tensor- and expert-parallel axis: Megatron's rule (module docstring)


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

_SEQ: list = [None]  # the open sequence's current token, or None


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def live_axes(mesh, axes) -> tuple:
    """The axes of ``axes`` whose size on ``mesh`` exceeds 1."""
    return tuple(a for a in _axes(axes) if mesh is not None and mesh.shape.get(a, 1) > 1)


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


def _sum(x: torch.Tensor, mesh, live: tuple, kind: str) -> torch.Tensor:
    """The sum of x over the ranks of the axes ``live``, a new tensor in
    x's dtype; bf16 and f16 sum in f32 and round once."""
    low = x.dtype in (torch.bfloat16, torch.float16)
    acc = x.float() if low else x.clone(memory_format=torch.contiguous_format)
    for a in live:
        _all_reduce(acc, mesh.group(a), kind)
    return acc.to(x.dtype) if low else acc


def _broadcast(part: torch.Tensor, group, j: int, kind: str) -> None:
    _run(kind, part, lambda: dist.broadcast(part, src=dist.get_global_rank(group, j), group=group))


def _gather_parts(x: torch.Tensor, mesh, axis: str, kind: str) -> list:
    """Every rank's block of x along ``axis``, in the order of their
    coordinates: one ``broadcast`` from each rank.  The rank broadcasts a
    copy of x: a broadcast counts as an in-place write of its tensor, and
    x may be a tensor that autograd saved (the flash Function's output)."""
    n, group, r = mesh.shape[axis], mesh.group(axis), mesh.coord(axis)
    parts = [x.clone(memory_format=torch.contiguous_format) if j == r
             else torch.empty_like(x, memory_format=torch.contiguous_format) for j in range(n)]
    for j, part in enumerate(parts):
        _broadcast(part, group, j, kind)
    return parts


def _gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    return torch.cat(_gather_parts(x, mesh, axis, "gather"), dim=dim)


# ------------------------------------------------------------------ autograd


@contextlib.contextmanager
def sequence(device):
    """Order the collectives of a differentiable forward (module docstring):
    a chain of tokens on ``device`` while the block runs.  Yields whether
    this call opened it (a nested call leaves the outer chain in place);
    the opener folds :func:`sequence_token`, read before the block ends,
    into its output with weight 0."""
    if _SEQ[0] is not None:
        yield False
        return
    _SEQ[0] = torch.zeros((), dtype=torch.float32, device=device, requires_grad=True)
    try:
        yield True
    finally:
        _SEQ[0] = None


def sequence_token() -> Optional[torch.Tensor]:
    """The open sequence's current token (None when none is open)."""
    return _SEQ[0]


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.is_floating_point()


def _apply(fn, x, *args):
    """``fn.apply(x, token, *args)`` threading the open sequence's token."""
    tok = _SEQ[0]
    y, nxt = fn.apply(x, tok, *args)
    if tok is not None:
        _SEQ[0] = nxt
    return y


def _next(tok):
    return None if tok is None else tok.clone()


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tok, mesh, live):
        ctx.mesh, ctx.batch = mesh, tuple(a for a in live if a != MODEL)
        return _sum(x, mesh, live, "sum"), _next(tok)

    @staticmethod
    def backward(ctx, dy, dtok):
        return (_sum(dy, ctx.mesh, ctx.batch, "sum_bwd") if ctx.batch else dy), dtok, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tok, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.blk = mesh, axis, dim % x.dim(), x.shape[dim]
        return _gather(x, mesh, axis, dim), _next(tok)

    @staticmethod
    def backward(ctx, dy, dtok):
        total = dy if ctx.axis == MODEL else _sum(dy, ctx.mesh, (ctx.axis,), "gather_bwd")
        r = ctx.mesh.coord(ctx.axis)
        return total.narrow(ctx.dim, r * ctx.blk, ctx.blk), dtok, None, None, None


class _Broadcast(torch.autograd.Function):
    """One step of the chain: every rank of ``axis`` receives the block of
    the rank at coordinate ``src``; ``last``: the chain's result, which
    every rank reads alike."""

    @staticmethod
    def forward(ctx, x, tok, mesh, axis, src, last):
        ctx.mesh, ctx.axis, ctx.src, ctx.last = mesh, axis, src, last
        y = x.clone(memory_format=torch.contiguous_format)
        _broadcast(y, mesh.group(axis), src, "chain")
        return y, _next(tok)

    @staticmethod
    def backward(ctx, dy, dtok):
        total = dy if ctx.last else _sum(dy, ctx.mesh, (ctx.axis,), "chain_bwd")
        mine = ctx.mesh.coord(ctx.axis) == ctx.src
        return (total if mine else torch.zeros_like(total)), dtok, None, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tok, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x), _next(tok)

    @staticmethod
    def backward(ctx, dy, dtok):
        return _sum(dy, ctx.mesh, (ctx.axis,), "enter_bwd"), dtok, None, None


class _SplitLinear(torch.autograd.Function):
    """x @ w for x that the ranks of ``axis`` hold alike and w the rank's
    columns; ``gather_out``: the products gathered over the axis."""

    @staticmethod
    def forward(ctx, x, tok, w, mesh, axis, gather_out):
        ctx.save_for_backward(x, w)
        ctx.mesh, ctx.axis, ctx.gather_out = mesh, axis, gather_out
        y = x @ w
        return (_gather(y, mesh, axis, -1) if gather_out else y), _next(tok)

    @staticmethod
    def backward(ctx, dy, dtok):
        x, w = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        n, r, cols = mesh.shape[axis], mesh.coord(axis), w.shape[-1]
        if ctx.gather_out:
            whole, mine = dy, dy.narrow(-1, r * cols, cols)
        else:
            mine = dy
            whole = torch.cat(_gather_parts(dy.contiguous(), mesh, axis, "split_bwd"), -1)
        w_whole = torch.cat(_gather_parts(w.contiguous(), mesh, axis, "split_bwd"), -1)
        x2, mine2 = x.reshape(-1, x.shape[-1]), mine.reshape(-1, cols)
        dx = whole.reshape(-1, n * cols).mm(w_whole.t()).view_as(x)
        dw = x2.t().mm(mine2) if ctx.needs_input_grad[2] else None
        return dx, dtok, dw, None, None, None


# ------------------------------------------------------------------ ops


def enter(x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """x, which every rank of the model axis ``axis`` holds alike, as it
    enters a region where each rank reads its own part: the identity; with
    grad mode on its backward sums the ranks' cotangents (module
    docstring)."""
    n = mesh.shape.get(axis, 1) if (mesh is not None and axis is not None) else 1
    if n == 1 or not _differentiable(x):
        return x
    return _apply(_Enter, x, mesh, axis)


def split_linear(x: torch.Tensor, w: torch.Tensor, mesh, axis: Optional[str], *,
                 gather_out: bool = False) -> torch.Tensor:
    """``x @ w`` for x (…, d) that every rank of the model axis ``axis``
    holds alike and w (d, c) the rank's columns; with ``gather_out`` the
    products of every rank concatenated (the vocab-parallel head).  The
    forward is the plain product (the meshless columns); with grad mode on
    the backward forms x's cotangent from the gathered cotangent and the
    gathered w, the meshless ``dy @ wᵀ`` (module docstring)."""
    n = mesh.shape.get(axis, 1) if (mesh is not None and axis is not None) else 1
    if n == 1 or not (_differentiable(x) or _differentiable(w)):
        y = x @ w
        return _gather(y, mesh, axis, -1) if (gather_out and n > 1) else y
    return _apply(_SplitLinear, x, w, mesh, axis, gather_out)


def psum(x: torch.Tensor, mesh, axes, *, kind: str = "sum") -> torch.Tensor:
    """The sum of x over the ranks of ``axes`` (a name or a tuple of
    names), in x's dtype; bf16 and f16 sum in f32 and round once.
    Differentiable with grad mode on: its backward a sum over the batch
    axes, the identity over ``model``."""
    live = live_axes(mesh, axes)
    if not live:
        return x
    if _differentiable(x):
        return _apply(_Psum, x, mesh, live)
    return _sum(x, mesh, live, kind)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of x over the ranks of ``axes``, a new tensor
    (kind ``pmax``): exact in any order, so every rank receives the bits
    of the largest.  Not differentiable."""
    live = live_axes(mesh, axes)
    if not live:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    for a in live:
        _run("pmax", out, lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group(a)))
    return out


def pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The mean of x over the ranks of ``axes``."""
    n = 1
    for a in _axes(axes):
        n *= mesh.shape.get(a, 1) if mesh is not None else 1
    return x if n == 1 else psum(x, mesh, axes) / n


def gather(x: torch.Tensor, mesh, axis: Optional[str], dim: int) -> torch.Tensor:
    """x's blocks of every rank of ``axis`` concatenated along ``dim`` in
    the order of their coordinates (``all_gather(tiled=True)``): one
    ``broadcast`` from each rank.  Differentiable with grad mode on: over
    a batch axis its backward is a reduce-scatter, over ``model`` the
    rank's block."""
    n = mesh.shape.get(axis, 1) if (mesh is not None and axis is not None) else 1
    if n == 1:
        return x
    if _differentiable(x):
        return _apply(_Gather, x, mesh, axis, dim)
    return _gather(x, mesh, axis, dim)


def chain(fn, x: torch.Tensor, mesh, axis: Optional[str]) -> torch.Tensor:
    """``fn`` applied by each rank of ``axis`` in the order of their
    coordinates, each to the previous rank's result (rank 0 to x), the last
    result returned on every rank: a sequential sum carried across the
    ranks, one ``broadcast`` a rank.  Differentiable with grad mode on:
    the backward runs the chain reversed."""
    n = mesh.shape.get(axis, 1) if (mesh is not None and axis is not None) else 1
    if n == 1:
        return fn(x)
    group, r = mesh.group(axis), mesh.coord(axis)
    x = x.contiguous()
    for j in range(n):
        if j == r:
            x = fn(x).contiguous()
        if _differentiable(x):
            x = _apply(_Broadcast, x, mesh, axis, j, j == n - 1)
        else:
            _broadcast(x, group, j, "chain")
    return x


def gather_axes(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """x gathered along ``dim`` over several axes, the first the outermost
    (the rows of a batch split over ``("pod", "data")``, row-major)."""
    for a in reversed(_axes(axes)):
        x = gather(x, mesh, a, dim)
    return x
