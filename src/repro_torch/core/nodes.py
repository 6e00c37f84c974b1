"""Node blocks: a node-stacked tensor split over the ranks of a mesh, and
per-node random draws that do not depend on the block a rank holds.

A node-stacked tensor has the node axis first (``s`` rows, one per node).
On a mesh of ``world`` ranks the axis is padded with zero rows to
``world · rows`` (``rows = ⌈s / world⌉``) and rank ``r`` owns rows
``[r·rows, (r+1)·rows)``: a :class:`NodeBlock` holds that block and where it
sits.  Padded rows carry zero data and zero weights, inert in every
weighted statistic.

The per-node functions draw their randomness batched over the node axis
(one ``torch.rand`` of shape ``(s, …)`` per step).  Inside a mesh rank's
call of such a function, :func:`node_rand` draws the same ``(s, …)``
tensor from the same generator and keeps this block's rows, so node ``i``
gets the uniforms the whole batch would give it, whichever rank holds it,
and the generator advances as it does in one process.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch

__all__ = ["NodeBlock", "block_bounds", "drawing_block", "node_rand"]


@dataclasses.dataclass
class NodeBlock:
    """This rank's block of a node-stacked tensor.

    ``local`` holds ``rows`` nodes starting at global node ``offset`` (zero
    rows past ``num_nodes``); ``shape`` is the shape of the whole tensor."""

    local: torch.Tensor
    offset: int
    num_nodes: int

    @property
    def shape(self) -> tuple:
        return (self.num_nodes, *self.local.shape[1:])

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def block_bounds(num_nodes: int, world: int, rank: int) -> tuple[int, int]:
    """``(offset, rows)`` of rank ``rank``'s block of ``num_nodes`` nodes."""
    rows = max(1, -(-int(num_nodes) // int(world)))
    return rank * rows, rows


# (offset, rows, num_nodes) of the block whose per-node function is running.
_BLOCK: contextvars.ContextVar[Optional[tuple[int, int, int]]] = contextvars.ContextVar(
    "node_block", default=None
)


@contextlib.contextmanager
def drawing_block(offset: int, rows: int, num_nodes: int):
    """While the block runs, :func:`node_rand` draws over all ``num_nodes``
    nodes and returns rows ``[offset, offset + rows)``."""
    token = _BLOCK.set((int(offset), int(rows), int(num_nodes)))
    try:
        yield
    finally:
        _BLOCK.reset(token)


def node_rand(shape, *, generator: torch.Generator, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.rand(shape)`` for a draw batched over the node axis.

    Outside :func:`drawing_block` this is ``torch.rand`` itself.  Inside it,
    ``shape[0]`` must be the block's row count: the draw covers every node
    and returns this block's rows, rows past the last node filled with 0.5.
    """
    block = _BLOCK.get()
    if block is None:
        return torch.rand(shape, generator=generator, dtype=dtype, device=device)
    offset, rows, num_nodes = block
    shape = tuple(shape)
    if shape[0] != rows:
        raise ValueError(f"node_rand: a draw of {shape[0]} rows inside a block of {rows} nodes")
    full = torch.rand((num_nodes, *shape[1:]), generator=generator, dtype=dtype, device=device)
    out = torch.full(shape, 0.5, dtype=dtype, device=device)
    real = max(0, min(rows, num_nodes - offset))
    out[:real] = full[offset: offset + real]
    return out
