"""Named outputs of the decode path's ops, for holding one decode to
another op by op.

The decode path calls :func:`tap` with each op's output: the token
embedding (``embed``), each layer's query, key and value projections
(``q``, ``k``, ``v``), its ``decode_attention`` (``attention``), the
output projection (``attn_out``), the MoE router's combine weights
(``router``), the experts' outputs (``experts``), an MLP's output (``mlp``,
the shared experts' too), the block's feed-forward (``ffn``) and the
block's output (``block``), then the ``logits``.  Outside a
:func:`recording` block a tap does nothing.  A tap names the dim that a
model axis splits where the rank holds only its part of the output (the
heads, the experts), so that a recorder can gather it whole.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

__all__ = ["active", "recording", "tap"]

_RECORDER: Optional[Callable] = None


def active() -> bool:
    """Whether a :func:`recording` block is open."""
    return _RECORDER is not None


def tap(op: str, t: torch.Tensor, split_dim: Optional[int] = None) -> None:
    """Hand op's output ``t`` to the open recording; ``split_dim``: the
    dim of ``t`` that the model axis splits, None where ``t`` is whole."""
    if _RECORDER is not None:
        _RECORDER(op, t, split_dim)


@contextlib.contextmanager
def recording(recorder: Callable):
    """While the block is open, every :func:`tap` calls
    ``recorder(op, t, split_dim)``."""
    global _RECORDER
    outer, _RECORDER = _RECORDER, recorder
    try:
        yield
    finally:
        _RECORDER = outer
