"""Executor seam: WHERE per-node local computations run.

The paper's Algorithms 1–3 share one shape: pack shards per the
:class:`~repro_torch.core.assignment.Assignment`, run an independent local
computation on every node's shard, then combine the alive nodes' outputs with
the recovery weights ``b`` (Lemma 3).  The algorithms define the per-node
function; the executor decides where it runs.

* :class:`LocalExecutor` — one process, all nodes as one batch: the node
  axis is the leading dimension of every node-stacked tensor, and the
  per-node function is written batched over it (the reference ``vmap``s
  an unbatched function instead).  One kernel launch per step covers every
  node.

The reference's mesh executor (one node per device) waits for the
``torch.distributed`` port (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch

from .aggregation import resilient_sum

__all__ = ["Executor", "LocalExecutor", "get_executor"]


class Executor:
    """Protocol: map a per-node function over node-stacked data.

    ``node_args`` are tensors with a leading node axis (e.g. the padded
    shards from ``pack_local_shards``); ``broadcast_args`` are shared by
    every node.  ``fn`` takes the node-stacked tensors as they are and
    returns node-stacked outputs (a tensor or a tuple / list / dict of them).
    """

    name = "abstract"

    def map_nodes(self, fn: Callable, node_args: Sequence[Any], broadcast_args: Sequence[Any] = ()):
        raise NotImplementedError

    def resilient_reduce(self, fn: Callable, node_args: Sequence[Any], broadcast_args: Sequence[Any], b_full):
        """Lemma-3 combine: ``Σ_i b_i · fn(node_i)`` over every output leaf.
        ``b_full`` carries zeros at stragglers, so their contributions vanish."""
        raise NotImplementedError


class LocalExecutor(Executor):
    """All nodes in one process as a single batch."""

    name = "local"

    def map_nodes(self, fn, node_args, broadcast_args=()):
        return fn(*(torch.as_tensor(a) for a in node_args), *broadcast_args)

    def resilient_reduce(self, fn, node_args, broadcast_args, b_full):
        return resilient_sum(self.map_nodes(fn, node_args, broadcast_args), b_full)


_LOCAL = LocalExecutor()


def get_executor(spec: Union[None, str, Executor] = None) -> Executor:
    """Resolve an ``executor=`` argument: ``None`` / ``"local"`` → the shared
    :class:`LocalExecutor`; an :class:`Executor` instance passes through."""
    if spec is None or spec == "local":
        return _LOCAL
    if spec == "mesh":
        raise NotImplementedError(
            "the mesh executor is not ported yet: it becomes a torch.distributed "
            "executor (ROADMAP queue 1, item 9)"
        )
    if isinstance(spec, Executor):
        return spec
    raise ValueError(f"unknown executor {spec!r}; expected None, 'local', or an Executor")
