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
* :class:`~repro_torch.launch.distributed.MeshExecutor` — the node axis
  split over the ranks of a ``torch.distributed`` process group, each rank
  running the same per-node function on its block (``get_executor("mesh")``).

:meth:`Executor.resilient_reduce_masked` solves the recovery weights on the
device inside the step (:func:`~repro_torch.core.recovery.device_recovery_masked`)
and combines, with no host synchronisation: the alive mask is data, so a
straggler pattern never seen before costs no host solve.  The reference
jits that step; here it runs eagerly, a fixed sequence of launches.

A node function may form its block's Lemma-3 combine itself
(:func:`takes_weights`): the executors then hand it the block's weights
``b=`` and take its output as the block's weighted sum, with no node
axis.  A training step does so: it adds each node's gradient times b_i
into one buffer as it goes, so no gradient per node is kept
(:func:`repro_torch.train.train_step.make_group_grad_fn`).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, Union

import numpy as np
import torch

from ..analysis import compiled_path
from ..device import resolve_device
from ..obs import trace_span
from .aggregation import resilient_sum
from .recovery import device_recovery_masked

__all__ = ["Executor", "LocalExecutor", "get_executor", "takes_weights"]


def takes_weights(fn: Callable) -> bool:
    """Whether ``fn`` forms its block's Lemma-3 combine itself: called with
    the keyword ``b=`` (the block's weights, one per node row), it returns
    ``Σ_i b_i · stat_i`` over its rows, with no node axis; called without,
    the node-stacked statistics, as any node function.  A function says so
    with the attribute ``takes_weights = True``."""
    return bool(getattr(fn, "takes_weights", False))


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
        ``b_full`` carries zeros at stragglers, so their contributions vanish.
        A ``fn`` that :func:`takes_weights` forms the sum itself."""
        raise NotImplementedError

    def resilient_reduce_masked(
        self,
        fn: Callable,
        node_args: Sequence[Any],
        broadcast_args: Sequence[Any],
        A,
        alive,
        *,
        iters: int = 300,
        b_override=None,
    ):
        """Lemma-3 combine with the recovery weights solved ON DEVICE.

        Takes the full assignment matrix ``A`` and the boolean ``alive`` mask
        as data, runs :func:`repro_torch.core.recovery.device_recovery_masked`
        and combines — so a straggler pattern never seen before costs no host
        solve.  Returns ``(reduced, b_full)``; the weights come back so
        callers can check them against the host LP without a second solve.

        ``b_override`` (optional ``(s,)`` weights) routes the combine through
        caller-supplied weights instead of the device solve, selected by
        ``torch.where`` on a flag tensor — the same launches either way.
        """
        raise NotImplementedError

    def replicated_compute(self, fn: Callable, args: Sequence[Any]):
        """Run ``fn(*args)`` redundantly on every node; return ONE result.

        Compute redundancy, the dual of the paper's data redundancy: all
        inputs are replicated, every node computes the identical output, and
        any alive replica serves it.  Locally one call stands in for all
        replicas.
        """
        raise NotImplementedError

    # --------------------------------------------------- placement helpers
    # Sessions (repro_torch.core.resilience) keep node-stacked inputs
    # resident across rounds; these helpers make placement explicit so only
    # changed blocks move after an elastic re-assignment.

    def place_node_stacked(self, arr, device=None) -> torch.Tensor:
        """A copy of a node-stacked array on ``device`` (the card by
        default): its own storage, so :meth:`update_node_rows` never writes
        through to the caller's array."""
        return torch.as_tensor(arr).to(resolve_device(device), copy=True)

    def place_broadcast(self, arr, device=None) -> torch.Tensor:
        """A copy of an array shared by all nodes on ``device``."""
        return torch.as_tensor(arr).to(resolve_device(device), copy=True)

    def update_node_rows(self, arr: torch.Tensor, rows: Sequence[int], new_rows) -> torch.Tensor:
        """Write ``arr[rows[i]] = new_rows[i]`` in place, moving only those
        rows to the device (``index_copy_`` on the node axis); returns ``arr``."""
        raise NotImplementedError


def override_flag(b_override, s: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(use, b)`` for :meth:`Executor.resilient_reduce_masked`: the
    override is data, not a branch — a flag tensor selects it."""
    if b_override is None:
        return (torch.zeros((), dtype=torch.bool, device=device),
                torch.zeros((s,), dtype=torch.float32, device=device))
    return (torch.ones((), dtype=torch.bool, device=device),
            torch.as_tensor(b_override, dtype=torch.float32, device=device))


class LocalExecutor(Executor):
    """All nodes in one process as a single batch."""

    name = "local"

    def map_nodes(self, fn, node_args, broadcast_args=()):
        return fn(*(torch.as_tensor(a) for a in node_args), *broadcast_args)

    def _weighted(self, fn, node_args, broadcast_args, b_full):
        if takes_weights(fn):
            node_args = tuple(torch.as_tensor(a) for a in node_args)
            b = torch.as_tensor(b_full, dtype=torch.float32, device=node_args[0].device)
            return fn(*node_args, *broadcast_args, b=b)
        return resilient_sum(self.map_nodes(fn, node_args, broadcast_args), b_full)

    def resilient_reduce(self, fn, node_args, broadcast_args, b_full):
        return self._weighted(fn, node_args, broadcast_args, b_full)

    @compiled_path("local.masked_reduce", kind="factory")
    def _masked_step_raw(self, fn: Callable, n_node: int, iters: int):
        """The fused step, solve → select → combine, as a callable
        ``step(A, alive, use_override, b_override, *node_args,
        *broadcast_args) -> (combined, b_full)``: what
        :meth:`resilient_reduce_masked` runs, and what the Layer-2 sync
        audit runs (the reference's ``_masked_step_raw``)."""

        def step(A, alive, use_override, b_override, *args):
            with trace_span("recovery.device_solve", nodes=A.shape[0], iters=iters):
                solved = device_recovery_masked(A, alive, iters=iters, device=A.device)
            # The override is data, not a branch (override_flag).
            b_full = torch.where(use_override, b_override, solved)
            return self._weighted(fn, args[:n_node], args[n_node:], b_full), b_full

        return step

    def resilient_reduce_masked(
        self, fn, node_args, broadcast_args, A, alive, *, iters: int = 300,
        b_override=None,
    ):
        node_args = tuple(torch.as_tensor(a) for a in node_args)
        device = node_args[0].device
        A = torch.as_tensor(A, dtype=torch.float32, device=device)
        alive = torch.as_tensor(alive, device=device)
        s = A.shape[0]
        use_ov, b_ov = override_flag(b_override, s, device)
        with trace_span(
            "executor.masked_reduce", executor=self.name,
            nodes=int(s), override=b_override is not None,
        ):
            step = self._masked_step_raw(fn, len(node_args), iters)
            return step(A, alive, use_ov, b_ov, *node_args, *broadcast_args)

    def replicated_compute(self, fn, args):
        return fn(*args)

    def update_node_rows(self, arr, rows, new_rows):
        idx = torch.as_tensor(np.asarray(list(rows), dtype=np.int64), device=arr.device)
        src = torch.as_tensor(new_rows, dtype=arr.dtype).to(arr.device)
        return arr.index_copy_(0, idx, src)


_LOCAL = LocalExecutor()


def get_executor(spec: Union[None, str, Executor] = None) -> Executor:
    """Resolve an ``executor=`` argument: ``None`` / ``"local"`` → the shared
    :class:`LocalExecutor`; ``"mesh"`` → the mesh executor on the default
    process group (a world of one in this process when none exists); an
    :class:`Executor` instance passes through."""
    if spec is None or spec == "local":
        return _LOCAL
    if spec == "mesh":
        from ..launch.distributed import default_mesh_executor

        return default_mesh_executor()
    if isinstance(spec, Executor):
        return spec
    raise ValueError(f"unknown executor {spec!r}; expected None, 'local', or an Executor")
