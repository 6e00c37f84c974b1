"""Algorithm 1 — straggler-resilient distributed k-median (paper §3.2).

Pipeline (exactly the paper's):

1. Allocate ``P`` to ``s`` workers by an assignment with Property 1.
2. Each worker solves weighted k-median on its local shard; the centers
   ``Y_i`` are weighted by their (weighted) cluster sizes ``w_i``.
3. The coordinator collects ``{(Y_i, w_i)}`` from the alive set ``R``,
   reweights by the recovery vector (``w(c) = b_i·w_i(c)``), and solves
   weighted k-median on the union.  Theorem 3: cost ≤ 3(1+δ)·OPT.

Execution: step 2 runs through the executor seam
(:mod:`repro_torch.core.executor`); the :class:`LocalExecutor` solves all
workers as one batch over the padded ``(s, m, d)`` shards, one kernel launch
per step.  Straggler nodes still compute and get ``b = 0``, so the combine
keeps the fixed ``(s·k,)`` shape and the straggler pattern never changes a
shape.  The recovery solve and the packing run on the host (numpy, scipy);
everything after the host-to-device copy runs on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.weighted_segsum.ops import weighted_segsum
from . import kmeans
from .assignment import Assignment
from .executor import Executor, get_executor
from .recovery import RecoveryResult, lp_recovery
from .resilience import ResilienceSession

__all__ = [
    "pack_local_shards",
    "prepare_resilient_run",
    "local_cluster_batch",
    "resilient_kmedian",
    "ignore_stragglers_kmedian",
    "ResilientClusteringOutput",
]


@dataclasses.dataclass
class ResilientClusteringOutput:
    centers: np.ndarray          # (k, d) final coordinator centers
    cost: float                  # cost(P, centers) on the FULL dataset
    recovery: RecoveryResult     # the b used (diagnostics: δ, coverage)
    summary_points: np.ndarray   # the coordinator's weighted input Y (s·k, d)
    summary_weights: np.ndarray  # b-weighted center weights (s·k,); 0 at stragglers


def pack_local_shards(
    points: np.ndarray, assignment: Assignment
) -> tuple[np.ndarray, np.ndarray]:
    """Pad per-node shards to the max load: (s, m, d) data + (s, m) weights.

    Padding rows are zeros with weight 0 — inert in every weighted statistic.
    Row ``i`` is exactly the data the assignment matrix maps to node ``i``.
    """
    s = assignment.num_nodes
    loads = [assignment.shards_of(i) for i in range(s)]
    m = max((len(l) for l in loads), default=1) or 1
    d = points.shape[1]
    xs = np.zeros((s, m, d), dtype=np.float32)
    ws = np.zeros((s, m), dtype=np.float32)
    for i, l in enumerate(loads):
        xs[i, : len(l)] = points[l]
        ws[i, : len(l)] = 1.0
    return xs, ws


def _session_for(assignment, recovery_method, executor, session) -> ResilienceSession:
    """The caller's session, checked against the other arguments, or a
    throwaway one (``recovery_method`` defaults to ``"auto"``).  Any
    assignment of the session's lineage — the original or an elastically
    patched successor — is accepted."""
    if session is None:
        return ResilienceSession(
            assignment, recovery_method=recovery_method or "auto", executor=executor
        )
    if recovery_method is not None and recovery_method != session.recovery_method:
        raise ValueError(
            f"recovery_method={recovery_method!r} conflicts with the session's "
            f"{session.recovery_method!r}; construct the ResilienceSession with "
            "the method you want"
        )
    if assignment is not None and id(assignment) not in session._assignment_lineage:
        raise ValueError(
            "assignment= is not the session's assignment (nor a pre-patch "
            "version of it); a session owns exactly one assignment — build "
            "a new ResilienceSession for a different one"
        )
    if executor is not None and get_executor(executor) is not session.executor:
        raise ValueError(
            f"executor={executor!r} conflicts with the session's "
            f"{session.executor.name!r} executor"
        )
    return session


def prepare_resilient_run(
    points,
    assignment: Assignment,
    alive,
    *,
    recovery_method: Optional[str] = None,
    executor: Union[None, str, Executor] = None,
    session: Optional[ResilienceSession] = None,
):
    """Shared prelude of every distributed algorithm: dtype coercion,
    recovery solve, all-dead guard, executor resolution, shard packing.

    Returns ``(points, alive, rec, ex, xs, ws)`` (host arrays).  Pass
    ``session=`` to share the per-pattern recovery cache and packed shards
    across calls; any ``assignment``/``executor``/``recovery_method`` that
    contradicts the session's is an error.
    """
    return _session_for(assignment, recovery_method, executor, session).prepare(points, alive)


def _local_solve(xs, ws, b, *, k, iters, median, impl, generator):
    """Every node's local solve, batched over the node axis: (centers
    (s, k, d), b-weighted center weights (s, k))."""
    res = kmeans.lloyd(
        xs, k, weights=ws, iters=iters, median=median, generator=generator, impl=impl
    )
    _, tot = weighted_segsum(xs, ws, res.assignment, k, impl=impl)
    return res.centers, b.unsqueeze(-1) * tot


def local_cluster_batch(
    xs, ws, k: int, *, iters: int = 20, median: bool = True, seed: int = 0,
    impl: str = "auto", executor: Union[None, str, Executor] = None, device=None,
):
    """All workers' local clustering through the executor seam.

    Returns (centers (s, k, d), center_weights (s, k)) tensors on ``device``,
    the center weights being the weighted local cluster sizes (``w_i(c)``).
    """
    device = resolve_device(device)
    xs = torch.as_tensor(xs, dtype=torch.float32, device=device)
    ws = torch.as_tensor(ws, dtype=torch.float32, device=device)
    ones = torch.ones(xs.shape[0], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    fn = lambda x, w, b: _local_solve(  # noqa: E731
        x, w, b, k=k, iters=iters, median=median, impl=impl, generator=gen
    )
    return get_executor(executor).map_nodes(fn, (xs, ws, ones))


def _coordinator_pipeline(
    points: torch.Tensor,
    k: int,
    xs: torch.Tensor,
    ws: torch.Tensor,
    b_full: torch.Tensor,
    ex: Executor,
    *,
    local_iters: int,
    coord_iters: int,
    seed: int,
    impl: str,
) -> tuple[np.ndarray, float, np.ndarray, np.ndarray]:
    """Shared steps 2–3 on device tensors: local solves (via executor),
    b-weighted fixed-shape union, coordinator weighted k-median,
    full-dataset cost."""
    s, _, d = xs.shape
    device = xs.device
    gen = torch.Generator(device=device).manual_seed(seed)
    fn = lambda x, w, b: _local_solve(  # noqa: E731
        x, w, b, k=k, iters=local_iters, median=True, impl=impl, generator=gen
    )
    centers_s, wts_s = ex.map_nodes(fn, (xs, ws, b_full))
    # Fixed-shape union: (s·k, d) points, b-weighted weights (0 at stragglers
    # — inert in the weighted coordinator solve, like in-shard padding rows).
    y = centers_s.reshape(s * k, d)
    wy = wts_s.reshape(s * k)
    res = kmeans.lloyd(
        y, k, weights=wy, iters=coord_iters, median=True,
        generator=torch.Generator(device=device).manual_seed(seed + 1), impl=impl,
    )
    full_cost = kmeans.clustering_cost(points, res.centers, median=True, impl=impl)
    return (
        res.centers.cpu().numpy(), float(full_cost), y.cpu().numpy(), wy.cpu().numpy()
    )


def resilient_kmedian(
    points: np.ndarray,
    k: int,
    assignment: Assignment,
    alive: np.ndarray,
    *,
    recovery_method: Optional[str] = None,
    local_iters: int = 20,
    coord_iters: int = 40,
    seed: int = 0,
    impl: str = "auto",
    executor: Union[None, str, Executor] = None,
    session: Optional[ResilienceSession] = None,
    device=None,
) -> ResilientClusteringOutput:
    """Paper Algorithm 1, end to end, on ``device`` (the card by default).
    ``session`` shares the recovery cache, the packed shards and their
    device copy across calls."""
    device = resolve_device(device)
    session = _session_for(assignment, recovery_method, executor, session)
    _, _, rec, ex, _, _ = session.prepare(points, alive)
    pts, xs, ws = session.device_shards(device)
    b = torch.as_tensor(rec.b_full, dtype=torch.float32, device=device)
    centers, full_cost, y, wy = _coordinator_pipeline(
        pts, k, xs, ws, b, ex,
        local_iters=local_iters, coord_iters=coord_iters, seed=seed, impl=impl,
    )
    return ResilientClusteringOutput(
        centers=centers, cost=full_cost, recovery=rec,
        summary_points=y, summary_weights=wy,
    )


def ignore_stragglers_kmedian(
    points: np.ndarray,
    k: int,
    assignment: Assignment,
    alive: np.ndarray,
    *,
    local_iters: int = 20,
    coord_iters: int = 40,
    seed: int = 0,
    impl: str = "auto",
    executor: Union[None, str, Executor] = None,
    device=None,
) -> ResilientClusteringOutput:
    """The paper's Fig 1(b) baseline: no recovery weighting — alive workers'
    centers are combined as-is (b ≡ 1 on the alive set).  With a
    non-redundant assignment this silently drops the stragglers' data."""
    device = resolve_device(device)
    points = np.ascontiguousarray(points, dtype=np.float32)
    alive = np.asarray(alive, dtype=bool)
    if not alive.any():
        raise ValueError("no surviving nodes with data — cannot form union")
    xs, ws = pack_local_shards(points, assignment)
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    centers, full_cost, y, wy = _coordinator_pipeline(
        to(points), k, to(xs), to(ws), to(alive.astype(np.float32)), get_executor(executor),
        local_iters=local_iters, coord_iters=coord_iters, seed=seed, impl=impl,
    )
    return ResilientClusteringOutput(
        centers=centers, cost=full_cost, recovery=lp_recovery(assignment, alive),
        summary_points=y, summary_weights=wy,
    )
