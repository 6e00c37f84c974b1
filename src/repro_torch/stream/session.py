"""StreamingSession — the always-on front door of the streaming layer.

The reference package's ``stream/session.py`` in PyTorch.  One object owns
the whole ingest → compact → solve → serve lifecycle:

* ``ingest(batch)`` feeds arriving points into the merge-and-reduce tree
  (:class:`~repro_torch.stream.buffer.StreamBuffer`).  The round's
  straggler mask comes from an attached scenario or an explicit ``alive=``;
  the wrapped :class:`~repro_torch.core.resilience.ResilienceSession`
  observes it first, so persistent stragglers trigger elastic
  re-assignment before any compaction runs against them.
* ``solve()`` runs weighted k-median (or k-means) over the tree frontier
  and refreshes the serving model.
* ``query(points)`` answers nearest-center queries through
  :class:`~repro_torch.stream.query.QueryEngine`, with a staleness bound.

The recovery state is shared across ingests: a straggler pattern seen in
round 3 costs no host solve when it recurs in round 300.  The tree, the
frontier and the centers live on ``device`` (the card by default).

Env knobs (defaults for unset constructor args):
``REPRO_STREAM_LEAF_SIZE`` — raw points per leaf before compaction (512);
``REPRO_STREAM_FANOUT`` — buckets merged per level compaction (4).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

import numpy as np
import torch

from ..analysis import compiled_path
from ..core import kmeans
from ..core.assignment import make_assignment
from ..core.executor import Executor
from ..core.resilience import ElasticPolicy, ResilienceSession
from ..core.stragglers import StragglerScenario
from ..device import resolve_device
from ..kernels import autotune
from ..obs import trace_span
from .buffer import StreamBuffer
from .query import QueryEngine, QueryResult, bucket_size

__all__ = ["StreamingSession", "StreamSolveResult"]


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


@dataclasses.dataclass
class StreamSolveResult:
    centers: torch.Tensor  # (k, d), on the session's device
    cost: float            # weighted clustering cost over the frontier
    frontier_size: int     # rows the coordinator solved over (pre-padding)
    version: int           # serving-model version (monotonic)


class StreamingSession:
    """Streaming resilient clustering over redundantly-compacted coresets.
    With ``executor="mesh"`` every rank of the mesh runs the session, its
    compactions through ``MeshExecutor.replicated_compute``, and holds the
    same tree."""

    def __init__(
        self,
        d: int,
        k: int,
        *,
        num_nodes: int = 8,
        scheme: str = "fractional_repetition",
        ell: int = 2,
        leaf_size: Optional[int] = None,
        fanout: Optional[int] = None,
        coreset_size: Optional[int] = None,
        scenario: Optional[StragglerScenario] = None,
        executor: Union[None, str, Executor] = None,
        elastic: Optional[ElasticPolicy] = None,
        recovery_method: str = "auto",
        squared: bool = False,
        impl: str = "auto",
        seed: int = 0,
        solve_iters: int = 20,
        device=None,
    ):
        self.d, self.k = int(d), int(k)
        self.device = resolve_device(device)
        leaf_size = leaf_size or _env_int("REPRO_STREAM_LEAF_SIZE", 512)
        fanout = fanout or _env_int("REPRO_STREAM_FANOUT", 4)
        coreset_size = coreset_size or max(self.k + 1, leaf_size // 4)
        if scenario is not None and scenario.num_nodes != num_nodes:
            raise ValueError(
                f"scenario has {scenario.num_nodes} nodes, session has {num_nodes}"
            )
        # The bucket→node placement: every level's fanout-sized compaction
        # group is a shard set of this assignment.  Fractional repetition's
        # replica groups are disjoint per bucket, so recovery is exact for
        # every coverage-preserving pattern.
        assignment = make_assignment(scheme, fanout, num_nodes, ell=ell)
        self.resilience = ResilienceSession(
            assignment,
            recovery_method=recovery_method,
            executor=executor,
            elastic=elastic if elastic is not None else ElasticPolicy(enabled=True, patience=2),
            device=self.device,
        )
        self.buffer = StreamBuffer(
            d, k,
            session=self.resilience,
            leaf_size=leaf_size,
            coreset_size=coreset_size,
            squared=squared,
            impl=impl,
            seed=seed,
            device=self.device,
        )
        self.scenario = scenario
        self.query_engine = QueryEngine(impl=impl, device=self.device)
        self.squared = bool(squared)
        self.impl = impl
        self.seed = int(seed)
        self.solve_iters = int(solve_iters)
        self._centers: Optional[torch.Tensor] = None
        self._version = 0
        self._ingested = 0
        self._ingests = 0
        self._points_at_solve = 0
        self._ingests_at_solve = 0
        self._solve_listeners: list = []

    def add_solve_listener(self, fn) -> None:
        """Register ``fn(session)`` to run after every successful solve (the
        serving frontend re-warms its tenants there).  Listener exceptions
        propagate."""
        self._solve_listeners.append(fn)

    # ------------------------------------------------------------- ingest

    def ingest(self, batch, alive: Optional[np.ndarray] = None) -> dict:
        """Feed one arriving batch; returns a per-round report.  The round's
        mask is ``alive`` if given, else the scenario's next step, else
        all-alive; the resilience session observes it first."""
        if alive is not None:
            step = np.asarray(alive, dtype=bool)
        elif self.scenario is not None:
            try:
                step = next(self.scenario)
            except StopIteration:
                raise ValueError(
                    f"straggler scenario exhausted after {self._ingests} "
                    "ingests — pass alive= explicitly or use loop=True"
                ) from None
        else:
            step = np.ones(self.resilience.num_nodes, dtype=bool)
        event = self.resilience.observe(step)
        mask = np.asarray(getattr(step, "alive", step), dtype=bool)
        with trace_span("stream.ingest", rows=len(batch), stragglers=int((~mask).sum())):
            report = self.buffer.add_batch(batch, mask)
        self._ingested += len(batch)
        self._ingests += 1
        report["alive"] = mask
        report["elastic"] = event
        return report

    # -------------------------------------------------------------- solve

    def frontier(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(points, weights) on the device: the tree's recovered summary."""
        return self.buffer.frontier()

    def _solve_frontier(self, generator: torch.Generator, x, w, iters: int):
        """Weighted coordinator solve over the frontier padded to a
        power-of-two row count with weight-0 rows (inert in every weighted
        statistic; the ++ seeding never draws them)."""
        n = x.shape[0]
        nb = bucket_size(n)
        xp = torch.zeros((nb, self.d), dtype=torch.float32, device=self.device)
        wp = torch.zeros((nb,), dtype=torch.float32, device=self.device)
        xp[:n], wp[:n] = x, w
        return kmeans.lloyd(
            xp, self.k, weights=wp, iters=iters, median=not self.squared,
            generator=generator, impl=self.impl,
        )

    def solve(self, *, iters: Optional[int] = None, seed: Optional[int] = None) -> StreamSolveResult:
        """Resilient k-median (``squared=False``) / k-means over the frontier;
        refreshes the serving centers and resets the staleness clock."""
        x, w = self.frontier()
        if x.shape[0] == 0:
            raise ValueError("nothing ingested yet — solve() needs data")
        gen = torch.Generator(device=self.device).manual_seed(self.seed if seed is None else int(seed))
        with trace_span("stream.solve", frontier=int(x.shape[0])):
            res = self._solve_frontier(gen, x, w, self.solve_iters if iters is None else int(iters))
        self._centers = res.centers
        self._version += 1
        self._points_at_solve = self._ingested
        self._ingests_at_solve = self._ingests
        # Warm the serving side of the generation bump off the hot path
        # (REPRO_WARM_START=0 opts out).
        if autotune.warm_start_enabled():
            self.query_engine.warmup(self._centers, self._version)
        for fn in list(self._solve_listeners):
            fn(self)
        return StreamSolveResult(
            centers=self._centers,
            cost=float(res.cost),
            frontier_size=int(x.shape[0]),
            version=self._version,
        )

    def solve_pca(self, r: int) -> torch.Tensor:
        """Top-r right singular basis (d, r) of the weighted frontier
        (√w-scaled rows, the Lemma-5 weighting), on the device."""
        x, w = self.frontier()
        if x.shape[0] == 0:
            raise ValueError("nothing ingested yet — solve_pca() needs data")
        scaled = torch.sqrt(torch.clamp_min(w, 0.0))[:, None] * x
        _, _, vt = torch.linalg.svd(scaled, full_matrices=False)
        return vt[:r].T

    # -------------------------------------------------------------- serve

    @property
    def centers(self) -> Optional[torch.Tensor]:
        return self._centers

    @property
    def version(self) -> int:
        """Serving-model version (bumped by every solve)."""
        return self._version

    @property
    def ingests(self) -> int:
        """Total ingest calls so far."""
        return self._ingests

    @property
    def generation(self) -> tuple:
        """``(version, ingests)`` — the serving tier's cache key."""
        return (self._version, self._ingests)

    def ensure_model(self) -> torch.Tensor:
        """Serving centers, solving once if no model exists yet."""
        if self._centers is None:
            self.solve()
        return self._centers

    @property
    def staleness(self) -> dict:
        """Ingestion that the current serving model has not seen."""
        return {
            "points": self._ingested - self._points_at_solve,
            "ingests": self._ingests - self._ingests_at_solve,
            "version": self._version,
        }

    @compiled_path("stream.query", kind="host")
    def query(self, queries) -> QueryResult:
        """Nearest-center answers with a staleness bound; solves once
        automatically if no model exists yet."""
        if self._centers is None:
            self.solve()
        return self.query_engine.assign(
            queries,
            self._centers,
            staleness_points=self._ingested - self._points_at_solve,
            staleness_ingests=self._ingests - self._ingests_at_solve,
            version=self._version,
        )

    # -------------------------------------------------------------- stats

    @property
    def stats(self) -> dict:
        """One flat view over tree, recovery and serving counters."""
        buf = self.buffer
        return {
            "ingested_points": self._ingested,
            "ingest_calls": self._ingests,
            "leaf_compactions": buf.leaf_compactions,
            "compactions": buf.compactions,
            "blocking_compactions": buf.blocking_compactions,
            "buckets": buf.num_buckets,
            "levels": len(buf.levels),
            "summary_points": buf.summary_points,
            "queries_served": self.query_engine.queries_served,
            "query_buckets_compiled": self.query_engine.compiled_buckets,
            "query_warmups": self.query_engine.warmups,
            "model_version": self._version,
            **{f"recovery_{k}": v for k, v in self.resilience.stats.as_dict().items()},
        }
