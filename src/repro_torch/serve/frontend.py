"""Planet-scale query frontend: async micro-batching over StreamingSessions.

The reference package's ``serve/frontend.py`` in PyTorch.
``StreamingSession.query`` is a single-process synchronous call — one
caller, one dispatch, one device round-trip.  This tier is how *many
concurrent* callers hit many sessions:

* **Micro-batching** — concurrent queries land in per-``(tenant, d)`` shape
  buckets (:class:`~repro_torch.serve.batcher.MicroBatcher`); a bucket
  becomes ONE ``assign_min`` launch and ONE device→host transfer
  (:class:`~repro_torch.stream.query.HostFetch`) when its batch window
  elapses or it reaches ``max_batch`` rows.  Rows are padded to the
  power-of-two buckets of :func:`repro_torch.stream.query.bucket_size`.
* **Per-tenant model routing** — each tenant name maps to its own
  :class:`~repro_torch.stream.session.StreamingSession`; its centers are
  placed on the device once per (model object, version) and reused.
* **Admission control** — callers attach ``max_staleness_points`` /
  ``max_staleness_ingests`` bounds.  Violations reject at submit
  (:class:`AdmissionError`, immediate backpressure) AND are re-checked at
  dispatch, because ingest may run concurrently while a ticket waits out
  the batch window.
* **Assignment-result cache** — repeat / near-duplicate query batches are
  answered from an LRU keyed by ``(tenant, generation, quantized-query
  digest)`` (:class:`~repro_torch.serve.cache.AssignmentCache`); any ingest or
  model-version bump changes the generation and thus invalidates.

The core (:class:`ServingFrontend`) is sans-io: no threads, no sleeps, time
injected via a clock — which is what makes the concurrency test suite
deterministic.  :class:`AsyncFrontend` is the thin asyncio shell production
callers await on.

Env knobs (defaults for unset constructor args):
``REPRO_SERVE_WINDOW_MS`` — batch window in milliseconds (2.0);
``REPRO_SERVE_MAX_BATCH`` — rows that close a bucket early (256);
``REPRO_SERVE_CACHE`` — assignment-cache entries (1024).
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import itertools
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..analysis import compiled_path
from ..kernels import autotune
from ..obs import default_registry, trace_span
from ..stream.query import DeviceCenters, HostFetch, QueryResult, assign_rows, bucket_size
from .batcher import Batch, MicroBatcher, Ticket
from .cache import AssignmentCache
from .clock import SystemClock

__all__ = ["AdmissionError", "ServingFrontend", "AsyncFrontend", "TenantState"]

# Distinguishes concurrent frontends' metrics in the shared registry
# (frontends come and go in tests; each instance's counters start at 0).
_FRONTEND_IDS = itertools.count()


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return max(0, int(os.environ.get(name, str(default))))
    except ValueError:
        return default


class AdmissionError(RuntimeError):
    """A query's staleness bound cannot be honored by the serving model."""

    def __init__(self, message: str, *, tenant: str = "", staleness: Optional[dict] = None):
        super().__init__(message)
        self.tenant = tenant
        self.staleness = dict(staleness or {})


@compiled_path("serve.batch_assign", kind="factory")
def _batch_assign_run(impl: str):
    """The frontend's micro-batch step, ``run(q, c) -> (idx, distance)``:
    registered so both analyzer layers cover the serving dispatch as they
    cover the per-session query path (the reference's ``_batch_assign_run``)."""

    def run(q, c):
        return assign_rows(q, c, impl)

    return run


@dataclasses.dataclass
class TenantState:
    """One tenant's session plus its device-resident model cache."""

    session: object                    # StreamingSession
    queries_served: int = 0
    batches: int = 0
    elastic_patches: int = 0
    warmups: int = 0                   # warm-up passes run for this tenant
    # (bucket, d) shape buckets this tenant's traffic has actually used —
    # the bucket set a warm-up pass re-compiles after a generation bump.
    observed_buckets: set = dataclasses.field(default_factory=set)
    # Centers on the device (a tensor's own, else the card), placed again
    # only when the model changes: ``device_centers(centers, version)``.
    device_centers: DeviceCenters = dataclasses.field(default_factory=DeviceCenters)


def _violation(staleness: dict, ticket: Ticket) -> Optional[str]:
    """Reason the ticket's bound is violated by ``staleness``, or None."""
    bp = ticket.max_staleness_points
    if bp is not None and staleness["points"] > bp:
        return (
            f"staleness {staleness['points']} points exceeds the query's "
            f"bound of {bp}"
        )
    bi = ticket.max_staleness_ingests
    if bi is not None and staleness["ingests"] > bi:
        return (
            f"staleness {staleness['ingests']} ingests exceeds the query's "
            f"bound of {bi}"
        )
    return None


class ServingFrontend:
    """Sans-io micro-batching query tier over per-tenant StreamingSessions."""

    def __init__(
        self,
        *,
        window: Optional[float] = None,
        max_batch: Optional[int] = None,
        cache_size: Optional[int] = None,
        quantize: int = 6,
        impl: str = "auto",
        clock=None,
    ):
        if window is None:
            window = _env_float("REPRO_SERVE_WINDOW_MS", 2.0) / 1000.0
        if max_batch is None:
            max_batch = max(1, _env_int("REPRO_SERVE_MAX_BATCH", 256))
        if cache_size is None:
            cache_size = _env_int("REPRO_SERVE_CACHE", 1024)
        self.clock = clock if clock is not None else SystemClock()
        self.impl = impl
        self._run = _batch_assign_run(impl)
        self.batcher = MicroBatcher(window=window, max_batch=max_batch)
        self.cache = AssignmentCache(cache_size, quantize=quantize)
        self._tenants: Dict[str, TenantState] = {}
        # All tier counters live in the process-wide metrics registry (the
        # legacy instance attributes survive as read properties below) — one
        # number each, shared with obs-report.
        self._obs_labels = {"frontend": f"f{next(_FRONTEND_IDS)}"}
        reg = default_registry()

        def _counter(name, help):
            return reg.counter(name, labels=self._obs_labels, help=help)

        self._c_served = _counter("serve_served_rows", "rows answered (cache + dispatch)")
        self._c_rejected = _counter("serve_rejected", "tickets bounced by admission")
        self._c_dispatches = _counter("serve_dispatches", "batch dispatches")
        self._c_warmups = _counter("serve_warmups", "warm-up passes (solves + explicit)")
        self._c_occupancy = _counter("serve_occupancy_sum", "Σ rows/padded-bucket per dispatch")
        # Admission rejections split by stage: a submit-time bounce is cheap
        # backpressure, a dispatch-time bounce wasted a batch slot.
        self._c_reject_stage = {
            stage: reg.counter(
                "serve_admission_rejects",
                labels={**self._obs_labels, "stage": stage},
                help="admission rejections by stage",
            )
            for stage in ("submit", "dispatch")
        }
        # Batch close reasons mirrored from the sans-io batcher (which stays
        # registry-free) so obs-report sees why buckets closed.
        self._g_close_reason = {
            reason: reg.gauge(
                "serve_batch_closes",
                labels={**self._obs_labels, "reason": reason},
                help="batches closed by reason (window elapsed vs max_batch)",
            )
            for reason in ("window", "size")
        }
        self._g_queue_depth = reg.gauge(
            "serve_queue_depth", labels=self._obs_labels,
            help="rows waiting in open buckets",
        )
        # Per-tenant latency histogram handles, resolved through the registry
        # ONCE per tenant.  The per-ticket observe must be a dict hit: a
        # registry lookup (label-sort + lock) per completed ticket measured
        # as a double-digit-% serve p50 regression at burst size 512.
        self._lat_hists: Dict[str, object] = {}
        self._fetch = HostFetch()

    # ------------------------------------------------------------ tenants

    def add_tenant(self, name: str, session) -> TenantState:
        """Route queries for ``name`` to ``session``; idempotent per name."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already registered")
        state = TenantState(session=session)
        self._tenants[name] = state
        # Count elastic re-assignments so serving stats show model-side
        # turbulence next to query-side latency (the patch itself changes
        # placement, not the model — cached answers stay valid).
        session.resilience.add_patch_listener(
            lambda *_a, _s=state: setattr(
                _s, "elastic_patches", _s.elastic_patches + 1
            )
        )
        # Re-warm this tenant after every generation bump: the solve already
        # cold-started every hot query (new centers to upload) — running the
        # warm-up plan synchronously inside
        # solve() keeps the first post-solve query at steady-state latency.
        # REPRO_WARM_START=0 opts out (checked at fire time, not here).
        add_listener = getattr(session, "add_solve_listener", None)
        if add_listener is not None:
            add_listener(
                lambda _s, _name=name: (
                    self.warmup(_name) if autotune.warm_start_enabled() else None
                )
            )
        return state

    def tenant(self, name: str) -> TenantState:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(
                f"unknown tenant {name!r}; register it with add_tenant()"
            ) from None

    # ------------------------------------------------------------- warm-up

    @compiled_path("serve.warmup", kind="host")
    def warmup(self, tenant: Optional[str] = None) -> "autotune.WarmupReport":
        """Place the centers and run the shape buckets a tenant's traffic has
        used once — off the hot path (the first call of a kernel loads, and
        if need be builds, its library).

        Run for one ``tenant`` or (default) all of them.  Tenants without a
        model yet are skipped (warm-up never forces a solve); tenants whose
        traffic has not been observed warm the smallest bucket, where the
        first real query lands.  Failures inside the plan are counted in the
        report, never raised: warm-up must not take down the tier.
        """
        names = [tenant] if tenant is not None else list(self._tenants)
        report = autotune.WarmupReport()
        for name in names:
            state = self.tenant(name)
            centers = state.session.centers
            if centers is None:
                continue
            d = int(centers.shape[1])
            version = state.session.version
            buckets = sorted(
                b for (b, bd) in state.observed_buckets if bd == d
            ) or [bucket_size(1)]

            def entry(b, _state=state, _c=centers, _v=version, _d=d):
                c_dev = _state.device_centers(_c, _v)
                return self._run(torch.zeros((b, _d), device=c_dev.device), c_dev)

            plan = [
                (f"{name}[{b}x{d}]", functools.partial(entry, b))
                for b in buckets
            ]
            with trace_span("serve.warmup", tenant=name, buckets=len(buckets)):
                report = report.merge(autotune.warmup(plan))
            state.warmups += 1
        self._c_warmups.inc()
        return report

    # ------------------------------------------------------------- submit

    def submit(
        self,
        tenant: str,
        queries,
        *,
        max_staleness_points: Optional[int] = None,
        max_staleness_ingests: Optional[int] = None,
    ) -> Ticket:
        """Admit one query row-batch; returns its :class:`Ticket`.

        Cache hits complete the ticket immediately; otherwise it joins the
        tenant's open shape bucket and completes on a later :meth:`flush`.
        Raises :class:`AdmissionError` if the tenant's staleness already
        violates the caller's bound — rejecting at the door is cheaper for
        both sides than a doomed batched dispatch.
        """
        state = self.tenant(tenant)
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(f"queries must be non-empty (n, d), got {q.shape}")
        now = self.clock.now()
        ticket = Ticket(
            tenant=tenant,
            queries=q,
            submitted_at=now,
            max_staleness_points=max_staleness_points,
            max_staleness_ingests=max_staleness_ingests,
        )
        staleness = state.session.staleness
        reason = _violation(staleness, ticket)
        if reason is not None:
            self._c_rejected.inc()
            self._c_reject_stage["submit"].inc()
            ticket._reject(reason)
            raise AdmissionError(reason, tenant=tenant, staleness=staleness)
        hit = self.cache.get(self.cache.key(tenant, state.session.generation, q))
        if hit is not None:
            # Generation-keyed hit: the cached answer's staleness equals what
            # a fresh dispatch would report right now, so the bound check
            # above already covers it.
            ticket.from_cache = True
            ticket._complete(hit)
            state.queries_served += ticket.rows
            self._c_served.inc(ticket.rows)
            self._observe_latency(tenant, ticket)
            return ticket
        self.batcher.submit(ticket, now)
        return ticket

    # -------------------------------------------------------------- drain

    def due(self) -> Optional[float]:
        """When the next flush will produce work (None if nothing pending)."""
        return self.batcher.due(self.clock.now())

    def flush(self, now: Optional[float] = None) -> int:
        """Dispatch every batch whose window has closed; returns how many."""
        batches = self.batcher.poll(self.clock.now() if now is None else now)
        for batch in batches:
            self._dispatch(batch)
        # Queue depth is sampled per flush, not per submit: submit is the
        # per-query hot path and the gauge only needs batch-rate resolution.
        self._g_queue_depth.set(self.batcher.pending)
        return len(batches)

    def drain(self) -> int:
        """Dispatch everything pending regardless of windows (shutdown)."""
        batches = self.batcher.drain()
        for batch in batches:
            self._dispatch(batch)
        self._g_queue_depth.set(self.batcher.pending)
        return len(batches)

    # ----------------------------------------------------------- dispatch

    @compiled_path("serve.dispatch", kind="host")
    def _dispatch(self, batch: Batch) -> None:
        """One closed bucket → one ``assign_min`` launch → ONE device→host
        transfer.

        Admission is re-checked against *live* staleness first: ingest may
        have run while tickets waited out the window, and a bound the
        submit-time check admitted can be violated by dispatch time.
        """
        state = self._tenants[batch.tenant]
        session = state.session
        centers = session.ensure_model()
        staleness = session.staleness
        live = []
        for t in batch.tickets:
            reason = _violation(staleness, t)
            if reason is not None:
                self._c_rejected.inc()
                self._c_reject_stage["dispatch"].inc()
                t._reject(reason)
            else:
                live.append(t)
        if not live:
            return
        q = np.concatenate([t.queries for t in live], axis=0)
        n, d = q.shape
        bucket = bucket_size(n)
        with trace_span(
            "serve.dispatch", tenant=batch.tenant, rows=n, bucket=bucket
        ):
            qp = np.zeros((bucket, d), np.float32)
            qp[:n] = q  # zero padding rows are sliced off below
            state.observed_buckets.add((bucket, d))
            c_dev = state.device_centers(centers, session.version)
            idx, dist = self._run(torch.from_numpy(qp).to(c_dev.device), c_dev)
            # Fetch the FULL padded arrays and slice on the host, as the
            # reference does: the padding is a few KB.
            idx_h, dist_h = self._fetch(idx, dist)
        idx_h = idx_h[:n]
        dist_h = dist_h[:n]
        generation = session.generation
        version = session.version
        offset = 0
        done = self.clock.now()
        lats = []
        for t in live:
            m = t.rows
            result = QueryResult(
                indices=idx_h[offset : offset + m],
                distances=dist_h[offset : offset + m],
                staleness_points=staleness["points"],
                staleness_ingests=staleness["ingests"],
                version=version,
            )
            offset += m
            self.cache.put(self.cache.key(batch.tenant, generation, t.queries), result)
            t._complete(result)
            state.queries_served += m
            lats.append((done - t.submitted_at) * 1e6)
        # Metric writes are batched — ONE counter inc and ONE histogram lock
        # per dispatch, not per ticket (per-ticket locking measured as a
        # serve p50 regression at burst size 512).
        self._c_served.inc(n)
        self._lat_hist(batch.tenant).observe_many(lats)
        state.batches += 1
        self._c_dispatches.inc()
        self._c_occupancy.inc(n / bucket)
        self._g_close_reason["window"].set(self.batcher.window_closes)
        self._g_close_reason["size"].set(self.batcher.size_closes)

    # -------------------------------------------------------------- stats

    def _lat_hist(self, tenant: str):
        """The per-tenant serve-latency histogram, cached after the first
        registry resolution (see ``_lat_hists`` in ``__init__``)."""
        h = self._lat_hists.get(tenant)
        if h is None:
            h = default_registry().histogram(
                "serve_latency_us",
                labels={**self._obs_labels, "tenant": tenant},
                help="submit→complete latency per tenant (µs)",
            )
            self._lat_hists[tenant] = h
        return h

    def _observe_latency(self, tenant: str, ticket: Ticket) -> None:
        """Record submit→complete latency into the per-tenant histogram —
        the ONE latency definition bench_serve's percentiles read back."""
        self._lat_hist(tenant).observe(
            (self.clock.now() - ticket.submitted_at) * 1e6
        )

    def latency_snapshot(self, tenant: str):
        """Point-in-time :class:`~repro_torch.obs.HistogramSnapshot` of one
        tenant's serve latency (µs) on THIS frontend."""
        return self._lat_hist(tenant).snapshot()

    # Legacy counter attributes, now read-only views over the registry.
    @property
    def served(self) -> int:
        return int(self._c_served.value)

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value)

    @property
    def dispatches(self) -> int:
        return int(self._c_dispatches.value)

    @property
    def warmups(self) -> int:
        return int(self._c_warmups.value)

    @property
    def occupancy(self) -> float:
        """Mean dispatched-rows / padded-bucket-rows (1.0 = zero padding)."""
        return self._c_occupancy.value / self.dispatches if self.dispatches else 0.0

    @property
    def stats(self) -> dict:
        return {
            "tenants": len(self._tenants),
            "served": self.served,
            "rejected": self.rejected,
            "dispatches": self.dispatches,
            "warmups": self.warmups,
            "occupancy": self.occupancy,
            "pending": self.batcher.pending,
            "rows_in": self.batcher.rows_in,
            "batches_closed": self.batcher.batches_closed,
            "window_closes": self.batcher.window_closes,
            "size_closes": self.batcher.size_closes,
            **{f"cache_{k}": v for k, v in self.cache.stats.items()},
        }


class AsyncFrontend:
    """The asyncio shell: ``await query(...)`` over the sans-io core.

    All scheduling happens on the event loop (``loop.call_later`` armed to
    the batcher's next deadline) — no polling, no background threads.  The
    core stays the single source of truth, so tests that drive it directly
    with a virtual clock are testing exactly what this shell runs.
    """

    def __init__(self, frontend: Optional[ServingFrontend] = None, **kwargs):
        self.core = frontend if frontend is not None else ServingFrontend(**kwargs)
        self._timer: Optional[asyncio.TimerHandle] = None

    async def query(
        self,
        tenant: str,
        queries,
        *,
        max_staleness_points: Optional[int] = None,
        max_staleness_ingests: Optional[int] = None,
    ) -> QueryResult:
        """Submit and await one query row-batch."""
        loop = asyncio.get_running_loop()
        ticket = self.core.submit(
            tenant,
            queries,
            max_staleness_points=max_staleness_points,
            max_staleness_ingests=max_staleness_ingests,
        )
        if ticket.done:  # cache hit (rejection raised inside submit)
            return ticket.result
        fut: asyncio.Future = loop.create_future()

        def _wake(t: Ticket) -> None:
            if fut.done():
                return
            if t.state == "done":
                fut.set_result(t.result)
            else:
                fut.set_exception(
                    AdmissionError(t.error or "rejected", tenant=t.tenant)
                )

        ticket.waiter = _wake
        self._arm(loop)
        return await fut

    async def drain(self) -> int:
        """Flush everything pending (shutdown path)."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        return self.core.drain()

    def _arm(self, loop) -> None:
        due = self.core.due()
        if due is None:
            return
        delay = max(0.0, due - self.core.clock.now())
        if self._timer is not None:
            self._timer.cancel()
        self._timer = loop.call_later(delay, self._fire, loop)

    def _fire(self, loop) -> None:
        self._timer = None
        self.core.flush()
        self._arm(loop)  # more buckets may still be open
