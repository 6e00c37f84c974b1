"""Elastic resilience runtime — session state for multi-round resilient runs.

The paper treats a straggler pattern as a one-shot event: draw a mask, solve
the recovery LP, combine.  A *run* on a real cluster is a stream of patterns
(correlated, persistent, adversarial — see :mod:`repro_torch.core.stragglers`),
and re-running the host prelude per call wastes exactly the state that stays
fixed across rounds: the assignment, the packed shards, their device copy,
and every previously-solved pattern.  :class:`ResilienceSession` owns that
state for a whole run:

* **One pattern-keyed cache** (alive-mask bytes → ``RecoveryResult``) shared
  by every consumer — Algorithms 1–3 and ``resilient_cost`` all hit the
  same dict instead of keeping private ones.
* **One resident cache** of the packed shards on the device, keyed by
  (source points object, content fingerprint, assignment version, device):
  :meth:`device_shards` (the algorithms) and :meth:`step_cost` read it.
* **On-device recovery for the hot path** — :meth:`step_cost` runs
  mask → :func:`~repro_torch.core.recovery.device_recovery_masked` →
  Lemma-3 combine through the executor's ``resilient_reduce_masked`` with
  no host synchronisation until the final scalar: a straggler pattern never
  seen before costs no host LP solve.  The host LP remains the offline/exact
  path (:meth:`recovery`) and the parity reference.
* **Elastic re-assignment** — :meth:`observe` tracks per-node straggle
  streaks; when persistent stragglers push some shard's healthy replica
  count to the configured floor, the session patches the assignment
  (re-replicates the at-risk shards onto live nodes), invalidates ONLY the
  cache entries the patch can change, and rewrites ONLY the moved node rows
  of the device copy (``Executor.update_node_rows``).

On a mesh (``executor="mesh"``) every rank runs the session: the resident
shards are the rank's own block of nodes (a ``NodeBlock``), ``step_cost``
combines across the ranks, and a patch writes the moved rows on the rank
that owns them only; ``moved_node_blocks`` counts the moved nodes, as the
reference does.

The reference package's ``core/resilience.py`` in PyTorch: the same state
machine, counters (``resilience_<field>{session=…}`` in the port's own
:mod:`repro_torch.obs` registry) and order of repair picks.  Two counters
are the port's own: ``packs`` (host shard packings) and ``device_copies``
(full copies of the packed shards to the device).

Env knob: ``REPRO_DEVICE_RECOVERY_ITERS`` — projected-gradient iteration
count for the on-device solver (default 300; raise for tighter δ bands).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
from typing import Optional, Union

import numpy as np
import torch

from ..analysis import compiled_path
from ..device import resolve_device
from ..obs import StatsView, default_registry, trace_span
from .assignment import Assignment, cyclic_assignment
from .executor import Executor, get_executor
from .placement import PlacementOptimizer
from .recovery import RecoveryResult, solve_recovery

__all__ = ["ElasticPolicy", "SessionStats", "ResilienceSession"]

# Distinguishes concurrent sessions' metrics in the shared registry
# (labels={"session": "s<N>"}).
_SESSION_IDS = itertools.count()


def _device_iters_default() -> int:
    try:
        return max(1, int(os.environ.get("REPRO_DEVICE_RECOVERY_ITERS", "300")))
    except ValueError:
        return 300


@dataclasses.dataclass
class ElasticPolicy:
    """When and how the session re-replicates shards away from stragglers.

    A node that misses ``patience`` consecutive rounds is *persistent*.  A
    shard whose replica count over non-persistent nodes has dropped to
    ``coverage_floor`` or below — because persistent nodes hold its other
    replicas — is *at risk* and gets ``extra_replicas`` new replicas.

    ``health_aware`` orders repair targets by (straggle EWMA, load)
    lexicographically, so a chronically-flaky node that happens to look
    healthy *this* round is not chosen just because it is empty.  ``False``
    restores the least-loaded-only selection.
    """

    enabled: bool = True
    patience: int = 3
    coverage_floor: int = 1
    extra_replicas: int = 1
    health_aware: bool = True


class SessionStats(StatsView):
    """Re-solve / cache / elastic counters.

    A thin view over the process-wide :class:`repro_torch.obs.MetricsRegistry`
    (metric names ``resilience_<field>{session=…}``): ``stats.host_solves``
    and a registry dump read the same counter.  Attribute reads/writes keep
    dataclass semantics (``+= 1``, integer values, ``as_dict()``).
    """

    PREFIX = "resilience_"
    FIELDS = {
        "host_solves": "host LP/NNLS solves (offline/exact path)",
        "device_solves": "on-device solves (step_cost / device_recovery_weights)",
        "cache_hits": "pattern-cache hits across ALL consumers",
        "coverage_checks": "per-pattern coverage validations COMPUTED",
        "elastic_patches": "assignment patches applied",
        "reshards": "full survivor re-shards (permanent loss broke coverage)",
        "moved_node_blocks": "node rows re-placed incrementally",
        "full_repacks": "patches that forced a FULL re-place (capacity overflow)",
        "cache_invalidations": "cache entries dropped by patches",
        "rounds": "observe() calls",
        "uncovered_rounds": "rounds where some shard had no alive replica",
        "placement_reoptimizes": "placement re-optimizations (permanent loss/join)",
        "packs": "host shard packings",
        "device_copies": "full copies of the packed shards to the device",
    }


class ResilienceSession:
    """Owns (assignment, recovery solver, per-pattern cache, packed shards,
    their device copy, scenario state) for a multi-round resilient run.
    See the module docstring.

    ``device`` is where :meth:`step_cost`, :meth:`device_recovery_weights`
    and the entry points (:meth:`kmedian`, …) run: the card by default,
    ``"cpu"`` when asked.
    """

    def __init__(
        self,
        assignment: Assignment,
        *,
        recovery_method: str = "auto",
        executor: Union[None, str, Executor] = None,
        elastic: Optional[ElasticPolicy] = None,
        device_iters: Optional[int] = None,
        placement: Union[None, bool, PlacementOptimizer] = None,
        device=None,
    ):
        self.assignment = assignment
        self.recovery_method = recovery_method
        self.executor = get_executor(executor)
        self.elastic = elastic if elastic is not None else ElasticPolicy(enabled=False)
        self.device_iters = device_iters or _device_iters_default()
        self.device = None if device is None else torch.device(device)
        # Health-aware placement policy (opt-in): when set, permanent
        # membership changes re-optimize the whole placement from the
        # learned per-node health instead of the cyclic takeover.
        if placement is True:
            placement = PlacementOptimizer()
        self.placement: Optional[PlacementOptimizer] = placement or None
        self._obs_labels = {"session": f"s{next(_SESSION_IDS)}"}
        self.stats = SessionStats(labels=self._obs_labels)
        self.version = 0  # bumped by every elastic patch
        # Object ids of every assignment this session has owned (the original
        # plus each elastic patch) — lets entry points reject a genuinely
        # foreign assignment while accepting pre-patch references mid-run.
        self._assignment_lineage = {id(assignment)}
        self._cache: dict[bytes, RecoveryResult] = {}
        # Per-pattern coverage validation: alive-mask bytes →
        # (has_surviving_data, uncovered shard ids).  Same invalidation rule
        # as the recovery cache.
        self._coverage: dict[bytes, tuple[bool, np.ndarray]] = {}
        # Boolean coverage predicate cache (pattern_covers): solve-free, so
        # it is keyed and invalidated like _coverage but seeded on its own.
        self._covers: dict[bytes, bool] = {}
        self._streak = np.zeros(assignment.num_nodes, dtype=np.int64)
        # Observed-straggle EWMA per node (0 = always alive, 1 = always
        # straggling) — the online per-node reliability estimate the
        # placement optimizer consumes.
        self.straggle_alpha = 0.2
        self._straggle_ewma = np.zeros(assignment.num_nodes, dtype=np.float64)
        # Nodes declared PERMANENTLY lost (vs. transient stragglers, which
        # are per-round mask entries) — see permanent_loss()/permanent_join().
        self._permanent_dead: set[int] = set()
        # Patch listeners: consumers that keep their OWN device-resident
        # node-stacked state register a callback(moved_nodes, old_m, new_m)
        # and re-place just the moved rows when the session patches the
        # assignment.
        self._patch_listeners: list = []
        # Host-side packed shards, keyed by the caller's points object.
        self._pack_src = None
        self._pack_fp: Optional[bytes] = None
        self._pack_version = -1
        self._packed: Optional[tuple[np.ndarray, np.ndarray]] = None
        self._packed_pts: Optional[np.ndarray] = None
        # The resident cache: the packed shards and the matrix on a device,
        # (xs, ws, A).  Keyed by its OWN source object: the host pack cache
        # may move to another points array without invalidating it.
        self._resident: Optional[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        self._resident_src = None
        self._resident_fp: Optional[bytes] = None
        self._resident_version = -1
        self._resident_device: Optional[torch.device] = None
        # The full points on the device (device_shards), keyed by
        # (source object, fingerprint, device): no assignment in the key.
        self._resident_pts: Optional[tuple] = None

    @property
    def num_nodes(self) -> int:
        return self.assignment.num_nodes

    @property
    def num_shards(self) -> int:
        return self.assignment.num_shards

    def _device(self) -> torch.device:
        return resolve_device(self.device)

    # ------------------------------------------------- host (exact) recovery

    def recovery(self, alive: np.ndarray) -> RecoveryResult:
        """Cached host solve for one alive pattern (LP/NNLS/uniform — the
        offline/exact path and the parity reference for the device solver)."""
        alive = np.asarray(alive, dtype=bool)
        key = alive.tobytes()
        hit = self._cache.get(key)
        if hit is not None:
            self.stats.cache_hits += 1
            return hit
        with trace_span(
            "session.recovery_solve",
            alive=int(alive.sum()), nodes=alive.size, **self._obs_labels,
        ):
            res = solve_recovery(self.assignment, alive, method=self.recovery_method)
        self.stats.host_solves += 1
        self._cache[key] = res
        return res

    def recovery_weights(self, alive: np.ndarray) -> tuple[np.ndarray, RecoveryResult]:
        """(s,) float32 b_full (zeros at stragglers) + diagnostics."""
        res = self.recovery(alive)
        return res.b_full.astype(np.float32), res

    def pattern_covers(self, alive: np.ndarray) -> bool:
        """True iff every shard keeps ≥ 1 alive replica under ``alive`` —
        the routing predicate between the on-device solver (which masks
        uncovered shards out of its objective, silently dropping their
        mass) and the host best-effort path (which reports them).

        Cached per pattern with the same invalidation rule as the recovery
        cache.  Unlike :meth:`validate_coverage` it never needs a recovery
        solve to seed — the hot path stays at zero host solves.
        """
        alive = np.asarray(alive, dtype=bool)
        key = alive.tobytes()
        hit = self._covers.get(key)
        if hit is None:
            hit = bool(alive.any()) and not (
                self.assignment.matrix[alive].sum(axis=0) == 0
            ).any()
            self._covers[key] = hit
        return hit

    def validate_coverage(
        self, alive: np.ndarray, rec: Optional[RecoveryResult] = None
    ) -> np.ndarray:
        """Cached per-pattern coverage validation; returns the uncovered
        shard ids for this pattern.  Computed once per (pattern, assignment
        version) — ``SessionStats.coverage_checks`` counts computations.
        Raises if no surviving node holds any data (the all-dead guard).
        """
        alive = np.asarray(alive, dtype=bool)
        key = alive.tobytes()
        hit = self._coverage.get(key)
        if hit is None:
            if rec is None:
                rec = self.recovery(alive)
            hit = (bool(np.any(rec.b_full > 0)), np.asarray(rec.uncovered))
            self._coverage[key] = hit
            self.stats.coverage_checks += 1
        has_data, uncovered = hit
        if not has_data:
            raise ValueError("no surviving nodes with data — cannot form union")
        return uncovered

    # -------------------------------------------------- prelude for Algs 1–3

    def prepare(self, points, alive):
        """The shared prelude of every distributed algorithm: dtype coercion,
        cached recovery solve, all-dead guard, packed shards (cached per
        points object, content and assignment version).

        Returns ``(points, alive, rec, executor, xs, ws)`` with numpy arrays.
        """
        alive = np.asarray(alive, dtype=bool)
        rec = self.recovery(alive)
        self.validate_coverage(alive, rec)  # cached per pattern, raises all-dead
        pts32, xs, ws = self._packed_shards(points)
        return pts32, alive, rec, self.executor, xs, ws

    def device_shards(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(points, xs, ws) of the last :meth:`prepare` on ``device``, from
        the resident cache: copied once per packing and device."""
        if self._packed is None:
            raise RuntimeError("device_shards() needs a prepare() first")
        device = torch.device(device)
        xs, ws, _ = self._ensure_resident(self._pack_src, device, self._pack_fp)
        src, fp = self._pack_src, self._pack_fp
        cached = self._resident_pts
        if cached is None or not (cached[0] is src and cached[1] == fp and cached[2] == device):
            pts = self.executor.place_broadcast(self._packed_pts, device)
            self._resident_pts = cached = (src, fp, device, pts)
        return cached[3], xs, ws

    @staticmethod
    def _fingerprint(points) -> bytes:
        """Cheap content hash: identity alone would serve stale packs after
        an in-place mutation of the caller's array (pts *= 0.5)."""
        a = np.ascontiguousarray(np.asarray(points))
        with trace_span("session.fingerprint", bytes=a.nbytes):
            h = hashlib.blake2b(digest_size=16)
            h.update(str((a.shape, a.dtype.str)).encode())
            h.update(a.tobytes())
            return h.digest()

    def _packed_shards(self, points, fp: Optional[bytes] = None):
        fp = self._fingerprint(points) if fp is None else fp
        if self._packed is not None and self._pack_src is points and (
            self._pack_version == self.version and self._pack_fp == fp
        ):
            return self._packed_pts, *self._packed
        from .kmedian import pack_local_shards

        pts32 = np.ascontiguousarray(points, dtype=np.float32)
        xs, ws = pack_local_shards(pts32, self.assignment)
        self._pack_src = points
        self._pack_fp = fp
        self._packed_pts = pts32
        self._packed = (xs, ws)
        self._pack_version = self.version
        self.stats.packs += 1
        return pts32, xs, ws

    # ------------------------------------------------ fused on-device path

    def _ensure_resident(self, points, device: torch.device, fp: Optional[bytes] = None):
        """(xs, ws, A) of ``points`` under the current assignment on
        ``device``; placed once per (source, fingerprint, version, device)."""
        fp = self._fingerprint(points) if fp is None else fp
        if self._resident is not None and (
            self._resident_version == self.version
            and self._resident_src is points
            and self._resident_fp == fp
            and self._resident_device == device
        ):
            return self._resident
        _, xs, ws = self._packed_shards(points, fp)
        ex = self.executor
        self._resident = (
            ex.place_node_stacked(xs, device),
            ex.place_node_stacked(ws, device),
            ex.place_broadcast(self.assignment.matrix.astype(np.float32), device),
        )
        self._resident_src = points
        self._resident_fp = fp
        self._resident_version = self.version
        self._resident_device = device
        self.stats.device_copies += 1
        return self._resident

    @compiled_path("session.step_cost", kind="host")
    def step_cost(
        self,
        points,
        centers,
        alive,
        *,
        median: bool = False,
        impl: str = "auto",
    ) -> float:
        """Lemma-3 cost estimate with the recovery solve on the device —
        the multi-round hot path.  The alive mask is data: a new straggler
        pattern triggers no host solve.  The only host synchronisation is
        the returned scalar."""
        from .kmeans import _local_cost_fn

        alive = np.asarray(alive, dtype=bool)
        if not alive.any():
            # Same contract as the host path: a silent 0.0 "estimate" for an
            # all-straggler round is indistinguishable from a perfect result.
            raise ValueError("no surviving nodes with data — cannot form union")
        device = self._device()
        xs_p, ws_p, A_p = self._ensure_resident(points, device)
        if not isinstance(centers, torch.Tensor):
            centers = np.array(centers, dtype=np.float32)  # a writable copy
        with trace_span(
            "session.step_cost",
            alive=int(alive.sum()), nodes=alive.size, **self._obs_labels,
        ):
            est, _b = self.executor.resilient_reduce_masked(
                _local_cost_fn(median, impl),
                (xs_p, ws_p),
                (torch.as_tensor(centers, dtype=torch.float32, device=device),),
                A_p,
                torch.as_tensor(alive, device=device),
                iters=self.device_iters,
            )
            self.stats.device_solves += 1
            # The scalar estimate is this call's one device-to-host sync.
            return float(est)  # repro-lint: disable=JS105

    def device_recovery_weights(self, alive) -> np.ndarray:
        """(s,) b_full from the on-device solver (no host LP).  Standalone
        form of the solve that :meth:`step_cost` runs inside its step — for
        consumers that need the weights themselves."""
        from .recovery import device_recovery_masked

        b = device_recovery_masked(
            self.assignment.matrix.astype(np.float32),
            np.asarray(alive, dtype=bool),
            iters=self.device_iters,
            device=self._device(),
        )
        self.stats.device_solves += 1
        return b.cpu().numpy()

    # ------------------------------------------------- algorithm entry points

    def _entry_kw(self, kw: dict) -> dict:
        if self.device is not None:
            kw.setdefault("device", self.device)
        return kw

    def kmedian(self, points, k: int, alive, **kw):
        from .kmedian import resilient_kmedian

        return resilient_kmedian(
            points, k, self.assignment, alive, session=self, **self._entry_kw(kw)
        )

    def pca(self, points, r: int, delta: float, alive, **kw):
        from .pca import resilient_pca

        return resilient_pca(
            points, r, delta, self.assignment, alive, session=self, **self._entry_kw(kw)
        )

    def coreset(self, points, k: int, m_per_node: int, alive, **kw):
        from .coreset import resilient_coreset

        return resilient_coreset(
            points, k, m_per_node, self.assignment, alive, session=self, **self._entry_kw(kw)
        )

    def cost(self, points, centers, alive, **kw):
        from .kmeans import resilient_cost

        return resilient_cost(
            points, centers, self.assignment, alive, session=self, **self._entry_kw(kw)
        )

    # --------------------------------------------------- scenario observation

    def observe(self, step) -> dict:
        """Feed one scenario step (or bare alive mask); returns an event dict.

        Updates straggle streaks and coverage accounting, and — when the
        elastic policy fires — patches the assignment.  The event reports
        ``{"patched": bool, "at_risk": [...], "moved_nodes": [...],
        "uncovered": int, "persistent": [...]}``.
        """
        alive = np.asarray(getattr(step, "alive", step), dtype=bool)
        # A permanently-lost node is never alive, whatever the scenario mask
        # says — and its streak/EWMA/gauge are frozen, not decayed.
        perm = np.zeros(self.num_nodes, dtype=bool)
        if self._permanent_dead:
            perm[list(self._permanent_dead)] = True
            alive = alive & ~perm
        self.stats.rounds += 1
        self._streak = np.where(alive, 0, self._streak + 1)
        self._streak[perm] = 0
        a = self.straggle_alpha
        ewma = (1.0 - a) * self._straggle_ewma + a * (~alive)
        self._straggle_ewma = np.where(perm, self._straggle_ewma, ewma)
        reg = default_registry()
        for i in np.flatnonzero(~perm):
            reg.gauge(
                "node_straggle_ewma",
                labels={**self._obs_labels, "node": str(i)},
                help="per-node observed-straggle EWMA (0=alive, 1=straggling)",
            ).set(float(self._straggle_ewma[i]))
        A = self.assignment.matrix
        uncovered = int((A[alive].sum(axis=0) == 0).sum()) if alive.any() else self.num_shards
        if uncovered:
            self.stats.uncovered_rounds += 1
        event = {
            "patched": False,
            "at_risk": [],
            "moved_nodes": [],
            "uncovered": uncovered,
            "persistent": np.flatnonzero(self._streak >= self.elastic.patience).tolist(),
        }
        if not self.elastic.enabled or not event["persistent"]:
            return event
        persistent = self._streak >= self.elastic.patience
        healthy = ~persistent
        if not healthy.any():
            return event  # nowhere to move data
        cover_healthy = A[healthy].sum(axis=0)
        cover_all = A.sum(axis=0)
        # At risk: replicas lost to persistent stragglers pushed the healthy
        # count to the floor.  Shards that were always thinly replicated but
        # have no persistent holder are left alone.
        at_risk = np.flatnonzero(
            (cover_healthy <= self.elastic.coverage_floor) & (cover_all > cover_healthy)
        )
        if at_risk.size:
            moved = self._patch(at_risk, healthy, alive)
            if moved:  # a patch with no candidate target nodes is a no-op
                event.update(patched=True, at_risk=at_risk.tolist(), moved_nodes=moved)
        return event

    @compiled_path("session.node_health", kind="host")
    def node_health(self) -> np.ndarray:
        """Observed-straggle EWMA over the LIVE node set: 0.0 = always
        alive, 1.0 = always straggling, learned online from :meth:`observe`
        rounds with smoothing ``straggle_alpha``.  The input signal for the
        placement optimizer (:mod:`repro_torch.core.placement`).
        Permanently-lost nodes are excluded, as their
        ``node_straggle_ewma{session=…,node=…}`` gauges are."""
        live = np.ones(self.num_nodes, dtype=bool)
        if self._permanent_dead:
            live[list(self._permanent_dead)] = False
        return self._straggle_ewma[live].copy()

    # ----------------------------------------------------- elastic patching

    def _patch(self, shards: np.ndarray, healthy: np.ndarray, alive: np.ndarray) -> list[int]:
        """Re-replicate ``shards`` onto repair targets picked by
        (straggle EWMA, load) lexicographic order — long-run-reliable nodes
        first, load as the tie-break (``ElasticPolicy.health_aware=False``:
        least-loaded only)."""
        mat = self.assignment.matrix.copy()
        loads = mat.sum(axis=1).astype(np.int64)
        moved: set[int] = set()
        # Prefer nodes that are both healthy and alive THIS round; fall back
        # to merely-healthy ones (transiently down but not persistent).
        for j in shards:
            for _ in range(self.elastic.extra_replicas):
                for pool in (healthy & alive, healthy):
                    cand = np.flatnonzero(pool & (mat[:, j] == 0))
                    if cand.size:
                        if self.elastic.health_aware:
                            order = np.lexsort(
                                (loads[cand], self._straggle_ewma[cand])
                            )
                            pick = int(cand[order[0]])
                        else:
                            pick = int(cand[np.argmin(loads[cand])])
                        mat[pick, j] = 1
                        loads[pick] += 1
                        moved.add(pick)
                        break
        if not moved:
            return []
        with trace_span(
            "session.elastic_patch",
            shards=int(shards.size), moved=len(moved), **self._obs_labels,
        ):
            old_m = int(self.assignment.matrix.sum(axis=1).max())
            scheme = self.assignment.scheme
            if not scheme.endswith("+elastic"):
                scheme = scheme + "+elastic"
            self.assignment = dataclasses.replace(
                self.assignment, matrix=mat, scheme=scheme
            )
            self._assignment_lineage.add(id(self.assignment))
            self._invalidate_patterns(sorted(moved))
            self.stats.elastic_patches += 1
            self.version += 1
            self._replace_moved_blocks(sorted(moved), old_m)
            new_m = int(self.assignment.matrix.sum(axis=1).max())
            for cb in self._patch_listeners:
                cb(sorted(moved), old_m, new_m)
        return sorted(moved)

    def add_patch_listener(self, cb) -> None:
        """Register ``cb(moved_nodes, old_max_load, new_max_load)`` to fire
        after every elastic patch (assignment already swapped, caches already
        invalidated).  Consumers holding device-resident node-stacked state
        use this to re-place only the moved node rows
        (``Executor.update_node_rows``)."""
        self._patch_listeners.append(cb)

    # ------------------------------------------ permanent loss / resharding
    # A PERMANENT loss is a different event from a per-round straggle: the
    # node is gone, its replicas are gone, and the session must decide once
    # (not per step) whether the survivor set still covers every shard.

    @property
    def permanent_dead(self) -> frozenset:
        """Nodes declared permanently lost (never counted alive again until
        :meth:`permanent_join`)."""
        return frozenset(self._permanent_dead)

    def alive_mask(self, transient_dead=None) -> np.ndarray:
        """(n,) bool: False at permanently-dead nodes, and additionally at
        ``transient_dead`` (a mask or an iterable of node ids) this round."""
        mask = np.ones(self.num_nodes, dtype=bool)
        for i in self._permanent_dead:
            mask[i] = False
        if transient_dead is not None:
            td = np.asarray(transient_dead)
            if td.dtype == bool:
                mask &= ~td
            else:
                for i in td.reshape(-1):
                    mask[int(i)] = False
        return mask

    def permanent_join(self, node: int) -> None:
        """A (re)joining node takes over the dead slot's shard set — warm
        takeover: batch shapes are unchanged, so no reshard is needed.

        The node's health state is refreshed (EWMA/streak reset, gauge
        re-exported at 0).  With a placement policy attached, the placement
        is re-optimized so the rejoined capacity is actually used."""
        node = int(node)
        self._permanent_dead.discard(node)
        self._streak[node] = 0
        self._straggle_ewma[node] = 0.0
        default_registry().gauge(
            "node_straggle_ewma",
            labels={**self._obs_labels, "node": str(node)},
            help="per-node observed-straggle EWMA (0=alive, 1=straggling)",
        ).set(0.0)
        if self.placement is not None:
            self._reoptimize(reason="permanent_join", node=node)

    def permanent_loss(self, node: int) -> RecoveryResult:
        """Declare ``node`` permanently lost; re-solve over the survivors
        ONCE (cached) and, if the loss broke coverage, reshard the
        survivors.  Returns the recovery result for the post-loss
        (post-reshard, if any) survivor pattern.

        The dead node's ``node_straggle_ewma`` gauge is dropped from the
        registry and its EWMA row is pinned at 1.0.  With a placement policy
        attached, the placement is re-optimized over the survivors from
        their learned health instead of waiting for coverage to break.
        """
        node = int(node)
        self._permanent_dead.add(node)
        self._drop_node_gauge(node)
        self._straggle_ewma[node] = 1.0
        self._streak[node] = 0
        if self.placement is not None:
            self._reoptimize(reason="permanent_loss", node=node)
            return self.recovery(self.alive_mask())
        alive = self.alive_mask()
        res = self.recovery(alive)
        if len(res.uncovered) > 0:
            with trace_span(
                "session.reshard", node=int(node), **self._obs_labels
            ):
                self._reshard_survivors(alive)
            res = self.recovery(self.alive_mask())
        return res

    def _drop_node_gauge(self, node: int) -> None:
        default_registry().remove(
            "node_straggle_ewma",
            labels={**self._obs_labels, "node": str(node)},
        )

    def _drop_placed(self) -> None:
        """Forget the host pack and the resident copy (rebuilt on next use)."""
        self._packed = None
        self._pack_version = -1
        self._resident = None
        self._resident_version = -1

    def _reoptimize(self, *, reason: str, node: int) -> list[int]:
        """Rebuild the placement from live-node health via the attached
        :class:`repro_torch.core.placement.PlacementOptimizer`; returns the
        node rows that changed.  Cache invalidation is SELECTIVE (same
        validity rule as elastic patches), but the packed/resident arrays
        are rebuilt wholesale, since a re-optimization typically moves many
        rows at once."""
        live = self.alive_mask()
        with trace_span(
            "session.placement_reoptimize",
            reason=reason, node=int(node), **self._obs_labels,
        ):
            new = self.placement.optimize(
                self.num_shards, self.num_nodes, self._straggle_ewma,
                exclude=~live,
            )
            changed = np.flatnonzero(
                (self.assignment.matrix != new.matrix).any(axis=1)
            )
            if changed.size == 0:
                return []
            old_m = int(self.assignment.matrix.sum(axis=1).max())
            self.assignment = dataclasses.replace(
                new, params={**new.params, "reason": reason}
            )
            self._assignment_lineage.add(id(self.assignment))
            self._invalidate_patterns(changed.tolist())
            self.stats.placement_reoptimizes += 1
            self.version += 1
            self._drop_placed()
            self.stats.full_repacks += 1
            new_m = int(self.assignment.matrix.sum(axis=1).max())
            for cb in self._patch_listeners:
                cb(changed.tolist(), old_m, new_m)
        return changed.tolist()

    def _reshard_survivors(self, alive: np.ndarray) -> None:
        """Coverage lost: rebuild the assignment over surviving nodes.

        Shard count and node count are preserved (static shapes); survivors
        take over the uncovered shards via a fresh cyclic assignment whose
        rows for dead nodes are folded onto surviving rows and zeroed.  The
        takeover target for each dead row is the survivor with the best
        (straggle EWMA, load) order.  With a placement policy attached, the
        whole rebuild is delegated to the optimizer.
        """
        alive = np.asarray(alive, dtype=bool)
        n_alive = int(alive.sum())
        if n_alive == 0:
            raise ValueError("cannot reshard: no surviving nodes")
        old = self.assignment.matrix
        old_m = int(old.sum(axis=1).max())
        if self.placement is not None:
            fresh = self.placement.optimize(
                self.num_shards, self.num_nodes, self._straggle_ewma,
                exclude=~alive,
            )
            self.assignment = fresh
        else:
            ell = min(max(2, int(self.assignment.params.get("ell", 2))), n_alive)
            fresh = cyclic_assignment(self.num_shards, self.num_nodes, int(ell))
            mat = fresh.matrix.copy()
            alive_idx = np.flatnonzero(alive)
            for dead in np.flatnonzero(~alive):
                loads = mat.sum(axis=1).astype(np.int64)
                order = np.lexsort(
                    (loads[alive_idx], self._straggle_ewma[alive_idx])
                )
                take = alive_idx[order[0]]
                mat[take] |= mat[dead]
                mat[dead] = 0
            self.assignment = dataclasses.replace(
                fresh, matrix=mat, scheme="elastic_cyclic"
            )
        self._assignment_lineage.add(id(self.assignment))
        # The whole matrix changed: every cached pattern, pack, and resident
        # copy is stale (unlike _patch's selective invalidation).
        self.stats.cache_invalidations += len(self._cache)
        self._cache.clear()
        self._coverage.clear()
        self._covers.clear()
        self._drop_placed()
        self.stats.reshards += 1
        self.version += 1
        changed = np.flatnonzero((old != self.assignment.matrix).any(axis=1))
        new_m = int(self.assignment.matrix.sum(axis=1).max())
        for cb in self._patch_listeners:
            cb(changed.tolist(), old_m, new_m)

    def _invalidate_patterns(self, moved_nodes: list[int]) -> None:
        """Drop ONLY the cache entries the patch can change.

        A cached ``RecoveryResult`` for pattern ``R`` stays exactly valid iff
        every patched node is dead in ``R`` — its weight is 0 there, so the
        new matrix entries never enter ``bᵀA_R``.  Entries with any patched
        node alive are dropped; everything else survives the patch.
        """
        moved = np.asarray(moved_nodes, dtype=np.int64)
        for key in list(self._cache):
            mask = np.frombuffer(key, dtype=bool)
            if mask[moved].any():
                del self._cache[key]
                self.stats.cache_invalidations += 1
        # Coverage entries follow the same validity rule, but are keyed
        # independently — sweep them on their own keys.
        for key in list(self._coverage):
            if np.frombuffer(key, dtype=bool)[moved].any():
                del self._coverage[key]
        for key in list(self._covers):
            if np.frombuffer(key, dtype=bool)[moved].any():
                del self._covers[key]

    def _replace_moved_blocks(self, moved_nodes: list[int], old_m: int) -> None:
        """Incrementally refresh the resident packed shards: only the node
        rows the patch touched are re-packed and written on the device
        (``Executor.update_node_rows``).  A patch that grows the maximum
        load needs wider padding → full repack on next use."""
        if self._resident is None or self._pack_src is None:
            return
        new_m = int(self.assignment.matrix.sum(axis=1).max())
        if (
            new_m > old_m  # wider padding needed: repack lazily
            or self._resident_version != self.version - 1
            or self._resident_src is not self._pack_src  # pack moved datasets
        ):
            self._resident = None
            return
        pts32 = self._packed_pts
        d = pts32.shape[1]
        xs_rows = np.zeros((len(moved_nodes), old_m, d), dtype=np.float32)
        ws_rows = np.zeros((len(moved_nodes), old_m), dtype=np.float32)
        for r, i in enumerate(moved_nodes):
            shard_ids = self.assignment.shards_of(i)
            xs_rows[r, : len(shard_ids)] = pts32[shard_ids]
            ws_rows[r, : len(shard_ids)] = 1.0
        ex = self.executor
        xs_p, ws_p, _ = self._resident
        self._resident = (
            ex.update_node_rows(xs_p, moved_nodes, xs_rows),
            ex.update_node_rows(ws_p, moved_nodes, ws_rows),
            ex.place_broadcast(self.assignment.matrix.astype(np.float32), self._resident_device),
        )
        self._resident_version = self.version
        # Host pack cache: patch the same rows so prepare() stays coherent.
        # Copy-on-patch — arrays already handed out by prepare() must not
        # change under a caller mid-algorithm.
        if self._packed is not None and self._pack_version == self.version - 1:
            xs, ws = self._packed[0].copy(), self._packed[1].copy()
            xs[moved_nodes] = xs_rows
            ws[moved_nodes] = ws_rows
            self._packed = (xs, ws)
            self._pack_version = self.version
        self.stats.moved_node_blocks += len(moved_nodes)
