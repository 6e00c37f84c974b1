"""Health-aware placement optimizer (ROADMAP: cost-model-driven placement).

The paper's constructions (and the elastic repair path) place shards blind
to node heterogeneity: Property 1 says which straggler *patterns* are
recoverable, nothing about which *nodes* should hold replicas.  On a real
cluster nodes differ — chronic stragglers, slow hosts, thin links — and
Behrouzi-Far & Soljanin (PAPERS.md) show task-to-worker placement dominates
expected completion time under exactly that heterogeneity.  This module
turns the online reliability signal the session already learns
(:meth:`repro_torch.core.resilience.ResilienceSession.node_health` — the per-node
observed-straggle EWMA) into a placement:

* :func:`expected_completion_time` — the cost model.  With per-node
  straggle probability ``q_i`` and relative capacity ``c_i``, the all-alive
  service time of a round is ``serve = max_j min_{i∈S_j} load_i / c_i``
  (each shard is served by its fastest replica; the round waits for the
  slowest shard).  A round must be retried while any shard has no alive
  replica, which happens with probability
  ``p_round = 1 − Π_j (1 − Π_{i∈S_j} q_i)``; retries are geometric, so

      ECT = serve / (1 − p_round).

  A shard whose replicas all sit on chronic stragglers drives
  ``p_round → 1`` and the ECT diverges — co-locating all replicas of a
  shard on an unhealthy (or correlated) node set is priced as what it is.
* :func:`health_assignment` — the ``"health"`` scheme behind
  :func:`repro_torch.core.assignment.make_assignment`.  A greedy constructor
  assigns each replica to the node with the smallest projected effective
  finish time ``(load + 1) / (c · (1 − q))`` under two hard constraints
  (Property-1 coverage: every shard keeps ``ℓ`` distinct replicas, at
  least one on a healthy node whenever one exists; correlation groups,
  when given, must be spanned).  The greedy then competes against an
  *anchored* family (first replica of every shard pinned to the ``k``
  most reliable nodes, ``k`` swept — drives per-shard miss products to
  ≈ 0 when most of the cluster is flaky) and the uniform constructions
  (cyclic, fractional repetition) under the cost model; the best
  *constraint-satisfying* candidate wins — so the scheme is never worse
  than uniform placement unless uniform placement violates the coverage
  constraint.
* :func:`choose_ell` — smallest replication factor whose greedy placement
  keeps the per-round coverage-miss probability under a target.
* :class:`PlacementOptimizer` — the session-facing wrapper: rebuilds the
  placement from live-node health on ``permanent_loss`` / ``permanent_join``
  (see :class:`repro_torch.core.resilience.ResilienceSession`).

Env knobs: ``REPRO_PLACEMENT_UNHEALTHY`` (EWMA at or above which a node
counts as unhealthy, default 0.5), ``REPRO_PLACEMENT_TARGET_MISS``
(:func:`choose_ell` per-round miss target, default 0.05),
``REPRO_PLACEMENT_MAX_ELL`` (:func:`choose_ell` cap, default 4).

All plain numpy — placement is coordinator-side metadata, like the
assignment constructions themselves.  Copied from the reference package's
``core/placement.py``; ``obs`` is the port's own copy.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..analysis import compiled_path
from ..obs import default_registry, trace_span
from .assignment import (
    Assignment,
    cyclic_assignment,
    fractional_repetition_assignment,
)

__all__ = [
    "PlacementOptimizer",
    "choose_ell",
    "expected_completion_time",
    "health_assignment",
    "round_miss_probability",
]

# Straggle probabilities are clipped below 1: a q=1 node is modelled as
# "misses almost every round", not as a division by zero.
_Q_MAX = 0.999


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _unhealthy_default() -> float:
    return _env_float("REPRO_PLACEMENT_UNHEALTHY", 0.5)


def _target_miss_default() -> float:
    return _env_float("REPRO_PLACEMENT_TARGET_MISS", 0.05)


def _max_ell_default() -> int:
    return max(1, int(_env_float("REPRO_PLACEMENT_MAX_ELL", 4)))


def _coerce_q(health, s: int) -> np.ndarray:
    q = np.zeros(s, dtype=np.float64) if health is None else np.asarray(
        health, dtype=np.float64
    )
    if q.shape != (s,):
        raise ValueError(f"health must have shape ({s},), got {q.shape}")
    return np.clip(q, 0.0, _Q_MAX)


def _coerce_c(capacity, s: int) -> np.ndarray:
    c = np.ones(s, dtype=np.float64) if capacity is None else np.asarray(
        capacity, dtype=np.float64
    )
    if c.shape != (s,):
        raise ValueError(f"capacity must have shape ({s},), got {c.shape}")
    return np.maximum(c, 1e-9)


# ------------------------------------------------------------- cost model


def _log_round_ok(matrix: np.ndarray, q: np.ndarray) -> float:
    """``log Π_j (1 − p_miss_j)`` — log-probability that EVERY shard keeps an
    alive replica in one round.  ``-inf`` when some shard is certainly missed
    (no replicas at all: the empty product gives ``p_miss = 1``)."""
    A = np.asarray(matrix, dtype=bool)
    with np.errstate(divide="ignore"):
        log_q = np.log(np.maximum(q, 1e-300))
    # Shard j: sum of log q over its replicas (0 for non-replicas).
    log_miss = np.where(A, log_q[:, None], 0.0).sum(axis=0)
    p_miss = np.exp(log_miss)  # empty replica set → exp(0) = 1: always missed
    with np.errstate(divide="ignore"):
        log_ok = np.log1p(-np.minimum(p_miss, 1.0))
    return float(log_ok.sum())


def round_miss_probability(matrix: np.ndarray, health) -> float:
    """Probability that some shard has NO alive replica in one round.

    Nodes straggle independently with ``q_i``; shard ``j`` is missed with
    ``Π_{i∈S_j} q_i``, and the round is missed when any shard is.  A shard
    with no replicas at all is missed with probability 1 (the empty
    product), so unplaced shards surface as a certain miss, never as a
    silent 0.
    """
    A = np.asarray(matrix, dtype=bool)
    q = _coerce_q(health, A.shape[0])
    total = _log_round_ok(A, q)
    if not np.isfinite(total):
        return 1.0
    return float(min(1.0, -np.expm1(total)))


@compiled_path("placement.expected_completion_time", kind="host")
def expected_completion_time(
    assignment: Assignment, health, capacity=None
) -> float:
    """Expected round-completion time of a placement under per-node health.

    ``serve / (1 − p_round)``: the all-alive service time (every shard
    served by its fastest replica, the round waits for the slowest shard)
    inflated by the geometric retry count of the per-round coverage-miss
    probability (:func:`round_miss_probability`).  Diverges — returns
    ``inf`` — when some shard's replicas are all chronic stragglers or a
    shard has no replica at all.
    """
    A = assignment.matrix.astype(bool)
    s = assignment.num_nodes
    q = _coerce_q(health, s)
    c = _coerce_c(capacity, s)
    loads = A.sum(axis=1).astype(np.float64)
    node_t = loads / c
    # Shard j is served by its fastest replica; unplaced shards → inf.
    shard_t = np.where(A, node_t[:, None], np.inf).min(axis=0)
    serve = float(shard_t.max()) if shard_t.size else 0.0
    if not np.isfinite(serve):
        return float("inf")
    # 1 − p_round in log space: keeps near-divergent placements finite (and
    # comparable) instead of rounding them all to inf; a truly impossible
    # round (unplaced shard, or the product underflows) still diverges.
    denom = np.exp(_log_round_ok(A, q))
    if denom <= 0.0:
        return float("inf")
    return serve / denom


# ------------------------------------------------------- greedy constructor


def _greedy_matrix(
    n: int,
    s: int,
    q: np.ndarray,
    c: np.ndarray,
    ell: int,
    allowed: np.ndarray,
    unhealthy: float,
    groups: Optional[np.ndarray],
    anchors: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Greedy health-aware placement under the coverage constraints.

    Per replica pick: the candidate with the smallest projected effective
    finish time ``(load + 1) / (c · (1 − q))`` — fast, reliable, unloaded
    nodes first.  The first replica of each shard comes from the anchor
    pool (default: the healthy nodes) whenever it is non-empty — pinning
    the anchor pool to the few most-reliable nodes drives each shard's
    miss product toward zero even when its other replicas land on flaky
    nodes for load balance.  Later replicas prefer unused correlation
    groups.
    """
    mat = np.zeros((s, n), dtype=np.uint8)
    loads = np.zeros(s, dtype=np.float64)
    rate = np.maximum(c * (1.0 - q), 1e-9)
    first_pool = (allowed & (q < unhealthy)) if anchors is None else (allowed & anchors)
    ell_eff = max(1, min(int(ell), int(allowed.sum())))
    for j in range(n):
        used_groups: set = set()
        for r in range(ell_eff):
            open_ = allowed & (mat[:, j] == 0)
            pool = first_pool & open_ if (r == 0 and first_pool.any()) else open_
            if not pool.any():
                pool = open_
            cand = np.flatnonzero(pool)
            if groups is not None and used_groups:
                fresh = cand[~np.isin(groups[cand], list(used_groups))]
                if fresh.size:
                    cand = fresh
            if not cand.size:
                break
            score = (loads[cand] + 1.0) / rate[cand]
            pick = int(cand[np.argmin(score)])
            mat[pick, j] = 1
            loads[pick] += 1.0
            if groups is not None:
                used_groups.add(groups[pick])
    return mat


def _embed_uniform(build, n: int, ell: int, allowed: np.ndarray) -> Optional[np.ndarray]:
    """Build a uniform construction over the allowed nodes only, embedded
    back into the full (s, n) row space (excluded rows stay zero)."""
    idx = np.flatnonzero(allowed)
    if idx.size == 0 or ell > idx.size:
        return None
    try:
        sub = build(n, int(idx.size), int(ell)).matrix
    except ValueError:
        return None  # e.g. fractional repetition with ell ∤ |allowed|
    mat = np.zeros((allowed.size, n), dtype=np.uint8)
    mat[idx] = sub
    return mat


def _satisfies_constraints(
    mat: np.ndarray,
    q: np.ndarray,
    allowed: np.ndarray,
    unhealthy: float,
    groups: Optional[np.ndarray],
) -> bool:
    """Hard placement constraints: every shard covered, nothing on excluded
    nodes, at least one healthy replica per shard whenever a healthy node
    exists, and (when correlation groups are given and more than one group
    is available) replicas of a shard never confined to a single group
    unless ℓ = 1."""
    A = mat.astype(bool)
    if A[~allowed].any():
        return False
    repl = A.sum(axis=0)
    if (repl == 0).any():
        return False
    healthy = allowed & (q < unhealthy)
    if healthy.any() and (A[healthy].sum(axis=0) == 0).any():
        return False
    if groups is not None:
        avail = np.unique(groups[allowed])
        if avail.size >= 2:
            for j in np.flatnonzero(repl >= 2):
                if np.unique(groups[A[:, j]]).size < 2:
                    return False
    return True


# --------------------------------------------------------- public entry points


@compiled_path("placement.choose_ell", kind="host")
def choose_ell(
    n: int,
    s: int,
    health,
    *,
    capacity=None,
    allowed: Optional[np.ndarray] = None,
    target_miss: Optional[float] = None,
    max_ell: Optional[int] = None,
    unhealthy: Optional[float] = None,
) -> int:
    """Smallest replication factor ℓ whose greedy health placement keeps the
    per-round coverage-miss probability at or under ``target_miss``
    (default ``REPRO_PLACEMENT_TARGET_MISS``), capped at ``max_ell``
    (default ``REPRO_PLACEMENT_MAX_ELL``) and at the available node count."""
    q = _coerce_q(health, s)
    c = _coerce_c(capacity, s)
    allowed = (
        np.ones(s, dtype=bool) if allowed is None else np.asarray(allowed, dtype=bool)
    )
    target = _target_miss_default() if target_miss is None else float(target_miss)
    thr = _unhealthy_default() if unhealthy is None else float(unhealthy)
    cap = min(_max_ell_default() if max_ell is None else int(max_ell),
              max(1, int(allowed.sum())))
    for ell in range(1, cap + 1):
        mat = _greedy_matrix(n, s, q, c, ell, allowed, thr, None)
        if round_miss_probability(mat, q) <= target:
            return ell
    return cap


@compiled_path("placement.health_assignment", kind="host")
def health_assignment(
    n: int,
    s: int,
    *,
    health=None,
    ell: Optional[int] = None,
    capacity=None,
    groups=None,
    allowed: Optional[np.ndarray] = None,
    unhealthy: Optional[float] = None,
    rng=None,  # accepted for make_assignment-factory compatibility; unused
) -> Assignment:
    """The ``"health"`` scheme: expected-completion-time-optimized placement.

    Builds the greedy health-aware placement, the anchored-k family
    (first replicas pinned to the k most reliable nodes) and embedded
    uniform candidates (cyclic, fractional repetition) over the allowed
    nodes, drops candidates violating the hard constraints
    (:func:`_satisfies_constraints` — the greedy always satisfies them),
    and returns the candidate with the smallest
    :func:`expected_completion_time` under ``health``/``capacity``.
    ``ell=None`` lets :func:`choose_ell` pick the replication factor.
    """
    del rng
    q = _coerce_q(health, s)
    c = _coerce_c(capacity, s)
    allowed = (
        np.ones(s, dtype=bool) if allowed is None else np.asarray(allowed, dtype=bool)
    )
    if not allowed.any():
        raise ValueError("health placement needs at least one allowed node")
    thr = _unhealthy_default() if unhealthy is None else float(unhealthy)
    grp = None if groups is None else np.asarray(groups)
    if grp is not None and grp.shape != (s,):
        raise ValueError(f"groups must have shape ({s},), got {grp.shape}")
    if ell is None:
        ell = choose_ell(
            n, s, q, capacity=c, allowed=allowed, unhealthy=thr
        )
    ell = max(1, min(int(ell), int(allowed.sum())))

    with trace_span("placement.optimize", nodes=s, shards=n, ell=ell):
        candidates = [
            ("greedy", _greedy_matrix(n, s, q, c, ell, allowed, thr, grp)),
        ]
        # Anchored family: pin every shard's first replica to the k most
        # reliable nodes (k swept).  The plain greedy optimizes projected
        # finish time and lets later replicas drift onto flaky nodes; when
        # most of the cluster is flaky that compounds into a near-certain
        # per-round miss.  A small anchor set of near-zero-q nodes keeps
        # every shard's miss product ≈ 0 at the price of some serve-time
        # imbalance — the ECT argmin below arbitrates the trade.
        order = np.flatnonzero(allowed)[np.lexsort((-c[allowed], q[allowed]))]
        for kk in range(1, min(int(order.size), 8) + 1):
            anchor_mask = np.zeros(s, dtype=bool)
            anchor_mask[order[:kk]] = True
            candidates.append((
                f"anchor{kk}",
                _greedy_matrix(n, s, q, c, ell, allowed, thr, grp, anchors=anchor_mask),
            ))
        for name, build in (
            ("cyclic", cyclic_assignment),
            ("fr", fractional_repetition_assignment),
        ):
            mat = _embed_uniform(build, n, ell, allowed)
            if mat is not None:
                candidates.append((name, mat))
        best_name, best_mat, best_ect = None, None, float("inf")
        for name, mat in candidates:
            if not _satisfies_constraints(mat, q, allowed, thr, grp):
                continue
            ect = expected_completion_time(
                Assignment(matrix=mat, scheme="health", params={}), q, c
            )
            if ect < best_ect or best_mat is None:
                best_name, best_mat, best_ect = name, mat, ect
        if best_mat is None:  # greedy always satisfies the constraints
            raise AssertionError("no constraint-satisfying placement candidate")
        reg = default_registry()
        reg.counter(
            "placement_builds",
            labels={"base": best_name},
            help="health placements built, by winning candidate",
        ).inc()
        reg.gauge(
            "placement_expected_completion",
            help="expected completion time of the last built health placement",
        ).set(best_ect if np.isfinite(best_ect) else -1.0)
    return Assignment(
        matrix=best_mat,
        scheme="health",
        params={
            "ell": int(ell),
            "base": best_name,
            "ect": float(best_ect),
            "unhealthy": thr,
        },
    )


@dataclasses.dataclass
class PlacementOptimizer:
    """Session-facing placement policy: rebuilds the assignment from live
    per-node health (see :meth:`repro_torch.core.resilience.ResilienceSession
    .permanent_loss` — the session re-optimizes on permanent membership
    changes and invalidates only the recovery-cache entries the changed
    rows can affect).

    ``ell=None`` re-chooses the replication factor per rebuild
    (:func:`choose_ell`); a fixed ``ell`` pins it.
    """

    ell: Optional[int] = None
    capacity: Optional[np.ndarray] = None
    groups: Optional[np.ndarray] = None
    unhealthy: Optional[float] = None
    target_miss: Optional[float] = None

    @compiled_path("placement.optimize_live", kind="host")
    def optimize(
        self, n: int, s: int, health, *, exclude: Optional[np.ndarray] = None
    ) -> Assignment:
        """Placement over the non-excluded nodes (excluded rows stay zero —
        static (s, n) shape for every consumer)."""
        allowed = np.ones(s, dtype=bool)
        if exclude is not None:
            allowed &= ~np.asarray(exclude, dtype=bool)
        ell = self.ell
        if ell is None:
            ell = choose_ell(
                n, s, health,
                capacity=self.capacity, allowed=allowed,
                target_miss=self.target_miss, unhealthy=self.unhealthy,
            )
        return health_assignment(
            n, s,
            health=health, ell=ell, capacity=self.capacity,
            groups=self.groups, allowed=allowed, unhealthy=self.unhealthy,
        )
