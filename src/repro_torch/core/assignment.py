"""Redundant data-assignment schemes (paper §3.1, §3.4), numpy only.

Copied from the reference package's ``core/assignment.py``.

An assignment matrix ``A ∈ {0,1}^{s×n}`` maps each of ``n`` data shards to a
subset of ``s`` compute nodes (``A[i, j] = 1`` iff shard ``j`` is assigned to
node ``i``).  Property 1 of the paper requires that for every non-straggler
set ``R`` (``|R| ≥ s − t``) there exists a non-negative recovery vector ``b``
with ``bᵀ A_R ∈ [1, 1+δ]ⁿ``.

Constructions implemented here:

* :func:`bernoulli_assignment` — the paper's randomized construction
  (Theorem 6): each entry is 1 w.p. ``ℓ/s`` with
  ``ℓ = 6(2+δ)²/δ² · log(√2·n) / (1 − p_t)``.
* :func:`fractional_repetition_assignment` — *beyond paper*: nodes are split
  into ``ℓ`` replica groups, each group partitions the shards.  Any straggler
  pattern that leaves at least one live replica of every shard admits an
  EXACT recovery (δ = 0), and up to ``t = ℓ − 1`` adversarial stragglers are
  always tolerated.
* :func:`cyclic_assignment` — *beyond paper*: shard ``j`` is assigned to the
  ``ℓ`` cyclically-consecutive nodes starting at ``j mod s`` (gradient-coding
  style); tolerates ``ℓ − 1`` adversarial stragglers.

All constructions are plain numpy — the assignment is coordinator-side
metadata, never device-resident tensor compute.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Iterable, Optional

import numpy as np

__all__ = [
    "Assignment",
    "theorem6_ell",
    "bernoulli_assignment",
    "fractional_repetition_assignment",
    "cyclic_assignment",
    "singleton_assignment",
    "make_assignment",
    "node_loads",
    "shard_replication",
    "min_cover_after_stragglers",
    "satisfies_property1",
]


@dataclasses.dataclass(frozen=True)
class Assignment:
    """An immutable assignment of ``n`` shards to ``s`` nodes."""

    matrix: np.ndarray  # (s, n) uint8
    scheme: str
    params: dict

    def __post_init__(self):
        m = np.asarray(self.matrix)
        if m.ndim != 2:
            raise ValueError(f"assignment matrix must be 2-D, got {m.shape}")
        if not np.isin(m, (0, 1)).all():
            raise ValueError("assignment matrix must be 0/1")
        object.__setattr__(self, "matrix", m.astype(np.uint8))

    @property
    def num_nodes(self) -> int:
        return int(self.matrix.shape[0])

    @property
    def num_shards(self) -> int:
        return int(self.matrix.shape[1])

    def shards_of(self, node: int) -> np.ndarray:
        """Shard indices assigned to ``node`` (the set ``P_i``)."""
        return np.flatnonzero(self.matrix[node])

    def nodes_of(self, shard: int) -> np.ndarray:
        """Node indices holding ``shard`` (the set ``A_p``)."""
        return np.flatnonzero(self.matrix[:, shard])

    def submatrix(self, alive: np.ndarray) -> np.ndarray:
        """``A_R`` for a boolean alive-mask or integer index array."""
        alive = np.asarray(alive)
        if alive.dtype == bool:
            return self.matrix[alive]
        return self.matrix[alive.astype(int)]


def theorem6_ell(n: int, delta: float, p_straggler: float) -> int:
    """Per-shard replication ``ℓ`` from Theorem 6.

    ``ℓ = 6(2+δ)²/δ² · log(√2·n) / (1 − p_t)`` (natural log, as in the
    Chernoff bound of the proof).
    """
    if not 0 < delta:
        raise ValueError("delta must be positive")
    if not 0 <= p_straggler < 1:
        raise ValueError("p_straggler must be in [0, 1)")
    gamma = delta / (2.0 + delta)
    ell = 6.0 * math.log(math.sqrt(2.0) * n) / (gamma**2 * (1.0 - p_straggler))
    return max(1, int(math.ceil(ell)))


def bernoulli_assignment(
    n: int,
    s: int,
    *,
    delta: float = 0.5,
    p_straggler: float = 0.1,
    ell: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
    ensure_cover: bool = True,
) -> Assignment:
    """Paper's randomized construction (eq. 2): ``A[i,j] ~ Bern(ℓ/s)`` i.i.d.

    ``ell`` overrides the Theorem-6 value (the paper's own experiments use
    ``p_a ∈ {0.1, 0.2}`` directly, i.e. ``ell = p_a · s``).

    ``ensure_cover`` re-rolls all-zero columns (a shard assigned to no node
    carries zero information for every straggler pattern; the paper's analysis
    conditions on the high-probability event that this does not happen).
    """
    rng = rng or np.random.default_rng(0)
    if ell is None:
        ell = theorem6_ell(n, delta, p_straggler)
    p_a = min(1.0, float(ell) / float(s))
    mat = (rng.random((s, n)) < p_a).astype(np.uint8)
    if ensure_cover:
        empty = np.flatnonzero(mat.sum(axis=0) == 0)
        for j in empty:
            mat[rng.integers(0, s), j] = 1
    return Assignment(
        matrix=mat,
        scheme="bernoulli",
        params={"p_a": p_a, "ell": float(ell), "delta": delta, "p_straggler": p_straggler},
    )


def fractional_repetition_assignment(n: int, s: int, ell: int) -> Assignment:
    """Fractional-repetition assignment (beyond paper; cf. Tandon et al. FRC).

    Nodes are split into ``ell`` replica groups of ``s // ell`` nodes; within a
    group the ``n`` shards are partitioned contiguously.  Every shard is held
    by exactly ``ell`` nodes — one per group — so as long as one replica group
    member per shard survives, recovery is exact (δ = 0).
    """
    if s % ell != 0:
        raise ValueError(f"s={s} must be divisible by the replication ell={ell}")
    g = s // ell  # nodes per replica group
    mat = np.zeros((s, n), dtype=np.uint8)
    # Shard j belongs to partition block (j * g) // n within each group.
    owner_in_group = (np.arange(n) * g) // n  # (n,) in [0, g)
    for rep in range(ell):
        mat[rep * g + owner_in_group, np.arange(n)] = 1
    return Assignment(matrix=mat, scheme="fractional_repetition", params={"ell": ell})


def cyclic_assignment(n: int, s: int, ell: int) -> Assignment:
    """Cyclic-shift assignment: shard ``j`` → nodes ``{j, j+1, …, j+ell−1} mod s``.

    Tolerates any ``ell − 1`` stragglers (every window of ``s − ell + 1``
    consecutive nodes covers all residues).  Loads are perfectly balanced.
    """
    if not 1 <= ell <= s:
        raise ValueError(f"need 1 <= ell <= s, got ell={ell}, s={s}")
    mat = np.zeros((s, n), dtype=np.uint8)
    for j in range(n):
        for r in range(ell):
            mat[(j + r) % s, j] = 1
    return Assignment(matrix=mat, scheme="cyclic", params={"ell": ell})


def singleton_assignment(n: int, s: int) -> Assignment:
    """Non-redundant baseline: round-robin partition (the paper's Fig 1(b))."""
    mat = np.zeros((s, n), dtype=np.uint8)
    mat[np.arange(n) % s, np.arange(n)] = 1
    return Assignment(matrix=mat, scheme="singleton", params={"ell": 1})


def make_assignment(
    scheme: str,
    n: int,
    s: int,
    *,
    ell: Optional[float] = 2,
    rng: Optional[np.random.Generator] = None,
    **kwargs,
) -> Assignment:
    """Factory over the five construction families, keyed by scheme name.

    ``"bernoulli"`` / ``"cyclic"`` / ``"fractional_repetition"`` (alias
    ``"fr"``) / ``"singleton"`` / ``"health"``.  ``ell`` is the per-shard
    replication (ignored by singleton; ``ell=None`` lets the ``"health"``
    optimizer choose it); remaining kwargs go to the construction — for
    ``"health"``, notably ``health=`` (per-node straggle probability, e.g.
    ``ResilienceSession.node_health()``) and ``capacity=``.  One shared
    spelling for benchmarks, sessions, and the streaming layer — instead
    of each call site keeping its own if/elif ladder.
    """
    if scheme == "bernoulli":
        return bernoulli_assignment(n, s, ell=float(ell), rng=rng, **kwargs)
    if scheme == "cyclic":
        return cyclic_assignment(n, s, int(ell), **kwargs)
    if scheme in ("fractional_repetition", "fr"):
        return fractional_repetition_assignment(n, s, int(ell), **kwargs)
    if scheme == "singleton":
        return singleton_assignment(n, s, **kwargs)
    if scheme == "health":
        from .placement import health_assignment  # local import: placement imports us

        return health_assignment(
            n, s, ell=None if ell is None else int(ell), rng=rng, **kwargs
        )
    raise ValueError(
        f"unknown assignment scheme {scheme!r}; expected "
        "bernoulli/cyclic/fractional_repetition/singleton/health"
    )


def node_loads(assignment: Assignment) -> np.ndarray:
    """Number of shards per node — the paper's 'load per machine'."""
    return assignment.matrix.sum(axis=1).astype(np.int64)


def shard_replication(assignment: Assignment) -> np.ndarray:
    """Number of nodes per shard (column weights)."""
    return assignment.matrix.sum(axis=0).astype(np.int64)


def min_cover_after_stragglers(assignment: Assignment, alive: np.ndarray) -> int:
    """Minimum replica count over shards restricted to alive nodes.

    0 means some shard is entirely lost — Property 1 cannot hold for this
    straggler pattern.
    """
    sub = assignment.submatrix(np.asarray(alive))
    return int(sub.sum(axis=0).min()) if sub.shape[1] else 0


def _alive_sets(s: int, t: int, limit: int, rng: np.random.Generator) -> Iterable[np.ndarray]:
    """Enumerate (or sample) alive-masks with exactly ``t`` stragglers."""
    total = math.comb(s, t)
    if total <= limit:
        for stragglers in itertools.combinations(range(s), t):
            mask = np.ones(s, dtype=bool)
            mask[list(stragglers)] = False
            yield mask
    else:
        for _ in range(limit):
            mask = np.ones(s, dtype=bool)
            mask[rng.choice(s, size=t, replace=False)] = False
            yield mask


def satisfies_property1(
    assignment: Assignment,
    t: int,
    delta: float,
    *,
    exhaustive_limit: int = 2048,
    rng: Optional[np.random.Generator] = None,
) -> bool:
    """Check Property 1 for all (or sampled) straggler patterns of size ``t``.

    Exhaustive when ``C(s, t) ≤ exhaustive_limit`` (then the answer is exact);
    otherwise Monte-Carlo over ``exhaustive_limit`` patterns (one-sided: a
    ``False`` is definitive, a ``True`` is high-confidence).
    """
    from .recovery import solve_recovery  # local import to avoid cycle

    rng = rng or np.random.default_rng(0)
    for alive in _alive_sets(assignment.num_nodes, t, exhaustive_limit, rng):
        res = solve_recovery(assignment, alive, method="lp")
        if not res.feasible or res.delta > delta + 1e-9:
            return False
    return True
