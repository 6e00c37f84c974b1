"""Recovery-vector solvers for Property 1 (paper §3.1, Theorem 6), host side.

Given an assignment ``A`` and the alive set ``R``, find ``b ≥ 0`` with
``bᵀ A_R = a`` and ``1 ≤ a_j ≤ 1+δ`` for all shards ``j``.

Copied from the reference package's ``core/recovery.py`` (numpy and scipy):

* :func:`uniform_recovery` — the paper's closed form for the Bernoulli
  ensemble: ``b = 𝟙 / ((1−γ)·ℓ·(1−p_t))`` (proof of Theorem 6).
* :func:`lp_recovery` — exact minimum-δ linear program
  (``min z  s.t.  A_Rᵀ b ≥ 1,  A_Rᵀ b ≤ z,  b ≥ 0``), solved with
  scipy/HiGHS.  δ* = z* − 1 is the best achievable band for this ``(A, R)``.
* :func:`nnls_recovery` — non-negative least squares, rescaled to min(a) = 1.

:func:`solve_recovery` dispatches and degrades gracefully: shards with zero
alive replicas are reported via ``uncovered``.  The on-device solvers
(``jax_recovery*``) are not ported yet (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .assignment import Assignment

__all__ = [
    "RecoveryResult",
    "uniform_recovery",
    "lp_recovery",
    "nnls_recovery",
    "solve_recovery",
    "expand_to_all_nodes",
]


@dataclasses.dataclass(frozen=True)
class RecoveryResult:
    """Solution of the Property-1 recovery problem for one alive set."""

    b: np.ndarray          # (|R|,) non-negative weights over alive nodes
    b_full: np.ndarray     # (s,) weights over all nodes (0 at stragglers)
    a: np.ndarray          # (n,) achieved column sums bᵀ A_R
    delta: float           # max(a) − 1 over covered shards
    feasible: bool         # all covered shards have a_j ≥ 1 (within tol)
    uncovered: np.ndarray  # shard indices with zero alive replicas
    method: str

    @property
    def covered_fraction(self) -> float:
        n = self.a.shape[0]
        return 1.0 - (len(self.uncovered) / max(1, n))


def _as_alive_index(A: np.ndarray, alive: np.ndarray) -> np.ndarray:
    alive = np.asarray(alive)
    if alive.dtype == bool:
        if alive.shape[0] != A.shape[0]:
            raise ValueError("alive mask length must equal number of nodes")
        return np.flatnonzero(alive)
    return alive.astype(int)


def _result(A, alive_idx, b, method) -> RecoveryResult:
    s, n = A.shape
    A_R = A[alive_idx].astype(np.float64)
    b = np.maximum(np.asarray(b, dtype=np.float64), 0.0)
    a = b @ A_R
    uncovered = np.flatnonzero(A_R.sum(axis=0) == 0)
    covered = np.setdiff1d(np.arange(n), uncovered)
    if covered.size:
        # Property 1 is only satisfied when EVERY shard is recoverable:
        # an uncovered shard makes the pattern infeasible outright.
        feasible = bool(a[covered].min() >= 1.0 - 1e-7) and uncovered.size == 0
        delta = float(a[covered].max() - 1.0)
    else:
        feasible, delta = False, float("inf")
    b_full = np.zeros(s, dtype=np.float64)
    b_full[alive_idx] = b
    return RecoveryResult(
        b=b, b_full=b_full, a=a, delta=delta, feasible=feasible,
        uncovered=uncovered, method=method,
    )


def uniform_recovery(
    assignment: Assignment,
    alive: np.ndarray,
    *,
    delta: Optional[float] = None,
    p_straggler: Optional[float] = None,
) -> RecoveryResult:
    """Paper's closed-form uniform ``b`` (proof of Theorem 6).

    ``b_i = 1 / ((1−γ)·ℓ·(1−p_t))`` with ``γ = δ/(2+δ)``.  Parameters default
    to those recorded in the assignment (Bernoulli construction).
    """
    A = assignment.matrix
    alive_idx = _as_alive_index(A, alive)
    params = assignment.params
    delta = params.get("delta", 0.5) if delta is None else delta
    p_t = params.get("p_straggler", 0.0) if p_straggler is None else p_straggler
    # Effective replication: p_a·s (the proof's ℓ(1−p_t) uses the *realized*
    # Bernoulli rate, which is clamped when the Theorem-6 ℓ exceeds s).
    if "p_a" in params:
        ell = params["p_a"] * A.shape[0]
    else:
        ell = params.get("ell", float(max(1.0, A.sum(axis=0).mean())))
    gamma = delta / (2.0 + delta)
    scale = 1.0 / ((1.0 - gamma) * ell * (1.0 - p_t))
    b = np.full(len(alive_idx), scale)
    return _result(A, alive_idx, b, "uniform")


def lp_recovery(assignment: Assignment, alive: np.ndarray) -> RecoveryResult:
    """Exact min-δ LP:  min z  s.t.  A_Rᵀb ≥ 1, A_Rᵀb ≤ z·𝟙, b ≥ 0, z ≥ 1."""
    from scipy.optimize import linprog

    A = assignment.matrix
    alive_idx = _as_alive_index(A, alive)
    A_R = A[alive_idx].astype(np.float64)
    r, n = A_R.shape
    covered = np.flatnonzero(A_R.sum(axis=0) > 0)
    if covered.size == 0:
        return _result(A, alive_idx, np.zeros(r), "lp")
    Ac = A_R[:, covered]  # (r, m)
    m = Ac.shape[1]
    # Variables x = [b (r), z (1)].
    c = np.zeros(r + 1)
    c[-1] = 1.0
    # -Acᵀ b ≤ -1   and   Acᵀ b − z ≤ 0
    A_ub = np.zeros((2 * m, r + 1))
    A_ub[:m, :r] = -Ac.T
    A_ub[m:, :r] = Ac.T
    A_ub[m:, r] = -1.0
    b_ub = np.concatenate([-np.ones(m), np.zeros(m)])
    bounds = [(0, None)] * r + [(1.0, None)]
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, bounds=bounds, method="highs")
    if not res.success:  # pragma: no cover - HiGHS is robust on feasible LPs
        return _result(A, alive_idx, np.zeros(r), "lp")
    return _result(A, alive_idx, res.x[:r], "lp")


def nnls_recovery(
    assignment: Assignment, alive: np.ndarray, *, target: float = 1.0
) -> RecoveryResult:
    """Non-negative least squares towards ``a = target·𝟙`` then rescale so
    that min(a) = 1 (fast heuristic; δ not optimal but good in practice)."""
    from scipy.optimize import nnls

    A = assignment.matrix
    alive_idx = _as_alive_index(A, alive)
    A_R = A[alive_idx].astype(np.float64)
    covered = np.flatnonzero(A_R.sum(axis=0) > 0)
    if covered.size == 0:
        return _result(A, alive_idx, np.zeros(A_R.shape[0]), "nnls")
    b, _ = nnls(A_R[:, covered].T, np.full(covered.size, target))
    a = b @ A_R[:, covered]
    amin = a.min()
    if amin <= 1e-12:
        # Degenerate active set: NNLS left some covered shard with
        # (numerically) zero mass, so no rescale can reach the a ≥ 1 band.
        # Report the infeasibility explicitly instead of returning the raw
        # unscaled b as if it were a usable solution.
        res = _result(A, alive_idx, b, "nnls")
        return dataclasses.replace(res, feasible=False)
    b = b / amin  # scale the band up so the lower bound is exactly 1
    return _result(A, alive_idx, b, "nnls")


def solve_recovery(
    assignment: Assignment,
    alive: np.ndarray,
    *,
    method: str = "auto",
    **kw,
) -> RecoveryResult:
    """Dispatch: 'auto' tries exact LP, falls back to nnls, then uniform."""
    if method == "uniform":
        return uniform_recovery(assignment, alive, **kw)
    if method == "nnls":
        return nnls_recovery(assignment, alive, **kw)
    if method == "lp":
        return lp_recovery(assignment, alive)
    if method == "jax":
        raise NotImplementedError(
            "the on-device recovery solver is not ported yet (ROADMAP queue 1, item 8)"
        )
    if method != "auto":
        raise ValueError(f"unknown recovery method {method!r}")
    res = lp_recovery(assignment, alive)
    if res.feasible:
        return res
    fallback = nnls_recovery(assignment, alive)
    return fallback if fallback.feasible else res


def expand_to_all_nodes(result: RecoveryResult) -> np.ndarray:
    """(s,) recovery weights with zeros at stragglers — the form consumed by
    the weighted-psum training path."""
    return result.b_full
