"""Recovery-vector solvers for Property 1 (paper §3.1, Theorem 6).

Given an assignment ``A`` and the alive set ``R``, find ``b ≥ 0`` with
``bᵀ A_R = a`` and ``1 ≤ a_j ≤ 1+δ`` for all shards ``j``.

The host solvers are copied from the reference package's
``core/recovery.py`` (numpy and scipy):

* :func:`uniform_recovery` — the paper's closed form for the Bernoulli
  ensemble: ``b = 𝟙 / ((1−γ)·ℓ·(1−p_t))`` (proof of Theorem 6).
* :func:`lp_recovery` — exact minimum-δ linear program
  (``min z  s.t.  A_Rᵀ b ≥ 1,  A_Rᵀ b ≤ z,  b ≥ 0``), solved with
  scipy/HiGHS.  δ* = z* − 1 is the best achievable band for this ``(A, R)``.
* :func:`nnls_recovery` — non-negative least squares, rescaled to min(a) = 1.

The on-device solvers are the reference's ``jax_recovery`` and
``jax_recovery_masked`` in PyTorch, with the same arithmetic:

* :func:`device_recovery` — projected gradient descent on
  ``½‖bᵀA_R − 𝟙‖²`` over the alive rows ``A_R``;
* :func:`device_recovery_masked` — the fixed-shape form: the full ``(s, n)``
  matrix and an ``(s,)`` alive mask, so every straggler pattern is data.

They carry the reference's ``@compiled_path`` names, ``recovery.jax`` and
``recovery.jax_masked`` (kind ``step``).  Both run eagerly on the tensors'
device with no host synchronisation:
every step is a fixed number of launches and no value comes back to the
host.  Their products are f32 matrix-vector products (``torch.mv``, a
non-tensor-core routine, so TF32 never enters them).

:func:`solve_recovery` dispatches and degrades gracefully: shards with zero
alive replicas are reported via ``uncovered``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..analysis import compiled_path
from ..device import resolve_device
from .assignment import Assignment

__all__ = [
    "RecoveryResult",
    "uniform_recovery",
    "lp_recovery",
    "nnls_recovery",
    "device_recovery",
    "device_recovery_masked",
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


def _power_sigma_sq(A_c: torch.Tensor) -> torch.Tensor:
    """σ_max(A_c)² by 8 power iterations on A_cᵀA_c, floored at 1e-6 — the
    Lipschitz constant of the gradient, kept on the device."""
    n = A_c.shape[1]
    v = torch.full((n,), 1.0 / float(np.sqrt(n)), dtype=torch.float32, device=A_c.device)
    for _ in range(8):
        v = torch.mv(A_c.T, torch.mv(A_c, v))
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-12)
    return torch.clamp_min(torch.linalg.vector_norm(torch.mv(A_c, v)) ** 2, 1e-6)


@compiled_path("recovery.jax", kind="step")
def device_recovery(A_R, *, iters: int = 500, lr: float = 1.0, device=None) -> torch.Tensor:
    """On-device projected-gradient recovery over the alive rows ``A_R``
    (r, n): PGD on the NNLS objective ``½‖bᵀA_R − 𝟙‖²`` with step
    1/σ_max(A_R)² (power-iteration estimate), then an exact rescale so that
    ``min_j a_j = 1`` on covered shards.  Returns ``b`` (r,) f32 on
    ``device`` (the card by default)."""
    device = resolve_device(device)
    A_R = torch.as_tensor(A_R, dtype=torch.float32, device=device)
    r, n = A_R.shape
    sigma_sq = _power_sigma_sq(A_R)
    step = lr / sigma_sq
    repl = torch.clamp_min(A_R.sum(dim=0), 1.0)
    b = torch.ones((r,), dtype=torch.float32, device=device) / torch.mean(repl)
    for _ in range(iters):
        grad = torch.mv(A_R, torch.mv(A_R.T, b) - 1.0)
        b = torch.clamp_min(b - step * grad, 0.0)
    a = torch.mv(A_R.T, b)
    covered = A_R.sum(dim=0) > 0
    amin = torch.amin(torch.where(covered, a, torch.inf))
    return torch.where(amin > 1e-12, b / amin, b)


@compiled_path("recovery.jax_masked", kind="step")
def device_recovery_masked(
    A, alive, *, iters: int = 300, lr: float = 1.0, device=None
) -> torch.Tensor:
    """Fixed-shape on-device recovery from an alive mask.

    Takes the FULL ``(s, n)`` assignment and the ``(s,)`` alive mask: every
    straggler pattern is data for the same launches.  Dead rows are masked
    out of the gradient and their weights pinned to 0; uncovered shards are
    masked out of the objective (their target is unreachable and would
    otherwise drag the covered band down).  Returns ``b_full`` — ``(s,)``
    f32 weights on ``device`` with zeros at stragglers, the form the
    executors' Lemma-3 combine consumes.
    """
    device = resolve_device(device)
    A = torch.as_tensor(A, dtype=torch.float32, device=device)
    alive_f = torch.as_tensor(alive, device=device).to(torch.float32)
    A_m = A * alive_f[:, None]            # dead rows contribute nothing
    covered = (A_m.sum(dim=0) > 0).to(torch.float32)
    A_c = A_m * covered[None, :]          # uncovered shards leave the objective
    sigma_sq = _power_sigma_sq(A_c)
    step = lr / sigma_sq
    repl = torch.clamp_min(A_c.sum(dim=0), 1.0)
    b = alive_f / torch.clamp_min(torch.mean(repl), 1.0)
    for _ in range(iters):
        grad = torch.mv(A_c, torch.mv(A_c.T, b) - covered)
        b = torch.clamp_min(b - step * grad, 0.0) * alive_f
    a = torch.mv(A_c.T, b)
    amin = torch.amin(torch.where(covered > 0, a, torch.inf))
    # Exact rescale so min_j a_j = 1 on covered shards; degenerate solves
    # (amin ≈ 0, or no covered shard at all) are returned unscaled — the
    # caller sees a < 1 and can fall back to the host LP.
    return torch.where((amin > 1e-12) & torch.isfinite(amin), b / amin, b)


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
    if method == "device":
        A = assignment.matrix
        alive_idx = _as_alive_index(A, alive)
        b = device_recovery(A[alive_idx], **kw).cpu().numpy()
        return _result(A, alive_idx, b, "device")
    if method == "jax":
        raise ValueError(
            "method='jax' is the reference package's name; the port's "
            "on-device solver is method='device'"
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
