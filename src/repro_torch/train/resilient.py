"""Straggler-resilient data-parallel training — the paper's technique as a
training-loop feature (Lemma 3 applied to gradients), the twin of the
reference's ``train/resilient.py``.

A :class:`RedundantShardPlan` assigns ``n_shards`` data shards to ``G``
DP groups by an assignment matrix with Property 1 (each group processes
``ℓ`` shards per step — that is the redundancy the paper trades for
resilience).  Each step:

1. a straggler mask over groups arrives (deadline-based on real clusters,
   simulated here);
2. the recovery solver produces ``b`` (zeros at stragglers): the host LP
   (:meth:`RedundantShardPlan.group_weights`, the trainer's host path) or
   the on-device solver (:meth:`RedundantShardPlan.step_weights`, on the
   session's device);
3. ``b`` reweights the per-group losses — the backward pass computes
   exactly  Σ_g b_g ∇L_g = Σ_s a_s ∇L_s  with ``a_s ∈ [1, 1+δ]``: an
   approximately-uniformly-reweighted full-data gradient, for ANY straggler
   pattern the assignment tolerates.

With the fractional-repetition assignment the band is exact (δ = 0) whenever
at least one replica of every shard survives.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.assignment import (
    Assignment,
    cyclic_assignment,
    fractional_repetition_assignment,
    singleton_assignment,
)
from ..core.recovery import RecoveryResult
from ..core.resilience import ResilienceSession

__all__ = ["RedundantShardPlan", "make_plan"]


@dataclasses.dataclass
class RedundantShardPlan:
    """Shard→group assignment with cached per-pattern recovery weights.

    The per-pattern cache and the solver live in a
    :class:`repro_torch.core.resilience.ResilienceSession` (``plan.session``) —
    the SAME cache the clustering entry points use, so a trainer and an
    evaluation pass over one assignment never solve a pattern twice.

    The plan follows its session: when the session's elastic policy patches
    the assignment mid-run (re-replicating at-risk shards away from
    persistent stragglers), :attr:`current_assignment`,
    :meth:`step_weights`, and the recovery cache all track the PATCHED
    matrix — ``assignment`` keeps the original construction for static-shape
    consumers (the data pipeline sizes its batches once, at plan creation).
    """

    assignment: Assignment
    num_groups: int
    session: ResilienceSession = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.session is None:
            self.session = ResilienceSession(self.assignment)
        elif self.session.assignment is not self.assignment:
            raise ValueError(
                "session was built for a different assignment — its recovery "
                "cache and patch lineage would not match this plan's matrix"
            )

    @property
    def num_shards(self) -> int:
        return self.assignment.num_shards

    @property
    def current_assignment(self) -> Assignment:
        """The session's live assignment — the original construction until an
        elastic patch replaces it."""
        return self.session.assignment

    @property
    def shards_per_group(self) -> int:
        """Uniform per-group load ℓ·n/G — only meaningful for balanced
        constructions (cyclic/FR/singleton).

        An unbalanced assignment (a Bernoulli draw, or a plan after elastic
        takeover) has no single per-group load; silently reporting
        ``loads[0]`` as if it were uniform mis-sizes every consumer that
        multiplies by it (batch shapes, padding, load accounting).  Raise
        instead, and point callers at :meth:`group_load` / :attr:`max_load`.
        """
        loads = self.assignment.matrix.sum(axis=1)
        if loads.size == 0 or not (loads == loads[0]).all():
            raise ValueError(
                "shards_per_group is only defined for load-balanced "
                f"assignments; got per-group loads {loads.tolist()} "
                "(use group_load(g) / max_load for unbalanced plans)"
            )
        return int(loads[0])

    @property
    def max_load(self) -> int:
        """Maximum per-group shard count — well-defined for ANY assignment
        (the padding capacity unbalanced consumers size against)."""
        return int(self.assignment.matrix.sum(axis=1).max())

    def group_load(self, g: int) -> int:
        """Shard count of group ``g`` under the ORIGINAL assignment."""
        return int(self.assignment.matrix[g].sum())

    def group_shards(self, g: int) -> np.ndarray:
        """Shard ids processed by group g (sorted, fixed for the run)."""
        return self.assignment.shards_of(g)

    def current_group_shards(self, g: int) -> np.ndarray:
        """Shard ids of group g under the CURRENT (possibly elastically
        patched) assignment."""
        return self.current_assignment.shards_of(g)

    def recovery(self, alive: np.ndarray) -> RecoveryResult:
        return self.session.recovery(alive)

    def group_weights(self, alive: np.ndarray) -> tuple[np.ndarray, RecoveryResult]:
        """(G,) float32 weights (b, zeros at stragglers) + diagnostics.

        Host-solved (LP/NNLS) — the offline/exact path and the parity
        reference for :meth:`step_weights`."""
        return self.session.recovery_weights(alive)

    def step_weights(self, alive: np.ndarray) -> np.ndarray:
        """(G,) float32 per-step weights from the ON-DEVICE solver (on the
        session's device), against the CURRENT (elastically patched)
        assignment.

        The form of :meth:`group_weights` with no host LP.  Degenerate patterns — some shard with zero alive
        replicas — fall back to the cached host solve, whose best-effort
        ``b_full`` preserves the mass of every still-covered shard instead
        of silently dropping it on device.
        """
        alive = np.asarray(alive, dtype=bool)
        if not self.session.pattern_covers(alive):
            # Uncovered shards: the device solver masks them out of its
            # objective (their target is unreachable), which would silently
            # drop their mass.  The host path reports them explicitly and
            # still weights the covered remainder.
            return self.session.recovery(alive).b_full.astype(np.float32)
        return self.session.device_recovery_weights(alive).astype(np.float32)

    def degraded_weights(self, alive: np.ndarray) -> np.ndarray:
        """Fallback when Property 1 fails (too many dead groups): use the
        best-effort covered-shard weights — training continues on the
        surviving information (elastic path)."""
        res = self.recovery(alive)
        return res.b_full.astype(np.float32)


def make_plan(
    num_groups: int,
    num_shards: int,
    *,
    redundancy: int = 2,
    scheme: str = "cyclic",
    rng: Optional[np.random.Generator] = None,
    session_kwargs: Optional[dict] = None,
) -> RedundantShardPlan:
    """Build a load-balanced redundant plan.

    scheme ∈ {"cyclic", "fr", "bernoulli", "singleton"}.  ``redundancy`` is
    the per-shard replication ℓ (ℓ=1 ⇒ no resilience, the baseline).
    ``session_kwargs`` configure the plan's :class:`ResilienceSession`
    (``executor=``, ``elastic=``, ``device_iters=``, ``device=`` …) — the session is
    always constructed around the plan's own assignment, so callers cannot
    pair the plan with a foreign matrix.
    """
    if scheme == "cyclic":
        a = cyclic_assignment(num_shards, num_groups, redundancy)
    elif scheme == "fr":
        a = fractional_repetition_assignment(num_shards, num_groups, redundancy)
    elif scheme == "bernoulli":
        # Bernoulli is not exactly load-balanced; regularize by using cyclic
        # with the Theorem-6 ℓ instead when balance is required.
        raise ValueError(
            "bernoulli assignments are not load-balanced; use 'cyclic' with "
            "ell from theorem6_ell for the randomized regime"
        )
    elif scheme == "singleton":
        a = singleton_assignment(num_shards, num_groups)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    session = ResilienceSession(a, **session_kwargs) if session_kwargs else None
    return RedundantShardPlan(assignment=a, num_groups=num_groups, session=session)
