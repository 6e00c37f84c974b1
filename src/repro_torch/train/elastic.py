"""Elastic group management: permanent node loss / join without restart
(the twin of the reference's ``train/elastic.py``).

Static-shape SPMD cannot change the mesh mid-run, so elasticity is expressed
at the *group* layer (the same place the paper's redundancy lives):

* a transiently-straggling group gets weight 0 for the step (Lemma 3 path);
* a group declared PERMANENTLY dead is excluded from the plan — the session
  re-solves the recovery LP over the survivor set once (not per step) and, if
  coverage is lost, regenerates the assignment over the survivors (a data
  re-shuffle, not a recompilation: batch shapes are unchanged — dead groups
  keep producing placeholder microbatches with weight 0 until the next
  scheduled re-shard);
* a joining group is assigned the shard set of a dead slot (warm takeover).

The mechanics live in :class:`repro_torch.core.resilience.ResilienceSession`
(``permanent_loss`` / ``permanent_join`` / ``_reshard_survivors``) — the same
object that owns the recovery cache, assignment lineage, and patch listeners,
so a reshard invalidates exactly the state a patch would.  This manager is
the training-layer facade: it tracks the plan rebinding a reshard forces
(the plan's ``assignment`` field must follow the session's new matrix so
load accounting — ``shards_per_group`` / ``max_load`` — reads the takeover
matrix, not the original balanced construction).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.recovery import RecoveryResult
from .resilient import RedundantShardPlan

__all__ = ["ElasticGroupManager"]


@dataclasses.dataclass
class ElasticGroupManager:
    plan: RedundantShardPlan

    @property
    def permanently_dead(self) -> set:
        return set(self.plan.session.permanent_dead)

    @property
    def reshard_count(self) -> int:
        return self.plan.session.stats.reshards

    def mark_dead(self, group: int) -> None:
        session = self.plan.session
        before = session.stats.reshards
        session.permanent_loss(int(group))
        if session.stats.reshards != before:
            # The session resharded: its assignment object changed, and the
            # plan's static-shape accounting must follow the takeover matrix.
            # session.assignment IS the new assignment, so the plan/session
            # identity contract holds by construction.
            self.plan = RedundantShardPlan(
                assignment=session.assignment,
                num_groups=self.plan.num_groups,
                session=session,
            )

    def mark_joined(self, group: int) -> None:
        self.plan.session.permanent_join(int(group))

    def alive_mask(self, transient_stragglers: Optional[np.ndarray] = None) -> np.ndarray:
        return self.plan.session.alive_mask(transient_stragglers)

    def step_weights(
        self, transient_stragglers: Optional[np.ndarray] = None
    ) -> tuple[np.ndarray, RecoveryResult]:
        """Per-step (G,) recovery weights over the CURRENT healthy set."""
        alive = self.alive_mask(transient_stragglers)
        return self.plan.group_weights(alive)
