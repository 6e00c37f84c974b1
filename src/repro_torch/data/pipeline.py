"""Redundant data pipeline: shards → DP groups per the assignment matrix (a
copy of the reference's ``data/pipeline.py``; numpy only, its batches
equal the reference's bit for bit).

Per step, the *unique* global batch is ``n_shards`` microbatches; group ``g``
materializes the concatenation of its assigned shards' microbatches (the ℓ×
compute redundancy the paper trades for straggler resilience).  The batch
tensor is laid out group-major, matching ``loss_fn``'s ``(G, …)`` reshape, so
``group_weights`` line up by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..train.resilient import RedundantShardPlan
from . import tokens as tok

__all__ = ["RedundantDataPipeline"]


@dataclasses.dataclass
class RedundantDataPipeline:
    plan: RedundantShardPlan
    vocab: int
    microbatch: int  # sequences per shard per step
    seq_len: int
    seed: int = 0

    def __post_init__(self):
        self._table = tok.make_markov_table(self.vocab, seed=self.seed)
        # Fixed shard order per group for the whole run (static shapes).
        self._group_shards = [
            self.plan.group_shards(g) for g in range(self.plan.num_groups)
        ]
        # Snapshot the uniform load ONCE: batch shapes are static for the
        # run, so a later elastic patch (which unbalances the plan and makes
        # plan.shards_per_group raise) must not change them.
        self._shards_per_group = self.plan.shards_per_group

    @property
    def batch_shape(self) -> tuple[int, int]:
        G = self.plan.num_groups
        L = self._shards_per_group
        return (G * L * self.microbatch, self.seq_len)

    def batch(self, step: int) -> np.ndarray:
        """(G·L·mb, T) int32 tokens, group-major.  Replicated shards produce
        bit-identical microbatches in every group that holds them."""
        groups = []
        for g in range(self.plan.num_groups):
            parts = [
                tok.shard_batch(self._table, int(s), step, self.microbatch, self.seq_len)
                for s in self._group_shards[g]
            ]
            groups.append(np.concatenate(parts, axis=0))
        return np.concatenate(groups, axis=0)

    def shard_rows(
        self, shard_ids, step: int, capacity: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Capacity-padded token rows for ONE group: ``(capacity·mb, T)``
        int32 tokens and a ``(capacity,)`` float32 shard-slot validity mask.

        The mesh-native trainer keeps these blocks device-resident (one row
        per group, node-stacked) and re-packs only moved groups after an
        elastic patch; ``capacity ≥ len(shard_ids)`` leaves headroom so a
        patch that grows a group's load fits without a shape change.  Padded
        slots carry zero tokens and validity 0 — inert in every statistic.
        """
        shard_ids = np.asarray(shard_ids, dtype=np.int64)
        if len(shard_ids) > capacity:
            raise ValueError(
                f"group holds {len(shard_ids)} shards > capacity {capacity}"
            )
        rows = np.zeros((capacity * self.microbatch, self.seq_len), dtype=np.int32)
        valid = np.zeros((capacity,), dtype=np.float32)
        for i, s in enumerate(shard_ids):
            rows[i * self.microbatch : (i + 1) * self.microbatch] = tok.shard_batch(
                self._table, int(s), step, self.microbatch, self.seq_len
            )
            valid[i] = 1.0
        return rows, valid

    def unique_batch(self, step: int) -> np.ndarray:
        """The deduplicated (n_shards·mb, T) batch — the 'ground truth' data
        of the step, used by tests to compare against non-redundant runs."""
        parts = [
            tok.shard_batch(self._table, s, step, self.microbatch, self.seq_len)
            for s in range(self.plan.num_shards)
        ]
        return np.concatenate(parts, axis=0)
