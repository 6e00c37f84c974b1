"""Bounded-memory merge-and-reduce coreset tree with redundant bucket placement.

The reference package's ``stream/buffer.py`` in PyTorch.  Arriving points
fill a raw *leaf* buffer; every full leaf is reduced to an m-point
sensitivity coreset (a level-0 *bucket*); whenever a level holds
``fanout`` buckets they are merged and reduced into one bucket a level up.
Memory is ``O(leaf + fanout · m · levels)`` with ``levels = O(log n)``.

The tree is straggler-proof:

* **Buckets are shards.**  The ``fanout`` buckets of a compaction are the
  shard set of an :class:`~repro_torch.core.assignment.Assignment`, so
  every bucket lives on ``ℓ`` nodes.  A compaction under an alive mask
  recovers each bucket's mass ``a_j = (bᵀA_R)_j ∈ [1, 1+δ]`` through the
  session's cached host solve; replicas are verbatim copies, so the
  Lemma-3 b-weighted union is the canonical buckets scaled by ``a_j``.
  Under fractional repetition (the streaming default) recovery is exact
  for every coverage-preserving pattern, so the merge equals the
  no-straggler merge.
* **Compactions are replicated compute.**  The reduce
  (:func:`repro_torch.core.coreset._reduce`) runs through
  :meth:`Executor.replicated_compute`; its generator is a pure function of
  ``(seed, seq)``, never of node identity or of the pattern, so every
  replica computes the same bucket.
* **A pattern that would orphan a bucket blocks instead of losing it.**
  The compaction falls back to the all-alive recovery and counts it in
  ``blocking_compactions``.

Buckets, the pending leaf and the frontier are tensors on the session's
device: nothing of the tree goes back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.coreset import _reduce
from ..core.resilience import ResilienceSession
from ..device import resolve_device
from ..obs import trace_span

__all__ = ["Bucket", "StreamBuffer"]

_MASS_SNAP_TOL = 1e-6  # |a_j − 1| below this is LP round-off, not real δ


@dataclasses.dataclass
class Bucket:
    """One node-replicated weighted summary in the tree."""

    points: torch.Tensor   # (m, d) float32, on the session's device
    weights: torch.Tensor  # (m,) float32
    level: int             # 0 = compacted leaf
    seq: int               # creation index, unique across the run

    @property
    def size(self) -> int:
        return int(self.points.shape[0])


def _generator(device: torch.device, seed: int, seq: int) -> torch.Generator:
    """The reduce's generator: a pure function of ``(seed, seq)`` (the twin
    of ``fold_in(PRNGKey(seed), seq)``)."""
    state = int(np.random.SeedSequence([int(seed), int(seq)]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(state)


class StreamBuffer:
    """The merge-and-reduce tree.  Driven by
    :class:`repro_torch.stream.session.StreamingSession`; usable standalone
    with any :class:`~repro_torch.core.resilience.ResilienceSession` whose
    assignment has ``num_shards == fanout``.  ``device`` is where the tree
    lives (the card by default)."""

    def __init__(
        self,
        d: int,
        k: int,
        *,
        session: ResilienceSession,
        leaf_size: int = 512,
        coreset_size: int = 128,
        squared: bool = False,
        bicriteria_iters: int = 4,
        impl: str = "auto",
        seed: int = 0,
        device=None,
    ):
        self.d, self.k = int(d), int(k)
        self.leaf_size = int(leaf_size)
        self.m = int(coreset_size)
        self.session = session
        self.fanout = session.num_shards
        if self.fanout < 2:
            raise ValueError(f"fanout (assignment shards) must be ≥ 2, got {self.fanout}")
        if not 1 <= self.m <= self.leaf_size:
            raise ValueError(
                f"need 1 <= coreset_size <= leaf_size, got {self.m} / {self.leaf_size}"
            )
        self.squared = bool(squared)
        self.bicriteria_iters = int(bicriteria_iters)
        self.impl = impl
        self.seed = int(seed)
        self.device = resolve_device(device)
        self._pending: list[torch.Tensor] = []
        self._pending_n = 0
        self.levels: list[list[Bucket]] = []
        self.compactions = 0            # level compactions (merge+reduce)
        self.leaf_compactions = 0       # raw leaf → level-0 bucket reductions
        self.blocking_compactions = 0   # fell back to all-alive recovery
        self._seq = 0

    # ------------------------------------------------------------- ingest

    def add_batch(self, points, alive: Optional[np.ndarray] = None) -> dict:
        """Buffer arriving points (host or device); compact every full leaf
        and cascade.  ``alive`` is the straggler mask in force for any
        compaction this batch triggers (all alive by default)."""
        pts = torch.as_tensor(points, dtype=torch.float32).to(self.device)
        if pts.dim() != 2 or pts.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) batch, got {tuple(pts.shape)}")
        alive = (
            np.ones(self.session.num_nodes, dtype=bool)
            if alive is None
            else np.asarray(alive, dtype=bool)
        )
        c0, l0, b0 = self.compactions, self.leaf_compactions, self.blocking_compactions
        if len(pts):
            self._pending.append(pts)
            self._pending_n += len(pts)
        while self._pending_n >= self.leaf_size:
            leaf = self._pop_leaf()
            ones = torch.ones(len(leaf), dtype=torch.float32, device=self.device)
            self._push(self._reduce(leaf, ones, level=0), alive)
        return {
            "leaves": self.leaf_compactions - l0,
            "compactions": self.compactions - c0,
            "blocking": self.blocking_compactions - b0,
            "buckets": self.num_buckets,
            "levels": len(self.levels),
            "pending": self._pending_n,
        }

    def _pop_leaf(self) -> torch.Tensor:
        out, need = [], self.leaf_size
        while need:
            head = self._pending[0]
            if len(head) <= need:
                out.append(head)
                need -= len(head)
                self._pending.pop(0)
            else:
                out.append(head[:need])
                self._pending[0] = head[need:]
                need = 0
        self._pending_n -= self.leaf_size
        return torch.cat(out, dim=0)

    # -------------------------------------------------------- compactions

    def _push(self, bucket: Bucket, alive: np.ndarray) -> None:
        while len(self.levels) <= bucket.level:
            self.levels.append([])
        self.levels[bucket.level].append(bucket)
        lvl = bucket.level
        while lvl < len(self.levels) and len(self.levels[lvl]) >= self.fanout:
            group = self.levels[lvl][: self.fanout]
            del self.levels[lvl][: self.fanout]
            merged_x, merged_w = self._recovered_merge(group, alive)
            nb = self._reduce(merged_x, merged_w, level=lvl + 1)
            self.compactions += 1
            while len(self.levels) <= nb.level:
                self.levels.append([])
            self.levels[nb.level].append(nb)
            lvl += 1

    def _recovered_merge(
        self, buckets: list[Bucket], alive: np.ndarray
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Lemma-3 recovery of one level group: per-bucket masses from the
        session's pattern-keyed cached solve, the canonical buckets' weights
        scaled by them."""
        sess = self.session
        if not alive.any():
            self.blocking_compactions += 1
            alive = np.ones(sess.num_nodes, dtype=bool)
        rec = sess.recovery(alive)
        if len(rec.uncovered) or not np.any(rec.b_full > 0):
            # The pattern would orphan a bucket: wait out the stragglers
            # rather than lose a level.
            self.blocking_compactions += 1
            rec = sess.recovery(np.ones(sess.num_nodes, dtype=bool))
            if len(rec.uncovered):
                raise ValueError(
                    "bucket assignment leaves shards uncovered even with all "
                    f"nodes alive (scheme {sess.assignment.scheme!r})"
                )
        a = np.asarray(rec.a, np.float64)
        masses = np.where(np.abs(a - 1.0) <= _MASS_SNAP_TOL, 1.0, a).astype(np.float32)
        xs = torch.cat([b.points for b in buckets], dim=0)
        ws = torch.cat([b.weights * float(masses[j]) for j, b in enumerate(buckets)], dim=0)
        return xs, ws

    def _reduce(self, x: torch.Tensor, w: torch.Tensor, level: int) -> Bucket:
        """Reduce a (merged) weighted summary to an m-point bucket, computed
        redundantly on every node through the executor seam."""
        gen = _generator(self.device, self.seed, self._seq)

        def fn(x, w):
            return _reduce(
                x, w, k=self.k, m=self.m, squared=self.squared,
                bicriteria_iters=self.bicriteria_iters, impl=self.impl, generator=gen,
            )

        with trace_span("stream.compaction", level=level, rows=int(x.shape[0])):
            pts, wts = self.session.executor.replicated_compute(fn, (x, w))
        if level == 0:
            self.leaf_compactions += 1
        b = Bucket(points=pts, weights=wts, level=level, seq=self._seq)
        self._seq += 1
        return b

    # ----------------------------------------------------------- frontier

    @property
    def num_buckets(self) -> int:
        return sum(len(lv) for lv in self.levels)

    @property
    def summary_points(self) -> int:
        """Points held across all buckets (the memory bound, minus the leaf)."""
        return sum(b.size for lv in self.levels for b in lv)

    def frontier(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The tree's current weighted summary on the device: all buckets
        plus the raw (not yet compacted) leaf buffer at weight 1."""
        xs = [b.points for lv in self.levels for b in lv] + list(self._pending)
        ws = [b.weights for lv in self.levels for b in lv] + [
            torch.ones(len(p), dtype=torch.float32, device=self.device) for p in self._pending
        ]
        if not xs:
            return (
                torch.zeros((0, self.d), dtype=torch.float32, device=self.device),
                torch.zeros((0,), dtype=torch.float32, device=self.device),
            )
        return torch.cat(xs, dim=0), torch.cat(ws, dim=0)
