"""Session state for resilient runs: the recovery cache and packed shards.

A run that sees the same straggler pattern or the same dataset again should
not pay the host prelude again.  :class:`ResilienceSession` owns that state:

* a pattern-keyed cache (alive-mask bytes → ``RecoveryResult``) of the
  host recovery solve, shared by every consumer;
* a per-pattern coverage validation (the all-dead guard);
* the packed shards, cached per points object, content fingerprint and
  assignment, and their device copy (:meth:`device_shards`).

This is the slim first slice of the reference's ``core/resilience.py``:
``observe``, elastic patching, ``step_cost`` and permanent loss/join wait
for ROADMAP queue 1, item 8.  Counters are a plain dataclass until
``repro.obs`` is ported.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Union

import numpy as np
import torch

from .assignment import Assignment
from .executor import Executor, get_executor
from .recovery import RecoveryResult, solve_recovery

__all__ = ["SessionStats", "ResilienceSession"]


@dataclasses.dataclass
class SessionStats:
    host_solves: int = 0      # host LP/NNLS solves
    cache_hits: int = 0       # pattern-cache hits
    coverage_checks: int = 0  # per-pattern coverage validations computed
    packs: int = 0            # host shard packings
    device_copies: int = 0    # host-to-device copies of the packed shards

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ResilienceSession:
    """Owns (assignment, recovery solver, per-pattern cache, packed shards)."""

    def __init__(
        self,
        assignment: Assignment,
        *,
        recovery_method: str = "auto",
        executor: Union[None, str, Executor] = None,
    ):
        self.assignment = assignment
        self.recovery_method = recovery_method
        self.executor = get_executor(executor)
        self.stats = SessionStats()
        self._cache: dict[bytes, RecoveryResult] = {}
        self._coverage: dict[bytes, tuple[bool, np.ndarray]] = {}
        self._pack_src = None
        self._pack_fp: Optional[bytes] = None
        self._packed: Optional[tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        self._resident: Optional[tuple[torch.Tensor, ...]] = None
        self._resident_key = None

    def recovery(self, alive: np.ndarray) -> RecoveryResult:
        """Cached host solve for one alive pattern."""
        alive = np.asarray(alive, dtype=bool)
        key = alive.tobytes()
        hit = self._cache.get(key)
        if hit is not None:
            self.stats.cache_hits += 1
            return hit
        res = solve_recovery(self.assignment, alive, method=self.recovery_method)
        self.stats.host_solves += 1
        self._cache[key] = res
        return res

    def validate_coverage(
        self, alive: np.ndarray, rec: Optional[RecoveryResult] = None
    ) -> np.ndarray:
        """Cached per-pattern coverage validation; returns the uncovered
        shard ids.  Raises if no surviving node holds any data."""
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

    def prepare(self, points, alive):
        """The shared prelude of every distributed algorithm: dtype coercion,
        cached recovery solve, all-dead guard, packed shards.

        Returns ``(points, alive, rec, executor, xs, ws)`` with numpy arrays.
        """
        alive = np.asarray(alive, dtype=bool)
        rec = self.recovery(alive)
        self.validate_coverage(alive, rec)
        pts32, xs, ws = self._packed_shards(points)
        return pts32, alive, rec, self.executor, xs, ws

    def device_shards(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(points, xs, ws) of the last :meth:`prepare` on ``device``; copied
        once per packing and device."""
        if self._packed is None:
            raise RuntimeError("device_shards() needs a prepare() first")
        key = (self.stats.packs, str(torch.device(device)))
        if self._resident_key != key:
            self._resident = tuple(torch.from_numpy(a).to(device) for a in self._packed)
            self._resident_key = key
            self.stats.device_copies += 1
        return self._resident

    @staticmethod
    def _fingerprint(points) -> bytes:
        """Cheap content hash: identity alone would serve stale packs after
        an in-place mutation of the caller's array."""
        a = np.ascontiguousarray(np.asarray(points))
        h = hashlib.blake2b(digest_size=16)
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
        return h.digest()

    def _packed_shards(self, points):
        fp = self._fingerprint(points)
        if self._packed is not None and self._pack_src is points and self._pack_fp == fp:
            return self._packed
        from .kmedian import pack_local_shards

        pts32 = np.ascontiguousarray(points, dtype=np.float32)
        xs, ws = pack_local_shards(pts32, self.assignment)
        self._pack_src = points
        self._pack_fp = fp
        self._packed = (pts32, xs, ws)
        self.stats.packs += 1
        return self._packed
