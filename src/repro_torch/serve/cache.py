"""Assignment-result cache for repeat / near-duplicate queries.

A copy of the reference package's ``serve/cache.py`` (numpy and the
standard library only), kept in the port so that it imports nothing of
the reference.

Keys bind the *answer* to the exact model state that produced it:

    (tenant, generation, digest-of-quantized-query-rows)

where ``generation`` is the session's ``(version, ingests)`` pair.  Any
ingest or re-solve changes the generation, so a stale entry can never be
*hit* — it is simply unreachable under the new key.  ``invalidate(tenant)``
additionally evicts the unreachable entries eagerly so a hot tenant that
re-solves often doesn't fill the LRU with dead generations.

Because the generation pins the ingest count, a cached answer's staleness
bound is *identical* to what a fresh dispatch at the same generation would
report — the property test of ``tests/test_torch_serve.py`` holds that
cached answers never violate a per-query staleness bound that a fresh
answer would satisfy.

Near-duplicate matching: query rows are quantized (rounded to ``quantize``
decimals, default 6) before hashing, so float jitter below the quantization
step maps to the same key.  The *cached* answer was computed from the first
seen representative — safe because two queries equal after rounding have
(for any sane data scale) the same nearest center.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

__all__ = ["AssignmentCache"]


class AssignmentCache:
    """Bounded LRU of (tenant, generation, query-digest) → QueryResult."""

    def __init__(self, maxsize: int = 1024, *, quantize: int = 6):
        if maxsize < 0:
            raise ValueError(f"maxsize must be >= 0, got {maxsize}")
        self.maxsize = int(maxsize)
        self.quantize = int(quantize)
        self._data: "OrderedDict[tuple, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    # -------------------------------------------------------------- keys

    def key(self, tenant: str, generation: Tuple[int, int], queries: np.ndarray) -> tuple:
        q = np.round(np.asarray(queries, np.float32), self.quantize).astype(np.float32)
        digest = hashlib.sha1(q.tobytes()).hexdigest()
        return (tenant, tuple(generation), q.shape, digest)

    # ------------------------------------------------------------ lookup

    def get(self, key: tuple):
        """Cached QueryResult or None; a hit refreshes LRU recency."""
        hit = self._data.get(key)
        if hit is None:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return hit

    def put(self, key: tuple, result) -> None:
        if self.maxsize == 0:
            return
        self._data[key] = result
        self._data.move_to_end(key)
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            self.evictions += 1

    def invalidate(self, tenant: str, *, keep_generation: Optional[Tuple[int, int]] = None) -> int:
        """Eagerly drop a tenant's entries (all of them, or every generation
        except ``keep_generation``).  Returns the number evicted."""
        dead = [
            k for k in self._data
            if k[0] == tenant and (keep_generation is None or k[1] != tuple(keep_generation))
        ]
        for k in dead:
            del self._data[k]
        self.invalidations += len(dead)
        return len(dead)

    # ------------------------------------------------------------- stats

    def __len__(self) -> int:
        return len(self._data)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def stats(self) -> dict:
        return {
            "size": len(self._data),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
        }
