"""Streaming resilient clustering (`repro_torch.stream`).

The reference package's ``stream/`` in PyTorch: the paper's redundancy
guarantee pushed to arriving data via Feldman–Langberg merge-and-reduce.
Each level of a bounded-memory coreset tree is a set of buckets treated as
shards, placed redundantly per :mod:`repro_torch.core.assignment`,
compacted through the executor seam and recovered with the pattern-keyed
cache of a :class:`~repro_torch.core.resilience.ResilienceSession`.

* :mod:`repro_torch.stream.buffer` — the merge-and-reduce tree itself.
* :mod:`repro_torch.stream.session` — :class:`StreamingSession`.
* :mod:`repro_torch.stream.query` — batched nearest-center queries with a
  per-query staleness bound.
"""

from .buffer import Bucket, StreamBuffer  # noqa: F401
from .query import QueryEngine, QueryResult  # noqa: F401
from .session import StreamingSession, StreamSolveResult  # noqa: F401

__all__ = [
    "Bucket",
    "StreamBuffer",
    "QueryEngine",
    "QueryResult",
    "StreamingSession",
    "StreamSolveResult",
]
