"""Sans-io micro-batcher: shape-bucketed collection of concurrent queries.

A copy of the reference package's ``serve/batcher.py`` (numpy and the
standard library only), kept in the port so that it imports nothing of
the reference.

Concurrent queries against the same tenant and dimensionality are collected
into one open :class:`Batch` per ``(tenant, d)`` bucket.  A bucket closes —
and becomes one ``assign_min`` dispatch — when either

* the **batch window** elapses (first-submit-anchored: the clock starts at
  the first ticket in the bucket, so no ticket waits more than ``window``), or
* the bucket reaches **max_batch** rows (closed immediately on the submit
  that fills it — a full batch never waits out its window).

The batcher holds no threads, timers, or futures: callers pass ``now``
explicitly and drain closed batches via :meth:`poll`.  That makes the whole
concurrency surface a deterministic state machine the test suite can drive
with a :class:`~repro_torch.serve.clock.VirtualClock`.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Ticket", "Batch", "MicroBatcher"]

# Ticket lifecycle: pending → done | rejected.
PENDING = "pending"
DONE = "done"
REJECTED = "rejected"

_ticket_ids = itertools.count(1)


@dataclasses.dataclass
class Ticket:
    """One submitted query (a row-batch from one caller) and its outcome."""

    tenant: str
    queries: np.ndarray                       # (m, d) float32
    submitted_at: float
    max_staleness_points: Optional[int] = None
    max_staleness_ingests: Optional[int] = None
    id: int = dataclasses.field(default_factory=lambda: next(_ticket_ids))
    state: str = PENDING
    result: object = None                     # QueryResult once done
    error: Optional[str] = None               # reason once rejected
    from_cache: bool = False
    # Completion hook for the async shell; called exactly once with the
    # ticket after it leaves PENDING.  The sans-io core never awaits.
    waiter: Optional[Callable] = None

    @property
    def done(self) -> bool:
        return self.state != PENDING

    @property
    def rows(self) -> int:
        return int(self.queries.shape[0])

    def _complete(self, result) -> None:
        self.result = result
        self.state = DONE
        if self.waiter is not None:
            self.waiter(self)

    def _reject(self, reason: str) -> None:
        self.error = reason
        self.state = REJECTED
        if self.waiter is not None:
            self.waiter(self)


@dataclasses.dataclass
class Batch:
    """One closed (or still-open) shape bucket: tickets sharing (tenant, d)."""

    key: Tuple[str, int]                      # (tenant, d)
    opened_at: float
    tickets: List[Ticket] = dataclasses.field(default_factory=list)

    @property
    def tenant(self) -> str:
        return self.key[0]

    @property
    def rows(self) -> int:
        return sum(t.rows for t in self.tickets)

    def deadline(self, window: float) -> float:
        return self.opened_at + window


class MicroBatcher:
    """Pure collection state: open buckets in, closed batches out."""

    def __init__(self, *, window: float, max_batch: int):
        if window < 0:
            raise ValueError(f"window must be >= 0, got {window}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.window = float(window)
        self.max_batch = int(max_batch)
        self._open: Dict[Tuple[str, int], Batch] = {}
        self._closed: List[Batch] = []
        # Counters for BENCH_serve / stats.
        self.rows_in = 0
        self.batches_closed = 0
        self.window_closes = 0                # closed because the window hit
        self.size_closes = 0                  # closed because max_batch hit

    # ------------------------------------------------------------- intake

    def submit(self, ticket: Ticket, now: float) -> None:
        """Add one ticket to its (tenant, d) bucket, closing the bucket
        immediately if this submit filled it."""
        key = (ticket.tenant, int(ticket.queries.shape[1]))
        batch = self._open.get(key)
        if batch is None:
            batch = self._open[key] = Batch(key=key, opened_at=now)
        batch.tickets.append(ticket)
        self.rows_in += ticket.rows
        if batch.rows >= self.max_batch:
            self._close(key, why="size")

    # ------------------------------------------------------------- drain

    def due(self, now: float) -> Optional[float]:
        """Earliest moment a poll will produce work: ``now`` if anything is
        already closed or overdue, else the nearest open deadline, else None."""
        if self._closed:
            return now
        deadlines = [b.deadline(self.window) for b in self._open.values()]
        if not deadlines:
            return None
        return max(min(deadlines), now) if min(deadlines) > now else now

    def poll(self, now: float) -> List[Batch]:
        """Close every bucket whose window has elapsed; return and forget all
        closed batches (size-closed ones from earlier submits included)."""
        for key in [k for k, b in self._open.items()
                    if now >= b.deadline(self.window)]:
            self._close(key, why="window")
        out, self._closed = self._closed, []
        return out

    def drain(self) -> List[Batch]:
        """Close and return everything regardless of windows (shutdown path)."""
        for key in list(self._open):
            self._close(key, why="window")
        out, self._closed = self._closed, []
        return out

    def _close(self, key: Tuple[str, int], *, why: str) -> None:
        self._closed.append(self._open.pop(key))
        self.batches_closed += 1
        if why == "size":
            self.size_closes += 1
        else:
            self.window_closes += 1

    # ------------------------------------------------------------- stats

    @property
    def pending(self) -> int:
        return sum(len(b.tickets) for b in self._open.values()) + sum(
            len(b.tickets) for b in self._closed
        )
