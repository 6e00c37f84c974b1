"""Structured tracing: nested host-side spans over the compiled tiers.

A *span* is one timed host-side operation — a serve dispatch, a recovery
solve, a streaming compaction, an autotune measurement pass — with monotonic
start/end timestamps, a parent (spans nest through a ``contextvars`` stack,
so the tree is correct under asyncio interleaving and threads), and a small
attribute dict (``tenant=…, node=…, shard=…, pattern=…``).

All of this is plain host Python: a span reads no device value and launches
nothing, so it may sit inside an eager step (the layer boundaries of a solve
and of a training step), where it times the host's launches and the device
work is found by what was launched inside it.  Finished spans land in a process-wide fixed-capacity
ring buffer (:class:`TraceBuffer`; ``REPRO_OBS_BUFFER`` rows, default 4096 —
overflow evicts the oldest and is counted, never grows) and export as JSONL
(:func:`export_jsonl`) for offline timeline assembly; each span also feeds
the ``obs_span_us{name=…}`` histogram in the default metrics registry so
``obs-report`` shows latency distributions without replaying the trace.

Gating: ``REPRO_OBS=0`` disables span recording (counters stay on — they are
the tiers' stats objects).  A span's ``ts`` is on ``time.perf_counter``, so a
profiler trace whose clock is tied to the host's places the device's kernels
inside the spans that launched them.

The clock is a module seam (:func:`set_clock`) mirroring the serving tier's
``VirtualClock`` pattern: the span-tree tests drive a fake monotonic clock
and assert exact timestamps — zero sleeps.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import threading
import time
from typing import Callable, List, Optional

from ..analysis import compiled_path
from .metrics import default_registry, log_bounds

__all__ = [
    "Span",
    "TraceBuffer",
    "configure_buffer",
    "default_buffer",
    "export_jsonl",
    "obs_enabled",
    "set_clock",
    "trace_span",
]

OBS_ENV = "REPRO_OBS"                  # opt-out: 0/off disables span recording
BUFFER_ENV = "REPRO_OBS_BUFFER"        # ring capacity (rows)

_OFF_VALUES = ("0", "off", "false", "no", "none")
DEFAULT_BUFFER_ROWS = 4096

# Latency spans span ~µs (cache hit) to ~minutes (mesh solve): µs-resolution
# log buckets, one shared shape for every obs_span_us series.
SPAN_BOUNDS = log_bounds(1.0, 1e8, 2.0)


def obs_enabled() -> bool:
    """Span recording on?  Default ON; ``REPRO_OBS=0`` opts out."""
    return os.environ.get(OBS_ENV, "1").strip().lower() not in _OFF_VALUES


def _buffer_rows() -> int:
    try:
        return max(1, int(os.environ.get(BUFFER_ENV, str(DEFAULT_BUFFER_ROWS))))
    except ValueError:
        return DEFAULT_BUFFER_ROWS


# Monotonic clock seam (tests swap in a fake; see module docstring).
_clock: Callable[[], float] = time.perf_counter


def set_clock(clock: Callable[[], float]) -> Callable[[], float]:
    """Swap the span clock; returns the previous one (restore in teardown)."""
    global _clock
    prev, _clock = _clock, clock
    return prev


_span_ids = itertools.count(1)
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_obs_current_span", default=None
)


class Span:
    """One in-flight (then finished) span.  Created by :func:`trace_span`."""

    __slots__ = (
        "name", "span_id", "parent_id", "t_start", "t_end", "attrs",
        "_token",
    )

    def __init__(self, name: str, parent_id: Optional[int], attrs: dict):
        self.name = name
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self.t_start = _clock()
        self.t_end: Optional[float] = None
        self.attrs = attrs
        self._token = None

    def set_attr(self, **kw) -> "Span":
        """Attach attributes discovered mid-span (e.g. rows dispatched)."""
        self.attrs.update(kw)
        return self

    @property
    def duration_us(self) -> float:
        end = self.t_end if self.t_end is not None else _clock()
        return (end - self.t_start) * 1e6

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "span": self.span_id,
            "parent": self.parent_id,
            "ts": self.t_start,
            "dur_us": self.duration_us,
            "attrs": self.attrs,
        }


class _NullSpan:
    """The shared do-nothing span handed out when ``REPRO_OBS=0``."""

    __slots__ = ()
    name = ""
    span_id = 0
    parent_id = None
    attrs: dict = {}
    duration_us = 0.0

    def set_attr(self, **kw) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class TraceBuffer:
    """Fixed-capacity ring of finished spans + a serialized JSONL exporter."""

    def __init__(self, capacity: Optional[int] = None):
        self.capacity = _buffer_rows() if capacity is None else max(1, int(capacity))
        self._rows: List[dict] = []
        self._next = 0
        self.recorded = 0
        self.dropped = 0       # evicted by overflow (ring semantics)
        self.exported = 0
        self._lock = threading.Lock()

    def record(self, row: dict) -> None:
        with self._lock:
            self.recorded += 1
            if len(self._rows) < self.capacity:
                self._rows.append(row)
            else:
                self._rows[self._next] = row
                self._next = (self._next + 1) % self.capacity
                self.dropped += 1

    def rows(self) -> List[dict]:
        """Buffered spans, oldest first."""
        with self._lock:
            return self._rows[self._next:] + self._rows[: self._next]

    def clear(self) -> None:
        with self._lock:
            self._rows = []
            self._next = 0

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "buffered": len(self._rows),
                "recorded": self.recorded,
                "dropped": self.dropped,
                "exported": self.exported,
            }

    def export_jsonl(self, path: str, *, clear: bool = False) -> int:
        """Append the buffered spans to ``path`` as JSONL; returns the row
        count.  The whole buffer goes out in ONE ``write`` of pre-joined
        lines under the buffer lock, so concurrent exporters (and recorders)
        interleave at line granularity — every line in the file is valid
        JSON no matter how many threads export at once."""
        with self._lock:
            rows = self._rows[self._next:] + self._rows[: self._next]
            payload = "".join(json.dumps(r, sort_keys=True) + "\n" for r in rows)
            if clear:
                self._rows = []
                self._next = 0
            self.exported += len(rows)
            with open(path, "a", encoding="utf-8") as f:
                f.write(payload)
        return len(rows)


_BUFFER = TraceBuffer()


def default_buffer() -> TraceBuffer:
    """The process-wide span ring ``trace_span`` records into."""
    return _BUFFER


def configure_buffer(capacity: Optional[int] = None) -> TraceBuffer:
    """Replace the process-wide buffer (fresh ring, e.g. per report run or
    per test); returns the new buffer."""
    global _BUFFER
    _BUFFER = TraceBuffer(capacity)
    return _BUFFER


@compiled_path("obs.export", kind="host")
def export_jsonl(path: str, *, clear: bool = False) -> int:
    """Export the default buffer (see :meth:`TraceBuffer.export_jsonl`)."""
    return _BUFFER.export_jsonl(path, clear=clear)


class trace_span:
    """``with trace_span("serve.dispatch", tenant=t) as sp:`` — one span.

    Class-based (not ``@contextmanager``) to keep the disabled path at two
    attribute checks and zero generator frames: the serving hot path enters
    one of these per dispatch.
    """

    __slots__ = ("_name", "_attrs", "_span")

    def __init__(self, name: str, **attrs):
        self._name = name
        self._attrs = attrs
        self._span: object = _NULL_SPAN

    def __enter__(self):
        if not obs_enabled():
            return _NULL_SPAN
        parent = _current.get()
        span = Span(
            self._name,
            parent.span_id if parent is not None else None,
            self._attrs,
        )
        span._token = _current.set(span)
        self._span = span
        return span

    def __exit__(self, exc_type, exc, tb):
        span = self._span
        if span is _NULL_SPAN:
            return False
        _current.reset(span._token)
        span.t_end = _clock()
        if exc_type is not None:
            span.attrs.setdefault("error", exc_type.__name__)
        _BUFFER.record(span.as_dict())
        default_registry().histogram(
            "obs_span_us", labels={"name": span.name}, bounds=SPAN_BOUNDS,
            help="span durations by name (µs)",
        ).observe(span.duration_us)
        return False
