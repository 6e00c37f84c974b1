"""What the program's own spans say about a traced window.

The program records its layer boundaries as spans
(``repro_torch.obs.trace_span``: ``ts`` on ``time.perf_counter``, ``dur_us``).
``run.traced`` lays the spans that closed in the window over the device's
trace beside the benchmark's own ranges, so each span is a host range on
the trace's clock.  A kernel belongs to a span when the call that launched
it was made while a span of that name was open: attribution goes by launch
time, not by thread, so the backward's kernels, launched from autograd's
device thread while the main thread waits inside ``train.backward``, count
there.  Span names are matched exactly, and the benchmark's ``perfbench.``
ranges are never read here.
"""

from __future__ import annotations

import bisect
import dataclasses
import weakref

from .devtrace import union

_INDEX: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclasses.dataclass
class SpanReading:
    spans: int         # spans of the name that closed in the window
    host_s: float      # their host durations, summed
    device_s: float    # device seconds of the kernels launched inside them
    kernels: int       # how many kernels that is
    extents_s: list    # per span: first launched kernel's start to last one's end (0 with none)


def _launches(trace):
    """The window's kernels with a launch record, by launch time: (launch
    times, the kernels in that order); built once a trace."""
    index = _INDEX.get(trace)
    if index is None:
        ks = sorted((k for k in trace.kernels() if k.launch is not None), key=lambda k: k.launch)
        index = _INDEX[trace] = ([k.launch for k in ks], ks)
    return index


def _inside(trace, start: int, end: int) -> list:
    times, ks = _launches(trace)
    return ks[bisect.bisect_left(times, start):bisect.bisect_right(times, end)]


def reading(run, name: str) -> SpanReading | None:
    """The kernels under the spans named ``name`` in ``run``'s window; None
    when no such span closed in it, or when the program's span ring filled
    (spans were then lost, and the reading would be too low)."""
    from repro_torch.obs import default_buffer

    rows = [s for s in run.spans if s["name"] == name]
    if not rows or len(run.spans) >= default_buffer().capacity:
        return None
    ranges = [(r.start, r.end) for r in run.trace.ranges if r.name == name]
    under = [k for s, e in union(ranges) for k in _inside(run.trace, s, e)]
    extents = []
    for s, e in ranges:
        ks = _inside(run.trace, s, e)
        extents.append((max(k.end for k in ks) - min(k.start for k in ks)) / 1e9 if ks else 0.0)
    return SpanReading(spans=len(rows), host_s=sum(r["dur_us"] for r in rows) / 1e6,
                       device_s=sum(k.end - k.start for k in under) / 1e9, kernels=len(under),
                       extents_s=extents)
