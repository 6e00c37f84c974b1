"""repro_torch.obs — unified observability: metrics registry + tracing spans.

A copy of the reference package's ``obs/`` (framework-free), kept in the
port so that the port imports nothing of the reference, and the port's
counters kept on the device (:mod:`.device`).

One process-wide :class:`MetricsRegistry` (counters / gauges / log-bucket
histograms, Prometheus text dump) and one :func:`trace_span` API (nested
host-side spans, JSONL ring-buffer export).  Every tier — resilience
sessions, executors, serving, streaming, training, autotune — records
through here; :func:`repro_torch.obs.report.write_report` renders both.

Everything in this package is host-side Python with no torch imports at
module scope; the device counters' adds are the only work it launches on
the device.
"""

from .device import DeviceCounters, default_counters
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    HistogramSnapshot,
    MetricsRegistry,
    StatsView,
    default_registry,
    log_bounds,
    percentile,
    set_default_registry,
)
from .trace import (
    Span,
    TraceBuffer,
    configure_buffer,
    default_buffer,
    export_jsonl,
    obs_enabled,
    set_clock,
    trace_span,
)

__all__ = [
    "Counter",
    "DeviceCounters",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "MetricsRegistry",
    "Span",
    "StatsView",
    "TraceBuffer",
    "configure_buffer",
    "default_buffer",
    "default_counters",
    "default_registry",
    "export_jsonl",
    "log_bounds",
    "obs_enabled",
    "percentile",
    "set_clock",
    "set_default_registry",
    "trace_span",
]
