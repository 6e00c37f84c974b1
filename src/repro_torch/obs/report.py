"""Rendering for obs-report: metrics dump + trace export + text summary.

Call :func:`write_report` after driving a workload; everything here reads the default registry and
default trace buffer, so it also works in-process after any bench run.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

from ..analysis import compiled_path
from .metrics import MetricsRegistry, default_registry
from .trace import TraceBuffer, default_buffer

__all__ = ["span_summary", "summary_lines", "write_report"]

METRICS_FILE = "OBS_metrics.prom"
TRACE_FILE = "OBS_trace.jsonl"


def span_summary(registry: Optional[MetricsRegistry] = None) -> List[Tuple[str, int, float, float, float]]:
    """Per-span-name rows ``(name, count, p50_us, p99_us, mean_us)`` from the
    ``obs_span_us`` histograms, busiest first."""
    reg = registry if registry is not None else default_registry()
    rows = []
    for key, snap in reg.collect().get("obs_span_us", {}).items():
        name = dict(key).get("name", "?")
        if snap.count:
            rows.append(
                (name, snap.count, snap.percentile(0.5), snap.percentile(0.99), snap.mean)
            )
    rows.sort(key=lambda r: -r[1])
    return rows


def _fmt_us(v: float) -> str:
    if v >= 1e6:
        return f"{v / 1e6:.2f}s"
    if v >= 1e3:
        return f"{v / 1e3:.1f}ms"
    return f"{v:.0f}µs"


def summary_lines(
    registry: Optional[MetricsRegistry] = None,
    buffer: Optional[TraceBuffer] = None,
) -> List[str]:
    """Human-readable digest: span latencies, tier counters, node health."""
    reg = registry if registry is not None else default_registry()
    buf = buffer if buffer is not None else default_buffer()
    collected = reg.collect()
    lines: List[str] = []

    spans = span_summary(reg)
    if spans:
        lines.append("spans (busiest first):")
        for name, count, p50, p99, mean in spans:
            lines.append(
                f"  {name:<28s} n={count:<6d} p50={_fmt_us(p50):>8s}"
                f" p99={_fmt_us(p99):>8s} mean={_fmt_us(mean):>8s}"
            )

    hits = reg.sum("resilience_cache_hits")
    host = reg.sum("resilience_host_solves")
    device = reg.sum("resilience_device_solves")
    lookups = hits + host + device
    if lookups:
        lines.append(
            f"recovery cache: {int(hits)}/{int(lookups)} hits "
            f"({hits / lookups:.1%}; host_solves={int(host)} "
            f"device_solves={int(device)})"
        )

    health = collected.get("node_straggle_ewma", {})
    if health:
        lines.append("per-node straggle EWMA (1.0 = always straggling):")
        for key in sorted(health, key=lambda k: -health[k]):
            labels = dict(key)
            lines.append(
                f"  session={labels.get('session', '?'):<6s} "
                f"node={labels.get('node', '?'):>3s}  {health[key]:.3f}"
            )

    lat = collected.get("serve_latency_us", {})
    if any(s.count for s in lat.values()):
        lines.append("serve latency by tenant:")
        for key, snap in sorted(lat.items()):
            if not snap.count:
                continue
            tenant = dict(key).get("tenant", "?")
            lines.append(
                f"  tenant={tenant:<10s} n={snap.count:<6d}"
                f" p50={_fmt_us(snap.percentile(0.5)):>8s}"
                f" p99={_fmt_us(snap.percentile(0.99)):>8s}"
            )

    bs = buf.stats
    lines.append(
        f"trace buffer: {bs['buffered']}/{bs['capacity']} buffered, "
        f"{bs['recorded']} recorded, {bs['dropped']} dropped"
    )
    return lines


@compiled_path("obs.report", kind="host")
def write_report(
    out_dir: str,
    registry: Optional[MetricsRegistry] = None,
    buffer: Optional[TraceBuffer] = None,
) -> Tuple[str, str]:
    """Write ``OBS_metrics.prom`` + ``OBS_trace.jsonl`` under ``out_dir``;
    returns the two paths."""
    reg = registry if registry is not None else default_registry()
    buf = buffer if buffer is not None else default_buffer()
    os.makedirs(out_dir, exist_ok=True)
    metrics_path = os.path.join(out_dir, METRICS_FILE)
    trace_path = os.path.join(out_dir, TRACE_FILE)
    with open(metrics_path, "w", encoding="utf-8") as f:
        f.write(reg.render_prom())
    # Truncate, then append the full ring: repeated reports don't accumulate.
    open(trace_path, "w", encoding="utf-8").close()
    buf.export_jsonl(trace_path)
    return metrics_path, trace_path
