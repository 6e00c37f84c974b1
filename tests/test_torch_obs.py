"""The port's observability layer (``repro_torch.obs``, a copy of the
reference package's ``obs/``) as a unit: the reference's ``tests/test_obs.py``
run against the port's copy, then the port's percentiles, histogram
snapshots and Prometheus text held equal to the reference's on the same
samples.

Everything here runs against a FRESH registry + trace buffer + fake clock
(the ``fresh_obs`` fixture) so tests neither see nor pollute the process-wide
instruments the instrumented tiers share.  Deterministic throughout: the span
tree drives :func:`repro_torch.obs.set_clock` (zero sleeps), and the EWMA test
scripts a straggler scenario and replays the recurrence by hand.
"""

from __future__ import annotations

import dataclasses
import json
import threading

import numpy as np
import pytest

from repro_torch.obs import (
    Histogram,
    MetricsRegistry,
    StatsView,
    TraceBuffer,
    default_registry,
    log_bounds,
    percentile,
    set_clock,
    set_default_registry,
    trace_span,
)
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.report import summary_lines, write_report


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def tick(self, dt: float) -> None:
        self.t += dt


@pytest.fixture()
def fresh_obs(monkeypatch):
    """Fresh registry, fresh 64-row buffer, fake clock; all restored after."""
    monkeypatch.delenv("REPRO_OBS", raising=False)
    prev_reg = set_default_registry(MetricsRegistry())
    prev_buf = trace_mod._BUFFER
    buf = trace_mod.configure_buffer(64)
    clock = FakeClock()
    prev_clock = set_clock(clock)
    yield default_registry(), buf, clock
    set_clock(prev_clock)
    trace_mod._BUFFER = prev_buf
    set_default_registry(prev_reg)


# --------------------------------------------------------------- percentile


def test_percentile_matches_legacy_bench_serve_formula():
    """THE pin for the emitter migration: the obs nearest-rank percentile
    must reproduce bench_serve's historical hand-rolled formula exactly on
    identical samples — the tracked serve_p50/p99 baselines must not move."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 512):
        lat = np.asarray(sorted(rng.lognormal(size=n)))

        def legacy(p):  # verbatim from the old bench_serve.py pct()
            return float(lat[min(len(lat) - 1, int(p * len(lat)))])

        h = Histogram()
        for v in lat:
            h.observe(float(v))
        snap = h.snapshot()
        for p in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert percentile(lat, p) == legacy(p)
            assert snap.percentile(p) == legacy(p)  # exact: nothing dropped
        assert snap.dropped_samples == 0


def test_percentile_validates():
    with pytest.raises(ValueError, match="empty"):
        percentile([], 0.5)
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        percentile([1.0], 1.5)


# ---------------------------------------------------------------- histogram


def test_histogram_bucket_boundary_edges():
    """A value exactly on a bucket's upper bound lands IN that bucket
    (bisect_left semantics), and values past the last bound overflow."""
    h = Histogram(bounds=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 1.5, 2.0, 4.0, 5.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap.counts == (2, 2, 1, 1)  # le=1: {0.5, 1.0}; le=2: {1.5, 2.0}
    assert snap.count == 6
    assert snap.min == 0.5 and snap.max == 5.0
    assert snap.mean == pytest.approx(14.0 / 6.0)


def test_histogram_estimate_after_sample_eviction_is_conservative():
    h = Histogram(bounds=(1.0, 2.0, 4.0), sample_cap=2)
    for v in (1.0, 3.0, 5.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap.dropped_samples == 1
    exact = percentile([1.0, 3.0, 5.0], 0.5)
    assert snap.percentile(0.5) >= exact          # never an under-estimate
    assert snap.percentile(0.5) == 4.0            # containing bucket's bound
    assert snap.percentile(1.0) == 5.0            # overflow caps at max
    with pytest.raises(ValueError, match="empty"):
        Histogram().snapshot().percentile(0.5)


def test_observe_many_matches_observe():
    """Bulk ingestion is state-for-state identical to one-at-a-time, and
    respects the ring cap/eviction accounting (the serve dispatch path
    records a whole batch through observe_many)."""
    vals = [0.5, 1.0, 7.0, 3.0, 2.0, 9.0, 0.1]
    one = Histogram(bounds=(1.0, 2.0, 4.0), sample_cap=4)
    many = Histogram(bounds=(1.0, 2.0, 4.0), sample_cap=4)
    for v in vals:
        one.observe(v)
    many.observe_many(vals)
    many.observe_many([])  # no-op
    s1, s2 = one.snapshot(), many.snapshot()
    assert s1 == s2
    assert s2.dropped_samples == len(vals) - 4


def test_log_bounds_shape_and_validation():
    b = log_bounds(1.0, 8.0, 2.0)
    assert b == (1.0, 2.0, 4.0, 8.0)
    with pytest.raises(ValueError):
        log_bounds(0.0, 8.0, 2.0)
    with pytest.raises(ValueError):
        log_bounds(1.0, 8.0, 1.0)


# ----------------------------------------------------------------- registry


def test_registry_kind_conflict_and_sum(fresh_obs):
    reg, _, _ = fresh_obs
    reg.counter("x", labels={"a": "1"}).inc(3)
    reg.counter("x", labels={"a": "2"}).inc(4)
    assert reg.sum("x") == 7
    assert reg.value("x", labels={"a": "1"}) == 3
    assert reg.value("never_touched") == 0
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x")


def test_render_prom_layout(fresh_obs):
    reg, _, _ = fresh_obs
    reg.counter("jobs", labels={"tier": "serve"}, help="jobs done").inc(2)
    reg.histogram("lat", bounds=(1.0, 2.0)).observe(1.5)
    text = reg.render_prom()
    assert "# HELP jobs jobs done" in text
    assert '# TYPE jobs counter' in text
    assert 'jobs{tier="serve"} 2' in text
    assert 'lat_bucket{le="2.0"} 1' in text
    assert 'lat_bucket{le="+Inf"} 1' in text
    assert "lat_count 1" in text


def test_stats_view_proxies_counters(fresh_obs):
    reg, _, _ = fresh_obs

    class V(StatsView):
        PREFIX = "v_"
        FIELDS = {"hits": "hits", "misses": "misses"}

    v = V(labels={"session": "s0"})
    v.hits += 2
    v.misses = 5
    assert (v.hits, v.misses) == (2, 5)
    assert reg.value("v_hits", labels={"session": "s0"}) == 2
    snap = v.snapshot()
    v.hits += 10
    v.restore(snap)
    assert v.hits == 2
    with pytest.raises(AttributeError):
        v.nope
    with pytest.raises(AttributeError):
        v.nope = 1
    # Same registry, different labels: independent numbers.
    w = V(labels={"session": "s1"})
    assert w.hits == 0


# -------------------------------------------------------------- span tracing


def test_span_tree_under_fake_clock(fresh_obs):
    reg, buf, clock = fresh_obs
    with trace_span("outer", tier="test") as outer:
        clock.tick(0.001)
        with trace_span("inner") as inner:
            clock.tick(0.0005)
            inner.set_attr(rows=3)
        with trace_span("inner2"):
            clock.tick(0.0002)
    rows = buf.rows()
    assert [r["name"] for r in rows] == ["inner", "inner2", "outer"]
    by_name = {r["name"]: r for r in rows}
    assert by_name["inner"]["parent"] == outer.span_id
    assert by_name["inner2"]["parent"] == outer.span_id
    assert by_name["outer"]["parent"] is None
    assert by_name["outer"]["ts"] == 100.0
    assert by_name["inner"]["ts"] == 100.001
    assert by_name["inner"]["dur_us"] == pytest.approx(500.0)
    assert by_name["inner2"]["dur_us"] == pytest.approx(200.0)
    assert by_name["outer"]["dur_us"] == pytest.approx(1700.0)
    assert by_name["outer"]["attrs"] == {"tier": "test"}
    assert by_name["inner"]["attrs"] == {"rows": 3}
    # Every finished span also feeds the obs_span_us histogram.
    snap = reg.histogram(
        "obs_span_us", labels={"name": "inner"}, bounds=trace_mod.SPAN_BOUNDS
    ).snapshot()
    assert snap.count == 1
    assert snap.samples[0] == pytest.approx(500.0)


def test_span_records_error_attr(fresh_obs):
    _, buf, clock = fresh_obs
    with pytest.raises(RuntimeError):
        with trace_span("boom"):
            clock.tick(0.001)
            raise RuntimeError("x")
    (row,) = buf.rows()
    assert row["attrs"]["error"] == "RuntimeError"
    assert row["dur_us"] == pytest.approx(1000.0)


def test_spans_disabled_by_env(fresh_obs, monkeypatch):
    _, buf, _ = fresh_obs
    monkeypatch.setenv("REPRO_OBS", "0")
    with trace_span("invisible") as sp:
        assert sp is trace_mod._NULL_SPAN
        assert sp.set_attr(x=1) is sp
    assert buf.rows() == []
    assert buf.stats["recorded"] == 0


def test_env_flag_parsing(monkeypatch):
    from repro_torch.obs import obs_enabled

    monkeypatch.delenv("REPRO_OBS", raising=False)
    assert obs_enabled()                      # default on
    monkeypatch.setenv("REPRO_OBS", "off")
    assert not obs_enabled()


# --------------------------------------------------------------- ring buffer


def test_trace_buffer_overflow_counts_and_order():
    buf = TraceBuffer(capacity=4)
    for i in range(10):
        buf.record({"i": i})
    st = buf.stats
    assert st == {
        "capacity": 4, "buffered": 4, "recorded": 10, "dropped": 6,
        "exported": 0,
    }
    assert [r["i"] for r in buf.rows()] == [6, 7, 8, 9]  # oldest first
    buf.clear()
    assert buf.rows() == []
    assert buf.stats["recorded"] == 10  # lifetime counters survive clear


def test_concurrent_writers_export_valid_jsonl(tmp_path):
    """Recorders and exporters race on one buffer + one file; every line of
    the result must still be a complete JSON document."""
    buf = TraceBuffer(capacity=32)
    path = str(tmp_path / "trace.jsonl")
    stop = threading.Event()

    def recorder(tid):
        i = 0
        while not stop.is_set():
            buf.record({"tid": tid, "i": i, "pad": "x" * 64})
            i += 1

    def exporter():
        for _ in range(20):
            buf.export_jsonl(path)

    recs = [threading.Thread(target=recorder, args=(t,)) for t in range(2)]
    exps = [threading.Thread(target=exporter) for _ in range(3)]
    for t in recs + exps:
        t.start()
    for t in exps:
        t.join()
    stop.set()
    for t in recs:
        t.join()
    with open(path, encoding="utf-8") as f:
        lines = f.readlines()
    assert lines, "exporters wrote nothing"
    for line in lines:
        row = json.loads(line)  # no torn/interleaved writes
        assert set(row) == {"tid", "i", "pad"}
    assert buf.stats["exported"] == len(lines)


# ------------------------------------------------------------- node health


def test_node_health_ewma_converges_under_scripted_straggling(fresh_obs, tmp_path):
    """Drive a session with a scripted StragglerScenario (a hand-written
    trace replay: nodes 6 and 7 stuck straggling every round) and check the
    exported per-node EWMA against the closed form: stuck stragglers
    converge toward 1, always-alive nodes stay at 0, and recover (decay)
    once the stragglers come back."""
    from repro_torch.core import ResilienceSession, cyclic_assignment, make_scenario

    reg, _, _ = fresh_obs
    s, rounds = 8, 12
    stuck = [6, 7]
    alive = [1] * s
    for i in stuck:
        alive[i] = 0
    path = tmp_path / "stuck.jsonl"
    path.write_text(json.dumps({"alive": alive}) + "\n", encoding="utf-8")
    scen = make_scenario("trace", s, path=str(path))  # loops the one row
    assert scen.name == "trace" and len(scen) == 1

    sess = ResilienceSession(cyclic_assignment(40, s, 2))
    a = sess.straggle_alpha
    for _ in range(rounds):
        sess.observe(next(scen))
    health = sess.node_health()
    expected = 1.0 - (1.0 - a) ** rounds
    np.testing.assert_allclose(health[stuck], expected, rtol=1e-12)
    mask = np.ones(s, dtype=bool)
    mask[stuck] = False
    assert (health[mask] == 0.0).all()
    # node_health returns a copy, not the live buffer.
    health[:] = -1.0
    assert (sess.node_health() >= 0.0).all()
    # The same numbers are exported as gauges for obs-report.
    for i in range(s):
        got = reg.value(
            "node_straggle_ewma", labels={**sess._obs_labels, "node": str(i)}
        )
        assert got == pytest.approx(expected if i in stuck else 0.0)
    # Recovery: all-alive rounds decay the stuck nodes' EWMA toward 0.
    for _ in range(3):
        sess.observe(np.ones(s, dtype=bool))
    np.testing.assert_allclose(
        sess.node_health()[stuck], expected * (1.0 - a) ** 3, rtol=1e-12
    )


# ------------------------------------------------------------------ report


def test_summary_lines_and_write_report(fresh_obs, tmp_path):
    reg, buf, clock = fresh_obs
    with trace_span("demo.work"):
        clock.tick(0.002)
    reg.counter("resilience_cache_hits", labels={"session": "s0"}).inc(3)
    reg.counter("resilience_device_solves", labels={"session": "s0"}).inc(1)
    reg.gauge("node_straggle_ewma", labels={"session": "s0", "node": "2"}).set(0.5)
    reg.histogram("serve_latency_us", labels={"tenant": "t0"}).observe(250.0)
    lines = summary_lines(reg, buf)
    text = "\n".join(lines)
    assert "demo.work" in text
    assert "recovery cache: 3/4 hits (75.0%" in text
    assert "node=  2  0.500" in text
    assert "tenant=t0" in text
    assert "1 recorded" in text
    metrics_path, trace_path = write_report(str(tmp_path), reg, buf)
    prom = open(metrics_path, encoding="utf-8").read()
    assert 'node_straggle_ewma{node="2",session="s0"} 0.5' in prom
    rows = [json.loads(l) for l in open(trace_path, encoding="utf-8")]
    assert [r["name"] for r in rows] == ["demo.work"]
    # Re-running truncates first: no accumulation across reports.
    write_report(str(tmp_path), reg, buf)
    rows = [json.loads(l) for l in open(trace_path, encoding="utf-8")]
    assert len(rows) == 1


# ------------------------------------------------- parity with the reference


def _lognormal(n, seed):
    return [float(v) for v in np.random.default_rng(seed).lognormal(size=n)]


@pytest.mark.parametrize("n", [1, 7, 100, 5000])
def test_percentile_equals_the_reference(n):
    from repro.obs import percentile as ref_percentile

    vals = _lognormal(n, n)
    for p in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert percentile(vals, p) == ref_percentile(vals, p)


@pytest.mark.parametrize("sample_cap", [None, 16])
def test_histogram_snapshot_equals_the_reference(sample_cap):
    from repro.obs import Histogram as RefHistogram

    kw = {} if sample_cap is None else {"sample_cap": sample_cap}
    vals = _lognormal(300, 3)
    ours, ref = Histogram(**kw), RefHistogram(**kw)
    for v in vals[:100]:
        ours.observe(v)
        ref.observe(v)
    ours.observe_many(vals[100:])
    ref.observe_many(vals[100:])
    a, b = ours.snapshot(), ref.snapshot()
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for p in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert a.percentile(p) == b.percentile(p)


def test_render_prom_equals_the_reference():
    from repro.obs import MetricsRegistry as RefRegistry

    ours, ref = MetricsRegistry(), RefRegistry()
    for reg in (ours, ref):
        reg.counter("resilience_host_solves", labels={"session": "s0"}, help="host").inc(3)
        reg.counter("resilience_host_solves", labels={"session": "s1"}, help="host").inc(1)
        reg.gauge("node_straggle_ewma", labels={"session": "s0", "node": "2"}, help="ewma").set(0.25)
        h = reg.histogram("obs_span_us", labels={"name": "session.step_cost"},
                          bounds=trace_mod.SPAN_BOUNDS, help="spans")
        for v in _lognormal(50, 5):
            h.observe(1e3 * v)
    assert ours.render_prom() == ref.render_prom()
