"""The per-layer metrics that read the program's spans
(``harness/spans.py``): kernels credited to the span whose name matches
exactly, by launch time, as ``run.traced`` lays the spans over the trace;
None with no span or a full ring; every span name a metric reads is one
the program records; and, on the card, a span still holds its own launch
at the end of a long window.
"""

import statistics
import time
from types import SimpleNamespace

import pytest
import torch

import run
from harness import files
from harness.devtrace import DeviceTrace
from harness.spans import reading
from repro_torch.obs import default_buffer

SOLVE_METRICS = ("fingerprint_ms.solve", "seed_device_s.solve", "lloyd_device_s.solve")
TRAIN_METRICS = ("forward_kernels.train", "backward_device_ms.train", "combine_device_ms.train",
                 "adamw_device_ms.train", "recovery_ms.train")
METRICS = SOLVE_METRICS + TRAIN_METRICS
UNITS = 2


class Ev:
    def __init__(self, name, kind, start, dur, corr):
        self._n, self._k, self._s, self._d, self._c = name, kind, start, dur, corr

    def name(self):
        return self._n

    def activity_type(self):
        return self._k

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0


def fake_run(name, *, spans_of=None, pad_to=0):
    """A window of 10 µs on the trace's clock, the host's perf_counter
    running 5 ms behind it.  Two spans named ``name`` (1000..3000 and
    8000..9000 ns) launch three kernels (600 + 800 + 100 ns, the second
    running past its span's end); a span ``name + "_x"`` and a benchmark
    range ``perfbench.layer.<name>`` launch one each, and one kernel is
    launched outside every range.  ``spans_of`` renames the program's
    spans; ``pad_to`` fills the ring with other rows."""
    host = -5_000_000          # perf_counter ns at the trace's 0
    offset = 7_000_000_000     # time_ns − perf_counter_ns, as run.traced takes it
    own = spans_of or name
    rows = [{"name": n, "span": i, "parent": None, "ts": (host + a) / 1e9, "dur_us": (b - a) / 1e3, "attrs": {}}
            for i, (n, a, b) in enumerate([(own, 1000, 3000), (own + "_x", 4000, 5000), (own, 8000, 9000)])]
    rows += [{"name": "other", "span": 100 + i, "parent": None, "ts": 0.0, "dur_us": 0.0, "attrs": {}}
             for i in range(max(0, pad_to - len(rows)))]
    ranges = [(s["name"], offset + int(s["ts"] * 1e9), offset + int(s["ts"] * 1e9 + s["dur_us"] * 1e3))
              for s in rows[:3]]
    ranges.append((f"perfbench.layer.{name}", offset + host + 6000, offset + host + 7000))
    launch = lambda t, c: Ev("cudaLaunchKernel", "cuda_runtime", t, 5, c)  # noqa: E731
    events = [launch(10, 9), Ev("spin_kernel", "kernel", 12, 1, 9),
              launch(1500, 1), Ev("k1", "kernel", 2000, 600, 1),
              launch(2500, 2), Ev("k2", "kernel", 2600, 800, 2),
              launch(4500, 3), Ev("k3", "kernel", 5000, 1000, 3),
              launch(6500, 4), Ev("k4", "kernel", 7000, 1000, 4),
              launch(7500, 5), Ev("k5", "kernel", 7600, 300, 5),
              launch(8500, 6), Ev("k6", "kernel", 9000, 100, 6)]
    trace = DeviceTrace(events, (offset + host, offset + host + 10_000), ranges,
                        marker=(offset + host + 8, offset + host + 12))
    return SimpleNamespace(trace=trace, spans=rows, units=UNITS)


# The readings of fake_run(SPAN): 3000 ns of host time in two spans; 1500 ns
# of device time in three kernels; extents 1400 + 100 ns.
EXPECTED = {
    "fingerprint_ms.solve": 3000e-6 / UNITS,
    "seed_device_s.solve": 1500e-9 / UNITS,
    "lloyd_device_s.solve": 1500e-9 / UNITS,
    "forward_kernels.train": 3 / UNITS,
    "backward_device_ms.train": 1500e-6 / UNITS,
    "combine_device_ms.train": 1500e-6 / UNITS,
    "adamw_device_ms.train": 1500e-6 / UNITS,
    "recovery_ms.train": 1500e-6 / UNITS,
}


@pytest.mark.parametrize("metric", METRICS)
def test_metric_credits_kernels_to_its_exact_span_name(metric):
    m = files.metric(metric)
    assert m.read(fake_run(m.SPAN)) == pytest.approx(EXPECTED[metric], rel=1e-9)


def test_reading_of_the_fake_window():
    r = reading(fake_run("train.forward"), "train.forward")
    assert (r.spans, r.kernels) == (2, 3)
    assert r.host_s == pytest.approx(3e-6) and r.device_s == pytest.approx(1.5e-6)
    assert r.extents_s == [pytest.approx(1.4e-6), pytest.approx(1e-7)]
    longer = reading(fake_run("train.forward"), "train.forward_x")
    assert (longer.spans, longer.kernels, longer.device_s) == (1, 1, pytest.approx(1e-6))


@pytest.mark.parametrize("metric", METRICS)
def test_metric_is_none_without_its_span(metric):
    m = files.metric(metric)
    assert m.read(fake_run(m.SPAN, spans_of="renamed." + m.SPAN)) is None


@pytest.mark.parametrize("metric", METRICS)
def test_metric_is_none_when_the_ring_was_full(metric):
    m = files.metric(metric)
    assert m.read(fake_run(m.SPAN, pad_to=default_buffer().capacity)) is None
    assert m.read(fake_run(m.SPAN, pad_to=default_buffer().capacity - 1)) is not None


def test_nested_spans_of_one_name_count_each_kernel_once():
    run_ = fake_run("kmeans.seed")
    outer = run_.trace.ranges[0]
    run_.trace.ranges.append(type(outer)("kmeans.seed", outer.start + 100, outer.end - 100))
    r = reading(run_, "kmeans.seed")
    assert (r.kernels, r.device_s) == (3, pytest.approx(1.5e-6))


# ----------------------------------------------------- the program's span names

SOLVE_TINY = dict(points=3000, dim=8, local_iters=3, coord_iters=3,
                  data={"kind": "gaussian_mixture", "components": 16, "mean_low": 0.0, "mean_high": 64.0,
                        "spread": 8.0})
TRAIN_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2, head_dim=16, seq_len=32, data_vocab=256)


@pytest.mark.parametrize("cell, over, metrics", [
    ("solve-sift1m-k1024-t3", dict(cfg=SOLVE_TINY, traffic={"k": 8}), SOLVE_METRICS),
    ("train-qwen3-1.7b-fr4-iid", dict(cfg=TRAIN_TINY, traffic={}), TRAIN_METRICS),
])
def test_a_unit_of_the_cell_records_every_span_its_metrics_read(cell, over, metrics, monkeypatch):
    """One unit of each cell at a tiny size on the CPU, driven as the window
    drives it: the program records each span a new metric of the cell
    reads, so a renamed span fails here, not as a silent None."""
    from repro_torch.core import recovery

    monkeypatch.setattr(recovery, "resolve_device", lambda device=None: torch.device("cpu"))
    w = files.by_name(files.manifest()["workloads"], cell, "workload")
    cfg = {**files.config(w["config"]), **over["cfg"]}
    traffic = {**files.traffic(w["traffic"]), **over["traffic"]}
    runner = files.driver(cfg["driver"]).setup(cfg, traffic, 2**31 + 977, torch.device("cpu"))
    default_buffer().clear()
    runner.step(0)
    names = {s["name"] for s in default_buffer().rows()}
    runner.free()
    assert {files.metric(m).SPAN for m in metrics} <= names
    layer = {m["name"] for m in files.manifest()["per_layer"] if cell in m["workloads"]}
    assert set(metrics) <= layer


# --------------------------------------------------------------------- the card

class Probe:
    """A unit: a quarter second of host work, then one kernel launched inside
    a program span of its own.  The host spins rather than sleeps, so the
    core is awake when the span opens."""

    def __init__(self, device):
        self.x = torch.zeros(1024, device=device)

    def layer_targets(self):
        return []

    def step(self, i):
        from repro_torch.obs import trace_span

        until = time.perf_counter() + 0.25
        while time.perf_counter() < until:
            pass
        with trace_span("probe.launch"):
            self.x.add_(1.0)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_a_span_holds_its_launch_at_the_end_of_a_long_window(card):
    """Over a window of at least 10 s traced as ``run.traced`` traces it, a
    program span around one kernel launch contains that launch on the
    trace's clock, every time, and where the launch falls in its span moves
    by at most 50 µs from the window's start to its end (the median of the
    first eight probes against that of the last eight): the two clocks do
    not drift apart across a window.  The launch call itself comes 0.1–0.2
    ms into its span on the card (the op's host time under the profiler),
    so its distance from the span's start is not the clocks' error."""
    probe = Probe(card)
    probe.step(-1)
    window_s, units, trace, _, spans = run.traced(probe, 10.0)
    assert window_s >= 10.0 and units >= 30
    view = SimpleNamespace(trace=trace, spans=spans, units=units)
    r = reading(view, "probe.launch")
    assert r is not None and r.spans == units and r.kernels == units, (r, trace.unlaunched)
    ranges = sorted((h for h in trace.ranges if h.name == "probe.launch"), key=lambda h: h.start)
    after = []
    for h in ranges:
        (k,) = [k for k in trace.kernels() if k.launch is not None and h.start <= k.launch <= h.end]
        after.append(k.launch - h.start)
    drift = statistics.median(after[-8:]) - statistics.median(after[:8])
    assert abs(drift) <= 50_000, [a / 1e3 for a in after]
