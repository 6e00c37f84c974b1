"""The readers of ``train-deepseek-v2-lite-ep8-4k-iid``'s new per-layer
metrics: the four span metrics on the synthetic window of
``test_perfbench_spans`` (kernels credited by launch time to the span of
the exact name; None without the span or with a full ring), the drop
share from the program's device counters, the operations a sequence needs
against a count of the reference's own weights, and the spans a unit of
the cell records at a tiny size on the CPU."""

import math
from types import SimpleNamespace

import pytest
import torch
from test_perfbench_spans import UNITS, fake_run

from harness import files
from repro_torch.obs import default_buffer, default_counters

CELL = "train-deepseek-v2-lite-ep8-4k-iid"
SPAN_METRICS = ("mla_attention_device_ms.train", "moe_route_device_ms.train", "moe_experts_device_ms.train",
                "moe_combine_device_ms.train")
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, seq_len=32, n_routed_experts=4, experts_held=[0, 4],
            published={"n_routed_experts": 16, "vocab_size": 102400, "num_hidden_layers": 27})


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_metric_credits_kernels_to_its_exact_span_name(metric):
    m = files.metric(metric)
    assert m.read(fake_run(m.SPAN)) == pytest.approx(1500e-6 / UNITS, rel=1e-9)
    assert m.read(fake_run(m.SPAN, spans_of="renamed." + m.SPAN)) is None
    assert m.read(fake_run(m.SPAN, pad_to=default_buffer().capacity)) is None


def test_drop_share_reads_the_device_counters():
    counters = default_counters()
    reader = files.metric("moe_drop_share.train")
    counters.clear()
    try:
        assert reader.read(None) is None
        counters.add("moe.routed", torch.tensor(0))
        assert reader.read(None) is None
        counters.add("moe.routed", torch.tensor(400))
        counters.add("moe.dropped", torch.tensor(3))
        counters.add("moe.dropped", torch.tensor(7))
        assert reader.read(None) == pytest.approx(2.5)
    finally:
        counters.clear()


def test_operations_a_sequence_needs_count_the_references_weights():
    """6 operations a token for each weight a token's products use (the
    held experts at the share top-k × held / routed of them) plus the
    causal attention's 6·H·(192 + 128) a (query, key) pair a layer."""
    cfg = files.config("deepseek-v2-lite-ep8")
    ref = files.reference("deepseek-v2-lite-ep8")
    E, (lo, hi), k = cfg["published"]["n_routed_experts"], cfg["experts_held"], cfg["num_experts_per_tok"]
    used = 0.0
    for name, shape, std in ref.shapes(cfg):
        if std is None or name == "embed":
            continue
        n = math.prod(shape)
        used += n * k / E if name.rsplit(".", 1)[-1] in ("w_gate", "w_up", "w_down") else n
    T, H, L = cfg["seq_len"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    want = 6.0 * used * T + 6.0 * H * (192 + 128) * L * T * (T + 1) / 2
    assert files.mfu(cfg["name"]).flops_per_sequence(cfg) == pytest.approx(want, rel=1e-12)
    assert hi - lo == 8 and E == 64


def test_a_unit_of_the_cell_records_every_span_and_counter_its_metrics_read(monkeypatch):
    from repro_torch.core import recovery

    monkeypatch.setattr(recovery, "resolve_device", lambda device=None: torch.device("cpu"))
    cfg = {**files.config("deepseek-v2-lite-ep8"), **TINY}
    runner = files.driver(cfg["driver"]).setup(cfg, files.traffic("closed-iid-p015"), 2**31 + 977,
                                               torch.device("cpu"))
    assert default_counters().read() == {}  # cleared at the end of set-up
    default_buffer().clear()
    runner.step(0)
    names = {s["name"] for s in default_buffer().rows()}
    runner.free()
    assert {files.metric(m).SPAN for m in SPAN_METRICS} <= names
    share = files.metric("moe_drop_share.train").read(SimpleNamespace())
    counts = default_counters().read()
    assert counts["moe.routed"] > 0 and 0.0 <= share < 100.0
    layer = {m["name"] for m in files.manifest()["per_layer"] if CELL in m.get("workloads", [])}
    assert set(SPAN_METRICS) | {"moe_drop_share.train", "train_mfu"} <= layer
    assert "flash_fwd_roofline.train" not in layer
