"""The roofline on H100 terms (``repro_torch.launch.roofline``) and its
op-level analysis (``repro_torch.launch.op_analysis``) against the
reference's ``launch/roofline.py`` and ``launch/hlo_analysis.py``, and the
paper's clustering configs (``repro_torch.configs.paper_kmedian``).

Bands:

* ``model_flops`` for every registered config and every ``SHAPES`` cell
  that applies to it: equal to the reference's, key by key;
* the report's terms times their peaks (FLOPs, bytes, collective bytes)
  and its ratios, for the same analysis dict: equal to the reference's;
* ``op_analysis.analyze`` of a smoke forward in f32 (qwen3-1.7b's and
  deepseek-moe-16b's smoke configs): matmul FLOPs within 1% of
  ``analyze_hlo`` of the reference's jitted forward on the CPU, whose
  attention at these sizes is ``attention_ref``'s two full einsums; the
  gap is reported by op;
* a plain-route flash call: exactly 4·B·H·T·S·dh, and nothing inside the
  plain version counted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registers the reference's configs)
from repro.configs import paper_kmedian as JP
from repro.launch import roofline as JR
from repro.launch import specs as JS
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import registry as JREG
from repro.models import transformer as JT
from repro_torch.configs import REFERENCE_ARCHS, paper_kmedian
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import collectives as C
from repro_torch.launch import op_analysis
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as S
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_config

CELLS = [(arch, name) for arch in REFERENCE_ARCHS for name in S.SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_is_the_reference_count(arch, shape):
    cfg, jcfg = get_config(arch), JREG.get_config(arch)
    cell, jcell = S.SHAPES[shape], JS.SHAPES[shape]
    applies = S.cell_is_applicable(cfg, cell)[0]
    assert applies == JS.cell_is_applicable(jcfg, jcell)[0]
    if applies:
        assert R.model_flops(cfg, cell) == JR.model_flops(jcfg, jcell)
        assert R._active_params(cfg) == JR._active_params(jcfg)


@pytest.mark.parametrize("chips", [1, 4, 256])
def test_report_terms_times_their_peaks_are_the_reference_terms(chips):
    analysis = {"flops": 3.1e15, "bytes": 7.3e12, "collective_bytes": 2.9e10}
    mf = JR.model_flops(JREG.get_config("qwen3-1.7b"), JS.SHAPES["train_4k"])
    port = R.roofline_terms("qwen3-1.7b", "train_4k", "m", chips, analysis, mf)
    ref = JR.roofline_terms("qwen3-1.7b", "train_4k", "m", chips, analysis, mf)
    assert port.compute_s * R.HW["peak_flops"] == pytest.approx(ref.compute_s * JR.HW["peak_flops"], rel=1e-15)
    assert port.memory_s * R.HW["hbm_bw"] == pytest.approx(ref.memory_s * JR.HW["hbm_bw"], rel=1e-15)
    assert port.collective_s * R.HW["link_bw"] == pytest.approx(ref.collective_s * JR.HW["ici_bw"], rel=1e-15)
    assert port.useful_ratio == ref.useful_ratio and port.model_flops == ref.model_flops
    terms = {"compute": port.compute_s, "memory": port.memory_s, "collective": port.collective_s}
    assert port.dominant == max(terms, key=terms.get)
    assert port.roofline_fraction == pytest.approx(mf["model_flops"] / chips / 989e12 / max(terms.values()))
    assert (R.HW["peak_flops"], R.HW["hbm_bw"], R.HW["link_bw"]) == (989e12, 3.35e12, 450e9)
    assert set(port.row()) == set(ref.row())


def _smoke(arch):
    mod = {"qwen3-1.7b": "qwen3_1_7b", "deepseek-moe-16b": "deepseek_moe_16b"}[arch]
    jcfg = dataclasses.replace(__import__(f"repro.configs.{mod}", fromlist=["x"]).smoke_config(),
                               compute_dtype="float32").validate()
    cfg = dataclasses.replace(__import__(f"repro_torch.configs.{mod}", fromlist=["x"]).smoke_config(),
                              compute_dtype="float32").validate()
    return jcfg, cfg


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_op_analysis_counts_the_reference_forward_flops(arch):
    jcfg, cfg = _smoke(arch)
    B, Tn = 2, 32
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, Tn)).astype(np.int32)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    hlo = jax.jit(lambda p, b: JT.forward_train(p, b, jcfg, JT.ModelContext())[0]).lower(
        jparams, {"tokens": jnp.asarray(tokens)}).compile().as_text()
    want = analyze_hlo(hlo)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = op_analysis.analyze(T.forward_train, model, {"tokens": torch.from_numpy(tokens).long()}, cfg,
                                  T.ModelContext())
    attn = cfg.n_layers * 4.0 * B * cfg.n_heads * Tn * Tn * cfg.head_dim
    gap = abs(got["flops"] - want["flops"]) / want["flops"]
    assert gap <= 1e-2, (gap, got["flops_by_op"], want["flops"])
    assert got["kernel_ops"] == {"flash_attention": cfg.n_layers}
    assert got["flops_by_op"]["kernel:flash_attention"] == attn
    assert got["bytes"] > 0 and got["collective_bytes"] == 0 and got["dot_ops"] >= cfg.n_layers


def test_a_plain_flash_call_counts_its_shapes_and_nothing_inside():
    q = torch.randn(2, 24, 8, 16)
    k = torch.randn(2, 40, 2, 16)
    got = op_analysis.analyze(fa.flash_attention, q, k, k, impl="torch_ref")
    assert got["flops"] == 4 * 2 * 8 * 24 * 40 * 16
    assert got["flops_by_op"] == {"kernel:flash_attention": 4.0 * 2 * 8 * 24 * 40 * 16}
    assert got["kernel_ops"] == {"flash_attention": 1} and got["dot_ops"] == 1
    assert got["bytes"] == (2 * q.numel() + 2 * k.numel()) * 4  # q, k, k read; o written
    # The observer closed with the call: a resolved op is the registered impl again.
    assert dispatch.resolve("flash_attention", "torch_ref", q, k, k)[1] is fa_ref.attention_ref


def test_op_analysis_reads_the_collectives_moved_during_the_call():
    def moves():
        C.STATS.add("gather", 1024)
        C.STATS.add("pmax", 64)
        return torch.ones(3) + 1

    got = op_analysis.analyze(moves)
    assert got["collectives_by_kind"] == {"gather": 1024.0, "pmax": 64.0}
    assert got["collective_bytes"] == 1088.0 and got["collective_ops"] == 2
    assert got["flops"] == 0.0 and got["dot_ops"] == 0 and got["bytes"] > 0


@pytest.mark.parametrize("name", ["paper_fig1", "production_scale"])
def test_paper_kmedian_is_the_reference_config(name):
    assert dataclasses.asdict(getattr(paper_kmedian, name)()) == dataclasses.asdict(getattr(JP, name)())
    assert [f.name for f in dataclasses.fields(paper_kmedian.ClusteringConfig)] == [
        f.name for f in dataclasses.fields(JP.ClusteringConfig)]


def test_dispatch_observers_see_each_resolved_op_and_nest():
    """``dispatch.observed``: each op that ``resolve`` hands out runs through
    the innermost open observer, which sees the op, the impl and the
    arguments; the outer one is back when the inner block closes."""
    q = torch.randn(1, 4, 2, 8)
    seen = []

    def observer(tag):
        def call(op, fn, *a, **kw):
            seen.append((tag, op, fn is fa_ref.attention_ref, tuple(a[0].shape)))
            return fn(*a, **kw)
        return call

    want = fa.flash_attention(q, q, q, impl="torch_ref")
    with dispatch.observed(observer("outer")):
        with dispatch.observed(observer("inner")):
            got = fa.flash_attention(q, q, q, impl="torch_ref")
        fa.flash_attention(q, q, q, impl="torch_ref")
    fa.flash_attention(q, q, q, impl="torch_ref")
    assert torch.equal(got, want)
    assert seen == [(tag, "flash_attention", True, (1, 4, 2, 8)) for tag in ("inner", "outer")]
