"""Parity of the port's training (``repro_torch.train``, ``repro_torch.data``,
``models.transformer.loss_fn``, ``launch.train``) with the reference, on
the CPU.

The reference's params are drawn by its own ``init_params`` at each
architecture's ``smoke_config()``, norm scales and QKV biases perturbed
from the seed (at init they are ones and zeros, which would hide a wrong
read), and ``convert`` carries them into the port as numpy arrays.  The
reference's attention runs as its plain ``attn_impl="ref"`` (its Pallas
kernel has no gradient; RecurrentGemma's windowed layers take
``"chunked"``, as its own tests run them), its gradients under
``jax.jit(jax.value_and_grad(loss_fn))``.

Tolerances:

* ``loss_fn`` and its gradient in f32, with Lemma 3's group weights (one
  group weighted 0): the loss within 1e-5 relative; each parameter's
  gradient within 1e-4 of that gradient's max|g| (f32 through four layers
  and a backward, summation orders differ), that scale floored at 1e-5
  of the model's largest max|g|: the sLSTM's input-gate bias ``b_i`` has
  a gradient that is zero but for rounding (h = c/n does not change when
  every i_t is scaled alike; both sides give ~1e-10 of the largest).  In bf16 the loss within 2e-2
  relative (the band of ``tests/test_models_smoke.py``: the two frameworks
  round bf16 at other places).  An MoE model replays the reference's
  routing (its combine weights recorded by a ``jax.debug.callback``), so
  that the two runs route alike.
* Lemma 3 on gradients (the twin of ``tests/test_training.py:58``): FR
  with one straggler against the unique batch, f32, 1e-5 of max|g|.
* AdamW and the schedule: rtol 1e-6 (the same f32 operations); int8
  codes and the error feedback: equal; the pipeline's batches and the
  recovery weights: equal (host LP) or within 1e-6 (the device solver).
* The trainer: a 5-step trajectory under ``deadline`` stragglers from the
  reference's initial weights, f32: losses within 1e-4 relative.  An
  interrupt and a resume: the same losses bit for bit.
* ``attention_bwd_ref`` against ``jax.grad`` of the reference's
  ``attention_ref``: rtol 1e-5, atol 1e-5 (f32).
"""

import dataclasses
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import RedundantDataPipeline as JPipeline
from repro.kernels.flash_attention import ref as JFR
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.train import checkpoint as JC
from repro.train import compression as JCOMP
from repro.train import optimizer as JO
from repro.train import resilient as JR
from repro.train.elastic import ElasticGroupManager as JElastic
from repro.train.train_step import init_train_state as j_init_train_state
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro_torch import convert
from repro_torch.data.pipeline import RedundantDataPipeline
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as M
from repro_torch.models import rglru as G
from repro_torch.models import transformer as T
from repro_torch.train import checkpoint as C
from repro_torch.train import compression as COMP
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from repro_torch.train.elastic import ElasticGroupManager
from repro_torch.train.resilient import make_plan
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = {
    "qwen3-4b": "qwen3_4b", "qwen3-8b": "qwen3_8b", "qwen2.5-3b": "qwen2_5_3b", "qwen3-1.7b": "qwen3_1_7b",
    "deepseek-moe-16b": "deepseek_moe_16b", "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "xlstm-1.3b": "xlstm_1_3b", "recurrentgemma-9b": "recurrentgemma_9b",
    "musicgen-large": "musicgen_large", "internvl2-1b": "internvl2_1b",
}
GW = np.array([1.0, 0.0, 2.0, 0.5], np.float32)  # Lemma 3's weights, one straggler


def _smoke(arch, compute_dtype="float32"):
    jcfg = importlib.import_module(f"repro.configs.{ARCHS[arch]}").smoke_config()
    pcfg = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke_config()
    over = dict(compute_dtype=compute_dtype)
    return dataclasses.replace(jcfg, **over).validate(), dataclasses.replace(pcfg, **over).validate()


def _jctx(cfg):
    return JT.ModelContext(attn_impl="chunked" if cfg.window else "ref")


def _params(jcfg, seed):
    """The reference's params with perturbed norms and QKV biases: (jnp
    tree, numpy tree)."""
    tree = jax.tree_util.tree_map(np.array, JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        if any(f"'{b}'" in name for b in ("bq", "bk", "bv")):
            return (0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _model(pcfg, np_tree):
    return T.model_from_state_dict(pcfg, convert.transformer_params_from_jax(np_tree))


def _batch(cfg, B, n, seed, gw=None):
    """(the reference's batch, the port's) of seeded tokens, (B, K, n) for a
    codebook model, with prefix embeddings for a prefix model."""
    rng = np.random.default_rng(seed)
    shape = (B, cfg.num_codebooks, n) if cfg.num_codebooks else (B, n)
    arrays = {"tokens": rng.integers(0, cfg.vocab, size=shape).astype(np.int32)}
    if cfg.num_prefix_tokens:
        arrays["prefix_embeds"] = rng.normal(size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    if gw is not None:
        arrays["group_weights"] = gw
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    pb = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v) for k, v in arrays.items()}
    return jb, pb


def _record_reference_routing(monkeypatch):
    """Record, inside the reference's jitted step, each MoE layer's combine
    weights (N, E) in call order."""
    log = []
    orig = JM._routing

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        jax.debug.callback(lambda w: log.append(np.array(w, np.float32)), out[0], ordered=True)
        return out

    monkeypatch.setattr(JM, "_routing", recorded)
    return log


def _selections(ws, cfg):
    """The port's routing log made from recorded combine weights: per layer
    each token's experts, then each expert's kept tokens."""
    log = []
    for w in ws:
        w = torch.from_numpy(w)
        log += [M._topk(w, cfg.moe.top_k)[1], M.kept_tokens(w, cfg.moe)]
    return log


def _port_loss_and_grads(model, batch, cfg, replay=None):
    def run():
        loss, metrics = T.loss_fn(model, batch, cfg, T.ModelContext())
        names, params = zip(*model.named_parameters())
        return loss, metrics, dict(zip(names, torch.autograd.grad(loss, params)))

    if replay is None:
        return run()
    with M.recorded_routing(replay=replay):
        return run()


# ------------------------------------------------------------------ loss_fn


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_match_jax_f32(arch, monkeypatch):
    jcfg, pcfg = _smoke(arch)
    jparams, tree = _params(jcfg, seed=3)
    jb, pb = _batch(jcfg, 4, 12, seed=4, gw=GW)
    ws = _record_reference_routing(monkeypatch) if jcfg.moe else None
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg, _jctx(jcfg)), has_aux=True))(jparams)
    jax.effects_barrier()
    replay = _selections(ws, pcfg) if ws is not None else None
    loss, metrics, grads = _port_loss_and_grads(_model(pcfg, tree), pb, pcfg, replay)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for key in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(metrics[key].detach()), float(jmet[key]), rtol=1e-5, atol=1e-6)
    want = convert.transformer_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want) == set(grads)
    top = max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        w = want[name].numpy()
        assert float(np.abs(w).max()) > 0, name  # every parameter gets a gradient
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * max(float(np.abs(w).max()), 1e-5 * top), (name, err, float(np.abs(w).max()))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_matches_jax_bf16(arch, monkeypatch):
    jcfg, pcfg = _smoke(arch, "bfloat16")
    jparams, tree = _params(jcfg, seed=5)
    jb, pb = _batch(jcfg, 4, 12, seed=6, gw=GW)
    ws = _record_reference_routing(monkeypatch) if jcfg.moe else None
    jloss, _ = jax.jit(lambda p: JT.loss_fn(p, jb, jcfg, _jctx(jcfg)))(jparams)
    jax.effects_barrier()
    with torch.no_grad(), M.recorded_routing(replay=_selections(ws, pcfg) if ws is not None else None):
        loss, _ = T.loss_fn(_model(pcfg, tree), pb, pcfg, T.ModelContext())
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)


def test_fr_plan_exact_gradient_recovery():
    """Lemma 3 on gradients: with FR (δ = 0) the b-weighted gradient of the
    redundant batch under one straggler equals the unique batch's."""
    _, pcfg = _smoke("qwen3-4b")
    plan = make_plan(4, 4, redundancy=2, scheme="fr", session_kwargs={"device": "cpu"})
    pipe = RedundantDataPipeline(plan, vocab=pcfg.vocab, microbatch=1, seq_len=32)
    model = T.init_params(pcfg, generator=torch.Generator().manual_seed(0))
    _, _, full = _port_loss_and_grads(model, {"tokens": torch.from_numpy(pipe.unique_batch(0)).long()}, pcfg)
    w, rec = plan.group_weights(np.array([True, False, True, True]))
    assert rec.feasible and rec.delta <= 1e-9 and w[1] == 0
    batch = {"tokens": torch.from_numpy(pipe.batch(0)).long(), "group_weights": torch.from_numpy(w)}
    _, _, resilient = _port_loss_and_grads(model, batch, pcfg)
    for name, g in full.items():
        assert float((g - resilient[name]).abs().max()) <= 1e-5 * float(g.abs().max()), name


# ------------------------------------------------------------------ optimizer


def _tree(rng, scale=1.0):
    return {"a": (scale * rng.normal(size=(3, 5))).astype(np.float32),
            "b": (scale * rng.normal(size=(7,))).astype(np.float32)}


def test_adamw_schedule_and_clipping_match_jax():
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=8, weight_decay=0.1, grad_clip=1.0)
    jcfg, pcfg = JO.AdamWConfig(**cfg), O.AdamWConfig(**cfg)
    for step in range(10):
        np.testing.assert_allclose(O.cosine_schedule(pcfg, step),
                                   float(JO.cosine_schedule(jcfg, jnp.asarray(step))), rtol=1e-6)
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jstate, pstate = JO.init_opt_state(jp), O.init_opt_state(pp)
    for step, scale in enumerate((10.0, 0.01, 3.0, 0.5)):  # clipped, then not, then clipped
        g = _tree(rng, scale)
        jp, jstate, jm = JO.adamw_update(jcfg, jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        _, pstate, pm = O.adamw_update(pcfg, pp, {k: torch.from_numpy(v) for k, v in g.items()}, pstate)
        assert pstate.step == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(pm["lr"], float(jm["lr"]), rtol=1e-6)
        for k in p0:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(pstate.m[k].numpy(), np.asarray(jstate.m[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(pstate.v[k].numpy(), np.asarray(jstate.v[k]), rtol=1e-6, atol=1e-12)
    assert float(O.global_norm({k: torch.from_numpy(v) for k, v in p0.items()})) == pytest.approx(
        float(JO.global_norm({k: jnp.asarray(v) for k, v in p0.items()})), rel=1e-6)


def test_int8_and_error_feedback_match_jax():
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.0], np.float32)  # scale 1: halves round to even
    rng = np.random.default_rng(1)
    for x in (ties, rng.normal(size=(3, 300)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)):
        jq, js, jn = JCOMP.quantize_int8(jnp.asarray(x), 256)
        q, s, n = COMP.quantize_int8(torch.from_numpy(x), 256)
        assert n == jn
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(COMP.dequantize_int8(q, s, n).numpy(), np.asarray(JCOMP.dequantize_int8(jq, js, jn)))
    assert COMP.quantize_int8(torch.from_numpy(ties))[0].tolist()[0][:7] == [127, 0, 2, 2, 0, -2, 3]
    p0 = {"a": rng.normal(size=(4, 300)).astype(np.float32), "b": rng.normal(size=(9,)).astype(np.float32)}
    ccfg, jccfg = COMP.CompressionConfig(block=64), JCOMP.CompressionConfig(block=64)
    ef = COMP.init_ef_state({k: torch.from_numpy(v) for k, v in p0.items()})
    jef = JCOMP.init_ef_state({k: jnp.asarray(v) for k, v in p0.items()})
    for _ in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        pg, ef = COMP.compress_with_error_feedback(ccfg, {k: torch.from_numpy(v) for k, v in g.items()}, ef)
        jg, jef = JCOMP.compress_with_error_feedback(jccfg, {k: jnp.asarray(v) for k, v in g.items()}, jef)
        for k in p0:
            np.testing.assert_array_equal(pg[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(ef[k].numpy(), np.asarray(jef[k]))


# ------------------------------------------------------------------ checkpoint


def _train_state(compress=False, seed=0):
    _, pcfg = _smoke("qwen3-4b")
    return TS.init_train_state(pcfg, generator=torch.Generator().manual_seed(seed),
                               compression=COMP.CompressionConfig() if compress else None)


def test_checkpoint_round_trip_rotation_and_checks(tmp_path):
    state = _train_state(compress=True)
    with torch.no_grad():
        for t in list(state.opt.m.values()) + list(state.ef.values()):
            t.normal_()
    state = state._replace(opt=state.opt._replace(step=7))
    for step in (2, 4, 6, 8):
        C.save_checkpoint(str(tmp_path), step, state, keep=2)
    assert C.list_checkpoints(str(tmp_path)) == [6, 8] and C.latest_step(str(tmp_path)) == 8
    assert json.loads((tmp_path / "metadata.json").read_text()) == {"latest_step": 8}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    fresh = _train_state(compress=True, seed=1)
    restored, step = C.restore_checkpoint(str(tmp_path), fresh)
    assert step == 8 and restored.opt.step == 7
    for (n, a), b in zip(state.params.named_parameters(), restored.params.parameters()):
        assert torch.equal(a, b), n
    for k in state.opt.m:
        assert torch.equal(state.opt.m[k], restored.opt.m[k]) and torch.equal(state.ef[k], restored.ef[k])
    with pytest.raises(ValueError, match="mismatch on keys"):
        C.restore_checkpoint(str(tmp_path), _train_state(compress=False))
    other = importlib.import_module("repro_torch.configs.qwen3_4b").smoke_config()
    wide = TS.init_train_state(dataclasses.replace(other, d_ff=256), generator=torch.Generator(),
                               compression=COMP.CompressionConfig())
    with pytest.raises(ValueError, match="shape mismatch"):
        C.restore_checkpoint(str(tmp_path), wide)
    with pytest.raises(FileNotFoundError):
        C.restore_checkpoint(str(tmp_path / "none"), fresh)


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b", "musicgen-large"])
def test_reference_checkpoint_restores_into_the_port(arch, tmp_path):
    """The reference's step_<n>.npz (params, m, v, step, error feedback)
    restores into the port through convert's mapping."""
    jcfg, pcfg = _smoke(arch)
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg, compression=JCOMP.CompressionConfig())
    rng = np.random.default_rng(0)
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
                                   jstate.params)
    params, opt, _ = JO.adamw_update(JO.AdamWConfig(), jstate.params, grads, jstate.opt)
    ef = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), params)
    jstate = jstate._replace(params=params, opt=opt, ef=ef)
    JC.save_checkpoint(str(tmp_path), 5, jstate)
    template = TS.init_train_state(pcfg, generator=torch.Generator(), compression=COMP.CompressionConfig())
    state, step = C.restore_checkpoint(str(tmp_path), template)
    assert step == 5 and state.opt.step == 1
    for part, want in (("params", jstate.params), ("m", jstate.opt.m), ("v", jstate.opt.v), ("ef", jstate.ef)):
        want = convert.transformer_params_from_jax(jax.tree_util.tree_map(np.asarray, want))
        got = dict(state.params.named_parameters()) if part == "params" else (
            state.ef if part == "ef" else getattr(state.opt, part))
        assert set(got) == set(want)
        for name, t in got.items():
            assert torch.equal(t.detach(), want[name]), (part, name)


# ------------------------------------------------------------------ data, plan


@pytest.mark.parametrize("scheme,G,S,ell", [("cyclic", 4, 4, 2), ("fr", 4, 8, 2), ("singleton", 4, 4, 1)])
def test_pipeline_batches_bit_for_bit(scheme, G, S, ell):
    plan = make_plan(G, S, redundancy=ell, scheme=scheme, session_kwargs={"device": "cpu"})
    jplan = JR.make_plan(G, S, redundancy=ell, scheme=scheme)
    pipe = RedundantDataPipeline(plan, vocab=97, microbatch=2, seq_len=9, seed=3)
    jpipe = JPipeline(jplan, vocab=97, microbatch=2, seq_len=9, seed=3)
    assert pipe.batch_shape == jpipe.batch_shape
    for step in (0, 5):
        np.testing.assert_array_equal(pipe.batch(step), jpipe.batch(step))
        np.testing.assert_array_equal(pipe.unique_batch(step), jpipe.unique_batch(step))
        rows, valid = pipe.shard_rows(plan.group_shards(1), step, plan.max_load + 1)
        jrows, jvalid = jpipe.shard_rows(jplan.group_shards(1), step, jplan.max_load + 1)
        np.testing.assert_array_equal(rows, jrows)
        np.testing.assert_array_equal(valid, jvalid)


@pytest.mark.parametrize("scheme,ell", [("cyclic", 2), ("fr", 2), ("cyclic", 3)])
def test_group_and_step_weights_match_jax(scheme, ell):
    G = S = 6
    plan = make_plan(G, S, redundancy=ell, scheme=scheme, session_kwargs={"device": "cpu"})
    jplan = JR.make_plan(G, S, redundancy=ell, scheme=scheme)
    np.testing.assert_array_equal(plan.assignment.matrix, jplan.assignment.matrix)
    rng = np.random.default_rng(ell)
    for _ in range(4):
        alive = rng.random(G) > 0.3
        w, rec = plan.group_weights(alive)
        jw, jrec = jplan.group_weights(alive)
        np.testing.assert_allclose(w, jw, rtol=1e-6, atol=1e-7)
        assert rec.feasible == jrec.feasible and len(rec.uncovered) == len(jrec.uncovered)
        np.testing.assert_allclose(plan.step_weights(alive), jplan.step_weights(alive), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(plan.degraded_weights(alive), jplan.degraded_weights(alive), atol=1e-7)
    mgr, jmgr = ElasticGroupManager(plan), JElastic(jplan)
    mgr.mark_dead(2)
    jmgr.mark_dead(2)
    w, _ = mgr.step_weights(np.eye(G, dtype=bool)[4])
    jw, _ = jmgr.step_weights(np.eye(G, dtype=bool)[4])
    np.testing.assert_allclose(w, jw, rtol=1e-6, atol=1e-7)
    assert mgr.permanently_dead == jmgr.permanently_dead == {2}


# ------------------------------------------------------------------ trainer


def _trainer_configs(steps, **over):
    kw = dict(num_groups=4, num_shards=4, redundancy=2, microbatch=1, seq_len=16, steps=steps,
              simulate_stragglers=True, straggler_deadline=1.4, **over)
    return JTrainerConfig(**kw), TrainerConfig(**kw)


def test_trainer_trajectory_matches_jax():
    """Five steps under deadline stragglers from the reference's initial
    weights, f32: the losses within 1e-4 relative."""
    jcfg, pcfg = _smoke("qwen3-4b")
    jtc, tc = _trainer_configs(5)
    ocfg = dict(lr=5e-3, warmup_steps=2, total_steps=5)
    jt = JTrainer(jcfg, jtc, JO.AdamWConfig(**ocfg), ctx=JT.ModelContext(attn_impl="ref"))
    jt.run()
    jinit = j_init_train_state(jax.random.PRNGKey(tc.seed), jcfg)
    model = _model(pcfg, jax.tree_util.tree_map(np.asarray, jinit.params))
    init = TS.init_train_state(pcfg, generator=torch.Generator(), model=model)
    t = Trainer(pcfg, tc, O.AdamWConfig(**ocfg), device="cpu", initial_state=init)
    t.run()
    assert [h["stragglers"] for h in t.history] == [h["stragglers"] for h in jt.history]
    assert sum(h["stragglers"] for h in t.history) > 0  # the simulator fired
    for h, jh in zip(t.history, jt.history):
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-4)
        np.testing.assert_allclose(h["covered"], jh["covered"])


def test_trainer_interrupt_and_resume_bit_for_bit(tmp_path):
    """Six steps with a checkpoint every three, against three steps, an
    interrupt and a resume from the checkpoint: the same losses bit for bit.
    The resumed trainer's straggler stream is advanced past the steps taken
    (a fresh trainer restarts it, as the reference's does)."""
    _, pcfg = _smoke("qwen3-4b")
    ocfg = O.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=6)
    _, tc = _trainer_configs(6, ckpt_every=3, ckpt_dir=str(tmp_path / "a"))
    whole = Trainer(pcfg, tc, ocfg, device="cpu")
    whole.run()
    _, tc_b = _trainer_configs(3, ckpt_every=3, ckpt_dir=str(tmp_path / "b"))
    Trainer(pcfg, tc_b, ocfg, device="cpu").run()
    resumed = Trainer(pcfg, dataclasses.replace(tc_b, steps=6), ocfg, device="cpu")
    for _ in range(3):
        next(resumed.scenario)
    resumed.run()
    assert [h["step"] for h in resumed.history] == [3, 4, 5]
    assert [h["loss"] for h in resumed.history] == [h["loss"] for h in whole.history[3:]]
    assert C.list_checkpoints(str(tmp_path / "b")) == [3, 6]


def test_train_step_accumulation_and_compression():
    """accum_steps=2 splits the batch group-aligned: the summed microbatch
    gradients give the full batch's update within 1e-5; compression runs."""
    _, pcfg = _smoke("qwen3-4b")
    ocfg = O.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, pcfg.vocab, size=(8, 12))).long(),
             "group_weights": torch.tensor([1.0, 0.0, 2.0, 1.0])}
    states = [_train_state() for _ in range(3)]
    one, _ = TS.make_train_step(pcfg, T.ModelContext(), ocfg)(states[0], batch)
    two, m2 = TS.make_train_step(pcfg, T.ModelContext(), ocfg, accum_steps=2, num_groups=4)(states[1], batch)
    for (n, a), b in zip(one.params.named_parameters(), two.params.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)
    assert float(m2["aux"]) == 0 and float(m2["tokens"]) == 0
    comp = TS.make_train_step(pcfg, T.ModelContext(), ocfg, compression=COMP.CompressionConfig())
    st, m = comp(states[2]._replace(ef=COMP.init_ef_state(dict(states[2].params.named_parameters()))), batch)
    assert st.opt.step == 1 and np.isfinite(float(m["loss"])) and any(bool(e.any()) for e in st.ef.values())
    ev = TS.make_eval_step(pcfg, T.ModelContext())(st.params, batch)
    assert set(ev) == {"loss", "ce", "aux", "tokens"} and not ev["loss"].requires_grad


def test_unported_training_paths_raise():
    """The mesh-native path is ported (``tests/test_torch_train_device.py``);
    what raises is the reference's own refusal: an ``executor`` other than
    "local" without ``device_recovery``, whose host path never reads it."""
    jcfg, pcfg = _smoke("qwen3-4b")
    with pytest.raises(ValueError, match="device_recovery"):
        JTrainer(jcfg, JTrainerConfig(executor="mesh"))
    with pytest.raises(ValueError, match="device_recovery"):
        Trainer(pcfg, TrainerConfig(executor="mesh"), device="cpu")
    assert callable(TS.make_group_grad_fn(pcfg, T.ModelContext()))
    assert callable(TS.make_recovered_apply_fn(O.AdamWConfig(), 4))


def test_launch_train_runs_on_cpu(capsys):
    history = launch_train.main(["--arch", "qwen3-4b", "--scale", "smoke", "--device", "cpu", "--steps", "3",
                                 "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "arch=qwen3-4b scale=smoke on cpu" in out and "final:" in out
    assert len(history) == 3


def test_launch_train_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--steps", "1"])


# ------------------------------------------------------------------ attention backward


@pytest.mark.parametrize("shape", [(2, 9, 9, 4, 2, 8), (1, 16, 16, 6, 3, 16), (2, 5, 5, 2, 2, 4)])
def test_attention_bwd_ref_matches_jax_grad(shape):
    B, Tq, S, H, KV, dh = shape
    rng = np.random.default_rng(sum(shape))
    q, k, v, do = (rng.normal(size=s).astype(np.float32)
                   for s in ((B, Tq, H, dh), (B, S, KV, dh), (B, S, KV, dh), (B, Tq, H, dh)))
    scale = dh ** -0.5
    jo, vjp = jax.vjp(lambda a, b, c: JFR.attention_ref(a, b, c, causal=True, scale=scale),
                      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = fa_ref.attention_bwd_ref(tq, tk, tv, torch.from_numpy(np.array(jo)), torch.from_numpy(do), scale)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # The autograd Function with the plain forward: the gradients of
    # torch's own autograd of attention_ref.
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa_ops.FlashAttentionFn.apply(*leaves, True, scale, fa_ref.attention_ref)
    mine = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    ref_leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    auto = torch.autograd.grad(fa_ref.attention_ref(*ref_leaves, causal=True, scale=scale), ref_leaves,
                               torch.from_numpy(do))
    for a, b in zip(mine, auto):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="T == S"):
        fa_ref.attention_bwd_ref(tq[:, :-1], tk, tv, tq[:, :-1], tq[:, :-1], scale)


def test_raw_flash_wrapper_refuses_to_drop_a_gradient():
    q = torch.randn(1, 4, 2, 16, requires_grad=True)
    k = torch.randn(1, 4, 2, 16)
    with pytest.raises(RuntimeError, match="no gradient"):
        fa_kernel.flash_attention_cuda(q, k, k, causal=True, scale=0.25)
    with torch.no_grad(), pytest.raises(ValueError, match="one CUDA device"):  # grad off: the usual checks
        fa_kernel.flash_attention_cuda(q, k, k, causal=True, scale=0.25)


def test_rglru_scan_out_of_place_equals_in_place():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(2, 37, 5)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(2, 37, 5)).astype(np.float32))
    want = G._scan(a.clone(), u.clone())
    ag, ug = a.clone().requires_grad_(), u.clone().requires_grad_()
    got = G._scan(ag, ug)
    assert torch.equal(got.detach(), want) and got.grad_fn is not None
    assert torch.equal(ag.detach(), a) and torch.equal(ug.detach(), u)  # the inputs are left as they were
    h = torch.zeros(2, 5)
    for t in range(37):  # the serial recurrence
        h = a[:, t] * h + u[:, t]
    torch.testing.assert_close(want[:, -1], h, rtol=1e-5, atol=1e-6)
