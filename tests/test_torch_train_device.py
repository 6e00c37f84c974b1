"""Parity of the port's mesh-native resilient training path
(``Trainer(device_recovery=True)``, ``train_step.make_group_grad_fn`` and
``make_recovered_apply_fn``) with the reference, on the CPU, and the
twins of the reference's device-recovery tests.

The reference's params are drawn by its own ``init_params`` at
``smoke_config()`` (qwen3-4b's, deepseek-moe-16b's for the MoE case) in
f32 and carried into the port by ``convert``; its attention runs as the
plain ``attn_impl="ref"``.  The resident pools are the reference
pipeline's ``shard_rows`` (the port's pipeline equals it bit for bit,
``tests/test_torch_train.py``).

Tolerances:

* ``make_group_grad_fn`` through each package's ``LocalExecutor.
  resilient_reduce_masked`` (the reference vmaps the groups and combines
  G gradient trees; the port forms Σ_g b_g·∇S_g by one backward of the
  G gradient trees; the port adds each group's gradient times b_g into a
  float64 buffer): loss, ce and tok rtol 1e-5, atol 1e-6; each
  parameter's gradient elementwise rtol 1e-5, atol 1e-6, the atol raised
  to 1e-5 of that gradient's scale max|g| where this is larger (the two
  frameworks' f32 gradients part by ~2e-6 of their scale whatever the
  combine; the tied embedding's scale is 1.26 at this seed, and one of
  its elements parts by 1.35e-6); ``b_full`` within 1e-5 of the
  reference's (the same 300 projected-gradient steps in f32).  The MoE
  case replays the reference's routing (recorded per group), so that a
  near tie routes alike.
* ``make_recovered_apply_fn`` from identical stats: params, m and v
  within 1e-6 (the same f32 operations); the error feedback equal.
* The trainer: 5 steps under deadline stragglers from the reference's
  initial weights: equal straggler counts, fallback flags and solve
  counters, losses rtol 1e-4 (as ``tests/test_torch_train.py``'s host
  path).
* The twins of ``tests/test_training.py:314-458`` hold the reference's own
  bounds (FR clean vs straggled params rtol 1e-5, atol 1e-6).  The
  recompile test (``:346``) has no eager meaning: its twin holds 0 host
  solves across patterns.
"""

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as JA
from repro.core.executor import LocalExecutor as JLocalExecutor
from repro.data.pipeline import RedundantDataPipeline as JPipeline
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.train import compression as JCOMP
from repro.train import optimizer as JO
from repro.train import resilient as JR
from repro.train import train_step as JTS
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro_torch import convert, train_resilient_lm
from repro_torch.core import ElasticPolicy, LocalExecutor, ResilienceSession, cyclic_assignment, takes_weights
from repro_torch.core.assignment import Assignment
from repro_torch.data.pipeline import RedundantDataPipeline
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.train import compression as COMP
from repro_torch.train import optimizer as O
from repro_torch.train import train_step as TS
from repro_torch.train.elastic import ElasticGroupManager
from repro_torch.train.resilient import RedundantShardPlan, make_plan
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = {"qwen3-4b": "qwen3_4b", "deepseek-moe-16b": "deepseek_moe_16b"}


def _smoke(arch="qwen3-4b"):
    jcfg = importlib.import_module(f"repro.configs.{ARCHS[arch]}").smoke_config()
    pcfg = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke_config()
    over = dict(compute_dtype="float32")
    return dataclasses.replace(jcfg, **over).validate(), dataclasses.replace(pcfg, **over).validate()


def _jctx():
    return JT.ModelContext(attn_impl="ref")


def _reference_init(jcfg, seed=0):
    """The reference's initial params: (jnp tree, the port's model)."""
    jparams = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, jax.tree_util.tree_map(np.asarray, jparams)


def _model(pcfg, np_tree):
    return T.model_from_state_dict(pcfg, convert.transformer_params_from_jax(np_tree))


def _pools(jcfg, G=4, S=4, ell=2, scheme="fr", headroom=1, P=2, mb=1, T_=16, seed=0):
    """The reference pipeline's resident pools: (plan, tokens (G, P, C·mb,
    T) int32, valid (G, C) f32)."""
    jplan = JR.make_plan(G, S, redundancy=ell, scheme=scheme)
    pipe = JPipeline(jplan, vocab=jcfg.vocab, microbatch=mb, seq_len=T_, seed=seed)
    C = jplan.shards_per_group + headroom
    toks, valid = [], []
    for g in range(G):
        rows = [pipe.shard_rows(jplan.group_shards(g), p, C) for p in range(P)]
        toks.append(np.stack([r for r, _ in rows]))
        valid.append(rows[0][1])
    return jplan, np.stack(toks), np.stack(valid)


def _close_stats(got, want, b, jb):
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)
    wg = convert.transformer_params_from_jax(jax.tree_util.tree_map(np.asarray, want["grads"]))
    assert set(wg) == set(got["grads"])
    for name, g in got["grads"].items():
        _assert_grad_close(g, wg[name], name)
    for key in ("loss", "ce", "tok"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-6, err_msg=key)


def _assert_grad_close(got, want, name):
    want = want.numpy()
    atol = max(1e-6, 1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol, err_msg=name)


# ------------------------------------------------------------------ the step's pieces


@pytest.mark.parametrize("weights", ["masked", "fixed"])
def test_group_grad_fn_matches_the_reference(weights):
    """The combined statistics of ``make_group_grad_fn`` through the
    executor's masked reduce, under the device solve (FR, one straggler)
    or a fixed ``b_override``."""
    jcfg, pcfg = _smoke()
    jparams, tree = _reference_init(jcfg, seed=3)
    jplan, toks, valid = _pools(jcfg)
    A = jplan.assignment.matrix.astype(np.float32)
    alive = np.array([True, False, True, True])
    b_override = np.array([1.0, 0.0, 0.75, 0.25], np.float32) if weights == "fixed" else None
    jstats, jb = JLocalExecutor().resilient_reduce_masked(
        JTS.make_group_grad_fn(jcfg, _jctx()), (toks, valid), (jparams, jnp.int32(1)), A, alive,
        iters=300, b_override=b_override)
    fn = TS.make_group_grad_fn(pcfg, T.ModelContext())
    assert takes_weights(fn)
    stats, b = LocalExecutor().resilient_reduce_masked(
        fn, (torch.from_numpy(toks), torch.from_numpy(valid)), (_model(pcfg, tree), 1), A, alive,
        iters=300, b_override=b_override)
    _close_stats(stats, jstats, b, jb)


def test_moe_group_grad_fn_keeps_routing_and_aux_per_group(monkeypatch):
    """deepseek-moe-16b's smoke config: each group routes, caps its
    experts and counts its aux loss over its own tokens, as under the
    reference's vmap.  The reference's groups run one by one (its
    ``group_stats`` unbatched, the combine its ``resilient_sum``), so that
    each layer's routing is recorded in call order and replayed into the
    port's per-group loop."""
    jcfg, pcfg = _smoke("deepseek-moe-16b")
    jparams, tree = _reference_init(jcfg, seed=3)
    _, toks, valid = _pools(jcfg, T_=12)
    b = np.array([1.0, 0.0, 0.75, 0.25], np.float32)
    log = []
    orig = JM._routing

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        jax.debug.callback(lambda w: log.append(np.array(w, np.float32)), out[0], ordered=True)
        return out

    monkeypatch.setattr(JM, "_routing", recorded)
    jfn = jax.jit(JTS.make_group_grad_fn(jcfg, _jctx()))
    per = [jfn(toks[g], valid[g], jparams, jnp.int32(1)) for g in range(4)]
    jax.effects_barrier()
    jstats = JA.resilient_sum(jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *per), jnp.asarray(b))
    replay = []
    for w in log:
        w = torch.from_numpy(w)
        replay += [M._topk(w, pcfg.moe.top_k)[1], M.kept_tokens(w, pcfg.moe)]
    with M.recorded_routing(replay=replay):
        stats = LocalExecutor().resilient_reduce(
            TS.make_group_grad_fn(pcfg, T.ModelContext()), (torch.from_numpy(toks), torch.from_numpy(valid)),
            (_model(pcfg, tree), 1), b)
    _close_stats(stats, jstats, torch.from_numpy(b), b)
    aux = [float(p["loss"] - p["ce"]) for p in per]  # each group's n_valid · aux term
    assert all(a > 0 for a in aux) and len({round(a, 9) for a in aux}) > 1
    np.testing.assert_allclose(float(stats["loss"] - stats["ce"]), float(np.dot(b, aux)), rtol=1e-5)


def test_group_grad_fn_unweighted_is_the_reference_per_group_stats():
    """Without ``b`` the function gives each group's own shard-sum
    statistics, stacked: the reference's vmapped ``group_stats``."""
    jcfg, pcfg = _smoke()
    jparams, tree = _reference_init(jcfg, seed=5)
    _, toks, valid = _pools(jcfg, scheme="cyclic", headroom=2)
    valid[2, 1] = 0.0  # a padded slot inside a group
    jper = JLocalExecutor().map_nodes(JTS.make_group_grad_fn(jcfg, _jctx()), (toks, valid), (jparams, jnp.int32(0)))
    per = TS.make_group_grad_fn(pcfg, T.ModelContext())(
        torch.from_numpy(toks), torch.from_numpy(valid), _model(pcfg, tree), 0)
    for g in range(4):
        wg = convert.transformer_params_from_jax(jax.tree_util.tree_map(lambda x: np.asarray(x[g]), jper["grads"]))
        assert set(wg) == set(per["grads"])
        for name, grad in per["grads"].items():
            _assert_grad_close(grad[g], wg[name], f"group {g} {name}")
    for key in ("loss", "ce", "tok"):
        np.testing.assert_allclose(per[key].numpy(), np.asarray(jper[key]), rtol=1e-5, atol=1e-6)
    # The reference's "tok" counts every row's labels, the padded slots'
    # too: C·mb·(T − 1) a group, whatever its valid slots.
    C, T_ = valid.shape[1], toks.shape[-1]
    assert per["tok"].tolist() == np.asarray(jper["tok"]).tolist() == [C * (T_ - 1)] * 4


@pytest.mark.parametrize("compress", [False, True])
def test_recovered_apply_matches_the_reference(compress):
    jcfg, pcfg = _smoke()
    jparams, tree = _reference_init(jcfg, seed=1)
    rng = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(lambda p: (3.0 * rng.normal(size=p.shape)).astype(np.float32), tree)
    scalars = {"loss": np.float32(21.5), "ce": np.float32(21.25), "tok": np.float32(120.0)}
    ocfg = dict(lr=5e-3, warmup_steps=1, total_steps=4, grad_clip=1.0)
    jcomp, comp = (JCOMP.CompressionConfig(block=64), COMP.CompressionConfig(block=64)) if compress else (None, None)
    japply = JTS.make_recovered_apply_fn(JO.AdamWConfig(**ocfg), 4, compression=jcomp)
    apply = TS.make_recovered_apply_fn(O.AdamWConfig(**ocfg), 4, compression=comp)
    jstate = JTS.TrainState(params=jparams, opt=JO.init_opt_state(jparams),
                            ef=JCOMP.init_ef_state(jparams) if compress else None)
    state = TS.init_train_state(pcfg, generator=torch.Generator(), compression=comp, model=_model(pcfg, tree))
    pgrads = convert.transformer_params_from_jax(grads)
    for _ in range(2):
        jstate, jm = japply(jstate, {"grads": jax.tree_util.tree_map(jnp.asarray, grads),
                                     **{k: jnp.asarray(v) for k, v in scalars.items()}})
        state, m = apply(state, {"grads": {k: v.clone() for k, v in pgrads.items()},
                                 **{k: torch.tensor(v) for k, v in scalars.items()}})
    for key in ("loss", "ce", "tokens", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-6)
    parts = [("params", jstate.params, dict(state.params.named_parameters())),
             ("m", jstate.opt.m, state.opt.m), ("v", jstate.opt.v, state.opt.v)]
    if compress:
        parts.append(("ef", jstate.ef, state.ef))
    for part, want, got in parts:
        want = convert.transformer_params_from_jax(jax.tree_util.tree_map(np.asarray, want))
        for name, t in got.items():
            if part == "ef":
                np.testing.assert_array_equal(t.detach().numpy(), want[name].numpy(), err_msg=name)
            else:
                np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-6,
                                           err_msg=f"{part} {name}")


# ------------------------------------------------------------------ the trainer


def _device_configs(steps, **over):
    kw = dict(num_groups=4, num_shards=4, redundancy=2, microbatch=1, seq_len=16, steps=steps,
              simulate_stragglers=True, straggler_deadline=1.4, device_recovery=True, resident_steps=2, **over)
    return JTrainerConfig(**kw), TrainerConfig(**kw)


def test_device_recovery_trajectory_matches_the_reference():
    """Five steps under deadline stragglers (cyclic ℓ = 2: some patterns
    lose a shard and take the host fallback) from the reference's initial
    weights."""
    jcfg, pcfg = _smoke()
    jtc, tc = _device_configs(5)
    ocfg = dict(lr=5e-3, warmup_steps=2, total_steps=5)
    jt = JTrainer(jcfg, jtc, JO.AdamWConfig(**ocfg), ctx=_jctx())
    jt.run()
    _, tree = _reference_init(jcfg, seed=tc.seed)
    init = TS.init_train_state(pcfg, generator=torch.Generator(), model=_model(pcfg, tree))
    t = Trainer(pcfg, tc, O.AdamWConfig(**ocfg), device="cpu", initial_state=init)
    t.run()
    for key in ("stragglers", "fallback", "host_solves", "device_solves", "patches"):
        assert [h[key] for h in t.history] == [h[key] for h in jt.history], key
    assert sum(h["stragglers"] for h in t.history) > 0 and any(h["fallback"] for h in t.history)
    assert not all(h["fallback"] for h in t.history)
    for h, jh in zip(t.history, jt.history):
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-4)
        np.testing.assert_allclose(h["b_sum"], jh["b_sum"], rtol=1e-5)
    assert t.plan.session.stats.as_dict() == jt.plan.session.stats.as_dict() | {
        k: v for k, v in t.plan.session.stats.as_dict().items() if k not in jt.plan.session.stats.as_dict()}


def _trace(tmp_path, name, rows):
    path = tmp_path / f"{name}.jsonl"
    path.write_text("".join(json.dumps({"alive": r}) + "\n" for r in rows))
    return str(path)


def _run(tmp_path, rows, steps, ocfg, name="trace", **over):
    _, pcfg = _smoke()
    kw = dict(num_groups=4, num_shards=4, redundancy=2, scheme="fr", microbatch=1, seq_len=32, steps=steps,
              simulate_stragglers=True, straggler_scenario="trace",
              scenario_kwargs={"path": _trace(tmp_path, name, rows)}, device_recovery=True, resident_steps=2)
    kw.update(over)
    t = Trainer(pcfg, TrainerConfig(**kw), O.AdamWConfig(**ocfg), device="cpu")
    return t, t.run()


def test_device_recovery_bit_matches_clean_run_fr(tmp_path):
    """The twin of tests/test_training.py:314: with FR (δ = 0) the fused
    path gives the same parameter trajectory under a coverage-preserving
    straggler pattern as with none, with zero host solves."""
    ocfg = dict(lr=5e-3, warmup_steps=2, total_steps=5)
    t_clean, s_clean = _run(tmp_path, [[1, 1, 1, 1]] * 5, 5, ocfg, "clean")
    t_strag, s_strag = _run(tmp_path, [[1, 0, 1, 1]] * 5, 5, ocfg, "strag")
    for (name, a), b in zip(s_clean.params.named_parameters(), s_strag.params.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)
    for t in (t_clean, t_strag):
        assert t.plan.session.stats.host_solves == 0
        assert t.plan.session.stats.device_solves == 5
    assert all(h["stragglers"] == 1 for h in t_strag.history)
    assert not any(h["fallback"] for h in t_strag.history)


def test_device_recovery_no_host_solve_across_patterns():
    """The twin of tests/test_training.py:346, recast: an eager step has no
    compile cache, so what carries over is that unseen straggler patterns
    are data — none of them costs a host solve."""
    _, pcfg = _smoke()
    tc = TrainerConfig(num_groups=4, num_shards=4, redundancy=2, scheme="fr", microbatch=1, seq_len=32, steps=5,
                       straggler_scenario="fixed", scenario_kwargs={"t": 1}, device_recovery=True, resident_steps=2)
    t = Trainer(pcfg, tc, O.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=5), device="cpu")
    state, _ = t.init_state()
    patterns = set()
    for step in range(5):
        alive = next(t.scenario).alive
        patterns.add(alive.tobytes())
        state, rec = t._device_recovery_step(state, step, alive)
        assert rec is not None and not rec["fallback"]
    assert len(patterns) > 1, "scenario never varied the pattern"
    assert t.plan.session.stats.host_solves == 0
    assert t.plan.session.stats.device_solves == 5


def test_device_recovery_degenerate_pattern_falls_back(tmp_path):
    """The twin of tests/test_training.py:372: a pattern that loses a shard
    (singleton, one dead group) takes the host best-effort weights."""
    t, _ = _run(tmp_path, [[1, 0, 1, 1]] * 3, 3, dict(lr=1e-3, warmup_steps=1, total_steps=3),
                redundancy=1, scheme="singleton", resident_steps=1)
    assert all(h.get("fallback") for h in t.history)
    s = t.plan.session.stats
    assert s.host_solves == 1 and s.device_solves == 0
    assert all("loss" in h and np.isfinite(h["loss"]) for h in t.history)
    assert all(h["b_sum"] == 3.0 for h in t.history)  # the three survivors' shards keep their mass


def test_device_recovery_elastic_patch_moves_only_changed_blocks(tmp_path):
    """The twin of tests/test_training.py:399: persistent stragglers → an
    elastic patch → only the moved groups' resident rows are rewritten,
    and the path returns to the device solver."""
    t, _ = _run(tmp_path, [[1, 1, 1, 1, 0, 0]] * 8, 6, dict(lr=1e-3, warmup_steps=1, total_steps=6),
                num_groups=6, num_shards=6, scheme="cyclic", elastic_patience=2, patch_headroom=2)
    s = t.plan.session.stats
    assert s.elastic_patches >= 1
    assert s.moved_node_blocks >= 1, "incremental re-place did not run"
    assert s.full_repacks == 0, "patch should fit inside the headroom"
    assert t.history[0]["fallback"] is True
    assert t.history[-1]["fallback"] is False
    A = t.plan.current_assignment.matrix
    alive = np.array([1, 1, 1, 1, 0, 0], dtype=bool)
    assert int((A[alive].sum(axis=0) == 0).sum()) == 0
    valid = t._res_valid.numpy()
    assert valid.sum() > t.tcfg.num_shards * t.tcfg.redundancy - 1
    # The resident rows are the patched assignment's shards, packed afresh.
    for g in range(6):
        toks, v = t._pack_group_rows(g)
        assert torch.equal(t._res_tokens[g], torch.from_numpy(toks)) and np.array_equal(valid[g], v)


def test_device_recovery_patch_beyond_headroom_repacks_everything(tmp_path):
    """A patch that outgrows the slot capacity (no headroom) re-places the
    whole pool at the new capacity and counts a full repack."""
    t, _ = _run(tmp_path, [[1, 1, 1, 1, 0, 0]] * 4, 4, dict(lr=1e-3, warmup_steps=1, total_steps=4),
                num_groups=6, num_shards=6, scheme="cyclic", elastic_patience=2, patch_headroom=0)
    s = t.plan.session.stats
    assert s.elastic_patches >= 1 and s.full_repacks >= 1
    assert t._res_valid.shape[1] == t._capacity >= t.plan.current_assignment.matrix.sum(axis=1).max() > 2
    assert t.history[-1]["fallback"] is False


def test_device_recovery_descends_under_stragglers():
    """The twin of tests/test_training.py:436."""
    _, pcfg = _smoke()
    tc = TrainerConfig(num_groups=4, num_shards=4, redundancy=2, scheme="fr", microbatch=2, seq_len=48, steps=30,
                       straggler_deadline=1.6, device_recovery=True, resident_steps=4)
    t = Trainer(pcfg, tc, O.AdamWConfig(lr=5e-3, warmup_steps=3, total_steps=30), device="cpu")
    t.run()
    losses = [h["loss"] for h in t.history if "loss" in h]
    assert sum(h.get("stragglers", 0) > 0 for h in t.history) > 0
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    s = t.plan.session.stats
    fallbacks = sum(bool(h.get("fallback")) for h in t.history)
    assert s.host_solves <= max(fallbacks, s.uncovered_rounds)
    assert s.device_solves == len(losses) - fallbacks


# ------------------------------------------------------------------ the plan (tests/test_resilience.py twins)


def test_training_plan_rides_the_session_cache():
    """The twin of tests/test_resilience.py:345."""
    plan = make_plan(6, 6, redundancy=2, scheme="cyclic", session_kwargs={"device": "cpu"})
    alive = np.array([True, True, False, True, True, True])
    plan.group_weights(alive)
    plan.group_weights(alive)
    plan.recovery(alive)
    assert plan.session.stats.host_solves == 1
    assert plan.session.stats.cache_hits == 2


def test_step_weights_degenerate_pattern_falls_back_to_host():
    """The twin of tests/test_resilience.py:909."""
    plan = make_plan(6, 6, redundancy=1, scheme="singleton", session_kwargs={"device": "cpu"})
    alive = np.array([True, True, False, True, True, True])  # shard 2 lost
    w = plan.step_weights(alive)
    assert plan.session.stats.device_solves == 0 and plan.session.stats.host_solves == 1
    a_ach = w.astype(np.float64) @ plan.current_assignment.matrix
    covered = plan.current_assignment.matrix[alive].sum(axis=0) > 0
    np.testing.assert_allclose(a_ach[covered], 1.0, atol=1e-7)
    assert (a_ach[~covered] == 0).all()
    plan2 = make_plan(6, 6, redundancy=2, scheme="fr", session_kwargs={"device": "cpu"})
    w2 = plan2.step_weights(np.array([True, False, True, True, True, True]))
    assert plan2.session.stats.host_solves == 0 and plan2.session.stats.device_solves == 1
    np.testing.assert_allclose(w2.astype(np.float64) @ plan2.current_assignment.matrix, 1.0, atol=1e-4)


def test_step_weights_follow_elastic_patch():
    """The twin of tests/test_resilience.py:936."""
    a = cyclic_assignment(8, 8, 2)
    plan = RedundantShardPlan(assignment=a, num_groups=8, session=ResilienceSession(
        a, elastic=ElasticPolicy(enabled=True, patience=2), device="cpu"))
    alive = np.ones(8, dtype=bool)
    alive[[6, 7]] = False  # adjacent cyclic nodes: coverage lost
    w0 = plan.step_weights(alive)
    assert plan.session.stats.host_solves == 1
    for _ in range(3):
        plan.session.observe(alive)
    assert plan.session.stats.elastic_patches >= 1 and plan.current_assignment is not plan.assignment
    w1 = plan.step_weights(alive)
    assert plan.session.stats.device_solves == 1
    A_cur = plan.current_assignment.matrix
    assert not (A_cur[alive].sum(axis=0) == 0).any()
    np.testing.assert_allclose(w1.astype(np.float64) @ A_cur, 1.0, atol=1e-3)
    assert w1.shape == w0.shape == (8,)


def test_shards_per_group_raises_on_unbalanced():
    """The twin of tests/test_resilience.py:968."""
    mat = np.zeros((3, 6), dtype=np.uint8)
    mat[0, :4] = 1
    mat[1, 3:] = 1
    mat[2, [0, 5]] = 1
    plan = RedundantShardPlan(assignment=Assignment(matrix=mat, scheme="crafted", params={}), num_groups=3,
                              session=None)
    with pytest.raises(ValueError, match="load-balanced"):
        _ = plan.shards_per_group
    assert plan.max_load == 4 and [plan.group_load(g) for g in range(3)] == [4, 3, 2]
    assert make_plan(4, 8, redundancy=2, scheme="cyclic").shards_per_group == 4


def test_elastic_reshard_plan_survives_unbalanced_loads():
    """The twin of tests/test_resilience.py:992."""
    plan = make_plan(4, 8, redundancy=2, scheme="cyclic", session_kwargs={"device": "cpu"})
    pipe = RedundantDataPipeline(plan, vocab=64, microbatch=1, seq_len=8)
    shape_before = pipe.batch_shape
    mgr = ElasticGroupManager(plan)
    mgr.mark_dead(0)
    mgr.mark_dead(1)
    assert mgr.reshard_count >= 1
    with pytest.raises(ValueError, match="load-balanced"):
        _ = mgr.plan.shards_per_group
    assert mgr.plan.max_load >= 2 and pipe.batch_shape == shape_before


# ------------------------------------------------------------------ the launcher twin


def test_train_resilient_lm_smoke_on_cpu(tmp_path, capsys):
    """The twin of examples/train_resilient_lm.py at its smoke preset: the
    host path with compression; without --resume the checkpoint directory
    is cleared first, with it left as it is."""
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "marker").write_text("")
    args = ["--preset", "smoke", "--device", "cpu", "--steps", "3", "--ckpt-dir", str(ck)]
    history = train_resilient_lm.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "preset=smoke: 4L d=128 vocab=512 on cpu" in out and "done: loss" in out
    assert [h["step"] for h in history] == [0, 1, 2] and all(np.isfinite(h["loss"]) for h in history)
    assert (ck / "marker").exists()
    train_resilient_lm.main(args)
    assert not (ck / "marker").exists()


def test_train_resilient_lm_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_resilient_lm.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
