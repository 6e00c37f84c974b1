"""Training on an LM mesh (``repro_torch.launch.collectives``' backward,
``models.transformer.loss_fn`` and ``train.train_step.make_train_step``
under ``ctx.mesh``, remat, ``train.trainer.Trainer(ctx=...)``) against the
meshless port and the reference, on the CPU over gloo ranks.

Each world size starts once (``run_ranks(mesh_runs.train_lm_rank, world)``
with every job of that world); a rank runs one intra-op thread
(``launch.distributed.rank_threads``).  All models are f32 smoke configs;
qwen3-1.7b's has 4 query heads over 2 KV heads, so a model axis of 4 takes
the GQA fallback (``wk``/``wv`` gathered, each rank keeping the KV heads
its query heads read).

Bands:

* each collective's backward (``psum``, ``gather`` over ``model`` and
  ``data``, ``chain``, ``gather_axes``, ``enter``, ``split_linear``)
  against autograd of the meshless global loss, in f64: 1e-6;
* the step on (1, 2), (2, 1), (2, 2) and (1, 4): the loss within 1e-6
  relative; every first-step gradient block within 1e-5 of its
  parameter's meshless max|g| (that scale floored at 1e-5 of the model's
  largest, as ``tests/test_torch_train.py`` floors it); the grad norm
  within 1e-6 relative; the moments on ``state_shardings``' blocks.  The
  parameters after 3 steps at lr 5e-3 within 5e-5, lr / 100: AdamW
  normalises each entry by its own
  magnitude, so an entry whose gradient is ~1e-4 of its parameter's
  max|g| carries the f32 rounding of a differently ordered sum (~1e-8 of
  the scale) as a ~1e-4 relative error into its update.  Measured: 1.9e-5
  on (1, 4), whose KV projections sum the ranks' partial products (the
  GQA fallback), 3.3e-6 on the meshes with data shards (their weight
  gradients summed over the shards) and 3.5e-7 on (1, 2);
* the twin of ``tests/test_launch.py:53-84``: one step of the reference's
  jitted ``make_train_step`` under ``state_shardings`` and
  ``batch_shardings`` on (2, 4) and (2, 2, 2), remat ``full``, against the
  port's on 8 gloo ranks: the loss, the grad norm and the updated
  parameters within 1e-5, and collectives counted (the port's form of the
  reference's ``coll > 0``).  The reference's default AdamW moves an
  entry by at most ~lr = 3e-6 on its first step, so the parameters'
  band alone would pass any update; the first moments (0.1 × the clipped
  gradient) are held within 1e-5 of each parameter's max|m|, and the
  update itself, (new − old) / lr, within 0.25 of the reference's
  (entries of magnitude ~1: a wrong sign parts by ~2; measured 0.082 on
  (2, 2, 2) and 0.027 on (2, 4), entries whose gradient is near f32 noise
  beside AdamW's ε, or whose parameter's ulp is ~1e-2 of lr);
* remat ``none``, ``full`` and ``dots``: the same gradients within 1e-6
  of their scale, meshless and on (2, 2); the attention calls a step are
  one a layer without remat and two with it;
* ``Trainer(ctx=mesh)`` on (2, 2), 5 steps under deadline stragglers from
  the same weights as the meshless trainer (its default AdamW): the
  parameters within 1e-5, the same history of stragglers and host solves,
  every rank's lockstep hash alike each step; ``accum_steps=2`` with
  G = 4 against the meshless accumulated step (one step at lr 5e-3: the
  loss within 1e-6 relative, the parameters within 5e-5).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import qwen3_1_7b
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh_runs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.sharding import make_context
from repro_torch.models import transformer as T
from repro_torch.train.optimizer import AdamWConfig, cosine_schedule
from repro_torch.train.train_step import init_train_state, make_grad_fn, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240.0  # seconds for one start of the ranks, setup to exit
OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=5)
STEP_MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
COLLECTIVE_MESHES = [(1, 2), (2, 2)]
REMATS = ("none", "full", "dots")
TWIN_MESHES = [(2, 4), (2, 2, 2)]
PARAM_BAND = 5e-5  # after AdamW steps at lr 5e-3 (module docstring)
UPDATE_BAND = 0.25  # (new - old) / lr after the reference's first AdamW step (module docstring)

_REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.qwen3_1_7b import smoke_config
    from repro.launch.compat import make_auto_mesh
    from repro.launch.sharding import make_context, state_shardings, batch_shardings
    from repro.train.optimizer import AdamWConfig
    from repro.train.train_step import init_train_state, make_train_step

    cfg = dataclasses.replace(
        smoke_config(), n_layers=4, vocab=512, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256, head_dim=32,
        compute_dtype="float32").validate()
    out = {}
    state = init_train_state(jax.random.PRNGKey(0), cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        out["params/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(16, 64)).astype(np.int32),
             "group_weights": np.array([1.0, 0.0, 1.0, 0.5], np.float32)}
    out["tokens"], out["group_weights"] = batch["tokens"], batch["group_weights"]
    for shape, axes in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        mesh = make_auto_mesh(shape, axes)
        ctx = make_context(mesh, attn_impl="chunked", remat="full")
        st_sh = state_shardings(state, mesh)
        b_sh = batch_shardings(batch, mesh)
        step = jax.jit(make_train_step(cfg, ctx, AdamWConfig()), in_shardings=(st_sh, b_sh),
                       out_shardings=(st_sh, None))
        new, metrics = step(jax.device_put(state, st_sh), jax.device_put(batch, b_sh))
        tag = "x".join(map(str, shape))
        out[tag + "/loss"] = np.asarray(metrics["loss"])
        out[tag + "/grad_norm"] = np.asarray(metrics["grad_norm"])
        for part, tree in (("params", new.params), ("m", new.opt.m)):
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                out[tag + f"/{part}/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    """
)


def _tag(shape):
    return "x".join(map(str, shape))


def _cfg():
    return dataclasses.replace(qwen3_1_7b.smoke_config(), compute_dtype="float32").validate()


def _batches(cfg, n, seed=0, rows=8, T_len=16):
    g = torch.Generator().manual_seed(seed)
    return [{"tokens": torch.randint(0, cfg.vocab, (rows, T_len), generator=g),
             "group_weights": torch.tensor([1.0, 0.0, 1.0, 0.5])} for _ in range(n)]


def _weights(cfg, seed=1):
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(seed))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _meshless(cfg, sd, batches, ocfg, *, remat="none", accum_steps=1):
    """The meshless port: the first batch's gradients, and the history and
    parameters after a step per batch."""
    ctx = T.ModelContext(remat=remat)
    state = init_train_state(cfg, generator=None, model=T.model_from_state_dict(
        cfg, {k: v.clone() for k, v in sd.items()}))
    loss, _, grads = make_grad_fn(cfg, ctx)(state.params, batches[0])
    step = make_train_step(cfg, ctx, AdamWConfig(**ocfg), accum_steps=accum_steps)
    hist = []
    for b in batches:
        state, m = step(state, b)
        hist.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])})
    return {"loss": float(loss), "grads": {n: g.numpy() for n, g in grads.items()}, "history": hist,
            "params": {n: p.detach().numpy().copy() for n, p in state.params.named_parameters()}}


def _grad_gap(got: dict, want: dict) -> tuple:
    top = max(float(np.abs(w).max()) for w in want.values())
    return max((float(np.abs(got[n] - w).max()) / max(float(np.abs(w).max()), 1e-5 * top), n)
               for n, w in want.items())


def _param_gap(got: dict, want: dict) -> tuple:
    return max((float(np.abs(got[n] - w).max()), n) for n, w in want.items())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_mesh_train") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"), JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], capture_output=True, text=True,
                          timeout=540, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if key.startswith(prefix):
            *parents, leaf = key[len(prefix):].split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = val
    return tree


def _twin_cfg():
    return dataclasses.replace(_cfg(), n_layers=4, vocab=512, d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                               head_dim=32).validate()


def _trainer_kw():
    return dict(num_groups=4, num_shards=4, redundancy=2, scheme="cyclic", microbatch=1, seq_len=16, steps=5,
                straggler_deadline=1.4, warm_start=False)


@pytest.fixture(scope="module")
def inputs():
    cfg = _cfg()
    sd = _weights(cfg)
    return {"cfg": cfg, "sd": sd, "batches": _batches(cfg, 3), "accum": _batches(cfg, 1, seed=7)}


CARD_CUT = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16, vocab=256,
                compute_dtype="float32")  # chip_smoke.py's phase "train mesh" cut to the smoke widths, f32


@pytest.fixture(scope="module")
def card_oracle(tmp_path_factory):
    """The meshless oracle of ``mesh_runs.train_mesh_rank`` at ``CARD_CUT``
    (32 tokens a row), written as the card phase writes it."""
    from repro_torch.models.registry import get_config
    from repro_torch.train.optimizer import global_norm

    cfg = get_config("qwen3-1.7b", **CARD_CUT)
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0))
    batch = mesh_runs.train_mesh_batches(cfg, 0, torch.device("cpu"), 1, seq_len=32)[0]
    loss, _, grads = make_grad_fn(cfg, T.ModelContext())(state.params, batch)
    path = str(tmp_path_factory.mktemp("card_oracle") / "oracle.pt")
    torch.save({"grads": grads, "loss": float(loss), "grad_norm": float(global_norm(grads)),
                "top": max(float(g.abs().max()) for g in grads.values())}, path)
    return path, T.param_count(state.params)


@pytest.fixture(scope="module")
def port(inputs, reference, card_oracle):
    """Every job on one start of the ranks per world size, keyed by (kind,
    shape, tag)."""
    cfg, sd, batches = inputs["cfg"], inputs["sd"], inputs["batches"]
    jobs: dict = {}

    def add(key, kind, shape, **kw):
        jobs.setdefault(int(np.prod(shape)), []).append((key, (kind, shape, kw)))

    for shape in COLLECTIVE_MESHES:
        add(("collectives", shape), "collectives", shape, seed=3)
    for shape in STEP_MESHES:
        add(("step", shape, "none"), "step", shape, cfg=cfg, sd=sd, batches=batches, ocfg=OCFG)
    for remat in REMATS[1:]:
        add(("step", (2, 2), remat), "step", (2, 2), cfg=cfg, sd=sd, batches=batches[:1], ocfg=OCFG, remat=remat)
    add(("accum", (2, 2)), "step", (2, 2), cfg=cfg, sd=sd, batches=inputs["accum"], ocfg=OCFG, accum_steps=2)
    add(("trainer", (2, 2)), "trainer", (2, 2), cfg=cfg, sd=sd, tcfg_kw=_trainer_kw(), ocfg=None)
    add(("card", (1, 2)), "card", (1, 2), seed=0, oracle_path=card_oracle[0], remat="full",
        cfg_overrides=CARD_CUT, seq_len=32)
    twin = _twin_cfg()
    twin_sd = convert.transformer_params_from_jax(_unflatten(reference, "params/"))
    twin_batch = {"tokens": torch.from_numpy(reference["tokens"]).long(),
                  "group_weights": torch.from_numpy(reference["group_weights"])}
    for shape in TWIN_MESHES:
        add(("twin", shape), "step", shape, cfg=twin, sd=twin_sd, batches=[twin_batch], ocfg={}, remat="full")
    got = {}
    for world, todo in sorted(jobs.items()):
        results = D.run_ranks(mesh_runs.train_lm_rank, world, backend="gloo", device="cpu", timeout=DEADLINE,
                              args=([job for _, job in todo],))
        got.update({key: res for (key, _), res in zip(todo, results)})
    return got


@pytest.fixture(scope="module")
def meshless(inputs):
    cfg, sd, batches = inputs["cfg"], inputs["sd"], inputs["batches"]
    out = {remat: _meshless(cfg, sd, batches if remat == "none" else batches[:1], OCFG, remat=remat)
           for remat in REMATS}
    out["accum"] = _meshless(cfg, sd, inputs["accum"], OCFG, accum_steps=2)
    return out


# ------------------------------------------------------------ collectives


def _collective_oracle(mesh_shape, name, seed):
    """The meshless global loss of ``mesh_runs._collectives_job``'s case
    ``name`` and its gradients, by autograd in f64: for each rank, those
    of its inputs (its own X or its data shard's XR, a, c, w)."""
    world = int(np.prod(mesh_shape))
    m = mesh_shape[1]
    nd = world // m
    g = torch.Generator().manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, generator=g, dtype=torch.float64).requires_grad_(True)  # noqa: E731
    X, XR = draw(world, 3, 4), draw(nd, 3, 4)
    W = torch.randn((world, 3, 4 * world), generator=g, dtype=torch.float64)
    A, Cm, Wl = draw(world, 3, 4), draw(world, 3, 4), draw(world, 4, 2)
    grid = np.arange(world).reshape(mesh_shape)

    def group(r, ax):
        c = list(np.unravel_index(r, mesh_shape))
        i = ("data", "model").index(ax)
        return [int(grid[tuple(c[:i] + [j] + c[i + 1:])]) for j in range(mesh_shape[i])]

    total = 0.0
    for r in range(world):
        d = r // m
        if name == "psum":
            y = X.sum(0)
        elif name == "gather_axes":
            y = torch.cat([X[s] for s in range(world)], -1)
        elif name == "enter":
            y = XR[d]
        elif name == "split_linear":
            y = XR[d] @ Wl[r]
        elif name == "split_linear_gathered":
            y = torch.cat([XR[d] @ Wl[s] for s in group(r, "model")], -1)
        else:
            kind, ax = name.split("_", 1)
            ranks = group(r, ax)
            if kind == "gather":
                y = torch.cat([X[s] for s in ranks], -1)
            else:
                y = X[ranks[0]]
                for s in ranks:
                    y = y * Cm[s] + A[s]
        total = total + (W[r, :, :y.shape[-1]] * y).sum()
    dX, dXR, dA, dC, dW = torch.autograd.grad(total, [X, XR, A, Cm, Wl], allow_unused=True)
    alike = name in ("enter", "split_linear", "split_linear_gathered")
    zero = torch.zeros((world, 3, 4), dtype=torch.float64)
    return [[(dXR[r // m] if alike else dX[r]), (zero if dA is None else dA)[r], (zero if dC is None else dC)[r],
             (torch.zeros((world, 4, 2), dtype=torch.float64) if dW is None else dW)[r]] for r in range(world)]


@pytest.mark.parametrize("shape", COLLECTIVE_MESHES, ids=_tag)
def test_each_collective_backward_matches_autograd_of_the_meshless_loss(shape, port):
    res = port[("collectives", shape)]
    names = {"psum", "gather_axes", "chain_model", "enter", "split_linear", "split_linear_gathered"}
    names |= {f"gather_{ax}" for ax, n in zip(("data", "model"), shape) if n > 1}
    assert set(res) == names
    for name, got in res.items():
        want = _collective_oracle(shape, name, seed=3)
        assert got["calls"], name
        for r, (per_rank, w_rank) in enumerate(zip(got["grads"], want)):
            for j, (g, w) in enumerate(zip(per_rank, w_rank)):
                w = w.numpy()
                if g is None:
                    assert not np.any(w), (name, r, j)
                    continue
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=f"{name} rank {r} input {j}")
    # The backward collectives each rule runs: the batch axes sum, the model
    # axis slices a gather (nothing to move) and sums at an entry.
    calls = {name: got["calls"] for name, got in res.items()}
    assert calls["enter"].get("enter_bwd", 0) > 0 and calls["split_linear"].get("split_bwd", 0) > 0
    assert calls["chain_model"].get("chain_bwd", 0) > 0
    assert "gather_bwd" not in calls["gather_model"]
    if "gather_data" in calls:
        assert calls["gather_data"].get("gather_bwd", 0) > 0 and calls["psum"].get("sum_bwd", 0) > 0


# ------------------------------------------------------------------ step


@pytest.mark.parametrize("shape", STEP_MESHES, ids=_tag)
def test_mesh_step_matches_the_meshless_port(shape, port, meshless):
    res, want = port[("step", shape, "none")], meshless["none"]
    assert res["lockstep"]
    assert abs(res["first"]["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    gap, name = _grad_gap(res["grads"], want["grads"])
    assert gap <= 1e-5, (gap, name)
    for h, w in zip(res["history"], want["history"]):
        assert abs(h["loss"] - w["loss"]) <= 1e-6 * abs(w["loss"]), (h, w)
        assert abs(h["grad_norm"] - w["grad_norm"]) <= 1e-6 * abs(w["grad_norm"]), (h, w)
    pgap, pname = _param_gap(res["params"], want["params"])
    assert pgap <= PARAM_BAND, (pgap, pname)
    for name, (m, v, block) in res["moments"].items():
        assert m == v == block, (name, m, v, block)
    calls = res["first"]["calls"]
    if shape[0] > 1:  # the data shards' gradients summed: FSDP's reduce-scatter, the replicated blocks' sum
        assert calls.get("gather_bwd", 0) > 0 and calls.get("grad_sum", 0) > 0, calls
    if shape[1] > 1:  # the model axis: the split products' backward
        assert calls.get("split_bwd", 0) > 0, calls


def test_mesh_step_splits_blocks_and_falls_back_to_whole_kv_heads(port):
    """(2, 2) holds a quarter of a (data, model) weight's moments a rank;
    (1, 4) splits 4 query heads over 4 ranks while 2 KV heads do not
    divide the axis: ``wk``/``wv`` are gathered in the forward and their
    gradients summed back over ``model`` in the backward."""
    m22 = port[("step", (2, 2), "none")]["moments"]
    wq = m22["blocks.0.attn.wq"][0]
    assert wq == (64 // 2, 64 // 2)
    assert m22["blocks.0.attn_norm"][0] == (64,)
    m14 = port[("step", (1, 4), "none")]["moments"]
    assert m14["blocks.0.attn.wq"][0] == (64, 64 // 4) and m14["blocks.0.attn.wk"][0] == (64, 32 // 4)


# ---------------------------------------------------------------- remat


def test_remat_gives_the_same_gradients_meshless_and_on_a_mesh(port, meshless):
    cfg = _cfg()
    base = meshless["none"]["grads"]
    for remat in REMATS[1:]:
        gap, name = _grad_gap(meshless[remat]["grads"], base)
        assert gap <= 1e-6, (remat, gap, name)
    on_mesh = port[("step", (2, 2), "none")]["grads"]
    for remat in REMATS:
        res = port[("step", (2, 2), remat)]
        gap, name = _grad_gap(res["grads"], on_mesh)
        assert gap <= 1e-6, (remat, gap, name)
        assert res["first"]["attention_calls"] == cfg.n_layers * (1 if remat == "none" else 2), res["first"]
        assert res["history"][0]["attention_calls"] == res["first"]["attention_calls"]


def test_remat_counts_the_attention_calls_meshless(inputs):
    from repro_torch.kernels import dispatch

    cfg, sd, batch = inputs["cfg"], inputs["sd"], inputs["batches"][0]
    for remat, per_layer in (("none", 1), ("full", 2), ("dots", 2)):
        model = T.model_from_state_dict(cfg, {k: v.clone() for k, v in sd.items()})
        dispatch.reset_call_counts()
        make_grad_fn(cfg, make_context(None, remat=remat))(model, batch)
        assert dispatch.call_counts()["flash_attention"] == per_layer * cfg.n_layers, (remat, dispatch.call_counts())
    with pytest.raises(ValueError, match="remat"):
        make_context(None, remat="some")


# ----------------------------------------------------- reference's twin


@pytest.mark.parametrize("shape", TWIN_MESHES, ids=_tag)
def test_mesh_step_matches_the_reference_jitted_mesh_step(shape, reference, port):
    res = port[("twin", shape)]
    tag = _tag(shape)
    assert res["lockstep"]
    assert res["first"]["calls"] and sum(res["first"]["calls"].values()) > 0
    np.testing.assert_allclose(res["history"][0]["loss"], float(reference[f"{tag}/loss"]), rtol=1e-5)
    np.testing.assert_allclose(res["history"][0]["grad_norm"], float(reference[f"{tag}/grad_norm"]), rtol=1e-5)
    want = convert.transformer_params_from_jax(_unflatten(reference, f"{tag}/params/"))
    want_m = convert.transformer_params_from_jax(_unflatten(reference, f"{tag}/m/"))
    old = convert.transformer_params_from_jax(_unflatten(reference, "params/"))
    lr = cosine_schedule(AdamWConfig(), 1)
    for name, w in want.items():
        np.testing.assert_allclose(res["params"][name], w.numpy(), rtol=0, atol=1e-5, err_msg=name)
        m = want_m[name].numpy()
        assert np.abs(res["m"][name] - m).max() <= 1e-5 * np.abs(m).max(), name
        step, want_step = ((p - old[name].numpy()) / lr for p in (res["params"][name], w.numpy()))
        assert np.abs(step - want_step).max() <= UPDATE_BAND, (name, np.abs(step - want_step).max())
        assert np.abs(want_step).max() > 0.5, name


# ---------------------------------------------------------------- trainer


@pytest.fixture(scope="module")
def meshless_trainer(inputs):
    cfg, sd = inputs["cfg"], inputs["sd"]
    state = init_train_state(cfg, generator=None, model=T.model_from_state_dict(
        cfg, {k: v.clone() for k, v in sd.items()}))
    t = Trainer(cfg, TrainerConfig(**_trainer_kw()), device="cpu", initial_state=state)
    state = t.run()
    return {"history": t.history,
            "params": {n: p.detach().numpy().copy() for n, p in state.params.named_parameters()}}


def test_mesh_trainer_matches_the_meshless_trainer(port, meshless_trainer):
    res, want = port[("trainer", (2, 2))], meshless_trainer
    assert res["lockstep"] and res["hashes_per_step"] == len(want["history"]) == 5
    assert [h["stragglers"] for h in res["history"]] == [h["stragglers"] for h in want["history"]]
    assert [h["host_solves"] for h in res["history"]] == [h["host_solves"] for h in want["history"]]
    assert sum(h["stragglers"] for h in want["history"]) > 0
    for h, w in zip(res["history"], want["history"]):
        assert abs(h["loss"] - w["loss"]) <= 1e-5 * abs(w["loss"]), (h, w)
    pgap, pname = _param_gap(res["params"], want["params"])
    assert pgap <= 1e-5, (pgap, pname)


def test_mesh_accumulation_is_the_meshless_accumulated_step(port, meshless):
    res, want = port[("accum", (2, 2))], meshless["accum"]
    assert res["lockstep"]
    assert abs(res["history"][0]["loss"] - want["history"][0]["loss"]) <= 1e-6 * abs(want["history"][0]["loss"])
    pgap, pname = _param_gap(res["params"], want["params"])
    assert pgap <= PARAM_BAND, (pgap, pname)


def test_the_card_phase_rank_program_at_the_smoke_size(port, card_oracle):
    """``chip_smoke.py``'s phase "train mesh" rank program on (1, 2) at the
    smoke widths in f32: each rank's gradient blocks within 1e-5 of the
    meshless oracle's scale, the loss and the grad norm within 1e-6
    relative, the moments on ``state_shardings``' blocks, a rank's heads
    the shape of its attention calls, fewer parameters a rank than the
    whole model's."""
    rep = port[("card", (1, 2))]
    for r in rep["ranks"]:
        assert r["grad_gap"] <= 1e-5, (r["grad_gap"], r["grad_gap_at"])
        assert abs(r["loss"] - rep["oracle_loss"]) <= 1e-6 * abs(rep["oracle_loss"])
        assert abs(r["grad_norm"] - rep["oracle_grad_norm"]) <= 1e-6 * rep["oracle_grad_norm"]
        assert r["moments_ok"] and r["flash_shape"] == (8, 32, 32, 2, 1, 16)
        assert r["params_held"] < card_oracle[1]


# ------------------------------------------------------------ mesh of one


def test_a_world_of_one_mesh_trains_bit_for_bit(inputs):
    """Mesh (1, 1) over gloo in this process: two steps of the mesh step
    are the meshless steps to the bit (loss, parameters, moments) and move
    no data."""
    from repro_torch.launch import collectives as C

    D.node_mesh()
    cfg, sd, batches = inputs["cfg"], inputs["sd"], inputs["batches"][:2]
    mesh = make_test_mesh((1, 1))
    states = [init_train_state(cfg, generator=None, model=T.model_from_state_dict(
        cfg, {k: v.clone() for k, v in sd.items()}), mesh=m) for m in (None, mesh)]
    steps = [make_train_step(cfg, c, AdamWConfig(**OCFG)) for c in (T.ModelContext(), make_context(mesh))]
    C.STATS.reset()
    for b in batches:
        outs = [step(st, b) for step, st in zip(steps, states)]
        states = [o[0] for o in outs]
        assert torch.equal(outs[0][1]["loss"], outs[1][1]["loss"])
        assert torch.equal(outs[0][1]["grad_norm"], outs[1][1]["grad_norm"])
    assert not C.STATS.calls
    for (n, p), (_, q) in zip(states[0].params.named_parameters(), states[1].params.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(states[0].opt.m[n], states[1].opt.m[n]), n
        assert torch.equal(states[0].opt.v[n], states[1].opt.v[n]), n
