"""The port's LM mesh (``repro_torch.launch.{mesh,sharding,collectives}``
and the mesh paths of ``repro_torch.models``) against the reference's on
the CPU: a dense model's serving path and the head-parallel sLSTM.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_launch.py`` runs it; this process keeps one device), jitted
with its ``param_shardings``, ``cache_shardings`` and ``make_context`` on
each mesh, and writes its params, inputs and outputs to an ``.npz``.  The
port runs the same converted weights on gloo ranks (``run_ranks``: spawn,
a ``FileStore``), one start per world size, every rank holding only its
blocks of the parameters (``shard_model``); each rank's rows are gathered
whole for the comparison.  A world of one over gloo, mesh (1, 1), runs in
this process.

Tolerances, all f32: prefill and decode logits within 1e-5 of the logits'
scale (max|a − b| / max|b|) of the reference's mesh run and of the port's
meshless run (the sums over the model axis add the same terms in another
order); the sLSTM block's output likewise within 1e-5; mesh (1, 1) bit for
bit with the meshless port (an axis of size 1 moves nothing).  Every model
rank of a data shard returns the same bits.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import musicgen_large, qwen3_4b, xlstm_1_3b
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh_runs
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.sharding import make_context, shard_model
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.serve import decode as SD

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240.0
DENSE_MESHES = [(2, 2), (1, 4), (2, 2, 2)]
SLSTM_MESHES = [(1, 2), (1, 4)]
TOL = 1e-5

_REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import qwen3_4b, xlstm_1_3b
    from repro.launch.compat import make_auto_mesh
    from repro.launch.sharding import make_context, param_shardings, cache_shardings
    from repro.models import transformer as JT, xlstm as JX

    out = {}
    rng = np.random.default_rng(0)

    def perturbed(tree):
        def one(path, leaf):
            leaf = np.array(leaf)
            if "norm" in jax.tree_util.keystr(path):
                leaf = (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
            return leaf
        return jax.tree_util.tree_map_with_path(one, tree)

    def save_tree(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)

    def axes_of(shape):
        return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")

    cfg = dataclasses.replace(qwen3_4b.smoke_config(), compute_dtype="float32").validate()
    params = perturbed(JT.init_params(jax.random.PRNGKey(0), cfg))
    save_tree("dense_params/", params)
    tokens = rng.integers(0, cfg.vocab, size=(4, 16)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, size=(4, 6)).astype(np.int32)
    out["dense_tokens"], out["dense_decode_tokens"] = tokens, dec
    for shape in %(dense)r:
        mesh = make_auto_mesh(shape, axes_of(shape))
        ctx = make_context(mesh)
        p = jax.device_put(params, param_shardings(params, mesh))
        logits, _ = jax.jit(lambda p, b: JT.prefill(p, b, cfg, ctx))(p, {"tokens": jnp.asarray(tokens)})
        cache = JT.init_cache(cfg, 4, dec.shape[1])
        cache = jax.device_put(cache, cache_shardings(cache, mesh, 4))
        step = jax.jit(lambda p, c, t, n: JT.decode_step(p, c, t, n, cfg, ctx))
        steps = []
        for t in range(dec.shape[1]):
            lg, cache = step(p, cache, jnp.asarray(dec[:, t:t + 1]), jnp.int32(t))
            steps.append(np.asarray(lg[:, 0]))
        tag = "x".join(map(str, shape))
        out[f"dense_{tag}_prefill"] = np.asarray(logits)
        out[f"dense_{tag}_decode"] = np.stack(steps, 1)

    xcfg = dataclasses.replace(xlstm_1_3b.smoke_config(), compute_dtype="float32").validate()
    sp = perturbed(JX.slstm_init(jax.random.PRNGKey(1), xcfg))
    save_tree("slstm_params/", sp)
    x = rng.normal(size=(4, 12, xcfg.d_model)).astype(np.float32)
    out["slstm_x"] = x
    for shape in %(slstm)r:
        mesh = make_auto_mesh(shape, axes_of(shape))
        ctx = make_context(mesh)
        p = jax.device_put(sp, param_shardings(sp, mesh))
        y = jax.jit(lambda p, x: JX.slstm_apply(p, x, xcfg, ctx=ctx))(p, jnp.asarray(x))
        out["slstm_%%s" %% "x".join(map(str, shape))] = np.asarray(y)
    np.savez(sys.argv[1], **out)
    """
) % {"dense": DENSE_MESHES, "slstm": SLSTM_MESHES}


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


def _tag(shape):
    return "x".join(map(str, shape))


def _gap(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a, np.float32)), torch.as_tensor(np.asarray(b, np.float32))
    return float((a - b).abs().max() / b.abs().max())


def _cfgs():
    import dataclasses

    dense = dataclasses.replace(qwen3_4b.smoke_config(), compute_dtype="float32").validate()
    xl = dataclasses.replace(xlstm_1_3b.smoke_config(), compute_dtype="float32").validate()
    return dense, xl


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_mesh") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"), JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], capture_output=True, text=True,
                          timeout=540, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def inputs(reference):
    dense, xl = _cfgs()
    sd = convert.transformer_params_from_jax(_unflatten(reference, "dense_params/"))
    slstm_sd = {k.replace("/", "."): torch.from_numpy(np.array(v))
                for k, v in _unflatten_flat(reference, "slstm_params/").items()}
    return {
        "dense": dense, "xlstm": xl, "sd": sd, "slstm_sd": slstm_sd,
        "tokens": torch.from_numpy(reference["dense_tokens"]).long(),
        "decode_tokens": torch.from_numpy(reference["dense_decode_tokens"]).long(),
        "x": torch.from_numpy(reference["slstm_x"]),
    }


def _unflatten_flat(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def meshless(inputs):
    """The port without a mesh: prefill, teacher-forced decode, the sLSTM block."""
    cfg, sd = inputs["dense"], inputs["sd"]
    model = T.model_from_state_dict(cfg, sd)
    ctx = T.ModelContext()
    with torch.no_grad():
        logits, _ = T.prefill(model, {"tokens": inputs["tokens"]}, cfg, ctx)
        dec = inputs["decode_tokens"]
        cache, steps = T.init_cache(cfg, dec.shape[0], dec.shape[1], device="cpu"), []
        for t in range(dec.shape[1]):
            lg, cache = T.decode_step(model, cache, dec[:, t:t + 1], t, cfg, ctx)
            steps.append(lg[:, 0])
        blk = X.SLSTMBlock(inputs["xlstm"], dtype=torch.float32, device="meta", generator=None)
        blk.load_state_dict(inputs["slstm_sd"], assign=True)
        y = X.slstm_apply(blk, inputs["x"], inputs["xlstm"])
    return {"prefill": logits, "decode": torch.stack(steps, 1), "slstm": y}


@pytest.fixture(scope="module")
def codebooks():
    """musicgen-large's smoke model (two codebook streams) drawn by the
    port, its inputs, and its meshless prefill and decode."""
    import dataclasses

    cfg = dataclasses.replace(musicgen_large.smoke_config(), compute_dtype="float32").validate()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (4, cfg.num_codebooks, 12), generator=g)
    dec = torch.randint(0, cfg.vocab, (4, cfg.num_codebooks, 4), generator=g)
    ctx = T.ModelContext()
    with torch.no_grad():
        logits, _ = T.prefill(model, {"tokens": tokens}, cfg, ctx)
        cache, steps = T.init_cache(cfg, 4, dec.shape[-1], device="cpu"), []
        for t in range(dec.shape[-1]):
            lg, cache = T.decode_step(model, cache, dec[..., t:t + 1], t, cfg, ctx)
            steps.append(lg[:, 0])
    return {"job": dict(cfg=cfg, sd=dict(model.state_dict()), tokens=tokens, decode_tokens=dec),
            "prefill": logits, "decode": torch.stack(steps, 1)}


@pytest.fixture(scope="module")
def port(inputs, codebooks):
    """Each mesh's jobs on one start of the ranks per world size, keyed by
    (kind, shape, the model's name)."""
    serve = dict(cfg=inputs["dense"], sd=inputs["sd"], tokens=inputs["tokens"],
                 decode_tokens=inputs["decode_tokens"])
    slstm = dict(cfg=inputs["xlstm"], sd=inputs["slstm_sd"], x=inputs["x"])
    jobs: dict = {}
    for shape in DENSE_MESHES:
        jobs.setdefault(int(np.prod(shape)), []).append(("serve", shape, serve))
    for shape in SLSTM_MESHES:
        jobs.setdefault(int(np.prod(shape)), []).append(("slstm", shape, slstm))
    jobs[4].append(("serve", (2, 2), codebooks["job"]))
    got = {}
    for world, todo in sorted(jobs.items()):
        results = D.run_ranks(mesh_runs.lm_rank, world, backend="gloo", device="cpu", timeout=DEADLINE,
                              args=(todo,))
        for (kind, shape, kw), res in zip(todo, results):
            got[(kind, tuple(shape), kw["cfg"].name)] = res
    return got


@pytest.mark.parametrize("shape", DENSE_MESHES, ids=_tag)
def test_dense_prefill_and_decode_on_a_mesh_match_the_reference_and_meshless(shape, reference, meshless, port):
    res = port[("serve", shape, "qwen3-4b")]
    assert res["lockstep"]
    want_p, want_d = reference[f"dense_{_tag(shape)}_prefill"], reference[f"dense_{_tag(shape)}_decode"]
    assert tuple(res["prefill"].shape) == want_p.shape and tuple(res["decode"].shape) == want_d.shape
    assert _gap(res["prefill"], want_p) < TOL and _gap(res["decode"], want_d) < TOL
    assert _gap(res["prefill"], meshless["prefill"]) < TOL and _gap(res["decode"], meshless["decode"]) < TOL


@pytest.mark.parametrize("shape", SLSTM_MESHES, ids=_tag)
def test_slstm_head_parallel_matches_the_reference_and_meshless(shape, reference, meshless, port):
    res = port[("slstm", shape, "xlstm-1.3b")]
    assert res["lockstep"]
    assert _gap(res["out"], reference[f"slstm_{_tag(shape)}"]) < TOL
    assert _gap(res["out"], meshless["slstm"]) < TOL


def test_codebook_embedding_and_head_are_vocab_parallel_on_a_mesh(codebooks, port):
    """musicgen's (K, V, d) embedding and (d, V·K) head split over the
    vocabulary of a (2, 2) mesh: each codebook's lookups joined by one sum,
    the K codebooks summed in order, the logits gathered; within 1e-5 of
    the meshless port."""
    res = port[("serve", (2, 2), "musicgen-large")]
    assert res["lockstep"]
    assert tuple(res["prefill"].shape) == tuple(codebooks["prefill"].shape)
    assert _gap(res["prefill"], codebooks["prefill"]) < TOL and _gap(res["decode"], codebooks["decode"]) < TOL


def test_a_world_of_one_mesh_is_the_meshless_port_bit_for_bit(inputs, meshless):
    D.node_mesh()  # a world of one over gloo in this process, unless a group exists
    mesh = make_test_mesh((1, 1))
    cfg = inputs["dense"]
    res = mesh_runs.lm_job("serve", (1, 1), cfg=cfg, sd=inputs["sd"], tokens=inputs["tokens"],
                           decode_tokens=inputs["decode_tokens"])
    assert np.array_equal(res["prefill"], meshless["prefill"].numpy())
    assert np.array_equal(res["decode"], meshless["decode"].numpy())
    y = mesh_runs.lm_job("slstm", (1, 1), cfg=inputs["xlstm"], sd=inputs["slstm_sd"], x=inputs["x"])["out"]
    assert np.array_equal(y, meshless["slstm"].numpy())
    model = T.model_from_state_dict(cfg, inputs["sd"])
    want = SD.greedy_generate(model, cfg, inputs["tokens"][:, :5], steps=4)
    sharded = shard_model(T.model_from_state_dict(cfg, inputs["sd"]), mesh)
    got = SD.greedy_generate(sharded, cfg, inputs["tokens"][:, :5], steps=4, ctx=make_context(mesh))
    assert torch.equal(got, want)
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    want = SD.greedy_generate(model, cfg, inputs["tokens"][:, :5], steps=4, temperature=0.8, generator=gen())
    got = SD.greedy_generate(sharded, cfg, inputs["tokens"][:, :5], steps=4, ctx=make_context(mesh),
                             temperature=0.8, generator=gen())
    assert torch.equal(got, want)


def test_training_on_a_mesh_raises_where_it_is_not_ported():
    """A no-grad forward on (1, 1) keeps its logits' shape.  Compression
    and checkpoints on an LM mesh are ported: the step, the state and the
    trainer take them (``tests/test_torch_lm_mesh_ckpt.py`` holds them to
    the reference).  The raises of training on an LM mesh that remain:
    ``device_recovery`` with an LM mesh (no such path in the reference),
    and accumulation that would split a group over the data shards
    (checked before any collective, so its mesh needs no process
    group)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.compression import CompressionConfig
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    D.node_mesh()
    cfg = _cfgs()[0]
    mesh = make_test_mesh((1, 1))
    ctx = make_context(mesh)
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), mesh=mesh)
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.long)}
    with torch.no_grad():
        logits, _, _ = T.forward_train(state.params, batch, cfg, ctx)
    assert logits.shape == (2, 4, cfg.vocab)
    comp = CompressionConfig()
    assert callable(make_train_step(cfg, ctx, AdamWConfig(), compression=comp))
    compressed = init_train_state(cfg, generator=torch.Generator().manual_seed(0), compression=comp, mesh=mesh)
    assert {n: tuple(t.shape) for n, t in compressed.ef.items()} == {
        n: tuple(p.shape) for n, p in compressed.params.named_parameters()}
    trainer = Trainer(cfg, TrainerConfig(ckpt_dir="unused", warm_start=False), ctx=ctx, device="cpu")
    assert trainer.mesh is mesh and trainer.tcfg.ckpt_dir == "unused"
    with pytest.raises(ValueError, match="device_recovery"):
        Trainer(cfg, TrainerConfig(device_recovery=True), ctx=ctx, device="cpu")
    split = Mesh(("data", "model"), (2, 1), coords=(0, 0), groups=(None, None))
    step = make_train_step(cfg, make_context(split), AdamWConfig(), accum_steps=2)
    tokens = torch.zeros((6, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="whole groups"):
        step(state, {"tokens": tokens, "group_weights": torch.ones(3)})
