"""The port's sequence-parallel decode (``make_context(mesh,
cache_layout="seq")``: each attention layer's cache holds all KV heads of
the rank's block of the slots, the softmax's statistics combined over the
model axis) against the reference's GSPMD decode under
``cache_shardings(..., layout="seq")`` on the CPU.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, jitted with its
``param_shardings`` and its seq-layout ``cache_shardings`` as the cache's
input and output shardings, and writes its params, inputs and decode
logits to an ``.npz``.  The port runs the same converted weights on gloo
ranks (``mesh_runs.lm_rank``), one start per world size (2, 4, 8).  The
dry run of the (2, 2) step runs in a second subprocess beside the
reference's.

Tolerances: f32 logits within 1e-5 of the logits' scale (max|a − b| /
max|b|) of the reference's seq-layout run and of the port's meshless run
(the split changes the f32 order of the softmax's sum and of p·V's sum
over the slots); bf16 within ``MESH_BAND`` = 2e-2 of the port's meshless
run (an f32 ulp of the sum can move p by a bf16 ulp); a model axis of size
1 bit for bit the feature layout.  Every model rank of a data shard
returns the same bits.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import qwen3_4b, recurrentgemma_9b
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh_runs
from repro_torch.launch import sharding as S
from repro_torch.launch.mesh import Mesh
from repro_torch.models import transformer as T

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240.0
DENSE_MESHES = [(1, 2), (2, 2), (1, 4), (2, 2, 2)]
RING_MESH = (2, 2)
STEPS, RING_STEPS = 8, 40  # 8 slots; the ring's 40 steps wrap its window of 32
TOL = 1e-5
MESH_BAND = 2e-2

_REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import qwen3_4b, recurrentgemma_9b
    from repro.launch.compat import make_auto_mesh
    from repro.launch.sharding import make_context, param_shardings, cache_shardings
    from repro.models import transformer as JT

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

    def decode(name, cfg, params, dec, shapes):
        for shape in shapes:
            mesh = make_auto_mesh(shape, axes_of(shape))
            ctx = make_context(mesh)
            p_sh = param_shardings(params, mesh)
            cache = JT.init_cache(cfg, dec.shape[0], dec.shape[1])
            c_sh = cache_shardings(cache, mesh, dec.shape[0], layout="seq")
            step = jax.jit(lambda p, c, t, n: JT.decode_step(p, c, t, n, cfg, ctx),
                           in_shardings=(p_sh, c_sh, None, None), out_shardings=(None, c_sh))
            p, cache = jax.device_put(params, p_sh), jax.device_put(cache, c_sh)
            steps = []
            for t in range(dec.shape[1]):
                lg, cache = step(p, cache, jnp.asarray(dec[:, t:t + 1]), jnp.int32(t))
                steps.append(np.asarray(lg[:, 0]))
            out[name + "_" + "x".join(map(str, shape))] = np.stack(steps, 1)

    cfg = dataclasses.replace(qwen3_4b.smoke_config(), compute_dtype="float32").validate()
    params = perturbed(JT.init_params(jax.random.PRNGKey(0), cfg))
    save_tree("dense_params/", params)
    dec = rng.integers(0, cfg.vocab, size=(4, %(steps)d)).astype(np.int32)
    rcfg = dataclasses.replace(recurrentgemma_9b.smoke_config(), compute_dtype="float32").validate()
    rparams = perturbed(JT.init_params(jax.random.PRNGKey(1), rcfg))
    save_tree("ring_params/", rparams)
    rdec = rng.integers(0, rcfg.vocab, size=(4, %(ring_steps)d)).astype(np.int32)
    out["dense_tokens"], out["ring_tokens"] = dec, rdec
    decode("dense", cfg, params, dec, %(dense)r)
    decode("ring", rcfg, rparams, rdec, [%(ring)r])
    np.savez(sys.argv[1], **out)
    """
) % {"dense": DENSE_MESHES, "ring": RING_MESH, "steps": STEPS, "ring_steps": RING_STEPS}

# The dry run of the (2, 2) decode twin at the smoke widths, one step under
# each layout (a fake group of 4 must not meet this process's groups).
_DRY_RUN = textwrap.dedent(
    """
    import json, sys
    from repro_torch.launch.dryrun import lower_cell
    over = dict(vocab=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=128, head_dim=16,
                compute_dtype="float32")
    recs = {layout: lower_cell("qwen3-4b", "decode_32k", mesh_shape=(2, 2), batch=4, seq_len=%(steps)d,
                               cache_layout=layout, cfg_overrides=over) for layout in ("feature", "seq")}
    print(json.dumps(recs))
    """
) % {"steps": STEPS}


def _tag(shape):
    return "x".join(map(str, shape))


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


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


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"), JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's npz and the dry run's records, both subprocesses
    started at once."""
    path = tmp_path_factory.mktemp("seq_decode") / "reference.npz"
    procs = [subprocess.Popen([sys.executable, "-c", code, *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=_env(), cwd=_REPO)
             for code, args in ((_REFERENCE, (str(path),)), (_DRY_RUN, ()))]
    try:
        (_, ref_err), (dry_out, dry_err) = (p.communicate(timeout=540) for p in procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[0].returncode == 0, ref_err[-3000:]
    assert procs[1].returncode == 0, dry_err[-3000:]
    with np.load(path) as z:
        got = {k: z[k] for k in z.files}
    got["dry_run"] = json.loads(dry_out.strip().splitlines()[-1])
    return got


def _cfg(mod, dtype="float32"):
    return dataclasses.replace(mod.smoke_config(), compute_dtype=dtype).validate()


def _meshless(cfg, sd, dec):
    model = T.model_from_state_dict(cfg, sd)
    ctx = T.ModelContext()
    cache, steps = T.init_cache(cfg, dec.shape[0], dec.shape[1], device="cpu"), []
    with torch.no_grad():
        for t in range(dec.shape[1]):
            lg, cache = T.decode_step(model, cache, dec[:, t:t + 1], t, cfg, ctx)
            steps.append(lg[:, 0])
    return torch.stack(steps, 1).float().numpy(), cache


@pytest.fixture(scope="module")
def inputs(reference):
    dense, ring, bf16 = _cfg(qwen3_4b), _cfg(recurrentgemma_9b), qwen3_4b.smoke_config().validate()
    sd = convert.transformer_params_from_jax(_unflatten(reference, "dense_params/"))
    rsd = convert.transformer_params_from_jax(_unflatten(reference, "ring_params/"))
    dec = torch.from_numpy(reference["dense_tokens"]).long()
    rdec = torch.from_numpy(reference["ring_tokens"]).long()
    meshless, cache = _meshless(dense, sd, dec)
    return {
        "dense": dict(cfg=dense, sd=sd, decode_tokens=dec), "ring": dict(cfg=ring, sd=rsd, decode_tokens=rdec),
        "bf16": dict(cfg=bf16, sd=sd, decode_tokens=dec), "meshless": meshless, "meshless_cache": cache,
        "ring_meshless": _meshless(ring, rsd, rdec)[0], "bf16_meshless": _meshless(bf16, sd, dec)[0],
    }


@pytest.fixture(scope="module")
def port(inputs):
    """Each job on one start of the ranks per world size, keyed by a label."""
    jobs = {
        2: [("dense (1, 2)", "seq_decode", (1, 2), dict(inputs["dense"])),
            ("seq (2, 1)", "seq_decode", (2, 1), dict(inputs["dense"])),
            ("feature (2, 1)", "seq_decode", (2, 1), dict(inputs["dense"], cache_layout="feature"))],
        4: [("dense (2, 2)", "seq_decode", (2, 2), dict(inputs["dense"], count=True)),
            ("dense (1, 4)", "seq_decode", (1, 4), dict(inputs["dense"])),
            ("ring (2, 2)", "seq_decode", RING_MESH, dict(inputs["ring"])),
            ("bf16 (2, 2)", "seq_decode", (2, 2), dict(inputs["bf16"]))],
        8: [("dense (2, 2, 2)", "seq_decode", (2, 2, 2), dict(inputs["dense"]))],
    }
    got = {}
    for world, todo in jobs.items():
        results = D.run_ranks(mesh_runs.lm_rank, world, backend="gloo", device="cpu", timeout=DEADLINE,
                              args=([(kind, shape, kw) for _, kind, shape, kw in todo],))
        for (label, *_), res in zip(todo, results):
            got[label] = res
    return got


@pytest.mark.parametrize("shape", DENSE_MESHES, ids=_tag)
def test_dense_seq_decode_matches_the_references_seq_layout_and_meshless(shape, reference, inputs, port):
    """qwen3-4b smoke in f32, 8 teacher-forced steps in 8 slots; (1, 4) is
    the GQA fallback (2 KV heads over 4 model ranks: each rank projects
    every KV head once)."""
    res = port[f"dense {shape}"]
    assert res["lockstep"]
    want = reference[f"dense_{_tag(shape)}"]
    assert res["decode"].shape == want.shape == inputs["meshless"].shape
    assert _gap(res["decode"], want) < TOL
    assert _gap(res["decode"], inputs["meshless"]) < TOL
    m = shape[-1]
    assert res["k_shapes"] == [(4 // int(np.prod(shape[:-1])), STEPS // m, 2, 16)] * 4


def test_ring_seq_decode_wraps_like_the_reference(reference, inputs, port):
    """recurrentgemma-9b smoke: the local-attention ring (window 32) split
    16 slots a rank, 40 steps so that the ring wraps; its block runs whole
    on the rank's rows with the mesh kept for the softmax's sums."""
    res = port["ring (2, 2)"]
    assert res["lockstep"]
    assert res["k_shapes"] == [(2, 16, 1, 16)] * 2
    assert _gap(res["decode"], reference[f"ring_{_tag(RING_MESH)}"]) < TOL
    assert _gap(res["decode"], inputs["ring_meshless"]) < TOL


def test_bf16_seq_decode_within_the_mesh_band(inputs, port):
    res = port["bf16 (2, 2)"]
    assert res["lockstep"]
    assert _gap(res["decode"], inputs["bf16_meshless"]) < MESH_BAND


def test_a_model_axis_of_one_is_the_feature_layout_bit_for_bit(inputs, port):
    seq, feature = port["seq (2, 1)"], port["feature (2, 1)"]
    assert np.array_equal(seq["decode"], feature["decode"])
    assert seq["k_shapes"] == feature["k_shapes"] == [(2, STEPS, 2, 16)] * 4
    assert _gap(seq["decode"], inputs["meshless"]) < TOL


def test_steps_whose_later_ranks_hold_only_masked_slots_are_finite(port):
    """The first S/m steps: ranks ≥ 1 add exp(−inf) = 0 and no NaN."""
    for shape in DENSE_MESHES:
        first = port[f"dense {shape}"]["decode"][:, :STEPS // shape[-1]]
        assert np.isfinite(first).all() and np.abs(first).max() > 0


def _stand_in(shape, coords) -> Mesh:
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return Mesh(axes, tuple(shape), coords=tuple(coords), groups=(None,) * len(shape))


def _ref_specs(cache_tree, shape, layout, monkeypatch):
    from repro.launch import sharding as JS

    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    mesh = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))
    return JS.cache_shardings(cache_tree, mesh, 4, layout=layout)


def test_init_cache_rank_blocks_are_the_seq_shardings_blocks(inputs, port, monkeypatch):
    """On (2, 2) each rank's cache is its block under the port's and the
    reference's ``cache_shardings(..., layout="seq")`` (rows over data,
    slots over model), and after the decode its first layer's K block is
    the meshless cache's block."""
    import jax

    cfg = inputs["dense"]["cfg"]
    full = inputs["meshless_cache"]
    tree = {"k": jax.ShapeDtypeStruct(tuple(full[0]["k"].shape), np.float32)}
    ref_spec = tuple(_ref_specs(tree, (2, 2), "seq", monkeypatch)["k"])
    spec = S.cache_shardings({"k": full[0]["k"]}, _stand_in((2, 2), (0, 0)), 4, layout="seq")["k"]
    assert spec == ref_spec == ("data", "model", None, None)
    res = port["dense (2, 2)"]
    assert res["k_shapes"][0] == S.block_shape(tuple(full[0]["k"].shape), spec, _stand_in((2, 2), (0, 0)))
    assert sorted(c for c, _ in res["k_blocks"]) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for coords, block in res["k_blocks"]:
        want = full[0]["k"][S.block_slices(tuple(full[0]["k"].shape), spec, _stand_in((2, 2), coords))]
        assert block.shape == tuple(want.shape)
        assert _gap(block, want.numpy()) < TOL
    assert len(res["k_shapes"]) == cfg.n_layers


def test_slots_that_the_model_axis_does_not_divide_raise():
    cfg = _cfg(qwen3_4b)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    ctx = S.make_context(_stand_in((1, 3), (0, 0)), cache_layout="seq")
    with pytest.raises(ValueError, match="8 slots .* 3 ranks"):
        T.init_cache(cfg, 4, 8, device="cpu", model=model, ctx=ctx)
    assert T.init_cache(cfg, 4, 9, device="cpu", model=model, ctx=ctx)[0]["k"].shape == (4, 3, 2, 16)
    with pytest.raises(ValueError, match="cache_layout"):
        T.ModelContext(cache_layout="heads")
    assert ctx.local().cache_layout == "seq" and ctx.local().seq_split() is None
    assert S.make_context(_stand_in((1, 1), (0, 0)), cache_layout="seq").seq_split() is None


def test_references_seq_spec_on_a_one_by_m_mesh_is_its_feature_spec(monkeypatch):
    """The reference splits the slots only where the batch is split over
    a data axis of size > 1 (``src/repro/launch/sharding.py:221-228``): on
    (1, m) its seq spec is the feature spec, and so is the port's spec.
    The port's seq decode splits the slots on every model axis of size > 1
    (ROADMAP §3)."""
    import jax

    tree = {"k": jax.ShapeDtypeStruct((4, 8, 2, 16), np.float32)}
    for shape in ((1, 2), (1, 4)):
        seq, feature = (_ref_specs(tree, shape, lay, monkeypatch)["k"] for lay in ("seq", "feature"))
        assert tuple(seq) == tuple(feature) == (None, None, None, "model")
        port = S.cache_shardings({"k": torch.empty((4, 8, 2, 16))}, _stand_in(shape, (0, 0)), 4, layout="seq")
        assert port["k"] == tuple(seq)
    assert S.make_context(_stand_in((1, 4), (0, 0)), cache_layout="seq").seq_split() == (4, 0)


def test_seq_minus_feature_collectives_are_the_stats_and_the_head_gathers(inputs, reference, port):
    """One decode step on (2, 2), seq minus feature, counted by
    ``collectives.STATS``: per attention layer a ``pmax`` and two ``sum``s
    (the row max, Σ exp, p·V), and one gather of q, k and v (m broadcasts)
    in place of the output's, k and v its added bytes; the dry run of the
    same step predicts the same calls and bytes."""
    cfg, m, B_loc = inputs["dense"]["cfg"], 2, 2
    got = port["dense (2, 2)"]["collectives"]
    calls, nbytes = ({k: got["seq"][part].get(k, 0) - got["feature"][part].get(k, 0)
                      for k in set(got["seq"][part]) | set(got["feature"][part])} for part in ("calls", "bytes"))
    L, H, KV, dh = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert calls == {"pmax": L, "sum": 2 * L, "gather": 0}
    row = B_loc * H * 4  # one f32 statistic a (row, head)
    kv = B_loc * 2 * (KV // m) * dh * 4  # the rank's k and v of one token, gathered beside q
    assert nbytes == {"pmax": L * row, "sum": L * (row + B_loc * H * dh * 4), "gather": L * m * kv}
    dry = reference["dry_run"]
    for layout in ("feature", "seq"):
        assert dry[layout]["collectives"]["calls_by_kind"] == got[layout]["calls"]
        assert dry[layout]["collectives"]["by_kind"] == {k: float(v) for k, v in got[layout]["bytes"].items()}
