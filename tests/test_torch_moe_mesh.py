"""The port's MoE under an LM mesh against the reference's, on the CPU:
experts over the model axis, FSDP expert weights, ``routing="pjit"`` and
``"local"``, the global-capacity branch of a model axis of size 1, and the
MoE smoke model's prefill on a (data, model) mesh.

The reference runs once, in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_launch.py`` runs it), at deepseek-moe-16b's smoke config in
f32: ``moe_apply`` eagerly with the mesh arguments of
``tests/test_launch.py:138-157``, the prefill jitted with its
``param_shardings``, each layer's combine weights recorded by a
``jax.debug.callback`` in its ``_routing``.  The port runs the same
converted weights on gloo ranks (``run_ranks``), one start per world
size, each rank holding only its blocks.

Tolerances: ``moe_apply``'s output within 2e-4 of its scale, the
reference's own band (``tests/test_launch.py:156-157``), each aux loss
within 1e-5 relative of the reference's for its routing, and the two
routings' outputs equal bit for bit (they route alike; only the aux
differs).  The prefill by the flip rule of ``tests/test_torch_moe.py`` at
its f32 band: with no routing decision that differs from the reference's,
the logits within 1e-4 of their scale; otherwise the K caches of every
layer up to the first that differs within 1e-4 relative in norm; then,
with the reference's decisions replayed on every rank, the logits within
1e-4.  Every model rank of a data shard returns the same bits.

The rank program of ``chip_smoke.py``'s phase "serve mesh" runs here too,
at the smoke widths in bf16 on (1, 2) and (2, 2): its prefill and
teacher-forced decode equal the meshless oracle's to the bit.
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
from repro_torch.configs import deepseek_moe_16b
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh_runs
from repro_torch.launch.mesh import MeshShape
from repro_torch.launch.sharding import param_shardings
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import MoEConfig, get_config
from repro_torch.serve import decode as SD

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240.0
MOE_MESHES = [(2, 4), (4, 1)]
PREFILL_MESH = (2, 2)
BAND, AUX, PREFILL = 2e-4, 1e-5, 1e-4

_REFERENCE = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import deepseek_moe_16b
    from repro.launch.compat import make_auto_mesh
    from repro.launch.sharding import make_context, param_shardings
    from repro.models import moe as JM, transformer as JT

    out = {}
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(deepseek_moe_16b.smoke_config(), compute_dtype="float32").validate()

    def perturbed(path, leaf):
        leaf = np.array(leaf)
        if "norm" in jax.tree_util.keystr(path):
            leaf = (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturbed, JT.init_params(jax.random.PRNGKey(0), cfg))
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["params/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)

    layer = jax.tree_util.tree_map(lambda a: jnp.asarray(a[1]), params["unit"]["slot0"]["moe"])
    x = rng.normal(size=(8, 16, cfg.d_model)).astype(np.float32)
    out["x"] = x
    for shape in %(moe)r:
        mesh = make_auto_mesh(shape, ("data", "model"))
        kw = dict(mesh=mesh, batch_axes=("data",), model_axis="model", fsdp_axis="data")
        for routing in ("pjit", "local"):
            o, aux = JM.moe_apply(layer, jnp.asarray(x), cfg, routing=routing, **kw)
            tag = "x".join(map(str, shape))
            out[f"moe_{tag}_{routing}"] = np.asarray(o)
            out[f"moe_{tag}_{routing}_aux"] = np.asarray(aux)

    log = []
    orig = JM._routing

    def recorded(*args, **kw):
        w, aux = orig(*args, **kw)
        jax.debug.callback(lambda v: log.append(np.asarray(v)), w)
        return w, aux

    JM._routing = recorded
    tokens = rng.integers(0, cfg.vocab, size=(4, 16)).astype(np.int32)
    out["tokens"] = tokens
    mesh = make_auto_mesh(%(prefill)r, ("data", "model"))
    ctx = make_context(mesh)
    p = jax.device_put(params, param_shardings(params, mesh))
    logits, cache = jax.jit(lambda p, b: JT.prefill(p, b, cfg, ctx))(p, {"tokens": jnp.asarray(tokens)})
    jax.effects_barrier()
    out["prefill"] = np.asarray(logits)
    out["prefill_k"] = np.asarray(cache["unit"]["slot0"]["k"])
    assert len(log) == cfg.n_layers, len(log)
    for i, w in enumerate(log):
        out[f"prefill_w{i}"] = w
    np.savez(sys.argv[1], **out)
    """
) % {"moe": MOE_MESHES, "prefill": PREFILL_MESH}


def _tag(shape):
    return "x".join(map(str, shape))


def _gap(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a, np.float32)), torch.as_tensor(np.asarray(b, np.float32))
    return float((a - b).abs().max() / b.abs().max())


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


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_mesh") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"), JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", _REFERENCE, str(path)], capture_output=True, text=True,
                          timeout=540, env=env)
    assert done.returncode == 0, done.stderr[-3000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def port(reference):
    cfg = dataclasses.replace(deepseek_moe_16b.smoke_config(), compute_dtype="float32").validate()
    sd = convert.transformer_params_from_jax(_unflatten(reference, "params/"))
    layer = {"moe." + k[len("blocks.1.moe."):]: v for k, v in sd.items() if k.startswith("blocks.1.moe.")}
    x = torch.from_numpy(reference["x"])
    tokens = torch.from_numpy(reference["tokens"]).long()
    weights = [reference[f"prefill_w{i}"] for i in range(cfg.n_layers)]
    jobs: dict = {}
    for shape in MOE_MESHES:
        jobs.setdefault(int(np.prod(shape)), []).append(("moe", shape, dict(cfg=cfg, sd=layer, x=x)))
    jobs.setdefault(int(np.prod(PREFILL_MESH)), []).append(
        ("serve", PREFILL_MESH, dict(cfg=cfg, sd=sd, tokens=tokens, decode_tokens=tokens[:, :3],
                                     reference_routing=weights)))
    got = {}
    for world, todo in sorted(jobs.items()):
        results = D.run_ranks(mesh_runs.lm_rank, world, backend="gloo", device="cpu", timeout=DEADLINE,
                              args=(todo,))
        for (kind, shape, _), res in zip(todo, results):
            got[(kind, tuple(shape))] = res
    return got


@pytest.mark.parametrize("shape", MOE_MESHES, ids=_tag)
def test_moe_apply_on_a_mesh_matches_the_reference_for_both_routings(shape, reference, port):
    res = port[("moe", shape)]
    assert res["lockstep"]
    for routing in ("pjit", "local"):
        out, aux = res[routing]
        want = reference[f"moe_{_tag(shape)}_{routing}"]
        assert tuple(out.shape) == want.shape
        assert _gap(out, want) < BAND, routing
        np.testing.assert_allclose(aux, float(reference[f"moe_{_tag(shape)}_{routing}_aux"]), rtol=AUX)
    assert np.array_equal(res["pjit"][0], res["local"][0])


def test_moe_routings_differ_only_in_the_aux_loss(reference, port):
    """As in the reference: on a model axis > 1 the per-shard aux mean
    differs from the global aux; on a model axis of size 1 both routings
    take the mesh-free branch and give the same aux."""
    wide, narrow = port[("moe", (2, 4))], port[("moe", (4, 1))]
    assert wide["pjit"][1] != wide["local"][1]
    assert float(reference["moe_2x4_pjit_aux"]) != float(reference["moe_2x4_local_aux"])
    assert narrow["pjit"][1] == narrow["local"][1]


def test_moe_prefill_on_a_mesh_by_the_flip_rule(reference, port):
    res = port[("serve", PREFILL_MESH)]
    assert res["lockstep"]
    differ = np.array(res["differ"]).sum(0)  # by layer, over the ranks
    first = next((i for i, n in enumerate(differ) if n), None)
    if first is None:
        assert _gap(res["prefill"], reference["prefill"]) < PREFILL
    else:
        for li in range(first + 1):
            a, b = torch.from_numpy(res["k_cache"][li]), torch.from_numpy(reference["prefill_k"][li])
            assert float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)) < PREFILL, li
    assert _gap(res["replayed"], reference["prefill"]) < PREFILL
    assert bool(np.isfinite(res["decode"]).all())


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=_tag)
def test_the_card_phase_rank_program_keeps_the_meshless_roundings(shape, tmp_path):
    """Phase "serve mesh" of ``chip_smoke.py`` at deepseek-moe-16b's smoke
    widths in bf16 over gloo CPU ranks: ``moe_mesh_oracle`` writes the
    meshless oracles, and ``moe_serve_rank``'s prefill and teacher-forced
    decode equal them to the bit on every rank, with no routing decision
    that differs (the split heads and ``d_ff`` columns are gathered before
    whole output projections, and the combine is chained in expert order,
    so the mesh rounds where the meshless model does)."""
    over = dict(vocab=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4, d_ff=32, head_dim=16,
                moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=2))
    cfg = get_config("deepseek-moe-16b", param_dtype="bfloat16", **over)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), M.recorded_routing() as log:
        logits, _ = T.prefill(model, {"tokens": tokens}, cfg, T.ModelContext())
    prompt = tokens[:, :16].contiguous()
    kept = {"logits": logits, "routing": log, "prompt": prompt,
            "ids": SD.greedy_generate(model, cfg, prompt, steps=8)}
    mesh_runs.moe_mesh_oracle(model, cfg, tokens, kept, str(tmp_path), half_decode_steps=2)
    decode_steps, greedy = (24, True) if shape == (1, 2) else (2, False)
    rep = D.run_ranks(mesh_runs.moe_serve_rank, shape[0] * shape[1], backend="gloo", device="cpu",
                      timeout=DEADLINE, args=(0, shape, str(tmp_path), decode_steps, greedy, greedy, over, 64))
    assert rep["lockstep"] and len(rep["ranks"]) == shape[0] * shape[1]
    grid = MeshShape(("data", "model"), shape)
    held = sum(t.numel() // int(np.prod([grid.shape[a] for a in spec if a]))
               for t, spec in zip(model.state_dict().values(),
                                  param_shardings(model.state_dict(), grid).values()))
    assert held < T.param_count(model) * 0.6
    for r in rep["ranks"]:
        assert r["flip"]["first"] is None and r["flip"]["logits_gap"] == 0.0
        assert r["replay_gap"] == 0.0 and r["decode_gap"] == 0.0 and r["decode_steps"] == decode_steps
        assert r["k_cache_shape"] == (4 // shape[0], 64, cfg.n_kv_heads // shape[1], cfg.head_dim)
        assert r["params_held"] == held
        if greedy:
            assert r["greedy_agree"] == 1.0


def _phase_model():
    """The card phase's model at the smoke widths in bf16, its weights and a
    prompt of 4 x 64 tokens, from seed 0."""
    over = dict(vocab=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=4, d_ff=32, head_dim=16,
                moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, num_shared=2))
    cfg = get_config("deepseek-moe-16b", param_dtype="bfloat16", **over)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(0))
    return over, cfg, model, tokens


def _taps_of_decode(model, cfg, tokens, steps):
    cache = T.init_cache(cfg, tokens.shape[0], steps, device=tokens.device)
    with torch.no_grad(), mesh_runs.decode_taps() as taps:
        for t in range(steps):
            _, cache = T.decode_step(model, cache, tokens[:, t:t + 1], t, cfg, T.ModelContext())
    return taps


def test_decode_taps_name_every_op_and_the_first_that_differs():
    """``mesh_runs.decode_taps`` records each op of a decode step in order,
    named by step and layer, and ``first_difference`` names the first op
    whose output changes when one layer's output projection is moved."""
    _, cfg, model, tokens = _phase_model()
    taps = _taps_of_decode(model, cfg, tokens, 2)
    layer = ["q", "k", "v", "attention", "attn_out", "router", "experts", "mlp", "ffn", "block"]
    want = [f"step{t}/{op}" for t in range(2) for op in
            ["embed"] + [f"layer{i}/{o}" for i in range(cfg.n_layers) for o in layer] + ["logits"]]
    assert [name for name, _ in taps] == want
    assert all(t.device.type == "cpu" for _, t in taps)
    assert mesh_runs.first_difference(_taps_of_decode(model, cfg, tokens, 2), taps) is None
    with torch.no_grad():
        model.blocks[1].attn["wo"].add_(1e-2)
    name, gap = mesh_runs.first_difference(_taps_of_decode(model, cfg, tokens, 2), taps)
    assert name == "step0/layer1/attn_out" and gap > 0


def test_the_card_phase_rank_program_names_the_first_op_that_differs(tmp_path):
    """Phase "serve mesh"'s rank program on (1, 2) at the smoke widths, with
    the oracle's logits of decode step 1 and the output of its layer-1
    ``decode_attention`` moved in the oracle's file: the rank sees a gap at
    step 1 alone, decodes again with each op's output gathered over the
    model axis and held to the oracle's, and names that op, every earlier
    one (the rank's heads and experts gathered whole) the meshless op's
    bits."""
    over, cfg, model, tokens = _phase_model()
    with torch.no_grad(), M.recorded_routing() as log:
        logits, _ = T.prefill(model, {"tokens": tokens}, cfg, T.ModelContext())
    prompt = tokens[:, :16].contiguous()
    kept = {"logits": logits, "routing": log, "prompt": prompt,
            "ids": SD.greedy_generate(model, cfg, prompt, steps=8)}
    mesh_runs.moe_mesh_oracle(model, cfg, tokens, kept, str(tmp_path), half_decode_steps=2)
    path = tmp_path / "full.pt"
    oracle = torch.load(path)
    oracle["decode_logits"][:, 1] += 1.0
    names = [name for name, _ in oracle["decode_taps"]]
    moved = names.index("step1/layer1/attention")
    oracle["decode_taps"][moved] = (names[moved], oracle["decode_taps"][moved][1] + 1.0)
    torch.save(oracle, path)
    rep = D.run_ranks(mesh_runs.moe_serve_rank, 2, backend="gloo", device="cpu", timeout=DEADLINE,
                      args=(0, (1, 2), str(tmp_path), 3, False, False, over, 64))
    for r in rep["ranks"]:
        assert r["decode_gaps"][0] == 0.0 and r["decode_gaps"][1] > 0 and r["decode_gaps"][2] == 0.0
        name, gap = r["decode_first_difference"]
        assert name == "step1/layer1/attention" and gap > 0


def test_the_card_phase_rank_program_decodes_under_the_seq_layout(tmp_path):
    """Phase "serve mesh" (b)'s seq-layout decode at the smoke widths in
    bf16 on (1, 2): the oracle's 24 teacher-forced steps in its 24 slots,
    12 a rank (steps 12–23 write rank 1's), the routing replayed, each
    step within the phase's 2e-2 band of the meshless logits; one step
    minus a feature-layout step is a ``pmax`` and two sums a layer (the
    softmax's statistics), one gather of q, k and v replacing the
    output's."""
    over, cfg, model, tokens = _phase_model()
    with torch.no_grad(), M.recorded_routing() as log:
        logits, _ = T.prefill(model, {"tokens": tokens}, cfg, T.ModelContext())
    prompt = tokens[:, :16].contiguous()
    kept = {"logits": logits, "routing": log, "prompt": prompt,
            "ids": SD.greedy_generate(model, cfg, prompt, steps=8)}
    mesh_runs.moe_mesh_oracle(model, cfg, tokens, kept, str(tmp_path), half_decode_steps=2)
    rep = D.run_ranks(mesh_runs.moe_serve_rank, 2, backend="gloo", device="cpu", timeout=DEADLINE,
                      args=(0, (1, 2), str(tmp_path), 2, False, False, over, 64, None, 24))
    assert rep["lockstep"]
    L = cfg.n_layers
    for r in rep["ranks"]:
        assert r["seq_steps"] == 24 and len(r["seq_gaps"]) == 24
        assert r["seq_gap"] < 2e-2 and r["seq_gap_late"] < 2e-2 and r["seq_first_difference"] is None
        assert r["seq_k_cache_shape"] == (4, 12, cfg.n_kv_heads, cfg.head_dim)
        assert r["seq_cache_bytes"] == r["feature_cache_bytes"]  # half the slots of all heads, half the heads
        seq, feature = r["seq_step"]["calls"], r["feature_step"]["calls"]
        diff = {k: seq.get(k, 0) - feature.get(k, 0) for k in set(seq) | set(feature)}
        assert {k: n for k, n in diff.items() if n} == {"pmax": L, "sum": 2 * L}
