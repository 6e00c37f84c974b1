"""Parity of the port's dense serving path (``repro_torch.models``,
``repro_torch.serve.decode``, ``repro_torch.launch.serve``) with the
reference, on the CPU.

The reference's params are drawn by its own ``init_params`` at the
``smoke_config()`` of qwen3-4b (qk-norm) and qwen2.5-3b (QKV bias), their
norm scales and biases are perturbed from the seed (at init they are ones
and zeros, which would hide a wrong read), and ``convert`` carries them
into the port as numpy arrays.

Tolerances:

* layers (``rmsnorm``, ``apply_rope``, ``mlp_apply``) at f32: rtol 1e-6,
  atol 1e-6 — the same f32 arithmetic in another summation order.
* ``prefill`` against the reference's ``T.prefill`` with
  ``attn_impl="pallas_interpret"`` (T == S, where its Pallas kernel is
  right), last-position logits and every layer's K/V: at
  ``compute_dtype="float32"`` rtol 1e-4, atol 1e-5 (f32 through four
  layers, summation orders differ).  At bf16 the 2e-2 band of
  ``tests/test_models_smoke.py``: rtol 2e-2, atol 2e-2 on the logits, and a
  relative (Frobenius) error ≤ 2e-2 per layer on the caches.  Both sides
  round to bf16 at the same places, but not the same way everywhere: the
  reference's bf16 ``logistic`` on the CPU rounds after each of exp, add and
  divide and often differs from a correctly rounded one by an ulp, so the
  bf16 residual streams part by one ulp here and there from layer 0's MLP
  on (layer 0's K/V are equal bit for bit).  The caches' error grows to
  about 1.2% by layer 3; elementwise, a k entry after the
  per-head RMSNorm over dh=16 can then sit a few ulps off and outside the
  band, so the caches are compared as tensors.
* ``decode_step`` against the port's own ``forward_train`` over 8 tokens:
  rtol 2e-2, atol 2e-2 (``tests/test_models_smoke.py:140-160``), and
  against the reference's ``decode_step``: f32 1e-4 / 1e-5, bf16 2e-2.
* ``greedy_generate`` at temperature 0 and f32: the same token ids as the
  reference's; the test asserts that no step's top two logits lie within
  1e-4 of each other, so that a near tie cannot decide it.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import decode as JD
from repro_torch import convert
from repro_torch.kernels import dispatch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import ModelConfig, get_config, list_archs
from repro_torch.serve import decode as D

ARCHS = {"qwen3-4b": "qwen3_4b", "qwen2.5-3b": "qwen2_5_3b"}
F32 = dict(rtol=1e-4, atol=1e-5)
BAND = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _values_not_gradients():
    """The parameters are trainable; these tests hold the serving path's
    values, so autograd records nothing here."""
    with torch.no_grad():
        yield


def _smoke(arch, compute_dtype):
    """The reference's smoke config and the port's twin of it."""
    jcfg = importlib.import_module(f"repro.configs.{ARCHS[arch]}").smoke_config()
    pcfg = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke_config()
    over = dict(compute_dtype=compute_dtype)
    return dataclasses.replace(jcfg, **over).validate(), dataclasses.replace(pcfg, **over).validate()


def _params(jcfg, seed):
    """The reference's params with perturbed norms and biases: (jnp tree,
    numpy tree)."""
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


def _tokens(cfg, B, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, n)).astype(np.int32)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# ------------------------------------------------------------------ layers


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(16,))).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    _close(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale)), _np(JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), tol)
    for pos in (np.arange(7, dtype=np.int32), rng.integers(0, 2048, size=(2, 7)).astype(np.int32)):
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
        _close(got, _np(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), tol)
    p = {n: rng.normal(size=s).astype(np.float32) / np.sqrt(s[0])
         for n, s in (("gate", (16, 40)), ("up", (16, 40)), ("down", (40, 16)))}
    h = rng.normal(size=(3, 5, 16)).astype(np.float32)
    for act in ("silu_glu", "gelu_glu"):
        got = L.mlp_apply({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(h), act=act,
                          compute_dtype=torch.float32)
        want = JL.mlp_apply({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(h), act=act,
                            compute_dtype=jnp.float32)
        _close(got, _np(want), tol)


# ------------------------------------------------------------------ prefill


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_matches_jax_pallas_interpret(arch, compute_dtype):
    jcfg, pcfg = _smoke(arch, compute_dtype)
    jparams, np_tree = _params(jcfg, seed=1)
    toks = _tokens(jcfg, 2, 64, seed=2)
    jlogits, jcache = JT.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                                 JT.ModelContext(attn_impl="pallas_interpret"))
    prefill = D.make_prefill_fn(pcfg, T.ModelContext())
    logits, cache = prefill(_model(pcfg, np_tree), {"tokens": torch.from_numpy(toks).long()})
    tol = F32 if compute_dtype == "float32" else BAND
    assert logits.shape == (2, 1, pcfg.vocab) and logits.dtype == getattr(torch, compute_dtype)
    _close(logits, _np(jlogits), tol)
    want = convert.cache_from_jax(jax.tree_util.tree_map(_np, jcache))
    assert len(cache) == len(want) == pcfg.n_layers
    for li, (c, w) in enumerate(zip(cache, want)):
        for key in ("k", "v"):
            assert c[key].shape == (2, 64, pcfg.n_kv_heads, pcfg.head_dim), (li, key)
            if compute_dtype == "float32":
                _close(c[key], w[key], tol)
            else:  # norm-wise at bf16: see the module docstring
                err = torch.linalg.vector_norm(c[key].float() - w[key]) / torch.linalg.vector_norm(w[key])
                assert float(err) <= 2e-2, (li, key, float(err))
    # The converter's two directions are inverse on this cache.
    back = convert.cache_to_jax(cache)
    assert back["unit"]["slot0"]["k"].shape == (pcfg.n_layers, 2, 64, pcfg.n_kv_heads, pcfg.head_dim)
    np.testing.assert_array_equal(back["unit"]["slot0"]["v"][1], cache[1]["v"].float().numpy())


# ------------------------------------------------------------------ decode


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_matches_forward_and_jax(arch, compute_dtype):
    jcfg, pcfg = _smoke(arch, compute_dtype)
    jparams, np_tree = _params(jcfg, seed=3)
    model = _model(pcfg, np_tree)
    B, n = 2, 8
    toks = _tokens(jcfg, B, n, seed=4)
    ctx, jctx = T.ModelContext(), JT.ModelContext(attn_impl="ref")
    full, _, _ = T.forward_train(model, {"tokens": torch.from_numpy(toks).long()}, pcfg, ctx)
    cache = T.init_cache(pcfg, B, n, device="cpu")
    jcache = JT.init_cache(jcfg, B, n)
    tol = F32 if compute_dtype == "float32" else BAND
    steps = []
    for t in range(n):
        lg, cache = T.decode_step(model, cache, torch.from_numpy(toks[:, t : t + 1]).long(), t, pcfg, ctx)
        jlg, jcache = JT.decode_step(jparams, jcache, jnp.asarray(toks[:, t : t + 1]),
                                     jnp.asarray(t, jnp.int32), jcfg, jctx)
        assert lg.shape == (B, 1, pcfg.vocab)
        _close(lg, _np(jlg), tol)
        steps.append(lg[:, 0])
    _close(torch.stack(steps, dim=1), full.float().numpy(), BAND)
    # The cache was written in place at every position.
    assert all(bool(c["k"].abs().sum(dim=(0, 2, 3)).gt(0).all()) for c in cache)


def test_greedy_generate_matches_jax_token_ids():
    jcfg, pcfg = _smoke("qwen3-4b", "float32")
    jparams, np_tree = _params(jcfg, seed=5)
    model = _model(pcfg, np_tree)
    B, n0, steps = 2, 8, 6
    prompt = _tokens(jcfg, B, n0, seed=6)
    got = D.greedy_generate(model, pcfg, torch.from_numpy(prompt).long(), steps=steps)
    want = np.asarray(JD.greedy_generate(jparams, jcfg, jnp.asarray(prompt), steps=steps))
    assert got.shape == (B, steps) and got.dtype == torch.int64
    # No step is a near tie: the top two logits of every decision differ by > 1e-4.
    seq = torch.cat([torch.from_numpy(prompt).long(), got[:, :-1]], dim=1)
    logits, _, _ = T.forward_train(model, {"tokens": seq}, pcfg, T.ModelContext())
    top2 = torch.topk(logits[:, n0 - 1 :].float(), 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    np.testing.assert_array_equal(got.numpy(), want)


def test_temperature_sampling_needs_a_generator_and_is_seeded():
    cfg = importlib.import_module("repro_torch.configs.qwen3_4b").smoke_config()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    prompt = torch.randint(0, cfg.vocab, (2, 4), generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="Generator"):
        D.greedy_generate(model, cfg, prompt, steps=3, temperature=0.8)
    a, b = (D.greedy_generate(model, cfg, prompt, steps=5, temperature=0.8,
                              generator=torch.Generator().manual_seed(7)) for _ in range(2))
    assert torch.equal(a, b) and int(a.max()) < cfg.vocab


def test_cast_params_holds_the_per_call_cast():
    cfg = importlib.import_module("repro_torch.configs.qwen3_4b").smoke_config()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    cast = T.cast_params(model, cfg)
    assert cast.blocks[0].attn["wq"].dtype == torch.bfloat16 and cast.embed.dtype == torch.bfloat16
    assert cast.blocks[0].attn["q_norm"].dtype == torch.float32 and cast.final_norm.dtype == torch.float32
    toks = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2))}
    a, ca = T.prefill(model, toks, cfg, T.ModelContext())
    b, cb = T.prefill(cast, toks, cfg, T.ModelContext())
    assert torch.equal(a, b) and all(torch.equal(x["k"], y["k"]) for x, y in zip(ca, cb))


# ------------------------------------------------------------------ registry, launcher


def test_dense_configs_registered_with_reference_shapes():
    assert list_archs() == sorted(["qwen3-4b", "qwen3-8b", "qwen2.5-3b", "qwen3-1.7b",
                                   "moonshot-v1-16b-a3b", "deepseek-moe-16b", "xlstm-1.3b",
                                   "recurrentgemma-9b", "musicgen-large", "internvl2-1b"])
    from repro.models.registry import get_config as j_get_config

    for arch in list_archs():
        got, want = get_config(arch), j_get_config(arch)
        # The two packages' MoEConfig are different classes: compared field by field.
        assert (got.moe is None) == (want.moe is None)
        if got.moe is not None:
            assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        assert got == ModelConfig(**{**vars(want), "moe": got.moe})
    full = get_config("qwen3-4b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim, full.d_ff,
            full.vocab) == (36, 2560, 32, 8, 128, 9728, 151936)


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-large"])
def test_get_config_raises_for_non_dense(arch):
    """The two frontend archs, the last the port raised for, are ported:
    they resolve to their configs, and an unknown name still raises."""
    cfg = get_config(arch)
    assert (cfg.num_codebooks, cfg.num_prefix_tokens) == {"musicgen-large": (4, 0), "internvl2-1b": (0, 256)}[arch]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch + "-x")


def test_unported_blocks_and_mesh_raise():
    cfg = importlib.import_module("repro_torch.configs.qwen3_4b").smoke_config()
    codebooks = T.init_params(dataclasses.replace(cfg, num_codebooks=4), generator=torch.Generator())
    assert codebooks.embed.shape == (4, cfg.vocab, cfg.d_model)
    assert codebooks.lm_head.shape == (cfg.d_model, 4 * cfg.vocab)
    with pytest.raises(ValueError, match="unknown block type"):
        T.init_params(dataclasses.replace(cfg, scan_unit=("conv_mlp",)), generator=torch.Generator())
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        T.ModelContext(mesh=object())


def test_launch_serve_runs_on_cpu(capsys):
    before = dispatch.launch_counts().get("flash_attention", 0)
    launch_serve.main(["--arch", "qwen3-4b", "--scale", "smoke", "--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    assert "qwen3-4b [smoke]" in out and "tok/s on cpu" in out and "row 0:" in out
    assert dispatch.launch_counts().get("flash_attention", 0) == before


def test_launch_serve_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--scale", "smoke"])
