"""Parity of the port's modality frontends (ROADMAP 13.4) with the
reference, on the CPU: musicgen-large's codebook streams and internvl2-1b's
prefix embeddings, at their ``smoke_config()`` (musicgen: 2 codebooks over
a vocab of 64; internvl: 8 prefix positions, 7 heads over 1 KV head).

The reference's params are drawn by its own ``init_params``, norm scales
and QKV biases perturbed from the seed, and carried into the port by
``convert`` (the (K, V, d) embedding and the (d, V·K) head as they are).
The reference's attention runs as its plain ``attn_impl="ref"``.

Tolerances: at ``compute_dtype="float32"`` rtol 1e-4, atol 1e-5 on the
logits and K/V caches (f32 through four layers, summation orders differ);
at bf16 the 2e-2 band of ``tests/test_models_smoke.py``.  ``decode_step``
against the port's own teacher-forced ``forward_train``: rtol 2e-2, atol
2e-2 (the twin of ``tests/test_models_smoke.py:142``, which holds the
reference to it).  ``greedy_generate`` at temperature 0 and f32: the same
token ids as the reference's, with no step's top two logits within 1e-4.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro.serve import decode as JD
from repro_torch import convert
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.serve import decode as D

ARCHS = {"musicgen-large": "musicgen_large", "internvl2-1b": "internvl2_1b"}
F32 = dict(rtol=1e-4, atol=1e-5)
BAND = dict(rtol=2e-2, atol=2e-2)
JCTX = JT.ModelContext(attn_impl="ref")


@pytest.fixture(autouse=True)
def _values_not_gradients():
    """These tests hold the serving and forward values, not gradients."""
    with torch.no_grad():
        yield


def _smoke(arch, compute_dtype):
    jcfg = importlib.import_module(f"repro.configs.{ARCHS[arch]}").smoke_config()
    pcfg = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke_config()
    over = dict(compute_dtype=compute_dtype)
    return dataclasses.replace(jcfg, **over).validate(), dataclasses.replace(pcfg, **over).validate()


def _params(jcfg, seed):
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


def _batch(cfg, B, n, seed):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.num_codebooks, n) if cfg.num_codebooks else (B, n)
    arrays = {"tokens": rng.integers(0, cfg.vocab, size=shape).astype(np.int32)}
    if cfg.num_prefix_tokens:
        arrays["prefix_embeds"] = rng.normal(size=(B, cfg.num_prefix_tokens, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    pb = {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v) for k, v in arrays.items()}
    return jb, pb


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)), **tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_forward_train_and_prefill_match_jax(arch, compute_dtype):
    """forward_train's logits (B, T, K, V) for codebooks, (B, P + T, V) with
    the prefix, and the label mask; prefill's last-position logits and
    every layer's K/V."""
    jcfg, pcfg = _smoke(arch, compute_dtype)
    jparams, tree = _params(jcfg, seed=1)
    model = _model(pcfg, tree)
    assert model.embed.shape == tuple(np.shape(tree["embed"]))
    jb, pb = _batch(jcfg, 2, 10, seed=2)
    tol = F32 if compute_dtype == "float32" else BAND
    logits, aux, mask = T.forward_train(model, pb, pcfg, T.ModelContext())
    jlogits, _, jmask = JT.forward_train(jparams, jb, jcfg, JCTX)
    P = jcfg.num_prefix_tokens
    want_shape = (2, 10, jcfg.num_codebooks, jcfg.vocab) if jcfg.num_codebooks else (2, P + 10, jcfg.vocab)
    assert tuple(logits.shape) == want_shape == tuple(jlogits.shape)
    _close(logits, jlogits, tol)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert float(mask[:, :P].sum()) == 0 and float(aux) == 0
    last, cache = T.prefill(model, pb, pcfg, T.ModelContext())
    jlast, jcache = JT.prefill(jparams, jb, jcfg, JCTX)
    assert tuple(last.shape) == tuple(jlast.shape)
    _close(last, jlast, tol)
    for li, c in enumerate(convert.cache_from_jax(jax.tree_util.tree_map(np.asarray, jcache))):
        for key in ("k", "v"):
            want = c[key].float().numpy()
            if compute_dtype == "float32":
                _close(cache[li][key], want, F32)
            else:  # bf16: the tensors in norm, as tests/test_torch_models.py holds them
                gap = np.linalg.norm(cache[li][key].float().numpy() - want) / np.linalg.norm(want)
                assert gap <= 2e-2, (li, key, gap)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_step_matches_teacher_forcing_and_jax(arch):
    """(B, K, 1) or (B, 1) tokens through decode_step, 8 steps: against the
    port's own forward_train within the reference's 2e-2 band, and each
    step's logits (B, 1, K, V) or (B, 1, V) against the reference's
    decode_step in f32."""
    jcfg, pcfg = _smoke(arch, "float32")
    jparams, tree = _params(jcfg, seed=3)
    model = _model(pcfg, tree)
    jb, pb = _batch(jcfg, 2, 8, seed=4)
    tokens, jtokens = pb["tokens"], jb["tokens"]
    full, _, _ = T.forward_train(model, {"tokens": tokens}, pcfg, T.ModelContext())
    cache = T.init_cache(pcfg, 2, 8, device="cpu")
    jcache = JT.init_cache(jcfg, 2, 8)
    steps = []
    for t in range(8):
        lg, cache = T.decode_step(model, cache, tokens[..., t : t + 1], t, pcfg, T.ModelContext())
        jlg, jcache = JT.decode_step(jparams, jcache, jtokens[..., t : t + 1], jnp.asarray(t, jnp.int32), jcfg, JCTX)
        assert tuple(lg.shape) == tuple(jlg.shape)
        _close(lg, jlg, F32)
        steps.append(lg[:, 0])
    _close(torch.stack(steps, dim=1), full.numpy(), BAND)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_generate_matches_jax_token_ids(arch):
    jcfg, pcfg = _smoke(arch, "float32")
    jparams, tree = _params(jcfg, seed=5)
    model = _model(pcfg, tree)
    jb, pb = _batch(jcfg, 3, 6, seed=6)
    steps = 6
    got = D.greedy_generate(model, pcfg, pb["tokens"], steps=steps)
    want = np.array(JD.greedy_generate(jparams, jcfg, jb["tokens"], steps=steps, ctx=JCTX))
    assert got.shape == (3, steps)
    np.testing.assert_array_equal(got.numpy(), want)
    # No near tie decided it: replay the ids through decode_step and check
    # each step's top-two gap.
    seq = torch.cat([pb["tokens"], got[:, None, :].expand(-1, max(pcfg.num_codebooks, 1), -1)
                     if pcfg.num_codebooks else got], dim=-1)
    full, _, _ = T.forward_train(model, {"tokens": seq}, pcfg, T.ModelContext())
    lg = full[:, 5:-1, 0] if pcfg.num_codebooks else full[:, 5:-1]
    top2 = torch.topk(lg, 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) > 1e-4
    sampled = D.greedy_generate(model, pcfg, pb["tokens"], steps=3, temperature=0.8,
                                generator=torch.Generator().manual_seed(0))
    assert sampled.shape == (3, 3) and bool(((sampled >= 0) & (sampled < pcfg.vocab)).all())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launch_serve_runs_the_frontends_on_cpu(arch, capsys):
    launch_serve.main(["--arch", arch, "--scale", "smoke", "--device", "cpu", "--gen", "3", "--prompt-len", "5"])
    out = capsys.readouterr().out
    assert f"{arch} [smoke]" in out and "tok/s on cpu" in out and "row 0:" in out
