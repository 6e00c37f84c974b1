"""Parity of the port's RecurrentGemma serving path (``repro_torch.models.rglru``,
the ``rglru_mlp``/``lattn_mlp`` blocks of ``repro_torch.models.transformer``,
the windowed ``chunked_attention`` and ``attn_decode_step``, the ``tail``
of ``repro_torch.convert``, the recurrentgemma-9b scale of
``repro_torch.launch.serve``) with the reference, on the CPU.

The reference's params are drawn by its own ``init_params`` at
``smoke_config()`` of recurrentgemma-9b (8 layers: (RG-LRU, RG-LRU, local
attention) × 2 and two RG-LRU in the tail; d_model 64, 4 heads over 1 KV
head of 16, window 32); its norm scales and biases are perturbed from the
seed (at init they are ones and zeros, which would hide a wrong read), and
``convert`` carries them into the port as numpy arrays.  The reference runs
as its own tests run it on the CPU: ``attn_impl="chunked"``, its jitted
decode step.

Tolerances:

* The scan: 2e-5 against a sequential float64 loop, the band of
  ``tests/test_cells_property.py::test_rglru_associative_scan_matches_sequential``.
* Block functions at f32: rtol 1e-5, atol 1e-5 (states: max|a−b| ≤
  1e-5·max|b|); the attention functions at the band of
  ``tests/test_kernels.py``'s chunked tests, rtol 2e-5, atol 2e-4.  At
  bf16, given the same bf16 input: the 2e-2 band of
  ``tests/test_torch_models.py`` (states within 2e-2 relative in norm).
  XLA's bf16 ``logistic`` and tanh-gelu on the CPU round after each of
  their elementwise steps, so many bf16 outputs sit one ulp from PyTorch's.
* The whole model at f32: logits rtol 1e-5, atol 1e-5, the greedy ids
  equal.  At bf16 those one-ulp gate differences (a block's output lies
  ~5e-3 from the reference's in norm, within the 2e-2 band) pass through
  8 layers: the port's logits then lie ~3e-2 from the reference's in norm
  and up to ~5e-2 of their scale, the size of the reference's own bf16
  rounding (its bf16 forward lies 5.3e-2 to 7.1e-2 of the scale from its
  f32 one at seeds 1, 2 and 8, the port's 4.5e-2 to 5.5e-2), and a few
  logits in 40,960 leave the 2e-2 band (by up to 1.05e-2).  So the whole
  model at bf16 is held to the reference's own band for two bf16
  computations of this model, rtol 5e-2, atol 5e-2
  (``tests/test_models_smoke.py::test_rglru_decode_consistency``), with the
  recurrent states and the K/V caches within 5e-2 relative in norm (the
  K cache of layer 5 lies 2.5e-2 away, downstream of five layers' drift;
  an element of it near 0 parts by more than 5e-2 of itself).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import recurrentgemma_9b as jconf
from repro.kernels.flash_attention import ops as j_fa
from repro.models import attention as JA
from repro.models import rglru as JG
from repro.models import transformer as JT
from repro.serve import decode as JD
from repro_torch import convert
from repro_torch.configs import recurrentgemma_9b as pconf
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as A
from repro_torch.models import rglru as G
from repro_torch.models import transformer as T
from repro_torch.models.registry import ModelConfig, get_config
from repro_torch.serve import decode as D

F32 = dict(rtol=1e-5, atol=1e-5)
ATTN = dict(rtol=2e-5, atol=2e-4)
BAND = dict(rtol=2e-2, atol=2e-2)
MODEL_BAND = dict(rtol=5e-2, atol=5e-2)
PERTURBED = ("norm", "'b'", "'b_i'", "'b_r'", "'bq'", "'bk'", "'bv'")
JCTX = JT.ModelContext(attn_impl="chunked")


@pytest.fixture(autouse=True)
def _values_not_gradients():
    """The parameters are trainable; these tests hold the serving path's
    values, so autograd records nothing here."""
    with torch.no_grad():
        yield


def _smoke(compute_dtype, **over):
    over = dict(compute_dtype=compute_dtype, **over)
    return (dataclasses.replace(jconf.smoke_config(), **over).validate(),
            dataclasses.replace(pconf.smoke_config(), **over).validate())


def _params(jcfg, seed):
    """The reference's params with perturbed norms and biases: (jnp tree,
    numpy tree)."""
    tree = jax.tree_util.tree_map(np.array, JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if any(p in name for p in PERTURBED):
            return (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _model(pcfg, np_tree):
    return T.model_from_state_dict(pcfg, convert.transformer_params_from_jax(np_tree))


def _layer(np_tree, model, li, n_slots=3):
    """Body layer li's parameters: (the reference's dict, the port's block)."""
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[li // n_slots]), np_tree["unit"][f"slot{li % n_slots}"])
    return jp, model.blocks[li]


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _norm_gap(got, want):
    want = torch.as_tensor(np.asarray(want, np.float32))
    return float(torch.linalg.vector_norm(got.float() - want) / torch.linalg.vector_norm(want))


def _scale_gap(got, want):
    want = torch.as_tensor(np.asarray(want, np.float32))
    return float((got.float() - want).abs().max() / want.abs().max())


def _inputs(shape, compute_dtype, seed):
    """The same input on both sides: (port tensor, reference array), bf16
    values equal bit for bit."""
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    if compute_dtype == "bfloat16":
        x = x.bfloat16()
        return x, jnp.asarray(x.float().numpy(), jnp.bfloat16)
    return x, jnp.asarray(x.numpy())


def _tokens(vocab, B, n, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, size=(B, n)).astype(np.int32)
    return {"tokens": torch.from_numpy(toks).long()}, {"tokens": jnp.asarray(toks)}


# ------------------------------------------------------------------ the scan


def _sequential(a, u):
    h, outs = np.zeros(a.shape[::2]), []
    for t in range(a.shape[1]):
        h = a[:, t].astype(np.float64) * h + u[:, t]
        outs.append(h.copy())
    return np.stack(outs, axis=1)


@pytest.mark.parametrize("T_len,a_low", [(40, 0.7), (1000, np.exp(-1.0))], ids=["T40", "T1000-a-to-1/e"])
def test_scan_matches_sequential(T_len, a_low):
    """Twin of tests/test_cells_property.py::test_rglru_associative_scan_matches_sequential,
    and at T = 1000 with a down to 1/e: the product of a over the sequence
    reaches e^-600, whose inverse overflows f32 (a scan that divided by a
    cumulative product would give inf or nan)."""
    rng = np.random.default_rng(2)
    B, d = 2, 8
    a = rng.uniform(a_low, 0.99, size=(B, T_len, d)).astype(np.float32)
    u = rng.normal(size=(B, T_len, d)).astype(np.float32)
    h = G._scan(torch.from_numpy(a.copy()), torch.from_numpy(u.copy()))
    assert bool(torch.isfinite(h).all())
    np.testing.assert_allclose(h.numpy(), _sequential(a, u), rtol=2e-5, atol=2e-5)
    if T_len == 40:  # and the reference's associative scan, same inputs

        def combine(lft, rgt):
            return lft[0] * rgt[0], rgt[0] * lft[1] + rgt[1]

        _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(u)), axis=1)
        np.testing.assert_allclose(h.numpy(), _np(want), rtol=2e-5, atol=2e-5)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000))
def test_rglru_gate_bounds_property(seed):
    """Twin of tests/test_cells_property.py::test_rglru_gate_bounds_property:
    a_t ∈ (0, 1) and u finite, so the recurrence is a strict contraction."""
    rng = np.random.default_rng(seed)
    cfg = pconf.smoke_config()
    p = G.RGLRUBlock(cfg, dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(seed))
    x = torch.from_numpy(rng.normal(size=(1, 16, cfg.d_rnn)).astype(np.float32))
    a, u = G._gates(p, x, cfg)
    assert float(a.min()) > 0.0 and float(a.max()) < 1.0
    assert bool(torch.isfinite(u).all())


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rglru_apply_and_decode_step_match_jax(compute_dtype):
    jcfg, pcfg = _smoke(compute_dtype)
    _, np_tree = _params(jcfg, seed=3)
    jp, p = _layer(np_tree, _model(pcfg, np_tree), 0)
    assert isinstance(p, G.RGLRUBlock)
    tol = F32 if compute_dtype == "float32" else BAND
    x, xj = _inputs((2, 24, pcfg.d_model), compute_dtype, seed=4)
    got = G.rglru_apply(p, x, pcfg)
    assert got.shape == x.shape and got.dtype == x.dtype
    _close(got, _np(JG.rglru_apply(jp, xj, jcfg)), tol)
    # Six decode steps from a nonzero state: h in f32, conv in the compute dtype.
    rng = np.random.default_rng(5)
    cd = getattr(torch, compute_dtype)
    state = {key: torch.from_numpy((0.3 * rng.normal(size=t.shape)).astype(np.float32)).to(t.dtype)
             for key, t in G.rglru_init_state(pcfg, 2, device="cpu", dtype=cd).items()}
    assert state["h"].dtype == torch.float32 and state["conv"].dtype == cd
    jstate = {"h": jnp.asarray(state["h"].numpy()), "conv": jnp.asarray(state["conv"].float().numpy(), jnp.dtype(compute_dtype))}
    for t in range(6):
        out, state = G.rglru_decode_step(p, state, x[:, t : t + 1], pcfg)
        jout, jstate = JG.rglru_decode_step(jp, jstate, xj[:, t : t + 1], jcfg)
        assert out.shape == (2, 1, pcfg.d_model) and out.dtype == x.dtype
        assert state["h"].dtype == torch.float32 and state["conv"].dtype == cd
        assert str(jstate["conv"].dtype) == compute_dtype
        _close(out, _np(jout), tol)
        gap = _scale_gap if compute_dtype == "float32" else _norm_gap
        limit = 1e-5 if compute_dtype == "float32" else 2e-2
        assert max(gap(state[key], _np(jstate[key])) for key in ("h", "conv")) <= limit, t


ATTN_CASES = [  # (B, T, S, H, KV, dh, window)
    pytest.param(1, 256, 256, 4, 2, 32, 64, id="oracle-shape"),
    pytest.param(2, 2048, 2048, 4, 1, 16, 300, id="blocks-skipped"),
    pytest.param(1, 64, 96, 4, 1, 16, 32, id="T-below-S"),
    pytest.param(2, 48, 80, 4, 2, 16, None, id="T-below-S-global"),
]


def _masked_oracle(q, k, v, window):
    """Dense attention with the causal (decode-aligned) and window masks,
    f32, no chunks."""
    T_len, S, g = q.shape[1], k.shape[1], q.shape[2] // k.shape[2]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float().repeat_interleave(g, 2)) * q.shape[-1] ** -0.5
    qp, kp = torch.arange(T_len)[:, None] + (S - T_len), torch.arange(S)[None, :]
    mask = (qp >= kp) & (kp > qp - window) if window is not None else qp >= kp
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float().repeat_interleave(g, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T_len,S,H,KV,dh,window", ATTN_CASES)
def test_chunked_attention_matches_jax_and_the_masked_oracle(B, T_len, S, H, KV, dh, window, dtype):
    """The port's chunked attention against the reference's (windowed, and
    with T < S: the decode alignment), and against the masked dense oracle
    of tests/test_kernels.py::test_flash_chunked_window_matches_masked_ref."""
    rng = np.random.default_rng(T_len + S + (window or 0))
    arrays = [rng.normal(size=(B, n, h, dh)).astype(np.float32) for n, h in ((T_len, H), (S, KV), (S, KV))]
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    jq = [jnp.asarray(t.float().numpy(), jnp.dtype(dtype)) for t in tq]
    before = dict(dispatch.launch_counts())
    got = fa.flash_attention(*tq, causal=True, window=window, impl="torch_chunked" if window is None else "auto")
    assert dispatch.launch_counts() == before
    assert got.dtype == tq[0].dtype and got.shape == (B, T_len, H, dh)
    want = j_fa.chunked_attention(*jq, causal=True, window=window)
    tol = ATTN if dtype == "float32" else BAND
    _close(got, _np(want), tol)
    _close(fa.chunked_attention(*tq, causal=True, window=window), got.float().numpy(), dict(rtol=0, atol=0))
    _close(got, _masked_oracle(*tq, window).numpy(), tol)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_windowed_decode_step_matches_jax_across_the_ring_wrap(compute_dtype):
    """attn_decode_step with window 32 over a ring of 32 slots, 44 steps
    from an empty cache: slot cur_len % 32 overwritten once the ring is
    full, the output and both caches against the reference's at every step."""
    jcfg, pcfg = _smoke(compute_dtype)
    _, np_tree = _params(jcfg, seed=6)
    jp, p = _layer(np_tree, _model(pcfg, np_tree), 2)
    assert p.block_type == "lattn_mlp" and pcfg.window == 32
    jp = jp["attn"]
    cd = getattr(torch, compute_dtype)
    tol = ATTN if compute_dtype == "float32" else BAND
    x, xj = _inputs((2, 44, pcfg.d_model), compute_dtype, seed=7)
    shape = (2, pcfg.window, pcfg.n_kv_heads, pcfg.head_dim)
    ck, cv = torch.zeros(shape, dtype=cd), torch.zeros(shape, dtype=cd)
    jk = jv = jnp.zeros(shape, jnp.dtype(compute_dtype))
    for t in range(44):
        out, ck, cv = A.attn_decode_step(p.attn, x[:, t : t + 1], ck, cv, t, pcfg, window=pcfg.window)
        jout, jk, jv = JA.attn_decode_step(jp, xj[:, t : t + 1], jk, jv, jnp.asarray(t, jnp.int32), jcfg,
                                           window=jcfg.window)
        _close(out, _np(jout), tol)
        _close(ck, _np(jk), tol)
        _close(cv, _np(jv), tol)
    # After the wrap, slot 0 holds position 32 and slot 11 position 43.
    q, k32, _ = A._project_qkv(p.attn, x[:, 32:33], pcfg, torch.full((2, 1), 32), cd)
    torch.testing.assert_close(ck[:, 0], k32[:, 0])


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_jax(compute_dtype):
    """forward_train and prefill over 80 tokens (past the window of 32:
    the clip binds), then the same tokens teacher-forced through 80 decode
    steps (the ring wraps twice): every step's logits, and the final
    recurrent states and ring caches of all 8 layers, tail included."""
    jcfg, pcfg = _smoke(compute_dtype)
    jparams, np_tree = _params(jcfg, seed=8)
    model = _model(pcfg, np_tree)
    B, n = 2, 80
    batch, jbatch = _tokens(pcfg.vocab, B, n, seed=9)
    tol = F32 if compute_dtype == "float32" else MODEL_BAND
    full, aux, _ = T.forward_train(model, batch, pcfg, T.ModelContext())
    jfull, _, _ = JT.forward_train(jparams, jbatch, jcfg, JCTX)
    assert full.shape == (B, n, pcfg.vocab) and float(aux) == 0
    _close(full, _np(jfull), tol)
    logits, cache = T.prefill(model, batch, pcfg, T.ModelContext())
    jlogits, jcache = JT.prefill(jparams, jbatch, jcfg, JCTX)
    _close(logits, _np(jlogits), tol)
    want = convert.cache_from_jax(jax.tree_util.tree_map(_np, jcache))
    assert len(cache) == len(want) == pcfg.n_layers
    for li, (c, w, bt) in enumerate(zip(cache, want, pcfg.block_types)):
        if bt == "rglru_mlp":
            assert c == w == {}, li
        else:
            assert c["k"].shape == w["k"].shape == (B, pcfg.window, pcfg.n_kv_heads, pcfg.head_dim), li
            for key in ("k", "v"):
                if compute_dtype == "float32":
                    _close(c[key], w[key].numpy(), F32)
                else:
                    assert _norm_gap(c[key], w[key].numpy()) <= MODEL_BAND["rtol"], (li, key)
    cache, jcache = T.init_cache(pcfg, B, n, device="cpu"), JT.init_cache(jcfg, B, n)
    decode = JD._decode_fn(jcfg, JCTX)
    for t in range(n):
        lg, cache = T.decode_step(model, cache, batch["tokens"][:, t : t + 1], t, pcfg, T.ModelContext())
        jlg, jcache = decode(jparams, jcache, jbatch["tokens"][:, t : t + 1], jnp.asarray(t, jnp.int32))
        assert lg.shape == (B, 1, pcfg.vocab)
        _close(lg, _np(jlg), tol)
    want = convert.cache_from_jax(jax.tree_util.tree_map(_np, jcache))
    keys = {"rglru_mlp": ["conv", "h"], "lattn_mlp": ["k", "v"]}
    assert [sorted(c) for c in cache] == [sorted(w) for w in want] == [keys[bt] for bt in pcfg.block_types]
    for li, (c, w) in enumerate(zip(cache, want)):
        assert {k: tuple(v.shape) for k, v in c.items()} == {k: tuple(v.shape) for k, v in w.items()}, li
        gap = _scale_gap if compute_dtype == "float32" else _norm_gap
        assert max(gap(c[k], w[k].numpy()) for k in c) <= (1e-5 if compute_dtype == "float32" else MODEL_BAND["rtol"]), li


@pytest.mark.parametrize("n", [10, 80])
def test_rglru_decode_consistency(n):
    """Twin of tests/test_models_smoke.py::test_rglru_decode_consistency
    (bf16, the reference's 5e-2), at its T = 10 and at T = 80, past the
    window: the port's parallel forward against its own stepwise decode."""
    cfg = pconf.smoke_config().validate()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(7))
    tokens = torch.randint(0, cfg.vocab, (1, n), generator=torch.Generator().manual_seed(8))
    full, _, _ = T.forward_train(model, {"tokens": tokens}, cfg, T.ModelContext())
    cache, outs = T.init_cache(cfg, 1, n, device="cpu"), []
    for t in range(n):
        lg, cache = T.decode_step(model, cache, tokens[:, t : t + 1], t, cfg, T.ModelContext())
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(), full.float().numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_greedy_generate_matches_jax_token_ids(compute_dtype):
    """Prompt 30, 12 steps: the decode passes the window of 32.  f32: the
    same ids, no decision a near tie.  bf16: the reference's ids
    teacher-forced through both decode paths, the logits within the model
    band at every decision."""
    jcfg, pcfg = _smoke(compute_dtype)
    jparams, np_tree = _params(jcfg, seed=10)
    model = _model(pcfg, np_tree)
    B, n0, steps = 2, 30, 12
    prompt = np.random.default_rng(11).integers(0, pcfg.vocab, size=(B, n0)).astype(np.int32)
    want = np.array(JD.greedy_generate(jparams, jcfg, jnp.asarray(prompt), steps=steps, ctx=JCTX))
    if compute_dtype == "float32":
        got = D.greedy_generate(model, pcfg, torch.from_numpy(prompt).long(), steps=steps)
        assert got.shape == (B, steps) and got.dtype == torch.int64
        seq = torch.cat([torch.from_numpy(prompt).long(), got[:, :-1]], dim=1)
        cache = T.init_cache(pcfg, B, seq.shape[1], device="cpu")
        for t in range(seq.shape[1]):
            lg, cache = T.decode_step(model, cache, seq[:, t : t + 1], t, pcfg, T.ModelContext())
            if t >= n0 - 1:
                top2 = torch.topk(lg[:, 0], 2, dim=-1).values
                assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4, t
        np.testing.assert_array_equal(got.numpy(), want)
        return
    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    cache, jcache = T.init_cache(pcfg, B, seq.shape[1], device="cpu"), JT.init_cache(jcfg, B, seq.shape[1])
    decode = JD._decode_fn(jcfg, JCTX)
    for t in range(seq.shape[1]):
        lg, cache = T.decode_step(model, cache, torch.from_numpy(seq[:, t : t + 1]).long(), t, pcfg,
                                  T.ModelContext())
        jlg, jcache = decode(jparams, jcache, jnp.asarray(seq[:, t : t + 1]), jnp.asarray(t, jnp.int32))
        if t >= n0 - 1:
            _close(lg[:, 0], _np(jlg[:, 0]), MODEL_BAND)


def test_reference_prefill_cache_misaligns_the_ring_unless_T_divides_by_the_window():
    """The reference's prefill keeps a local layer's last min(W, T)
    positions, position T − W + i in slot i, while decode writes slot
    cur_len % S: decoding one token on from that cache agrees with the
    forward only when T % W == 0 (T = 64), and parts from it at T = 40
    (a stale key stays, a live one is overwritten) and T = 20 (the cache
    has T slots and loses position 0).  No serving path decodes on from a
    prefill.  The port follows the reference: its one-token decode matches
    the reference's in every case."""
    over = dict(scan_unit=("lattn_mlp",), tail=(), n_layers=2)
    jcfg, pcfg = _smoke("float32", **over)
    jparams, np_tree = _params(jcfg, seed=12)
    model = _model(pcfg, np_tree)
    batch, jbatch = _tokens(pcfg.vocab, 2, 65, seed=13)
    gaps = {}
    for n in (64, 40, 20):
        prefix, jprefix = {"tokens": batch["tokens"][:, :n]}, {"tokens": jbatch["tokens"][:, :n]}
        _, jcache = JT.prefill(jparams, jprefix, jcfg, JCTX)
        jlg, _ = JT.decode_step(jparams, jcache, jbatch["tokens"][:, n : n + 1], jnp.asarray(n, jnp.int32), jcfg, JCTX)
        jfull, _, _ = JT.forward_train(jparams, {"tokens": jbatch["tokens"][:, : n + 1]}, jcfg, JCTX)
        gaps[n] = float(np.abs(_np(jlg[:, 0]) - _np(jfull[:, n])).max() / np.abs(_np(jfull[:, n])).max())
        _, cache = T.prefill(model, prefix, pcfg, T.ModelContext())
        assert cache[0]["k"].shape[1] == min(pcfg.window, n)
        lg, _ = T.decode_step(model, cache, batch["tokens"][:, n : n + 1], n, pcfg, T.ModelContext())
        _close(lg, _np(jlg), F32)
    assert gaps[64] <= 1e-5 and gaps[40] > 0.1 and gaps[20] > 0.1, gaps


# ------------------------------------------------------------------ params, convert, registry, launcher


def test_convert_maps_the_tail_and_the_full_count():
    jcfg, pcfg = _smoke("float32")
    jparams, np_tree = _params(jcfg, seed=14)
    sd = convert.transformer_params_from_jax(np_tree)
    model = T.model_from_state_dict(pcfg, sd)  # strict: every key of the port's tree, no other
    names = {"norm", "w_x", "w_gate", "conv.w", "conv.b", "w_i", "b_i", "w_r", "b_r", "lam", "w_out",
             "mlp_norm", "mlp.gate", "mlp.up", "mlp.down"}
    lnames = {"attn_norm", "attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp_norm", "mlp.gate", "mlp.up", "mlp.down"}
    assert pcfg.block_types == ("rglru_mlp", "rglru_mlp", "lattn_mlp") * 2 + ("rglru_mlp",) * 2
    for li, bt in enumerate(pcfg.block_types):
        got = {k.split(".", 2)[2] for k in sd if k.startswith(f"blocks.{li}.")}
        assert got == (names if bt == "rglru_mlp" else lnames), li
    for ti in range(2):  # the tail is layers 6 and 7
        np.testing.assert_array_equal(model.blocks[6 + ti].lam.numpy(), np_tree["tail"][f"tail{ti}"]["lam"])
        np.testing.assert_array_equal(model.blocks[6 + ti].mlp["down"].numpy(), np_tree["tail"][f"tail{ti}"]["mlp"]["down"])
    np.testing.assert_array_equal(model.blocks[4].w_r.numpy(), np_tree["unit"]["slot1"]["w_r"][1])
    assert T.param_count(model) == sum(int(np.asarray(x).size) for x in jax.tree_util.tree_leaves(np_tree))
    # The decode cache: the tail's {h, conv} after the body's layers.
    jcache = jax.tree_util.tree_map(_np, JT.init_cache(jcfg, 2, 40))
    cache = convert.cache_from_jax(jcache)
    assert [sorted(c) for c in cache] == [sorted(c) for c in T.init_cache(pcfg, 2, 40, device="cpu")]
    assert cache[7]["conv"].shape == (2, 3, pcfg.d_rnn) and cache[2]["k"].shape == (2, 32, 1, 16)
    with pytest.raises(ValueError, match="pass n_layers"):
        convert.cache_from_jax({"unit": {"slot0": {}, "slot1": {}}, "tail": {"tail0": {}}})
    assert convert.cache_from_jax({"unit": {"slot0": {}}, "tail": {"tail0": {}}}, n_layers=3) == [{}] * 3
    full = T.Transformer(get_config("recurrentgemma-9b"), device="meta", generator=None)
    assert T.param_count(full) == 10_444_984_320  # jax.eval_shape of the reference's init_params
    assert full.blocks[0].w_i.shape == (4096, 4096) and full.blocks[2].attn["wk"].shape == (4096, 256)


def test_recurrentgemma_registered_with_the_reference_shape():
    from repro.models.registry import get_config as j_get_config

    assert get_config("recurrentgemma-9b") == ModelConfig(**vars(j_get_config("recurrentgemma-9b")))
    assert pconf.smoke_config() == ModelConfig(**vars(jconf.smoke_config()))
    full = get_config("recurrentgemma-9b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim, full.window,
            full.block_types.count("lattn_mlp")) == (38, 4096, 16, 1, 256, 2048, 12)
    cache = T.init_cache(pconf.smoke_config(), 2, 100, device="cpu")
    assert cache[2]["k"].shape == (2, 32, 1, 16)  # min(window, max_len)
    assert T.init_cache(pconf.smoke_config(), 2, 20, device="cpu")[2]["k"].shape == (2, 20, 1, 16)
    assert cache[0]["conv"].dtype == torch.bfloat16 and cache[0]["h"].dtype == torch.float32


def test_launch_serve_runs_recurrentgemma_on_cpu(capsys):
    cfg = launch_serve.scaled_config("recurrentgemma-9b", "smoke")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_kv_heads) == (5, 128, 12288, 1)  # one unit + the tail
    before = dict(dispatch.launch_counts())
    launch_serve.main(["--arch", "recurrentgemma-9b", "--scale", "smoke", "--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    assert "recurrentgemma-9b [smoke]" in out and "tok/s on cpu" in out and "row 0:" in out
    assert dispatch.launch_counts() == before


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-1.3b", "recurrentgemma-9b"])
def test_launcher_draws_f32_reads_in_f32_and_matmul_weights_in_bf16(arch):
    """The launcher's parameters at smoke scale: the ones the forward reads
    in f32 (norm scales, MoE routers, the sLSTM's r, the RG-LRU's lam) in
    f32, as the reference's launcher holds them; the embedding, the matmul
    weights, biases and conv taps in the compute dtype."""
    cfg = launch_serve.scaled_config(arch, "smoke")
    model = launch_serve.init_model(cfg, torch.device("cpu"))
    f32 = {name for name, t in model.state_dict().items() if t.dtype == torch.float32}
    assert f32 == {name for name in model.state_dict() if name.endswith(T._READ_IN_F32)}
    assert all(t.dtype == torch.bfloat16 for name, t in model.state_dict().items() if name not in f32)
    kinds = {"deepseek-moe-16b": "moe.router", "xlstm-1.3b": ".r_z", "recurrentgemma-9b": ".lam"}
    assert any(name.endswith(kinds[arch]) for name in f32) and "final_norm" in f32
    assert model.embed.dtype == torch.bfloat16


def test_cast_params_keeps_lam_f32():
    cfg = pconf.smoke_config()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    cast = T.cast_params(model, cfg)
    p = cast.blocks[0]
    assert p.lam.dtype == p.norm.dtype == torch.float32 and p.lam.data_ptr() == model.blocks[0].lam.data_ptr()
    assert p.w_i.dtype == p.conv["w"].dtype == cast.blocks[2].attn["wq"].dtype == torch.bfloat16
    toks = {"tokens": torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(2))}
    assert torch.equal(T.forward_train(model, toks, cfg, T.ModelContext())[0],
                       T.forward_train(cast, toks, cfg, T.ModelContext())[0])
