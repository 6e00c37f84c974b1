"""Parity of the port's xLSTM serving path (``repro_torch.models.xlstm``,
the ``mlstm``/``slstm`` blocks of ``repro_torch.models.transformer``,
``causal_conv1d*`` of ``repro_torch.models.layers``, the xLSTM scale of
``repro_torch.launch.serve`` and ``repro_torch.serve_decode``) with the
reference, on the CPU.

The reference's params are drawn by its own ``init_params`` at
``smoke_config()`` of xlstm-1.3b (8 layers, scan unit mLSTM ×3 + sLSTM,
d_model 64, 4 heads); its norm scales and biases are perturbed from the
seed (at init they are ones, zeros and threes, which would hide a wrong
read), and ``convert`` carries them into the port as numpy arrays.

Tolerances:

* The chunkwise cell: the reference's own bands (chunk-size invariance
  2e-4, chunkwise against the stepwise recurrence 5e-4,
  ``tests/test_cells_property.py``), and 1e-5 against the reference's cell
  at the same chunk (the same f32 arithmetic in other summation orders).
* Block functions (``causal_conv1d``, ``mlstm_apply``, ``slstm_apply``,
  the two decode steps) at f32: rtol 1e-5, atol 1e-5 (states: max|a−b| ≤
  1e-5·max|b|).  At bf16, given the same bf16 input: outputs in the 2e-2
  band of ``tests/test_torch_models.py``, states within 2e-2 relative in
  norm.  The two sides round to bf16 at the same places (the dtypes of
  every intermediate are held equal), but XLA's bf16 ``logistic`` and
  ``tanh``-gelu on the CPU round after each of their elementwise steps, so
  many bf16 silu and gelu outputs sit one ulp from PyTorch's.
* The whole model at f32: logits rtol 1e-5, atol 1e-5; the final
  recurrent states 1e-5 of their scale.  At bf16 those ulps pass through
  8 layers whose recurrences divide by running normalisers, and the
  reference itself holds its bf16 forward and its bf16 decode of one
  model only to 5e-2 (``tests/test_models_smoke.py::
  test_xlstm_decode_consistency``); the port is held to that band: logits
  rtol 5e-2, atol 5e-2, states within 5e-2 relative in norm.
* ``greedy_generate`` at temperature 0: the same ids as the reference's
  in f32 (no decision's top two logits within 1e-4).  In bf16 the random
  smoke model's top two logits often lie within an ulp, so along the
  reference's ids: the two sides' logits within the model band at every
  decision, the reference's pick within twice their largest gap of the
  port's top logit, and the same ids up to the first decision whose top
  two lie closer than that.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import xlstm_1_3b as jconf
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.serve import decode as JD
from repro_torch import convert, serve_decode
from repro_torch.configs import xlstm_1_3b as pconf
from repro_torch.kernels import dispatch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models.registry import ModelConfig, get_config
from repro_torch.serve import decode as D

F32 = dict(rtol=1e-5, atol=1e-5)
BAND = dict(rtol=2e-2, atol=2e-2)
MODEL_BAND = dict(rtol=5e-2, atol=5e-2)
BIASES = ("'b'", "'b_i'", "'b_f'", "'b_z'", "'b_o'")


def _smoke(compute_dtype):
    over = dict(compute_dtype=compute_dtype)
    return (dataclasses.replace(jconf.smoke_config(), **over).validate(),
            dataclasses.replace(pconf.smoke_config(), **over).validate())


def _params(jcfg, seed):
    """The reference's params with perturbed norms and biases: (jnp tree,
    numpy tree)."""
    tree = jax.tree_util.tree_map(np.array, JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = jax.tree_util.keystr(path)
        if "norm" in name or any(b in name for b in BIASES):
            return (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _model(pcfg, np_tree):
    return T.model_from_state_dict(pcfg, convert.transformer_params_from_jax(np_tree))


def _layer(np_tree, model, li, n_slots=4):
    """Layer li's parameters: (the reference's dict, the port's block)."""
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


def _state_gap(got: dict, want: dict, compute_dtype):
    """The largest gap over a state's tensors: of the scale at f32, in norm at bf16."""
    gap = _scale_gap if compute_dtype == "float32" else _norm_gap
    return max(gap(got[key], _np(want[key])) for key in want)


# ------------------------------------------------------------------ the chunkwise cell


def _cell_inputs(B, H, T, dh, seed):
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(size=(B, H, T, dh)).astype(np.float32) for _ in range(3)]
    li = rng.normal(size=(B, H, T)).astype(np.float32)
    lf = (rng.normal(size=(B, H, T)) - 1.0).astype(np.float32)
    return qkv + [li, lf]


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_mlstm_chunk_size_invariance(chunk):
    """Twin of tests/test_cells_property.py::test_mlstm_chunk_size_invariance,
    and the port's cell against the reference's at the same chunk."""
    args = _cell_inputs(2, 2, 32, 8, seed=0)
    t = [torch.from_numpy(a) for a in args]
    ref = X._mlstm_chunkwise(*t, chunk=32)  # a single chunk: the exact parallel form
    got = X._mlstm_chunkwise(*t, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-4)
    want = JX._mlstm_chunkwise(*[jnp.asarray(a) for a in args], chunk=chunk)
    _close(got, _np(want), F32)


def test_mlstm_chunkwise_matches_stepwise_recurrence():
    """Twin of tests/test_cells_property.py::test_mlstm_chunkwise_matches_stepwise_recurrence:
    chunkwise (two chunks carried) against the sequential stabilised
    recurrence in float64."""
    B, H, T, dh = 1, 2, 24, 4
    q, k, v, li, lf = args = _cell_inputs(B, H, T, dh, seed=1)
    par = X._mlstm_chunkwise(*[torch.from_numpy(a) for a in args], chunk=8)
    C, n, m = np.zeros((B, H, dh, dh)), np.zeros((B, H, dh)), np.zeros((B, H))
    outs = []
    for t in range(T):
        m_new = np.maximum(lf[:, :, t] + m, li[:, :, t])
        decay, inject = np.exp(lf[:, :, t] + m - m_new), np.exp(li[:, :, t] - m_new)
        C = decay[..., None, None] * C + inject[..., None, None] * (k[:, :, t, :, None] * v[:, :, t, None, :])
        n = decay[..., None] * n + inject[..., None] * k[:, :, t]
        qt = q[:, :, t] * dh**-0.5
        num, den = np.einsum("bhd,bhde->bhe", qt, C), np.einsum("bhd,bhd->bh", qt, n)
        outs.append(num / np.maximum(np.abs(den), np.exp(-m_new))[..., None])
        m = m_new
    np.testing.assert_allclose(par.numpy(), np.stack(outs, axis=2), rtol=5e-4, atol=5e-4)
    _close(par, _np(JX._mlstm_chunkwise(*[jnp.asarray(a) for a in args], chunk=8)), F32)


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(compute_dtype):
    rng = np.random.default_rng(2)
    p = {"w": rng.normal(size=(4, 24)).astype(np.float32) / 2, "b": 0.1 * rng.normal(size=(24,)).astype(np.float32)}
    pt, pj = ({n: torch.from_numpy(a) for n, a in p.items()}, {n: jnp.asarray(a) for n, a in p.items()})
    x, xj = _inputs((2, 9, 24), compute_dtype, seed=3)
    got, want = L.causal_conv1d(pt, x), JL.causal_conv1d(pj, xj)
    assert got.dtype == x.dtype
    np.testing.assert_array_equal(got.float().numpy(), _np(want))  # the same taps, rounded alike
    # The step with an f32 window and an input in the compute dtype: f32 out.
    state = np.random.default_rng(4).normal(size=(2, 3, 24)).astype(np.float32)
    new, out = L.causal_conv1d_step(pt, torch.from_numpy(state), x[:, 0])
    jnew, jout = JL.causal_conv1d_step(pj, jnp.asarray(state), xj[:, 0])
    assert out.dtype == new.dtype == torch.float32 and new.shape == (2, 3, 24)
    _close(out, _np(jout), F32)
    np.testing.assert_array_equal(new.numpy(), _np(jnew))
    # Stepping through T from a zero window gives the forward.
    window, steps = torch.zeros((2, 3, 24), dtype=x.dtype), []
    for t in range(x.shape[1]):
        window, o = L.causal_conv1d_step(pt, window, x[:, t])
        steps.append(o)
    _close(torch.stack(steps, 1), got.float().numpy(), F32 if compute_dtype == "float32" else BAND)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mlstm_pre_takes_the_reference_dtypes(compute_dtype):
    """The decode path's f32 conv state promotes the conv output, q, k and
    the gates to f32 under a bf16 compute dtype; the forward keeps them in
    the compute dtype (as ``jax.eval_shape`` of the reference gives)."""
    jcfg, pcfg = _smoke(compute_dtype)
    jparams, np_tree = _params(jcfg, seed=5)
    jp, p = _layer(np_tree, _model(pcfg, np_tree), 0)
    x, xj = _inputs((2, 1, pcfg.d_model), compute_dtype, seed=6)
    state = X.mlstm_init_state(pcfg, 2, device="cpu")
    jstate = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), state)
    for conv, jconv in ((None, None), (state["conv"], jstate["conv"])):
        got = X._mlstm_pre(p, x, pcfg, conv_state=conv)
        want = JX._mlstm_pre(jp, xj, jcfg, conv_state=jconv)
        assert [str(t.dtype).split(".")[1] for t in got if t is not None] == [
            str(jnp.dtype(t.dtype)) for t in want if t is not None]
        assert [tuple(t.shape) for t in got if t is not None] == [t.shape for t in want if t is not None]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("li", [0, 3], ids=["mlstm", "slstm"])
def test_block_apply_and_decode_step_match_jax(li, compute_dtype):
    jcfg, pcfg = _smoke(compute_dtype)
    _, np_tree = _params(jcfg, seed=7)
    model = _model(pcfg, np_tree)
    jp, p = _layer(np_tree, model, li)
    kind = pcfg.block_types[li]
    apply, japply = (X.mlstm_apply, JX.mlstm_apply) if kind == "mlstm" else (X.slstm_apply, JX.slstm_apply)
    step, jstep = ((X.mlstm_decode_step, JX.mlstm_decode_step) if kind == "mlstm"
                   else (X.slstm_decode_step, JX.slstm_decode_step))
    init = X.mlstm_init_state if kind == "mlstm" else X.slstm_init_state
    tol = F32 if compute_dtype == "float32" else BAND
    x, xj = _inputs((2, 16, pcfg.d_model), compute_dtype, seed=8)
    got = apply(p, x, pcfg)
    assert got.shape == x.shape and got.dtype == x.dtype
    _close(got, _np(japply(jp, xj, jcfg)), tol)
    # Five decode steps from a nonzero state (the states at f32, as the reference holds them).
    rng = np.random.default_rng(9)
    state = {key: torch.from_numpy((0.3 * rng.normal(size=t.shape)).astype(np.float32))
             for key, t in init(pcfg, 2, device="cpu").items()}
    if kind == "slstm":
        state["n"] = state["n"].abs() + 0.5  # a normaliser is positive
    jstate = {key: jnp.asarray(t.numpy()) for key, t in state.items()}
    for t in range(5):
        out, state = step(p, state, x[:, t : t + 1], pcfg)
        jout, jstate = jstep(jp, jstate, xj[:, t : t + 1], jcfg)
        assert out.shape == (2, 1, pcfg.d_model) and out.dtype == x.dtype
        _close(out, _np(jout), tol)
        assert all(v.dtype == torch.float32 for v in state.values())
        assert _state_gap(state, jstate, compute_dtype) <= (1e-5 if compute_dtype == "float32" else 2e-2), t


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_prefill_and_decode_match_jax(compute_dtype):
    """forward_train and prefill over 12 tokens, then the same tokens
    teacher-forced through 12 decode steps: every step's logits and the
    final recurrent states of all 8 layers against the reference's."""
    jcfg, pcfg = _smoke(compute_dtype)
    jparams, np_tree = _params(jcfg, seed=10)
    model = _model(pcfg, np_tree)
    B, n = 2, 12
    toks = np.random.default_rng(11).integers(0, pcfg.vocab, size=(B, n)).astype(np.int32)
    batch, jbatch = {"tokens": torch.from_numpy(toks).long()}, {"tokens": jnp.asarray(toks)}
    tol = F32 if compute_dtype == "float32" else MODEL_BAND
    jctx = JT.ModelContext()
    full, aux, _ = T.forward_train(model, batch, pcfg, T.ModelContext())
    jfull, _, _ = JT.forward_train(jparams, jbatch, jcfg, jctx)
    assert full.shape == (B, n, pcfg.vocab) and full.dtype == getattr(torch, compute_dtype) and float(aux) == 0
    _close(full, _np(jfull), tol)
    logits, cache = T.prefill(model, batch, pcfg, T.ModelContext())
    jlogits, jcache = JT.prefill(jparams, jbatch, jcfg, jctx)
    _close(logits, _np(jlogits), tol)
    assert cache == [{}] * pcfg.n_layers == convert.cache_from_jax(jcache, n_layers=pcfg.n_layers)
    cache, jcache = T.init_cache(pcfg, B, n, device="cpu"), JT.init_cache(jcfg, B, n)
    decode = JD._decode_fn(jcfg, jctx)  # the reference's jitted step, compiled once
    for t in range(n):
        lg, cache = T.decode_step(model, cache, batch["tokens"][:, t : t + 1], t, pcfg, T.ModelContext())
        jlg, jcache = decode(jparams, jcache, jbatch["tokens"][:, t : t + 1], jnp.asarray(t, jnp.int32))
        assert lg.shape == (B, 1, pcfg.vocab)
        _close(lg, _np(jlg), tol)
    want = convert.cache_from_jax(jax.tree_util.tree_map(_np, jcache))
    keys = {"mlstm": ["C", "conv", "m", "n"], "slstm": ["c", "h", "m", "n"]}
    assert [sorted(c) for c in cache] == [sorted(w) for w in want] == [keys[bt] for bt in pcfg.block_types]
    limit = 1e-5 if compute_dtype == "float32" else MODEL_BAND["rtol"]
    for li, (c, w) in enumerate(zip(cache, want)):
        assert {k: tuple(v.shape) for k, v in c.items()} == {k: tuple(v.shape) for k, v in w.items()}, li
        assert _state_gap(c, {k: v.numpy() for k, v in w.items()}, compute_dtype) <= limit, li


def test_xlstm_decode_consistency():
    """Twin of tests/test_models_smoke.py::test_xlstm_decode_consistency:
    the port's chunkwise forward against its own stepwise decode, bf16."""
    cfg = pconf.smoke_config().validate()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(5))
    tokens = torch.randint(0, cfg.vocab, (1, 12), generator=torch.Generator().manual_seed(6))
    full, _, _ = T.forward_train(model, {"tokens": tokens}, cfg, T.ModelContext())
    cache, outs = T.init_cache(cfg, 1, 12, device="cpu"), []
    for t in range(12):
        lg, cache = T.decode_step(model, cache, tokens[:, t : t + 1], t, cfg, T.ModelContext())
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).float().numpy(), full.float().numpy(), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_greedy_generate_matches_jax_token_ids(compute_dtype):
    jcfg, pcfg = _smoke(compute_dtype)
    jparams, np_tree = _params(jcfg, seed=12)
    model = _model(pcfg, np_tree)
    B, n0, steps = 2, 6, 8
    prompt = np.random.default_rng(13).integers(0, pcfg.vocab, size=(B, n0)).astype(np.int32)
    got = D.greedy_generate(model, pcfg, torch.from_numpy(prompt).long(), steps=steps)
    want = np.array(JD.greedy_generate(jparams, jcfg, jnp.asarray(prompt), steps=steps))
    assert got.shape == (B, steps) and got.dtype == torch.int64
    if compute_dtype == "float32":
        # No decision is a near tie: the top two logits differ by > 1e-4.
        seq = torch.cat([torch.from_numpy(prompt).long(), got[:, :-1]], dim=1)
        cache = T.init_cache(pcfg, B, seq.shape[1], device="cpu")
        for t in range(seq.shape[1]):
            lg, cache = T.decode_step(model, cache, seq[:, t : t + 1], t, pcfg, T.ModelContext())
            if t >= n0 - 1:
                top2 = torch.topk(lg[:, 0], 2, dim=-1).values
                assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4, t
        np.testing.assert_array_equal(got.numpy(), want)
        return
    # bf16: the reference's ids teacher-forced through both decode paths.
    # At each decision the two sides' logits lie within the model band, and
    # the reference's pick is within twice their largest gap of the port's
    # top logit (closer logits may swap); where the port's top two lie
    # farther apart than that, the ids are equal.
    seq = np.concatenate([prompt, want[:, :-1]], axis=1)
    cache, jcache = T.init_cache(pcfg, B, seq.shape[1], device="cpu"), JT.init_cache(jcfg, B, seq.shape[1])
    decode = JD._decode_fn(jcfg, JT.ModelContext())
    decided = np.ones(B, bool)
    for t in range(seq.shape[1]):
        lg, cache = T.decode_step(model, cache, torch.from_numpy(seq[:, t : t + 1]).long(), t, pcfg,
                                  T.ModelContext())
        jlg, jcache = decode(jparams, jcache, jnp.asarray(seq[:, t : t + 1]), jnp.asarray(t, jnp.int32))
        if t < n0 - 1:
            continue
        p, r, pick = lg[:, 0].float(), torch.from_numpy(_np(jlg[:, 0])), torch.from_numpy(want[:, t - n0 + 1])
        drift = (p - r).abs().amax(-1)
        assert float(drift.max()) <= MODEL_BAND["atol"] + MODEL_BAND["rtol"] * float(r.abs().max()), t
        top2 = torch.topk(p, 2, dim=-1).values
        assert bool((p.gather(1, pick.long()[:, None])[:, 0] >= top2[:, 0] - 2 * drift).all()), t
        decided &= (top2[:, 0] - top2[:, 1] > 2 * drift).numpy()
        for b in np.flatnonzero(decided):  # every decision so far decided: the port chose the same
            assert int(got[b, t - n0 + 1]) == int(want[b, t - n0 + 1]), (b, t)


# ------------------------------------------------------------------ params, registry, launchers


def test_convert_carries_the_xlstm_tree_and_the_full_count():
    jcfg, pcfg = _smoke("float32")
    _, np_tree = _params(jcfg, seed=14)
    sd = convert.transformer_params_from_jax(np_tree)
    model = T.model_from_state_dict(pcfg, sd)  # strict: every key of the port's tree, no other
    m_names = {"norm", "w_up", "conv.w", "conv.b", "wq", "wk", "wv", "w_i", "b_i", "w_f", "b_f", "hnorm", "w_down"}
    s_names = ({"norm", "hnorm", "w_out", "ffn_norm", "ffn.gate", "ffn.up", "ffn.down"}
               | {f"{w}_{g}" for w in "wrb" for g in "zifo"})
    for li, bt in enumerate(pcfg.block_types):
        names = {k.split(".", 2)[2] for k in sd if k.startswith(f"blocks.{li}.")}
        assert names == (m_names if bt == "mlstm" else s_names), li
    H, dh = pcfg.n_heads, pcfg.d_model // pcfg.n_heads
    assert model.blocks[3].r_z.shape == (H, dh, dh) and model.blocks[3].ffn["up"].shape == (pcfg.d_model, 85)
    np.testing.assert_array_equal(model.blocks[6].wq.numpy(), np_tree["unit"]["slot2"]["wq"][1])
    assert T.param_count(model) == sum(int(np.asarray(x).size) for x in jax.tree_util.tree_leaves(np_tree))
    full = T.Transformer(get_config("xlstm-1.3b"), device="meta", generator=None)
    assert T.param_count(full) == 3_631_155_536  # jax.eval_shape of the reference's init_params
    assert full.blocks[0].wq.shape == (4096, 4096) and full.blocks[7].ffn["gate"].shape == (2048, 2730)


def test_init_params_follows_the_reference_laws():
    cfg = pconf.smoke_config()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    m, s = model.blocks[0], model.blocks[3]
    assert torch.equal(m.b_f, torch.full_like(m.b_f, 3.0)) and not m.b_i.any()
    assert torch.equal(s.b_f, torch.full_like(s.b_f, 3.0)) and not s.b_z.any()
    assert float(m.w_i.std()) < 0.05 and float(s.w_f.std()) < 0.05 and float(m.wq.std()) > 0.05


def test_cast_params_keeps_norms_and_the_recurrence_f32():
    cfg = pconf.smoke_config()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    cast = T.cast_params(model, cfg)
    s = cast.blocks[3]
    assert all(getattr(s, f"r_{g}").dtype == torch.float32 for g in "zifo")
    assert s.r_z.data_ptr() == model.blocks[3].r_z.data_ptr()  # shared, not copied
    assert s.w_z.dtype == cast.blocks[0].wq.dtype == cast.blocks[0].conv["w"].dtype == torch.bfloat16
    assert cast.blocks[0].hnorm.dtype == s.ffn_norm.dtype == torch.float32
    toks = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2))}
    assert torch.equal(T.forward_train(model, toks, cfg, T.ModelContext())[0],
                       T.forward_train(cast, toks, cfg, T.ModelContext())[0])


def test_xlstm_config_registered_with_the_reference_shape():
    from repro.models.registry import get_config as j_get_config

    assert get_config("xlstm-1.3b") == ModelConfig(**vars(j_get_config("xlstm-1.3b")))
    assert pconf.smoke_config() == ModelConfig(**vars(jconf.smoke_config()))
    full = get_config("xlstm-1.3b")
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab, full.block_types.count("slstm")) == (
        48, 2048, 4, 50304, 6)


def test_launch_serve_runs_xlstm_on_cpu(capsys):
    cfg = launch_serve.scaled_config("xlstm-1.3b", "smoke")
    assert (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_kv_heads) == (8, 128, 0, 4)  # 4 layers rounded up to a unit
    assert launch_serve.scaled_config("qwen3-4b", "smoke").n_layers == 4
    before = dict(dispatch.launch_counts())
    launch_serve.main(["--arch", "xlstm-1.3b", "--scale", "smoke", "--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    assert "xlstm-1.3b [smoke]" in out and "tok/s on cpu" in out and "row 0:" in out
    assert dispatch.launch_counts() == before


def test_serve_decode_module_runs_on_cpu(capsys):
    serve_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "qwen3-smoke" in out and "xlstm-smoke" in out and out.count("tok/s on cpu") == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_decode.main([])
