"""Parity of the port's MoE serving path (``repro_torch.models.moe``, the
``attn_moe`` blocks of ``repro_torch.models.transformer``, the MoE scales of
``repro_torch.launch.serve``) with the reference, on the CPU.

The reference's params are drawn by its own ``init_params`` at the
``smoke_config()`` of deepseek-moe-16b (softmax router, two shared experts)
and moonshot-v1-16b-a3b (sigmoid router with top-k renormalisation, one
shared expert); their norm scales are perturbed from the seed (at init they
are ones, which would hide a wrong read), and ``convert`` carries them into
the port as numpy arrays.

Tolerances:

* ``moe_apply`` at f32: output rtol 1e-5, atol 1e-6 (the same f32
  arithmetic in other summation orders), aux rtol 1e-6, and the chosen
  experts equal.  At bf16, given the same bf16 input: rtol 2e-2, atol
  2e-2, the band of ``tests/test_torch_models.py``.
* Where the capacity binds, the kept tokens of every expert equal the
  reference's, ties to the lower token index (``jax.lax.top_k``'s order).
* ``prefill``, ``forward_train`` and ``decode_step`` at f32: rtol 1e-4,
  atol 1e-5; the summed aux rtol 1e-5.  At bf16 the two sides' residual
  streams part by an ulp here and there (the reference's bf16 ``logistic``
  on the CPU, see ``tests/test_torch_models.py``), and an ulp at a near tie
  can flip a top-k choice or a capacity cut, which moves a token's output
  by a whole expert.  So bf16 runs are held by the flip rule: both sides'
  routing decisions (each token's experts, each expert's kept tokens) are
  recorded per layer; with no difference, the logits lie within the 2e-2
  band and the aux within 2e-2 relative; otherwise every layer up to and
  including the first that differs has its K cache within 2e-2 relative
  in norm, since those caches do not depend on a flipped decision.  Then
  the port runs again with the reference's decisions replayed
  (``recorded_routing(replay=...)``) and every output is held to the band:
  the logits, the aux and each layer's K and V caches.
* ``greedy_generate`` at f32: the same token ids as the reference's; the
  test asserts that no decision's top two logits lie within 1e-4.

At decode the batch is 4 and the capacity max(1, int(4·2·1.25/8)) = 1: an
expert that two requests pick keeps one.  So MoE decode is held to the
reference's ``decode_step``, never to ``forward_train`` (as the reference's
``tests/test_models_smoke.py`` runs its teacher-forcing check on dense
architectures only).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serve import decode as JD
from repro_torch import convert
from repro_torch.kernels import dispatch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.registry import ModelConfig, get_config
from repro_torch.serve import decode as D

ARCHS = {"deepseek-moe-16b": "deepseek_moe_16b", "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b"}
F32 = dict(rtol=1e-4, atol=1e-5)
BAND = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _values_not_gradients():
    """The parameters are trainable; these tests hold the serving path's
    values, so autograd records nothing here."""
    with torch.no_grad():
        yield


def _smoke(arch, compute_dtype="float32"):
    """The reference's smoke config and the port's twin of it."""
    jcfg = importlib.import_module(f"repro.configs.{ARCHS[arch]}").smoke_config()
    pcfg = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").smoke_config()
    over = dict(compute_dtype=compute_dtype)
    return dataclasses.replace(jcfg, **over).validate(), dataclasses.replace(pcfg, **over).validate()


def _params(jcfg, seed):
    """The reference's params with perturbed norms: (jnp tree, numpy tree)."""
    tree = jax.tree_util.tree_map(np.array, JT.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        if "norm" in jax.tree_util.keystr(path):
            return (leaf + 0.1 * rng.normal(size=leaf.shape)).astype(leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(perturb, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), tree


def _model(pcfg, np_tree):
    return T.model_from_state_dict(pcfg, convert.transformer_params_from_jax(np_tree))


def _layer_moe(pcfg, np_tree, layer=0):
    """Layer ``layer``'s MoE parameters: (the reference's dict, the port's
    :class:`MoE` holding the converted tensors)."""
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[layer]), np_tree["unit"]["slot0"]["moe"])
    prefix = f"blocks.{layer}.moe."
    sd = {k[len(prefix):]: v for k, v in convert.transformer_params_from_jax(np_tree).items()
          if k.startswith(prefix)}
    p = M.MoE(pcfg, dtype=torch.float32, device="meta", generator=None)
    p.load_state_dict(sd, assign=True)
    return jp, p


def _tokens(cfg, B, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, n)).astype(np.int32)


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _record_reference(monkeypatch):
    """Record every call of the reference's ``_routing``: its combine
    weights (N, E) as a numpy array, one entry per MoE layer in call order."""
    log = []
    orig = JM._routing

    def recorded(*args, **kw):
        out = orig(*args, **kw)
        log.append(_np(out[0]))
        return out

    monkeypatch.setattr(JM, "_routing", recorded)
    return log


def _selections(ws, cfg):
    """The selections of :func:`repro_torch.models.moe.recorded_routing`'s
    log made from recorded combine weights (N, E): per layer each token's
    experts (the nonzero weights, in ``jax.lax.top_k``'s order), then each
    expert's kept tokens."""
    log = []
    for w in ws:
        w = torch.from_numpy(w)
        assert bool((w > 0).sum(1).eq(cfg.moe.top_k).all())
        log += [M._topk(w, cfg.moe.top_k)[1], M.kept_tokens(w, cfg.moe)]
    return log


# ------------------------------------------------------------------ moe_apply


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_apply_matches_jax(arch, compute_dtype):
    jcfg, pcfg = _smoke(arch, compute_dtype)
    _, np_tree = _params(jcfg, seed=1)
    jp, p = _layer_moe(pcfg, np_tree, layer=1)
    x = np.random.default_rng(2).normal(size=(2, 16, pcfg.d_model)).astype(np.float32)
    if compute_dtype == "bfloat16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(xt.float().numpy(), jnp.bfloat16)  # the same bf16 input on both sides
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    out, aux = M.moe_apply(p, xt, pcfg)
    jout, jaux = JM.moe_apply(jp, xj, jcfg)
    assert out.shape == xt.shape and out.dtype == xt.dtype and aux.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-6) if compute_dtype == "float32" else BAND
    _close(out, _np(jout), tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    w, _ = M._routing(p.router, xt, pcfg.moe)
    jw, _ = JM._routing(jp, xj, jcfg.moe, jnp.dtype(compute_dtype))
    np.testing.assert_array_equal(w.numpy() > 0, _np(jw) > 0)  # the chosen experts
    assert bool((w > 0).sum(1).eq(pcfg.moe.top_k).all())


def test_topk_breaks_ties_as_jax_lax_top_k():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, size=(6, 40)).astype(np.float32)  # many exact ties
    x[0] = 0.0  # an expert no token picked: all weights 0
    for k in (1, 7, 40):
        vals, idx = M._topk(torch.from_numpy(x), k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_capacity_binds_on_duplicate_rows_as_the_reference(arch):
    """A router biased to one expert and every token row present twice:
    the capacity binds at that expert and, since C is odd, splits a pair of
    equal rows; the port keeps the reference's tokens, the lower index first."""
    jcfg, pcfg = _smoke(arch)
    _, np_tree = _params(jcfg, seed=4)
    np_tree["unit"]["slot0"]["moe"]["router"][:, :, 3] += 0.5
    jp, p = _layer_moe(pcfg, np_tree)
    half = np.random.default_rng(5).normal(size=(12, pcfg.d_model)).astype(np.float32)
    x = np.concatenate([half, half])[None]  # (1, 24, d): token i + 12 repeats token i
    n, m = 24, pcfg.moe
    capacity = M.capacity(n, m)
    assert capacity == 7
    w, _ = M._routing(p.router, torch.from_numpy(x), m)
    jw, _ = JM._routing(jp, jnp.asarray(x), jcfg.moe, jnp.float32)
    w, jw = w.numpy(), _np(jw)
    np.testing.assert_array_equal(w[:12], w[12:])  # duplicate rows route identically
    assert int((w[:, 3] > 0).sum()) > capacity  # the capacity binds at expert 3
    kept, jkept = M.kept_tokens(torch.from_numpy(w), m).numpy(), np.asarray(
        jax.lax.top_k(jnp.asarray(jw).T, capacity)[1])
    np.testing.assert_array_equal(kept, jkept)
    assert any(i < 12 and i + 12 not in kept[3] for i in kept[3])  # a pair was split, the lower kept
    with M.recorded_routing() as log:
        out, aux = M.moe_apply(p, torch.from_numpy(x), pcfg)
    jout, jaux = JM.moe_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(log[1].numpy(), kept)
    _close(out, _np(jout), dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _combine_case(seed, n=24, E=6, k=4):
    """Combine weights (n, E) with k nonzero, non-dyadic weights a row:
    every token gets k contributions, the capacity binds at busy experts,
    and quiet experts keep zero-weight slots."""
    rng = np.random.default_rng(seed)
    w = np.zeros((n, E), np.float32)
    for t in range(n):
        w[t, rng.choice(E, k, replace=False)] = rng.uniform(0.05, 1.0, size=k)
    w[:, 0] *= (np.arange(n) < n // 2)  # expert 0 serves half the tokens: zero-weight slots
    return w, 14  # under the busiest experts' load (n·k/E = 16 a expert on average)


def _serial_combine(weighted, idx, n):
    """The serial scatter-add, expert by expert: one expert's kept tokens
    are distinct, so each step adds once to each of its rows and rounds.
    (``index_add_`` on the CPU sums a row's bf16 contributions in f32 and
    rounds once, so it is not this order's oracle.)"""
    flat = torch.zeros((n, weighted.shape[-1]), dtype=weighted.dtype)
    for e in range(weighted.shape[0]):
        flat[idx[e]] = flat[idx[e]] + weighted[e]
    return flat


def test_combine_adds_in_the_reference_serial_order_bit_for_bit():
    """bf16 expert outputs summed into their tokens as the reference's
    ``flat.at[idx].add`` sums them: expert by expert, rounding after each
    add; equal bit for bit, and to the serial expert-by-expert sum, while
    the same sums taken in reverse expert order differ."""
    k = 4
    w, cap = _combine_case(17, k=k)
    n, E = w.shape
    c = min(cap, n)
    jvals, jidx = jax.lax.top_k(jnp.asarray(w).T, c)
    assert int((np.asarray(jvals) == 0).sum()) > 0  # inert slots
    out = torch.from_numpy(np.random.default_rng(18).normal(size=(E, c, 16)).astype(np.float32)).bfloat16()
    idx, vals = torch.from_numpy(np.array(jidx)).long(), torch.from_numpy(np.array(jvals))
    got = M._combine(out, idx, vals, n, k)
    weighted = out * vals[..., None].bfloat16()
    jout = jnp.asarray(weighted.float().numpy(), jnp.bfloat16)
    want = jnp.zeros((n, 16), jnp.bfloat16).at[jidx.reshape(-1)].add(jout.reshape(-1, 16))
    assert got.dtype == torch.bfloat16 and got.shape == (n, 16)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    assert torch.equal(got, _serial_combine(weighted, idx, n))
    assert not torch.equal(got, _serial_combine(weighted.flip(0), idx.flip(0), n))  # the order shows in the bits


def test_expert_compute_is_the_reference_bit_for_bit_in_bf16():
    """The expert computation in bf16, the dispatch and experts
    (``_expert_outputs``) then the combine (``_combine``) as ``moe_apply``
    runs them, against the reference's ``_expert_compute``, at a shape
    where several experts keep each token.  The inputs keep every
    step before the combine exact or singly rounded on both sides: integer
    tokens and weights put each gate pre-activation at 8 or more, where the
    silu of both packages returns its input, and the products sum exactly
    in f32; so the outputs differ only if the combine's order does."""
    k = 4
    w, cap = _combine_case(19, k=k)
    n, E = w.shape
    d, f = 8, 6
    rng = np.random.default_rng(20)
    x = rng.integers(1, 3, size=(n, d)).astype(np.float32)
    wg, wu = (rng.integers(1, 3, size=(E, d, f)).astype(np.float32) for _ in range(2))
    wd = rng.integers(-2, 3, size=(E, f, d)).astype(np.float32)
    out, idx, vals = M._expert_outputs(*(torch.from_numpy(a) for a in (x, w, wg, wu, wd)), cap, torch.bfloat16)
    got = M._combine(out, idx, vals, n, k)
    want = JM._expert_compute(*(jnp.asarray(a) for a in (x, w, wg, wu, wd)), cap, jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    assert int((torch.from_numpy(w) > 0).sum(0).max()) > min(cap, n)  # the capacity binds somewhere


def test_recorded_routing_replays_a_runs_selections():
    """A run given its own selections gives the same bits; another input
    given them makes exactly those selections, with its own weights."""
    _, pcfg = _smoke("deepseek-moe-16b")
    _, np_tree = _params(_smoke("deepseek-moe-16b")[0], seed=15)
    _, p = _layer_moe(pcfg, np_tree)
    rng = np.random.default_rng(16)
    x, y = (torch.from_numpy(rng.normal(size=(2, 12, pcfg.d_model)).astype(np.float32)) for _ in range(2))
    with M.recorded_routing() as log_x:
        out_x, aux_x = M.moe_apply(p, x, pcfg)
    assert [tuple(t.shape) for t in log_x] == [(24, pcfg.moe.top_k), (pcfg.moe.num_experts, M.capacity(24, pcfg.moe))]
    with M.recorded_routing() as log_y:
        out_y, _ = M.moe_apply(p, y, pcfg)
    assert M.routing_differences(log_x, log_x) == [0] and M.routing_differences(log_x, log_y) != [0]
    with M.recorded_routing(replay=log_x) as again:
        out, aux = M.moe_apply(p, x, pcfg)
    assert torch.equal(out, out_x) and torch.equal(aux, aux_x)
    assert all(torch.equal(a, b) for a, b in zip(again, log_x))
    with M.recorded_routing(replay=log_x) as forced:
        out, _ = M.moe_apply(p, y, pcfg)
    assert M.routing_differences(forced, log_x) == [0] and not torch.equal(out, out_y)
    with pytest.raises(RuntimeError, match="more selections"):
        with M.recorded_routing(replay=log_x[:1]):
            M.moe_apply(p, x, pcfg)
    with pytest.raises(RuntimeError, match="left unused"):
        with M.recorded_routing(replay=log_x + log_x):
            M.moe_apply(p, x, pcfg)


# ------------------------------------------------------------------ the model


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_forward_match_jax_at_f32(arch):
    jcfg, pcfg = _smoke(arch)
    jparams, np_tree = _params(jcfg, seed=6)
    model = _model(pcfg, np_tree)
    toks = _tokens(jcfg, 2, 64, seed=7)
    batch, jbatch = {"tokens": torch.from_numpy(toks).long()}, {"tokens": jnp.asarray(toks)}
    jctx = JT.ModelContext(attn_impl="pallas_interpret")
    jlogits, jcache = JT.prefill(jparams, jbatch, jcfg, jctx)
    logits, cache = D.make_prefill_fn(pcfg, T.ModelContext())(model, batch)
    assert logits.shape == (2, 1, pcfg.vocab)
    _close(logits, _np(jlogits), F32)
    want = convert.cache_from_jax(jax.tree_util.tree_map(_np, jcache))
    for c, w in zip(cache, want):
        for key in ("k", "v"):
            _close(c[key], w[key], F32)
    full, aux, _ = T.forward_train(model, batch, pcfg, T.ModelContext())
    jfull, jaux, _ = JT.forward_train(jparams, jbatch, jcfg, jctx)
    _close(full, _np(jfull), F32)
    assert aux.dtype == torch.float32 and float(aux) > 0.5 * pcfg.n_layers  # ≈ 1 a layer near uniform
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_forward_match_jax_at_bf16_by_the_flip_rule(arch, monkeypatch):
    jcfg, pcfg = _smoke(arch, "bfloat16")
    jparams, np_tree = _params(jcfg, seed=8)
    model = _model(pcfg, np_tree)
    B, n = 2, 64
    toks = _tokens(jcfg, B, n, seed=9)
    toks[1, :8] = toks[0, :8]  # equal rows: their first tokens tie in every router
    batch, jbatch = {"tokens": torch.from_numpy(toks).long()}, {"tokens": jnp.asarray(toks)}
    refs = _record_reference(monkeypatch)
    with M.recorded_routing() as ports:
        logits, cache = T.prefill(model, batch, pcfg, T.ModelContext())
        full, aux, _ = T.forward_train(model, batch, pcfg, T.ModelContext())
    with jax.disable_jit():  # the reference's scan runs layer by layer: its weights are concrete
        jctx = JT.ModelContext(attn_impl="ref")
        jlogits, jcache = JT.prefill(jparams, jbatch, jcfg, jctx)
        jfull, jaux, _ = JT.forward_train(jparams, jbatch, jcfg, jctx)
    L = pcfg.n_layers
    assert len(ports) == 2 * len(refs) == 4 * L
    chosen = _selections(refs, pcfg)
    want = convert.cache_from_jax(jax.tree_util.tree_map(_np, jcache))

    def cache_gap(li, got, key):
        return float(torch.linalg.vector_norm(got[li][key].float() - want[li][key])
                     / torch.linalg.vector_norm(want[li][key]))

    for run in (slice(0, 2 * L), slice(2 * L, 4 * L)):  # prefill, then forward_train: the same routing
        differ = M.routing_differences(ports[run], chosen[run])
        first = next((li for li, c in enumerate(differ) if c), None)
        if first is None:
            _close(logits, _np(jlogits), BAND)
            _close(full, _np(jfull), BAND)
            np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-2)
        for li in range(L if first is None else first + 1):
            assert cache_gap(li, cache, "k") <= 2e-2, (li, differ)
    # Given the reference's selections, the port differs from it only in
    # arithmetic: every output lies within the band, whatever flipped above.
    with M.recorded_routing(replay=chosen):
        logits, cache = T.prefill(model, batch, pcfg, T.ModelContext())
        full, aux, _ = T.forward_train(model, batch, pcfg, T.ModelContext())
    _close(logits, _np(jlogits), BAND)
    _close(full, _np(jfull), BAND)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-2)
    for li in range(L):
        assert cache_gap(li, cache, "k") <= 2e-2 and cache_gap(li, cache, "v") <= 2e-2, li


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_step_matches_jax_at_capacity_one(arch):
    jcfg, pcfg = _smoke(arch)
    jparams, np_tree = _params(jcfg, seed=10)
    model = _model(pcfg, np_tree)
    B, n = 4, 8
    m = pcfg.moe
    assert max(1, int(B * m.top_k * m.capacity_factor / m.num_experts)) == 1
    toks = _tokens(jcfg, B, n, seed=11)
    toks[1] = toks[0]  # two requests with equal rows: a capacity-one tie at every step
    cache = T.init_cache(pcfg, B, n, device="cpu")
    jcache = JT.init_cache(jcfg, B, n)
    ctx, jctx = T.ModelContext(), JT.ModelContext(attn_impl="ref")
    for t in range(n):
        lg, cache = T.decode_step(model, cache, torch.from_numpy(toks[:, t : t + 1]).long(), t, pcfg, ctx)
        jlg, jcache = JT.decode_step(jparams, jcache, jnp.asarray(toks[:, t : t + 1]),
                                     jnp.asarray(t, jnp.int32), jcfg, jctx)
        assert lg.shape == (B, 1, pcfg.vocab)
        _close(lg, _np(jlg), F32)
    # Capacity one drops a tied request's experts: its logits are not its twin's.
    assert not torch.equal(lg[0], lg[1])


def test_greedy_generate_matches_jax_token_ids():
    jcfg, pcfg = _smoke("deepseek-moe-16b")
    jparams, np_tree = _params(jcfg, seed=12)
    model = _model(pcfg, np_tree)
    B, n0, steps = 2, 8, 6
    prompt = _tokens(jcfg, B, n0, seed=13)
    got = D.greedy_generate(model, pcfg, torch.from_numpy(prompt).long(), steps=steps)
    want = np.asarray(JD.greedy_generate(jparams, jcfg, jnp.asarray(prompt), steps=steps))
    assert got.shape == (B, steps) and got.dtype == torch.int64
    # No decision is a near tie: the decode path's top two logits differ by > 1e-4.
    seq = torch.cat([torch.from_numpy(prompt).long(), got[:, :-1]], dim=1)
    cache = T.init_cache(pcfg, B, seq.shape[1], device="cpu")
    for t in range(seq.shape[1]):
        lg, cache = T.decode_step(model, cache, seq[:, t : t + 1], t, pcfg, T.ModelContext())
        if t >= n0 - 1:
            top2 = torch.topk(lg[:, 0], 2, dim=-1).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4, t
    np.testing.assert_array_equal(got.numpy(), want)


def test_cast_params_keeps_the_router_f32():
    cfg = importlib.import_module("repro_torch.configs.deepseek_moe_16b").smoke_config()
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    cast = T.cast_params(model, cfg)
    moe = cast.blocks[0].moe
    assert moe.router.dtype == torch.float32
    assert moe.router.data_ptr() == model.blocks[0].moe.router.data_ptr()  # shared, not copied
    assert moe.w_gate.dtype == moe.shared["down"].dtype == torch.bfloat16
    toks = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2))}
    a, ca = T.prefill(model, toks, cfg, T.ModelContext())
    b, cb = T.prefill(cast, toks, cfg, T.ModelContext())
    assert torch.equal(a, b) and all(torch.equal(x["k"], y["k"]) for x, y in zip(ca, cb))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_convert_carries_the_moe_subtree(arch):
    jcfg, pcfg = _smoke(arch)
    _, np_tree = _params(jcfg, seed=14)
    sd = convert.transformer_params_from_jax(np_tree)
    model = T.model_from_state_dict(pcfg, sd)  # strict: every key of the port's tree, no other
    moe = np_tree["unit"]["slot0"]["moe"]
    names = {"router", "w_gate", "w_up", "w_down"} | {f"shared.{k}" for k in moe["shared"]}
    assert {k.split(".moe.", 1)[1] for k in sd if ".moe." in k} == names
    got = dict(model.named_parameters())
    for li in range(pcfg.n_layers):
        for name in names:
            leaf = moe
            for part in name.split("."):
                leaf = leaf[part]
            np.testing.assert_array_equal(got[f"blocks.{li}.moe.{name}"].numpy(), leaf[li])
    E, d, f = pcfg.moe.num_experts, pcfg.d_model, pcfg.moe.d_expert
    assert got["blocks.0.moe.w_down"].shape == (E, f, d)
    assert got["blocks.0.moe.shared.up"].shape == (d, f * pcfg.moe.num_shared)
    assert T.param_count(model) == sum(int(np.asarray(x).size) for x in jax.tree_util.tree_leaves(np_tree))


# ------------------------------------------------------------------ registry, launcher


def test_moe_configs_registered_with_reference_shapes():
    from repro.models.registry import get_config as j_get_config

    for arch in ARCHS:
        got, want = get_config(arch), j_get_config(arch)
        # the port's own fields (a held share, the balance loss, padding that routes) at their defaults
        ours = dataclasses.asdict(got.moe)
        assert {k: ours.pop(k) for k in ("experts_held", "balance", "padding_routes")} == {
            "experts_held": None, "balance": "switch", "padding_routes": True}
        assert ours == dataclasses.asdict(want.moe)
        assert got == ModelConfig(**{**vars(want), "moe": got.moe})
    full = get_config("deepseek-moe-16b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim, full.vocab) == (
        28, 2048, 16, 16, 128, 102400)
    assert (full.moe.num_experts, full.moe.top_k, full.moe.d_expert, full.moe.num_shared) == (64, 6, 1408, 2)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_launch_serve_runs_moe_on_cpu(arch, capsys):
    cfg = launch_serve.scaled_config(arch, "smoke")
    assert (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_expert, cfg.moe.num_shared) == (8, 2, 64, 1)
    assert cfg.n_kv_heads == cfg.n_heads and cfg.moe.router_score == get_config(arch).moe.router_score
    before = dict(dispatch.launch_counts())
    launch_serve.main(["--arch", arch, "--scale", "smoke", "--device", "cpu", "--gen", "4"])
    out = capsys.readouterr().out
    assert f"{arch} [smoke]" in out and "tok/s on cpu" in out and "row 0:" in out
    assert dispatch.launch_counts() == before
