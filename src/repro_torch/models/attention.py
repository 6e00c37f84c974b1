"""GQA attention block, global or sliding-window, with prefill and decode
paths (the twin of the reference's ``models/attention.py``).  The heavy
math of prefill is :func:`repro_torch.kernels.flash_attention.ops.flash_attention`:
the hand-written kernel on the card and its plain version on the CPU for
global attention, the plain chunked attention on every device for a
window (RecurrentGemma's local attention).  A windowed decode writes a ring
cache of the window's size.

Under an LM mesh (``ctx.mesh``) the block runs head-parallel when the
spec of ``wq`` gives each model rank whole heads: the rank projects its
H/m query heads and the KV heads they read and runs the attention (the
kernel, on the card) on them; the heads' outputs are gathered over the
model axis and every rank runs the whole output projection (``wo``
gathered), the meshless model's product to the bit.  Where the KV heads
do not divide the model axis (GQA with KV < m), ``wk``/``wv`` are
gathered and the rank keeps the KV heads its query heads read.  Otherwise
every rank runs all heads on its rows with the weights gathered.  The
decode cache holds the rank's KV heads of its rows.  Under
``ctx.cache_layout == "seq"`` it holds all KV heads of the rank's block of
the slots instead (the reference's ``cache_shardings(layout="seq")``): a
head-parallel block gathers its q, k and v whole over the model axis
after the projections, in one gather (under the GQA fallback each rank
projects all KV heads from the ``wk``/``wv`` it gathers anyway, and
gathers q alone), the owner of the token's
slot writes it, and :func:`decode_attention_seq` combines the ranks'
softmax statistics; the output is whole on every rank.  In training the
projections to the rank's heads are ``collectives.split_linear``
products (under the GQA fallback the input passes
``collectives.enter`` to the KV heads instead, whose counts may differ
between ranks)."""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention import ops as fa
from ..launch import collectives as C
from . import layers as L
from . import taps
from .registry import ModelConfig

__all__ = ["attn_init", "attn_apply", "attn_decode_step", "decode_attention_seq", "local_heads"]


def attn_init(cfg: ModelConfig, *, dtype, device, generator, f32_read_dtype=None) -> nn.ParameterDict:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device, generator=generator)
    p = nn.ParameterDict({
        "wq": L.dense_init(d, H * dh, **kw),
        "wk": L.dense_init(d, KV * dh, **kw),
        "wv": L.dense_init(d, KV * dh, **kw),
        "wo": L.dense_init(H * dh, d, **kw),
    })
    if cfg.qkv_bias:
        for name, width in (("bq", H * dh), ("bk", KV * dh), ("bv", KV * dh)):
            p[name] = L._param(torch.zeros((width,), dtype=dtype, device=device))
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, dtype=f32_read_dtype or dtype, device=device)
        p["k_norm"] = L.rmsnorm_init(dh, dtype=f32_read_dtype or dtype, device=device)
    return p


def local_heads(p, cfg: ModelConfig, ctx=None):
    """This rank's heads: (h0, h1) its query heads, (k0, k1) the KV heads
    they read, ``pick`` the KV head of each query head relative to k0 when
    the query heads' groups do not share KV heads evenly (else ``None``),
    and whether the block runs head-parallel.  Meshless: all heads."""
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lo, hi, split = L.tp_part(p["wq"], 1, ctx, unit=dh)
    if not split:
        return (0, H), (0, KV), None, False
    h0, h1 = lo // dh, hi // dh
    g = H // KV
    kv = [j // g for j in range(h0, h1)]
    k0, k1 = kv[0], kv[-1] + 1
    rep = len(kv) // (k1 - k0)
    even = len(kv) % (k1 - k0) == 0 and kv == [k for k in range(k0, k1) for _ in range(rep)]
    return (h0, h1), (k0, k1), None if even else [k - k0 for k in kv], True


def _project_qkv(p, x, cfg: ModelConfig, positions, compute_dtype, ctx=None, all_kv=False):
    """q, k and v of the rank's heads (``local_heads``); with ``all_kv``
    k and v of every KV head, each once."""
    B, T, _ = x.shape
    dh = cfg.head_dim
    (h0, h1), (k0, k1), pick, split = local_heads(p, cfg, ctx)
    if all_kv:
        (k0, k1), pick = (0, cfg.n_kv_heads), None
    xc = x.to(compute_dtype)

    def proj(name, a, b, even=True):
        w = L.weight(p[name], ctx, 1, a * dh, b * dh).to(compute_dtype)
        if not split:
            return xc @ w
        if even:  # every rank the same count of columns
            return C.split_linear(xc, w, ctx.mesh, ctx.model_axis)
        return C.enter(xc, ctx.mesh, ctx.model_axis) @ w

    q = proj("wq", h0, h1)
    k = proj("wk", k0, k1, pick is None and not all_kv)
    v = proj("wv", k0, k1, pick is None and not all_kv)
    if cfg.qkv_bias:
        q = q + L.weight(p["bq"], ctx, 0, h0 * dh, h1 * dh).to(compute_dtype)
        k = k + L.weight(p["bk"], ctx, 0, k0 * dh, k1 * dh).to(compute_dtype)
        v = v + L.weight(p["bv"], ctx, 0, k0 * dh, k1 * dh).to(compute_dtype)
    q = q.reshape(B, T, h1 - h0, dh)
    k = k.reshape(B, T, k1 - k0, dh)
    v = v.reshape(B, T, k1 - k0, dh)
    if pick is not None:  # one KV head per query head
        k, v = k[:, :, pick], v[:, :, pick]
    if cfg.qk_norm:  # the norms, alike on every model rank, read at the rank's heads
        qn, kn = (C.enter(p[n], ctx.mesh, ctx.model_axis) if split else p[n] for n in ("q_norm", "k_norm"))
        q = L.rmsnorm(q, qn, eps=cfg.rms_eps)
        k = L.rmsnorm(k, kn, eps=cfg.rms_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(p, o, cfg: ModelConfig, ctx, compute_dtype, whole=False):
    """The output projection of the attention output o (B, T, H_loc, dh),
    the rank's heads gathered whole over the model axis first when
    head-parallel (unless o is ``whole`` already)."""
    if not whole and local_heads(p, cfg, ctx)[3]:
        o = C.gather(o, ctx.mesh, ctx.model_axis, 2)
    B, T, h, dh = o.shape
    return o.reshape(B, T, h * dh) @ L.weight(p["wo"], ctx).to(compute_dtype)


def attn_apply(p, x, cfg: ModelConfig, *, positions, window=None, impl="auto", ctx=None):
    """Training / prefill forward.  x: (B, T, d).  Returns (out, (k, v)),
    k and v of the rank's KV heads under a mesh."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype, ctx)
    o = fa.flash_attention(q, k, v, causal=True, window=window, impl=impl)
    return _out(p, o, cfg, ctx, compute_dtype).to(x.dtype), (k, v)


def _gather_heads(mesh, axis: str, *parts):
    """Each of ``parts`` (B, T, h_i, dh), the rank's heads, whole over the
    model axis ``axis``: one gather of their concatenation along the heads,
    each rank's block split back (the ranks' heads in the order of their
    coordinates)."""
    sizes = [t.shape[2] for t in parts]
    whole = C.gather(torch.cat(parts, dim=2), mesh, axis, 2)
    B, T, _, dh = whole.shape
    m = whole.shape[2] // sum(sizes)
    blocks = whole.reshape(B, T, m, sum(sizes), dh).split(sizes, dim=3)
    return [b.reshape(B, T, m * h, dh) for b, h in zip(blocks, sizes)]


def decode_attention_seq(q, k_cache, v_cache, n_valid: int, mesh, axis: str, *, scale=None):
    """Single-token decode attention over a cache whose slots are split
    over the model axis ``axis``: q (B, 1, H, dh) whole on every rank; the
    caches (B, S_loc, KV, dh) the rank's block of the slots; ``n_valid``
    the count of the rank's first slots that hold a token.  The reference's
    ``decode_attention`` as GSPMD partitions it over the sharded slots: s
    in f32, the row max ``pmax``-ed, Σ exp(s − m) ``psum``-med, p = exp(s −
    m)/l in the cache's dtype, the rank's f32 p·V ``psum``-med and cast to
    q's dtype after the sum.  A rank whose slots are all masked adds
    exp(−inf) = 0 (m is the global max, and slot 0, on rank 0, always holds
    a token).  Three all-reduces; every rank returns the same bits."""
    B, _, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    scale = (dh ** -0.5) if scale is None else scale
    qg = (q.reshape(B, KV, g, dh) * torch.tensor(scale, dtype=q.dtype)).to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    valid = torch.arange(S, device=q.device) < n_valid
    s = s.masked_fill(~valid, float("-inf"))
    m = C.pmax(s.amax(dim=-1, keepdim=True), mesh, axis)
    e = torch.exp(s - m)
    l = C.psum(e.sum(dim=-1, keepdim=True), mesh, axis)
    p = (e / l).to(v_cache.dtype)
    out = C.psum(torch.einsum("bkgs,bskd->bkgd", p.float(), v_cache.float()), mesh, axis)
    return out.reshape(B, 1, H, dh).to(q.dtype)


def attn_decode_step(p, x_t, cache_k, cache_v, cur_len: int, cfg: ModelConfig, *, window=None, ctx=None):
    """One-token decode.  x_t: (B, 1, d); caches (B, S, KV, dh).  Writes this
    token's k and v at slot ``cur_len`` of the caches IN PLACE (the
    reference returns updated copies), or with a ``window`` at the ring slot
    ``cur_len % S`` (the cache is sized to the window), and returns (out,
    cache_k, cache_v).  RoPE takes the absolute position ``cur_len``; a ring
    attends to its min(cur_len + 1, S) filled slots, whose order does not
    matter to the softmax.  Under ``cache_layout="seq"`` on a model axis of
    m > 1 ranks the caches are rank r's block of the S·m slots (module
    docstring): the slot's owner writes it, the attention runs
    :func:`decode_attention_seq`."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    seq = ctx.seq_split() if ctx is not None else None
    if seq is None:
        return _decode_feature(p, x_t, cache_k, cache_v, cur_len, cfg, window, ctx, compute_dtype)
    m, r = seq
    S_loc = cache_k.shape[1]
    S = S_loc * m
    pos = torch.full((x_t.shape[0], 1), cur_len, dtype=torch.int32, device=x_t.device)  # (B, 1)
    split = local_heads(p, cfg, ctx)[3]
    all_kv = split and cfg.n_kv_heads % m != 0  # the GQA fallback: ranks share KV heads
    q, k, v = _project_qkv(p, x_t, cfg, pos, compute_dtype, ctx, all_kv=all_kv)
    if split:  # the heads whole on every rank, in one gather
        if all_kv:
            (q,) = _gather_heads(ctx.mesh, ctx.model_axis, q)
        else:
            q, k, v = _gather_heads(ctx.mesh, ctx.model_axis, q, k, v)
    slot = cur_len % S if window is not None else cur_len
    if slot >= S:
        raise IndexError(f"attn_decode_step: slot {slot} of a cache of {S} slots")
    if slot // S_loc == r:  # cur_len is a Python int: choosing the owner syncs nothing
        cache_k[:, slot - r * S_loc] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot - r * S_loc] = v[:, 0].to(cache_v.dtype)
    n = min(cur_len + 1, S) if window is not None else cur_len + 1
    o = decode_attention_seq(q, cache_k, cache_v, min(max(n - r * S_loc, 0), S_loc), ctx.mesh, ctx.model_axis)
    out = _out(p, o, cfg, ctx, compute_dtype, whole=True)
    if taps.active():
        for op, t in (("q", q), ("k", k), ("v", v), ("attention", o), ("attn_out", out)):
            taps.tap(op, t, None)
    return out.to(x_t.dtype), cache_k, cache_v


def _decode_feature(p, x_t, cache_k, cache_v, cur_len: int, cfg: ModelConfig, window, ctx, compute_dtype):
    """:func:`attn_decode_step` with the cache of the rank's KV heads (or
    meshless)."""
    S = cache_k.shape[1]
    pos = torch.full((x_t.shape[0], 1), cur_len, dtype=torch.int32, device=x_t.device)  # (B, 1)
    q, k, v = _project_qkv(p, x_t, cfg, pos, compute_dtype, ctx)
    slot = cur_len % S if window is not None else cur_len
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    o = fa.decode_attention(q, cache_k, cache_v, min(cur_len + 1, S) if window is not None else cur_len + 1)
    out = _out(p, o, cfg, ctx, compute_dtype)
    if taps.active():
        heads = 2 if local_heads(p, cfg, ctx)[3] else None
        for op, t, dim in (("q", q, heads), ("k", k, heads), ("v", v, heads), ("attention", o, heads),
                           ("attn_out", out, None)):
            taps.tap(op, t, dim)
    return out.to(x_t.dtype), cache_k, cache_v
