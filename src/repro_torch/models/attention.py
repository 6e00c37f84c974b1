"""GQA attention block, global or sliding-window, with prefill and decode
paths (the twin of the reference's ``models/attention.py``).  The heavy
math of prefill is :func:`repro_torch.kernels.flash_attention.ops.flash_attention`:
the hand-written kernel on the card and its plain version on the CPU for
global attention, the plain chunked attention on every device for a
window (RecurrentGemma's local attention).  A windowed decode writes a ring
cache of the window's size."""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention import ops as fa
from . import layers as L
from .registry import ModelConfig

__all__ = ["attn_init", "attn_apply", "attn_decode_step"]


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


def _project_qkv(p, x, cfg: ModelConfig, positions, compute_dtype):
    B, T, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xc = x.to(compute_dtype)
    q = xc @ p["wq"].to(compute_dtype)
    k = xc @ p["wk"].to(compute_dtype)
    v = xc @ p["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(compute_dtype)
        k = k + p["bk"].to(compute_dtype)
        v = v + p["bv"].to(compute_dtype)
    q = q.reshape(B, T, H, dh)
    k = k.reshape(B, T, KV, dh)
    v = v.reshape(B, T, KV, dh)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"], eps=cfg.rms_eps)
        k = L.rmsnorm(k, p["k_norm"], eps=cfg.rms_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, *, positions, window=None, impl="auto"):
    """Training / prefill forward.  x: (B, T, d).  Returns (out, (k, v))."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    o = fa.flash_attention(q, k, v, causal=True, window=window, impl=impl)
    B, T = x.shape[:2]
    out = o.reshape(B, T, cfg.n_heads * cfg.head_dim) @ p["wo"].to(compute_dtype)
    return out.to(x.dtype), (k, v)


def attn_decode_step(p, x_t, cache_k, cache_v, cur_len: int, cfg: ModelConfig, *, window=None):
    """One-token decode.  x_t: (B, 1, d); caches (B, S, KV, dh).  Writes this
    token's k and v at slot ``cur_len`` of the caches IN PLACE (the
    reference returns updated copies), or with a ``window`` at the ring slot
    ``cur_len % S`` (the cache is sized to the window), and returns (out,
    cache_k, cache_v).  RoPE takes the absolute position ``cur_len``; a ring
    attends to its min(cur_len + 1, S) filled slots, whose order does not
    matter to the softmax."""
    compute_dtype = getattr(torch, cfg.compute_dtype)
    S = cache_k.shape[1]
    pos = torch.full((x_t.shape[0], 1), cur_len, dtype=torch.int32, device=x_t.device)  # (B, 1)
    q, k, v = _project_qkv(p, x_t, cfg, pos, compute_dtype)
    slot = cur_len % S if window is not None else cur_len
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    o = fa.decode_attention(q, cache_k, cache_v, min(cur_len + 1, S) if window is not None else cur_len + 1)
    B = x_t.shape[0]
    out = o.reshape(B, 1, cfg.n_heads * cfg.head_dim) @ p["wo"].to(compute_dtype)
    return out.to(x_t.dtype), cache_k, cache_v
