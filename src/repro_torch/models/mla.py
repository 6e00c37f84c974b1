"""Multi-head latent attention (MLA), DeepSeek-V2's attention
(arXiv:2405.04434 §2.1), without the query's low-rank path, for training
and prefill.  The reference package has no twin of it.

Per layer, on the normed residual x:

* q = x·W_q, split per head into a ``qk_nope``-wide part and a
  ``qk_rope``-wide part;
* [c, k_r] = x·W_kva, c the ``kv_lora_rank``-wide latent and k_r one
  ``qk_rope``-wide key shared by every head; c ← RMSNorm(c);
* [k_nope, v] = c·W_kvb, ``qk_nope`` + ``v_head_dim`` per head;
* rotary embedding, with YaRN's frequencies (``layers.yarn_freqs``), on
  q's rope part and on k_r; each head's key is [k_nope, k_r];
* causal softmax attention at the scale (qk_nope + qk_rope)^−½ ·
  yarn_mscale(factor, mscale_all_dim)², then o·W_o.

The rotary embedding pairs the rope part's dimensions by split halves
(dimension i with i + qk_rope/2), as every rotary layer of the port does;
DeepSeek-V2's published weights pair adjacent dimensions, which is the same
rotation after a fixed permutation of the rope columns of W_q and W_kva.
The attention's q/k heads (192 at the published widths) are wider than its
v heads (128), so ``flash_attention`` routes the call to its plain route on
every device (``kernels.flash_attention.ops``).  Each layer's forward is
the span ``mla.attention``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention import ops as fa
from ..obs import trace_span
from . import layers as L
from .registry import ModelConfig

__all__ = ["mla_apply", "mla_init", "mla_rope_freqs", "mla_scale"]


def mla_init(cfg: ModelConfig, *, dtype, device, generator, f32_read_dtype=None) -> nn.ParameterDict:
    """``wq`` (d, H·(nope + rope)), ``wkv_a`` (d, rank + rope), ``kv_norm``
    (rank,), ``wkv_b`` (rank, H·(nope + v)) and ``wo`` (H·v, d)."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    kw = dict(dtype=dtype, device=device, generator=generator)
    return nn.ParameterDict({
        "wq": L.dense_init(d, H * (m.qk_nope_head_dim + m.qk_rope_head_dim), **kw),
        "wkv_a": L.dense_init(d, m.kv_lora_rank + m.qk_rope_head_dim, **kw),
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, dtype=f32_read_dtype or dtype, device=device),
        "wkv_b": L.dense_init(m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim), **kw),
        "wo": L.dense_init(H * m.v_head_dim, d, **kw),
    })


def mla_scale(cfg: ModelConfig) -> float:
    """The softmax scale: (qk_nope + qk_rope)^−½ · yarn_mscale²."""
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5 * L.yarn_mscale(m.rope_factor,
                                                                            m.rope_mscale_all_dim) ** 2


def mla_rope_freqs(cfg: ModelConfig, device=None):
    m = cfg.mla
    return L.yarn_freqs(m.qk_rope_head_dim, cfg.rope_theta, m.rope_factor, m.rope_original_max, m.rope_beta_fast,
                        m.rope_beta_slow, device=device)


def mla_apply(p, x, cfg: ModelConfig, *, positions, impl="auto"):
    """Training / prefill forward.  x: (B, T, d) → (B, T, d) in x's dtype.
    YaRN's rotary factor mscale / mscale_all_dim is 1 when the two are
    equal, as in DeepSeek-V2's configs; the rotation then has unit norm."""
    m, H = cfg.mla, cfg.n_heads
    nope, rope, rank, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank, m.v_head_dim
    if m.rope_mscale != m.rope_mscale_all_dim:
        raise ValueError(f"{cfg.name}: rope mscale {m.rope_mscale} != mscale_all_dim {m.rope_mscale_all_dim}")
    cd = getattr(torch, cfg.compute_dtype)
    B, T, _ = x.shape
    with trace_span("mla.attention"):
        xc = x.to(cd)
        q_nope, q_rope = (xc @ p["wq"].to(cd)).view(B, T, H, nope + rope).split([nope, rope], dim=-1)
        c, k_rope = (xc @ p["wkv_a"].to(cd)).split([rank, rope], dim=-1)
        c = L.rmsnorm(c, p["kv_norm"], eps=cfg.rms_eps)
        k_nope, v = (c @ p["wkv_b"].to(cd)).view(B, T, H, nope + dv).split([nope, dv], dim=-1)
        freqs = mla_rope_freqs(cfg, device=x.device)
        q_rope = L.apply_rope(q_rope, positions, cfg.rope_theta, freqs=freqs)
        k_rope = L.apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta, freqs=freqs)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(B, T, H, rope)], dim=-1)
        o = fa.flash_attention(q, k, v, causal=True, scale=mla_scale(cfg), impl=impl)
        return (o.reshape(B, T, H * dv) @ p["wo"].to(cd)).to(x.dtype)
