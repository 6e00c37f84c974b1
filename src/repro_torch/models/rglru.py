"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), the
twin of the reference's ``models/rglru.py``.

The Real-Gated Linear Recurrent Unit is a *linear* diagonal recurrence

    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t),
    a_t = exp(−c · r_t · softplus(Λ)),   r_t, i_t = σ(linear(x_t))

Block layout: norm → {conv1d → RG-LRU} ⊙ gelu-gate → out projection, then
a gated-MLP sub-layer (``gelu_glu``).

The forward runs the recurrence as :func:`_scan`, a Hillis–Steele doubling
of the reference's ``associative_scan`` combine: ⌈log₂ T⌉ steps, each a few
whole-tensor launches (46 launches a layer at T = 4096), parallel in T.  It
never divides by a cumulative product of a: log a lies in (−1.02, 0), so
1/Πa overflows f32 after ~90 steps, while products of a only underflow
towards 0.  The decode step is the O(d_rnn) recurrence on a vector state.

Dtypes follow the reference: i and r in the compute dtype, log a, a, β, u
and the state h in f32, h rounded to the compute dtype before the gate
product; ``lam`` is read in f32; the decode's conv state is held in the
compute dtype (unlike the xLSTM's f32 one).  Nothing here is a
hand-written kernel: the reference runs the scan as XLA ops outside any
Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import layers as L
from .registry import ModelConfig

__all__ = ["RGLRUBlock", "rglru_apply", "rglru_decode_step", "rglru_init_state"]


def _cd(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


class RGLRUBlock(nn.Module):
    """Parameters of one ``rglru_mlp`` block, with the reference's names and
    initialisation laws: ``norm``, ``w_x`` and ``w_gate`` (d, d_rnn),
    ``conv.{w,b}``, ``w_i`` and ``w_r`` (d_rnn, d_rnn) at scale 0.02 with
    zero biases ``b_i``, ``b_r``, ``lam`` ~ U(−4.6, −2) (so a^c spreads over
    (0.9, 0.999)), ``w_out`` (d_rnn, d), ``mlp_norm`` and the gated ``mlp``.
    The norms and ``lam``, which the forward reads in f32, are held in
    ``f32_read_dtype`` (``dtype`` by default)."""

    block_type = "rglru_mlp"

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator, f32_read_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        rd = f32_read_dtype or dtype
        d = cfg.d_model
        dr = cfg.d_rnn or d
        self.norm = L.rmsnorm_init(d, dtype=rd, device=device)
        self.w_x = L.dense_init(d, dr, **kw)
        self.w_gate = L.dense_init(d, dr, **kw)
        self.conv = L.causal_conv1d_init(dr, cfg.conv_width, **kw)
        self.w_i = L.dense_init(dr, dr, scale=0.02, **kw)
        self.b_i = L._param(torch.zeros((dr,), dtype=dtype, device=device))
        self.w_r = L.dense_init(dr, dr, scale=0.02, **kw)
        self.b_r = L._param(torch.zeros((dr,), dtype=dtype, device=device))
        lam = torch.rand((dr,), generator=generator, device=device, dtype=torch.float32)
        self.lam = L._param(lam.mul_(2.6).sub_(4.6).to(rd))
        self.w_out = L.dense_init(dr, d, **kw)
        self.mlp_norm = L.rmsnorm_init(d, dtype=rd, device=device)
        self.mlp = L.mlp_init(d, cfg.d_ff, gated=True, **kw)


def _gates(p: RGLRUBlock, xc, cfg: ModelConfig):
    """a (f32) and the normalised gated input u (f32) from the conv output
    xc, whose dtype the gates' matmuls take."""
    cd = xc.dtype
    i_t = torch.sigmoid(xc @ p.w_i.to(cd) + p.b_i.to(cd))
    r_t = torch.sigmoid(xc @ p.w_r.to(cd) + p.b_r.to(cd))
    log_a = -cfg.rglru_c * r_t.float() * F.softplus(p.lam.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    u = beta * (i_t.float() * xc.float())
    return a, u


def _scan(a, u):
    """h_t = a_t·h_{t−1} + u_t along dim 1 from h = 0, for a, u (B, T, n):
    Hillis–Steele over the combine (a_l·a_r, a_r·b_l + b_r), the shift
    doubling from 1, so after the step of shift s element t holds the
    composition over (t − 2s, t].  Each right-hand side is computed whole
    before it is written, so the step reads only the previous step's
    values.  Serving overwrites a and u and returns h in u's storage;
    when autograd records (grad enabled and a or u requiring grad), each
    step builds new tensors of the same values instead, since autograd
    refuses the overwrites."""
    T = a.shape[1]
    inplace = not (torch.is_grad_enabled() and (a.requires_grad or u.requires_grad))
    s = 1
    while s < T:
        step_u = torch.addcmul(u[:, s:], a[:, s:], u[:, :-s])
        step_a = a[:, s:] * a[:, :-s] if 2 * s < T else None  # the last step needs no products of a
        if inplace:
            u[:, s:] = step_u
            if step_a is not None:
                a[:, s:] = step_a
        else:
            u = torch.cat([u[:, :s], step_u], dim=1)
            if step_a is not None:
                a = torch.cat([a[:, :s], step_a], dim=1)
        s *= 2
    return u


def _mlp_sublayer(p: RGLRUBlock, x, cfg: ModelConfig, cd):
    xn = L.rmsnorm(x, p.mlp_norm, eps=cfg.rms_eps)
    return x + L.mlp_apply(p.mlp, xn, act="gelu_glu", compute_dtype=cd).to(x.dtype)


def rglru_apply(p: RGLRUBlock, x, cfg: ModelConfig):
    """Training / prefill forward, parallel in T.  x: (B, T, d) → (B, T, d)."""
    cd = _cd(cfg)
    xn = L.rmsnorm(x, p.norm, eps=cfg.rms_eps).to(cd)
    xc = L.causal_conv1d(p.conv, xn @ p.w_x.to(cd))
    h = _scan(*_gates(p, xc, cfg))  # (B, T, d_rnn) f32
    gate = L._gelu(xn @ p.w_gate.to(cd))
    x = x + ((h.to(cd) * gate) @ p.w_out.to(cd)).to(x.dtype)
    return _mlp_sublayer(p, x, cfg, cd)


def rglru_init_state(cfg: ModelConfig, B: int, *, device, dtype) -> dict:
    """Zeros ``h`` (B, d_rnn) in f32 and ``conv`` (B, conv_width − 1, d_rnn)
    in ``dtype`` (the model's compute dtype, as the reference holds it)."""
    dr = cfg.d_rnn or cfg.d_model
    return {
        "h": torch.zeros((B, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((B, cfg.conv_width - 1, dr), dtype=dtype, device=device),
    }


def rglru_decode_step(p: RGLRUBlock, state: dict, x_t, cfg: ModelConfig):
    """x_t: (B, 1, d) → (out (B, 1, d), the new state).  O(d_rnn) a token."""
    cd = _cd(cfg)
    xn = L.rmsnorm(x_t, p.norm, eps=cfg.rms_eps).to(cd)
    conv, xc = L.causal_conv1d_step(p.conv, state["conv"], (xn @ p.w_x.to(cd))[:, 0, :])
    a, u = _gates(p, xc, cfg)
    h = a * state["h"] + u
    gate = L._gelu(xn @ p.w_gate.to(cd))[:, 0, :]
    x = x_t + ((h.to(cd) * gate) @ p.w_out.to(cd)).to(x_t.dtype)[:, None, :]
    return _mlp_sublayer(p, x, cfg, cd), {"h": h, "conv": conv}
