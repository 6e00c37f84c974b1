"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential), the twin of the reference's
``models/xlstm.py`` (Beck et al. 2024, arXiv:2405.04517).

mLSTM's forward is the stabilised chunkwise form: a loop over T/chunk
chunks carrying the state (C, n, m); within a chunk a (chunk × chunk)
masked product plus the state's correction terms, in f32.  Its decode step
is the O(dh²) recurrence with no KV cache.  sLSTM's hidden state feeds its
gates through block-diagonal per-head matrices, so its forward is a loop
over T of one cell step.  Nothing here is a hand-written kernel: the
reference runs these steps as XLA ops outside any Pallas kernel.

Dtypes follow the reference's promotions, which differ between the paths:
JAX promotes bf16 with f32 to f32, so under a bf16 compute dtype the
decode step's f32 conv state makes the conv output, q, k and the gates f32
(matmuls against the bf16-rounded weights), while the forward's q, k and v
are bf16.  ``_mm`` makes the same promotion where ``torch.matmul`` would
refuse mixed dtypes.

Under an LM mesh the sLSTM runs head-parallel when the spec of its gate
weights gives each model rank whole heads (H % m == 0), the point of the
reference's head-sharding constraint on the carry: ``w_{z,i,f,o}`` are
column-parallel, the block-diagonal ``r_{z,i,f,o}`` are read at the rank's
heads, so each rank steps its H/m heads with no collective inside the time
loop; the heads' outputs are then gathered over the model axis, and the
norm, ``w_out`` and the gated FFN (its ``d_ff`` columns split) follow as
in ``layers.mlp_apply``.  Otherwise, and in the mLSTM, every rank runs
the whole block on its rows with the weights gathered (their tensor
parallelism is ROADMAP §2 speed work).  The
sLSTM decode step runs all heads with the weights gathered, as the
reference's constraint does not reach its decode.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..launch import collectives as C
from . import layers as L
from .registry import ModelConfig

__all__ = [
    "MLSTMBlock",
    "SLSTMBlock",
    "mlstm_apply",
    "mlstm_decode_step",
    "mlstm_init_state",
    "slstm_apply",
    "slstm_decode_step",
    "slstm_init_state",
]

_GATES = ("z", "i", "f", "o")


def _mm(a, w, compute_dtype):
    """``a @ w.astype(compute_dtype)`` with JAX's promotion: the product
    runs in the wider of a's dtype and the compute dtype."""
    w = w.to(compute_dtype)
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _cd(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _scale(dh: int, dtype: torch.dtype) -> float:
    """dh^-0.5 rounded to ``dtype``: JAX rounds a Python scalar to the
    dtype of the array it multiplies."""
    return float(torch.tensor(dh**-0.5, dtype=dtype))


# --------------------------------------------------------------------- mLSTM


class MLSTMBlock(nn.Module):
    """Parameters of one mLSTM block, with the reference's names and
    initialisation laws: ``norm``, ``w_up`` (d, 2·di), ``conv.{w,b}``,
    ``wq``/``wk``/``wv`` (di, di), ``w_i``/``w_f`` (di, H) at scale 0.02,
    ``b_i`` zeros, ``b_f`` threes (open forget gates), ``hnorm``,
    ``w_down`` (di, d); di = mlstm_proj_factor·d."""

    block_type = "mlstm"

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator, f32_read_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        rd = f32_read_dtype or dtype
        d, H = cfg.d_model, cfg.n_heads
        di = int(cfg.mlstm_proj_factor * d)
        self.norm = L.rmsnorm_init(d, dtype=rd, device=device)
        self.w_up = L.dense_init(d, 2 * di, **kw)
        self.conv = L.causal_conv1d_init(di, cfg.conv_width, **kw)
        self.wq = L.dense_init(di, di, **kw)
        self.wk = L.dense_init(di, di, **kw)
        self.wv = L.dense_init(di, di, **kw)
        self.w_i = L.dense_init(di, H, scale=0.02, **kw)
        self.b_i = L._param(torch.zeros((H,), dtype=dtype, device=device))
        self.w_f = L.dense_init(di, H, scale=0.02, **kw)
        self.b_f = L._param(torch.full((H,), 3.0, dtype=dtype, device=device))
        self.hnorm = L.rmsnorm_init(di, dtype=rd, device=device)
        self.w_down = L.dense_init(di, d, **kw)


def _mlstm_chunkwise(q, k, v, log_i, log_f, *, chunk: int):
    """Stabilised chunkwise mLSTM cell, in f32.

    q, k, v: (B, H, T, dh); log_i, log_f: (B, H, T).  Returns h (B, H, T, dh)."""
    B, H, T, dh = q.shape
    nc = T // chunk
    qs = (q * _scale(dh, q.dtype)).float().reshape(B, H, nc, chunk, dh)
    ks = k.float().reshape(B, H, nc, chunk, dh)
    vs = v.float().reshape(B, H, nc, chunk, dh)
    li = log_i.float().reshape(B, H, nc, chunk)
    b = torch.cumsum(log_f.float().reshape(B, H, nc, chunk), dim=-1)  # inclusive within-chunk decay
    total = b[..., -1]  # (B, H, nc)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()  # τ' ≤ τ

    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=q.device)
    m = torch.zeros((B, H), dtype=torch.float32, device=q.device)
    hs = []
    for j in range(nc):
        qc, kc, vc = qs[:, :, j], ks[:, :, j], vs[:, :, j]
        ic, bc, tot = li[:, :, j], b[:, :, j], total[:, :, j]
        # Stabilisers.
        g = ic - bc  # (B, H, c): i_τ' − b_τ'
        gmax = torch.cummax(g, dim=-1).values  # running max over τ' ≤ τ
        m_intra = bc + gmax
        m_new = torch.maximum(bc + m[..., None], m_intra)  # (B, H, c)
        alpha = torch.exp(bc + m[..., None] - m_new)  # inter-chunk coefficient
        # Intra-chunk masked weights D_ττ' = exp(b_τ − b_τ' + i_τ' − m_τ).
        logD = bc[..., :, None] - bc[..., None, :] + ic[..., None, :] - m_new[..., None]
        D = torch.where(tri, torch.exp(logD), 0.0)  # (B, H, c, c)
        sD = (qc @ kc.transpose(-1, -2)) * D  # (B, H, c, c)
        num = sD @ vc
        num = num + alpha[..., None] * (qc @ C)
        den = torch.sum(sD, dim=-1)  # Σ D·(q·k)
        den = den + alpha * torch.einsum("bhqd,bhd->bhq", qc, n)
        hs.append(num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None])
        # State update to the chunk's end.
        m_next = torch.maximum(tot + m, tot + gmax[..., -1])
        w_in = torch.exp(tot[..., None] - bc + ic - m_next[..., None])  # (B, H, c)
        kw = kc * w_in[..., None]  # weight the keys first: the cheap contraction order
        decay = torch.exp(tot + m - m_next)
        C = decay[..., None, None] * C + kw.transpose(-1, -2) @ vc
        n = decay[..., None] * n + torch.sum(kw, dim=2)
        m = m_next
    return torch.stack(hs, dim=2).reshape(B, H, T, dh)


def _mlstm_pre(p: MLSTMBlock, x, cfg: ModelConfig, conv_state=None):
    """The shared projection path.  Returns per-head q, k, v (B, H, T, dh),
    log_i and log_f (B, H, T) in f32, the gate branch, and the new conv
    state (None without ``conv_state``)."""
    cd = _cd(cfg)
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    H = cfg.n_heads
    xn = L.rmsnorm(x, p.norm, eps=cfg.rms_eps).to(cd)
    z = xn @ p.w_up.to(cd)
    x_in, x_gate = z[..., :di], z[..., di:]
    if conv_state is None:
        c = F.silu(L.causal_conv1d(p.conv, x_in))
        new_conv = None
    else:
        new_conv, c1 = L.causal_conv1d_step(p.conv, conv_state, x_in[:, 0, :])
        c = F.silu(c1)[:, None, :]
    q = _mm(c, p.wq, cd)
    k = _mm(c, p.wk, cd)
    v = x_in @ p.wv.to(cd)
    log_i = _mm(c, p.w_i, cd) + p.b_i.to(cd)
    log_f = F.logsigmoid((_mm(c, p.w_f, cd) + p.b_f.to(cd)).float())
    B, T = x.shape[:2]
    dh = di // H

    def to_heads(t):
        return t.reshape(B, T, H, dh).transpose(1, 2)

    return (
        to_heads(q), to_heads(k), to_heads(v),
        log_i.float().transpose(1, 2),  # (B, H, T)
        log_f.transpose(1, 2),
        x_gate, new_conv,
    )


def _mlstm_post(p: MLSTMBlock, h_heads, x, x_gate, cfg: ModelConfig):
    """Per-head norm → gate → down-projection → residual."""
    cd = _cd(cfg)
    B, H, T, dh = h_heads.shape
    h = h_heads.transpose(1, 2).reshape(B, T, H * dh)
    h = L.rmsnorm(h.to(cd), p.hnorm, eps=cfg.rms_eps)
    h = h * F.silu(x_gate)
    out = h @ p.w_down.to(cd)
    return x + out.to(x.dtype)


def mlstm_apply(p: MLSTMBlock, x, cfg: ModelConfig, *, chunk: int = 256):
    """mLSTM block forward.  x: (B, T, d) → (B, T, d).  The chunk is
    min(chunk, T), halved until it divides T."""
    q, k, v, log_i, log_f, x_gate, _ = _mlstm_pre(p, x, cfg)
    T = x.shape[1]
    chunk = min(chunk, T)
    while T % chunk:
        chunk //= 2
    h = _mlstm_chunkwise(q, k, v, log_i, log_f, chunk=max(chunk, 1))
    return _mlstm_post(p, h.to(x.dtype), x, x_gate, cfg)


def mlstm_init_state(cfg: ModelConfig, B: int, *, device, dtype=torch.float32) -> dict:
    """Zeros: ``C`` (B, H, dh, dh), ``n`` (B, H, dh), ``m`` (B, H) and the
    conv window ``conv`` (B, W−1, di), dh = di / H."""
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    dh = di // H
    kw = dict(dtype=dtype, device=device)
    return {
        "C": torch.zeros((B, H, dh, dh), **kw),
        "n": torch.zeros((B, H, dh), **kw),
        "m": torch.zeros((B, H), **kw),
        "conv": torch.zeros((B, cfg.conv_width - 1, di), **kw),
    }


def mlstm_decode_step(p: MLSTMBlock, state: dict, x_t, cfg: ModelConfig):
    """x_t: (B, 1, d) → (out (B, 1, d), the new state).  O(dh²), no KV cache."""
    q, k, v, log_i, log_f, x_gate, new_conv = _mlstm_pre(p, x_t, cfg, conv_state=state["conv"])
    qs = q[:, :, 0].float() * _scale(q.shape[-1], torch.float32)  # (B, H, dh)
    kc = k[:, :, 0].float()
    vc = v[:, :, 0].float()
    li = log_i[:, :, 0]
    lf = log_f[:, :, 0]
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(lf + m, li)
    decay = torch.exp(lf + m - m_new)
    inject = torch.exp(li - m_new)
    C = decay[..., None, None] * C + inject[..., None, None] * (kc[..., :, None] * vc[..., None, :])
    n = decay[..., None] * n + inject[..., None] * kc
    num = (qs[..., None, :] @ C)[..., 0, :]  # Σ_d q_d C_de
    den = torch.sum(qs * n, dim=-1)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]  # (B, H, dh)
    out = _mlstm_post(p, h[:, :, None, :].to(x_t.dtype), x_t, x_gate, cfg)
    return out, {"C": C, "n": n, "m": m_new, "conv": new_conv}


# --------------------------------------------------------------------- sLSTM


class SLSTMBlock(nn.Module):
    """Parameters of one sLSTM block, with the reference's names and
    initialisation laws: ``norm``; per gate g in z, i, f, o ``w_g`` (d, d)
    (scale 0.02 for i and f), ``r_g`` (H, dh, dh) ~ N(0, 1)/√dh·0.5 and
    ``b_g`` (d,) (threes for f); ``hnorm``, ``w_out`` (d, d), ``ffn_norm``
    and the gated ``ffn`` of width int(slstm_proj_factor·d)."""

    block_type = "slstm"

    def __init__(self, cfg: ModelConfig, *, dtype, device, generator, f32_read_dtype=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device, generator=generator)
        rd = f32_read_dtype or dtype
        d, H = cfg.d_model, cfg.n_heads
        dh = d // H
        self.norm = L.rmsnorm_init(d, dtype=rd, device=device)
        for g in _GATES:
            setattr(self, f"w_{g}", L.dense_init(d, d, scale=0.02 if g in ("i", "f") else None, **kw))
            r = torch.randn((H, dh, dh), generator=generator, device=device, dtype=rd)
            setattr(self, f"r_{g}", L._param(r.div_(math.sqrt(dh)).mul_(0.5)))
            b = torch.full((d,), 3.0 if g == "f" else 0.0, dtype=dtype, device=device)
            setattr(self, f"b_{g}", L._param(b))
        self.hnorm = L.rmsnorm_init(d, dtype=rd, device=device)
        self.w_out = L.dense_init(d, d, **kw)
        self.ffn_norm = L.rmsnorm_init(d, dtype=rd, device=device)
        self.ffn = L.mlp_init(d, int(cfg.slstm_proj_factor * d), gated=True, **kw)


def _recurrence(p: SLSTMBlock, heads=None, ctx=None):
    """The four gates' per-head recurrent matrices side by side, (H, dh,
    4·dh) in f32 (the reference reads them at the hidden state's f32), of
    the heads [h0, h1) given."""
    h0, h1 = heads or (0, None)
    return torch.cat([L.weight(getattr(p, f"r_{g}"), ctx, 0, h0, h1).float() for g in _GATES], dim=-1)


def _slstm_cell(r, pre, state):
    """One time step, heads leading.  r: :func:`_recurrence`'s (H, dh, 4·dh);
    pre: the input projections (H, B, 4·dh), gates z, i, f, o side by side;
    state: (h, c, n, m), each (H, B, dh) f32.  Returns the new state."""
    h, c, n, m = state
    dh = h.shape[-1]
    pre = torch.baddbmm(pre, h, r)  # x-projection + Σ_d h_d r_de, per head
    z = torch.tanh(pre[..., :dh])
    log_i = pre[..., dh : 2 * dh]
    log_f = F.logsigmoid(pre[..., 2 * dh : 3 * dh])
    o = torch.sigmoid(pre[..., 3 * dh :])
    m_new = torch.maximum(log_f + m, log_i)
    decay = torch.exp(log_f + m - m_new)
    inject = torch.exp(log_i - m_new)
    c = decay * c + inject * z
    n = decay * n + inject
    return o * c / torch.clamp_min(n, 1e-6), c, n, m_new


def _slstm_gates(p: SLSTMBlock, xn, cfg: ModelConfig, cols=(0, None), ctx=None):
    """The input projections of the four gates: (..., H, 4·dh) f32 from
    xn (..., d) in the compute dtype, at the columns [lo, hi) of whole
    heads given (under a mesh, the rank's: ``collectives.split_linear``)."""
    cd = _cd(cfg)
    lo, hi = cols
    dh = cfg.d_model // cfg.n_heads

    def mm(w):
        if ctx is not None and ctx.mesh is not None:
            return C.split_linear(xn, w, ctx.mesh, ctx.model_axis)
        return xn @ w

    pre = [(mm(L.weight(getattr(p, f"w_{g}"), ctx, 1, lo, hi).to(cd))
            + L.weight(getattr(p, f"b_{g}"), ctx, 0, lo, hi).to(cd)).float() for g in _GATES]
    return torch.stack([t.unflatten(-1, (-1, dh)) for t in pre], dim=-2).flatten(-2)


def _slstm_out(p: SLSTMBlock, x, h, cfg: ModelConfig, ctx=None):
    """The cell's output h (B, T, d) f32 → norm → projection → residual,
    then the post-FFN (gelu_glu) with its residual."""
    cd = _cd(cfg)
    h = L.rmsnorm(h.to(cd), p.hnorm, eps=cfg.rms_eps)
    x = x + (h @ L.weight(p.w_out, ctx).to(cd)).to(x.dtype)
    xn2 = L.rmsnorm(x, p.ffn_norm, eps=cfg.rms_eps)
    return x + L.mlp_apply(p.ffn, xn2, act="gelu_glu", compute_dtype=cd, ctx=ctx).to(x.dtype)


def slstm_apply(p: SLSTMBlock, x, cfg: ModelConfig, ctx=None):
    """sLSTM block forward.  x: (B, T, d) → (B, T, d); the cell runs over T
    one step at a time, on the rank's heads under a mesh that splits them."""
    cd = _cd(cfg)
    B, T, d = x.shape
    dh = d // cfg.n_heads
    lo, hi, split = L.tp_part(p.w_z, 1, ctx, unit=dh)
    if not split:
        p, ctx = L.gathered(p, ctx), None
    H = (hi - lo) // dh
    xn = L.rmsnorm(x, p.norm, eps=cfg.rms_eps).to(cd)
    pre = _slstm_gates(p, xn, cfg, (lo, hi), ctx).permute(1, 2, 0, 3).contiguous()  # (T, H, B, 4·dh)
    r = _recurrence(p, (lo // dh, hi // dh), ctx)
    state = (torch.zeros((H, B, dh), dtype=torch.float32, device=x.device),) * 4
    hs = []
    for t in range(T):
        state = _slstm_cell(r, pre[t], state)
        hs.append(state[0])
    h = torch.stack(hs, dim=0).permute(2, 0, 1, 3).reshape(B, T, H * dh)  # (T, H, B, dh) → (B, T, H·dh)
    if split:
        h = C.gather(h, ctx.mesh, ctx.model_axis, -1)
    return _slstm_out(p, x, h, cfg, ctx)


def slstm_init_state(cfg: ModelConfig, B: int, *, device, dtype=torch.float32) -> dict:
    """Zeros ``h``, ``c``, ``n``, ``m``, each (B, H, dh), dh = d / H."""
    shape = (B, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {key: torch.zeros(shape, dtype=dtype, device=device) for key in ("h", "c", "n", "m")}


def slstm_decode_step(p: SLSTMBlock, state: dict, x_t, cfg: ModelConfig):
    """x_t: (B, 1, d) → (out (B, 1, d), the new state).  Meshless (under a
    mesh the caller passes the block with its weights gathered)."""
    B = x_t.shape[0]
    xn = L.rmsnorm(x_t[:, 0, :], p.norm, eps=cfg.rms_eps).to(_cd(cfg))
    pre = _slstm_gates(p, xn, cfg).transpose(0, 1)  # (H, B, 4·dh)
    heads_first = tuple(state[key].transpose(0, 1) for key in ("h", "c", "n", "m"))
    h, c, n, m = (t.transpose(0, 1) for t in _slstm_cell(_recurrence(p), pre, heads_first))
    out = _slstm_out(p, x_t, h.reshape(B, 1, cfg.d_model), cfg)
    return out, {"h": h, "c": c, "n": n, "m": m}
