"""Shared neural building blocks, as in the reference's ``models/layers.py``:
RMSNorm and RoPE in f32, the gated MLP in the compute dtype, the depthwise
causal convolution of the xLSTM blocks in its input's dtype.  Dense weights
keep the reference's (d_in, d_out) layout, so a forward is ``x @ w`` on
both sides."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "dense_init",
    "rmsnorm_init",
    "rmsnorm",
    "rope_freqs",
    "apply_rope",
    "mlp_init",
    "mlp_apply",
    "causal_conv1d_init",
    "causal_conv1d",
    "causal_conv1d_step",
]


def _param(t: torch.Tensor) -> nn.Parameter:
    # Trainable; the serving entry points run under no_grad.
    return nn.Parameter(t)


def dense_init(d_in: int, d_out: int, *, dtype, device, generator, scale: float | None = None):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=generator, device=device, dtype=dtype)
    return _param(w.mul_(scale))


def rmsnorm_init(d: int, *, dtype, device):
    return _param(torch.ones((d,), dtype=dtype, device=device))


def rmsnorm(x, scale, *, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, T, H, dh); positions: (T,) or (B, T).  Split halves, f32 math."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)  # (dh/2,)
    pos = positions.float()
    if pos.dim() == 1:
        pos = pos[None, :]  # (1, T)
    ang = pos[..., None] * freqs[None, None, :]  # (B?, T, dh/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(d: int, d_ff: int, *, gated: bool, dtype, device, generator) -> nn.ParameterDict:
    kw = dict(dtype=dtype, device=device, generator=generator)
    p = nn.ParameterDict()
    if gated:
        p["gate"] = dense_init(d, d_ff, **kw)
    p["up"] = dense_init(d, d_ff, **kw)
    p["down"] = dense_init(d_ff, d, **kw)
    return p


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def mlp_apply(p, x, *, act: str, compute_dtype):
    xc = x.to(compute_dtype)
    if "gate" in p:
        g = xc @ p["gate"].to(compute_dtype)
        u = xc @ p["up"].to(compute_dtype)
        h = (F.silu(g) if act == "silu_glu" else _gelu(g)) * u
    else:
        h = _gelu(xc @ p["up"].to(compute_dtype))
    return h @ p["down"].to(compute_dtype)


def causal_conv1d_init(d: int, width: int, *, dtype, device, generator) -> nn.ParameterDict:
    w = torch.randn((width, d), generator=generator, device=device, dtype=dtype)
    return nn.ParameterDict({
        "w": _param(w.div_(math.sqrt(width))),
        "b": _param(torch.zeros((d,), dtype=dtype, device=device)),
    })


def causal_conv1d(p, x):
    """Depthwise causal conv over time.  x: (B, T, d) → (B, T, d), every
    product and sum rounded to x's dtype, as the reference's unrolled taps."""
    w = p["w"].to(x.dtype)  # (W, d)
    width, T = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x)
    for i in range(width):  # width is tiny (4): unrolled adds, no conv op
        out = out + pad[:, i : i + T, :] * w[i]
    return out + p["b"].to(x.dtype)


def causal_conv1d_step(p, state, x_t):
    """Single decode step.  state: (B, W−1, d) past inputs; x_t: (B, d).
    Returns (the new state, out (B, d)).  The window takes the wider of the
    two dtypes (the reference's f32 state makes the output f32 under a bf16
    input)."""
    w = p["w"].to(x_t.dtype)
    window = torch.cat([state, x_t[:, None, :]], dim=1)  # (B, W, d)
    out = torch.einsum("bwd,wd->bd", window, w.to(window.dtype)) + p["b"].to(x_t.dtype)
    return window[:, 1:], out  # the new state drops the oldest column
