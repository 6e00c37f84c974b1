"""Shared neural building blocks, as in the reference's ``models/layers.py``:
RMSNorm and RoPE in f32, the gated MLP in the compute dtype, the depthwise
causal convolution of the xLSTM blocks in its input's dtype.  Dense weights
keep the reference's (d_in, d_out) layout, so a forward is ``x @ w`` on
both sides.

Under an LM mesh a parameter may hold only this rank's block of the full
tensor, tagged with its spec (``mesh_spec``, set by
``launch.sharding.shard_model``).  :func:`weight` is how the model code
reads one: the full tensor, or a slice of it along one dim, from the
local block where the block covers the slice and gathered over the spec's
axes otherwise (FSDP dims always: the reference's GSPMD gathers them right
before the layer).  :func:`gathered` gives a whole block's parameters so.
:func:`mlp_apply` splits its ``d_ff`` columns over the model axis when the
spec does."""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..launch import collectives as C
from . import taps

__all__ = [
    "gathered",
    "tp_part",
    "weight",
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


def mlp_apply(p, x, *, act: str, compute_dtype, ctx=None):
    """The MLP on x (..., d) in ``compute_dtype``.  Under a mesh whose
    model axis splits the ``d_ff`` columns of ``up``, each model rank runs
    its columns of gate and up, the hidden activations are gathered whole
    over the model axis, and every rank runs the whole down projection
    (its weight gathered): the meshless model's product, to the bit.  The
    split columns are ``collectives.split_linear`` products, whose backward
    forms the input's cotangent whole."""
    lo, hi, split = tp_part(p["up"], 1, ctx)
    xc = x.to(compute_dtype)

    def cols(name):
        w = weight(p[name], ctx, 1, lo, hi).to(compute_dtype)
        return C.split_linear(xc, w, ctx.mesh, ctx.model_axis) if split else xc @ w

    if "gate" in p:
        g = cols("gate")
        u = cols("up")
        h = (F.silu(g) if act == "silu_glu" else _gelu(g)) * u
    else:
        h = _gelu(cols("up"))
    if split:
        h = C.gather(h, ctx.mesh, ctx.model_axis, -1)
    out = h @ weight(p["down"], ctx).to(compute_dtype)
    taps.tap("mlp", out)
    return out


# ------------------------------------------------------------------ mesh


def _spec(w):
    return getattr(w, "mesh_spec", None)


def _full_dim(w, dim: int, ctx) -> int:
    """The size of w's dim ``dim`` in the full tensor."""
    spec = _spec(w)
    if spec is None or spec[dim] is None or ctx is None or ctx.mesh is None:
        return w.shape[dim]
    return w.shape[dim] * ctx.mesh.shape[spec[dim]]


def tp_part(w, dim: int, ctx, unit: int = 1):
    """(lo, hi, split): this model rank's range of w's dim ``dim`` when
    the spec splits that dim over the model axis into whole ``unit``s
    (heads of width ``unit``), else the whole dim and ``split`` False."""
    n = _full_dim(w, dim, ctx)
    spec = _spec(w)
    if spec is None or ctx is None or ctx.mesh is None or ctx.model_axis is None or spec[dim] != ctx.model_axis:
        return 0, n, False
    m = ctx.mesh.shape[ctx.model_axis]
    if (n // unit) % m:
        return 0, n, False
    blk = n // m
    r = ctx.mesh.coord(ctx.model_axis)
    return r * blk, (r + 1) * blk, True


def weight(w, ctx, dim=None, lo: int = 0, hi=None):
    """The full tensor w, or its slice [lo, hi) along ``dim``: the local
    block's part when the spec splits ``dim`` and this rank's block covers
    the slice, gathered over every other split dim's axis.  A slice of a
    tensor that the model ranks hold alike passes ``collectives.enter``
    first (each rank's slice is its own)."""
    spec = _spec(w)
    if spec is None or ctx is None or ctx.mesh is None:
        if dim is None or (lo == 0 and hi in (None, w.shape[dim])):
            return w
        return w.narrow(dim, lo, hi - lo)
    mesh = ctx.mesh
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        blk = w.shape[i]
        start = mesh.coord(ax) * blk
        if i == dim and start <= lo and hi <= start + blk:
            w = w.narrow(i, lo - start, hi - lo)
            dim = None
        else:
            w = C.gather(w, mesh, ax, i)
    if dim is not None and not (lo == 0 and hi in (None, w.shape[dim])):
        # The model ranks hold w alike and each reads its own slice.
        w = C.enter(w, mesh, ctx.model_axis).narrow(dim, lo, hi - lo)
    return w


def _with_params(module: nn.Module, tensors: dict, prefix: str = "") -> nn.Module:
    new = copy.copy(module)
    new._parameters = {k: (None if v is None else tensors[prefix + k]) for k, v in module._parameters.items()}
    new._modules = {k: (None if m is None else _with_params(m, tensors, f"{prefix}{k}."))
                    for k, m in module._modules.items()}
    return new


def gathered(module: nn.Module, ctx) -> nn.Module:
    """``module`` with every parameter whole (:func:`weight`): a shallow
    copy holding the gathered tensors, or ``module`` itself when no
    parameter is split."""
    if ctx is None or ctx.mesh is None:
        return module
    params = dict(module.named_parameters())
    if all(_spec(p) is None or all(a is None for a in _spec(p)) for p in params.values()):
        return module
    return _with_params(module, {name: weight(p, ctx) for name, p in params.items()})


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
