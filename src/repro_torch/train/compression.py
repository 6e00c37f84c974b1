"""Gradient compression with error feedback (the twin of the reference's
``train/compression.py``).

Int8 block quantization: each leaf is quantized in blocks of ``block``
along its last dim with an f32 scale per block; the *dequantized* value is
what enters the optimizer.  The quantization residual is carried in an
error-feedback buffer and re-injected next step (Karimireddy et al., 2019).
``torch.round``, like ``jnp.round``, rounds half to even, so the codes
equal the reference's.

Under an LM mesh a rank holds its block of each gradient (its spec's
``mesh_spec``), and the reference quantizes the global tensor.  A rank
lays its columns on the global block grid, by their offset along the last
dim: where the split cuts the last dim at a multiple of ``block`` the
rank's blocks are whole; elsewhere a block straddles two ranks' columns,
and its scale is the max of the ranks' partial maxima over the axis that
splits the last dim (``collectives.pmax``, exact in any order).  Each
element is then quantized with its block's global scale, so the codes,
the dequantized gradient and the buffer are the global ones' blocks, bit
for bit; the buffers lie on the parameters' blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "CompressionConfig",
    "init_ef_state",
    "quantize_int8",
    "dequantize_int8",
    "compress_with_error_feedback",
]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = True
    block: int = 256  # quantization block along the trailing dim


def init_ef_state(params: dict) -> dict:
    """Zero buffers shaped as the parameters (under a mesh, their blocks)."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}


def _blocked(x, block: int, offset: int = 0):
    """x (…, n) laid on the block grid of a tensor whose columns start at
    ``offset``: zero-padded by ``offset % block`` on the left and to a
    whole block on the right, (…, n_blocks, block); returns it and the
    left pad."""
    n = x.shape[-1]
    left = offset % block
    xp = F.pad(x, (left, (-(left + n)) % block))
    return xp.reshape(x.shape[:-1] + (-1, block)), left


def _scale(amax):
    return torch.clamp_min(amax / 127.0, 1e-12)


def _codes(xb, scale):
    return torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)


def quantize_int8(x, block: int = 256):
    """Returns (q int8, scales f32 (…, n_blocks, 1), n) with per-block
    scales max|x|/127, at least 1e-12."""
    xb, _ = _blocked(x.float(), block)
    scale = _scale(torch.amax(torch.abs(xb), dim=-1, keepdim=True))
    return _codes(xb, scale), scale, x.shape[-1]


def dequantize_int8(q, scale, n: int, left: int = 0):
    x = q.float() * scale
    return x.reshape(x.shape[:-2] + (-1,))[..., left:left + n]


def _last_split(spec, mesh) -> Optional[str]:
    """The mesh axis that splits the last dim under ``spec`` (None when
    the rank holds whole rows)."""
    if mesh is None or not spec:
        return None
    ax = spec[-1]
    if ax is None or mesh.shape.get(ax, 1) == 1:
        return None
    if not isinstance(ax, str):
        raise ValueError(f"compression: a last dim split over several axes {ax}")
    return ax


def _quantize_split(x, block: int, mesh, axis: str):
    """(q, scales, left pad) of a rank's columns x (…, w) of a tensor whose
    last dim the ``axis`` ranks split evenly: the scales are the global
    blocks' (module docstring)."""
    from ..launch import collectives as C

    w = x.shape[-1]
    r = mesh.coord(axis)
    xb, left = _blocked(x, block, r * w)
    amax = torch.amax(torch.abs(xb), dim=-1)  # (…, local blocks): partial where a block straddles
    if w % block:  # some block straddles two ranks: the max of the partial maxima over the axis
        n_global = -(-w * mesh.shape[axis] // block)
        b0 = r * w // block
        every = amax.new_zeros(amax.shape[:-1] + (n_global,))
        every[..., b0:b0 + amax.shape[-1]] = amax
        amax = C.pmax(every, mesh, axis)[..., b0:b0 + amax.shape[-1]]
    scale = _scale(amax[..., None])
    return _codes(xb, scale), scale, left


@torch.no_grad()
def compress_with_error_feedback(cfg: CompressionConfig, grads: dict, ef: dict, *, mesh=None,
                                 specs: Optional[dict] = None):
    """g ← Q(g + e);  e ← (g + e) − Q(g + e), leaf by leaf.  Returns (the
    dequantized grads in each grad's dtype, the new error buffers).  Under
    ``mesh`` each gradient is the rank's block under ``specs[name]`` and
    is quantized in the global tensor's blocks (module docstring): every
    rank issues the same ``pmax`` calls, in the order of ``grads``."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        g32 = g.float() + ef[name]
        if g32.dim() == 0:
            out_g[name], out_e[name] = g32.to(g.dtype), torch.zeros_like(g32)
            continue
        axis = _last_split((specs or {}).get(name), mesh)
        if axis is None:
            q, s, n = quantize_int8(g32, cfg.block)
            deq = dequantize_int8(q, s, n)
        else:
            q, s, left = _quantize_split(g32, cfg.block, mesh, axis)
            deq = dequantize_int8(q, s, g32.shape[-1], left)
        deq = deq.reshape(g32.shape)
        out_g[name], out_e[name] = deq.to(g.dtype), g32 - deq
    return out_g, out_e
