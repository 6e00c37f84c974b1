"""Gradient compression with error feedback (the twin of the reference's
``train/compression.py``).

Int8 block quantization: each leaf is quantized in blocks of ``block``
along its last dim with an f32 scale per block; the *dequantized* value is
what enters the optimizer.  The quantization residual is carried in an
error-feedback buffer and re-injected next step (Karimireddy et al., 2019).
``torch.round``, like ``jnp.round``, rounds half to even, so the codes
equal the reference's.
"""

from __future__ import annotations

import dataclasses

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
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for n, p in params.items()}


def _blocked(x, block: int):
    n = x.shape[-1]
    pad = (-n) % block
    xp = F.pad(x, (0, pad))
    return xp.reshape(x.shape[:-1] + (-1, block)), n, pad


def quantize_int8(x, block: int = 256):
    """Returns (q int8, scales f32 (…, n_blocks, 1), n) with per-block
    scales max|x|/127, at least 1e-12."""
    xb, n, _ = _blocked(x.float(), block)
    scale = torch.clamp_min(torch.amax(torch.abs(xb), dim=-1, keepdim=True) / 127.0, 1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale, n


def dequantize_int8(q, scale, n: int):
    x = q.float() * scale
    return x.reshape(x.shape[:-2] + (-1,))[..., :n]


@torch.no_grad()
def compress_with_error_feedback(cfg: CompressionConfig, grads: dict, ef: dict):
    """g ← Q(g + e);  e ← (g + e) − Q(g + e), leaf by leaf.  Returns (the
    dequantized grads in each grad's dtype, the new error buffers)."""
    out_g, out_e = {}, {}
    for name, g in grads.items():
        g32 = g.float() + ef[name]
        if g32.dim() == 0:
            out_g[name], out_e[name] = g32.to(g.dtype), torch.zeros_like(g32)
            continue
        q, s, n = quantize_int8(g32, cfg.block)
        deq = dequantize_int8(q, s, n).reshape(g32.shape)
        out_g[name], out_e[name] = deq.to(g.dtype), g32 - deq
    return out_g, out_e
