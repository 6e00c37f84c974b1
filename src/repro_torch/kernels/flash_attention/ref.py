"""Plain PyTorch oracle for the flash-attention kernel (GQA, causal or full).

Computed exactly as the reference package's ``flash_attention/ref.py``:
f32 scores of the upcast inputs, the causal offset S − T (query t attends
to keys ≤ t + S − T, the decode alignment), softmax in f32, the product
with v in f32, the output in q's dtype.  TF32 is off for the two products.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """q: (B, T, H, dh); k, v: (B, S, KV, dh) with H % KV == 0.
    Returns (B, T, H, dh) in q.dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = (dh ** -0.5) if scale is None else scale
    kr = torch.repeat_interleave(k, g, dim=2)  # (B, S, H, dh): head h reads kv head h // g
    vr = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kr.float())
    s = s * scale
    if causal:
        qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
        kpos = torch.arange(S, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bhts,bshd->bthd", p, vr.float())
    return out.to(q.dtype)
