"""Plain PyTorch oracle for the flash-attention kernel (GQA, causal or full),
and the explicit backward that the kernel's autograd Function runs.

:func:`attention_ref` is computed exactly as the reference package's
``flash_attention/ref.py``: f32 scores of the upcast inputs, the causal
offset S − T (query t attends to keys ≤ t + S − T, the decode alignment),
softmax in f32, the product with v in f32, the output in q's dtype.  TF32
is off for the two products.

:func:`attention_bwd_ref` is the gradient of that function, written out:
the reference has no backward kernel (``jax.grad`` differentiates its
plain attention), so the port's backward is plain PyTorch too.
"""

from __future__ import annotations

import torch

__all__ = ["attention_bwd_ref", "attention_ref"]


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


def attention_bwd_ref(q, k, v, o, do, scale, *, causal: bool = True):
    """Gradients (dq, dk, dv) of ``o = attention(q, k, v)`` given the
    output's gradient ``do``, recomputed from q and k in f32: P =
    softmax(scale·q·kᵀ) under the causal mask, then dV = Pᵀ·dO, dP =
    dO·Vᵀ, dS = P∘(dP − rowsum(dO∘O)), dQ = scale·dS·K and dK =
    scale·dSᵀ·Q, with dK and dV summed over each GQA group.  q, o, do:
    (B, T, H, dh); k, v: (B, S, KV, dh) with T == S (training and prefill;
    raises otherwise).  Each gradient is returned in its input's dtype.
    TF32 is off for the products, as in :func:`attention_ref`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    if T != S:
        raise ValueError(f"attention_bwd_ref: needs T == S, got T={T}, S={S}")
    g = H // KV
    kr = torch.repeat_interleave(k, g, dim=2).float()  # (B, S, H, dh)
    vr = torch.repeat_interleave(v, g, dim=2).float()
    qf, of, dof = q.float(), o.float(), do.float()
    s = torch.einsum("bthd,bshd->bhts", qf, kr) * scale
    if causal:
        s = s.masked_fill(torch.ones((T, S), dtype=torch.bool, device=q.device).triu(1), float("-inf"))
    p = torch.softmax(s, dim=-1)  # (B, H, T, S)
    del s
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dp = torch.einsum("bthd,bshd->bhts", dof, vr)
    delta = torch.sum(dof * of, dim=-1).transpose(1, 2)  # (B, H, T): rowsum(dO∘O)
    ds = p * (dp - delta[..., None])
    del p, dp
    dq = torch.einsum("bhts,bshd->bthd", ds, kr) * scale
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale
    dk = dk.reshape(B, S, KV, g, dh).sum(3)
    dv = dv.reshape(B, S, KV, g, dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
