"""Public attention entry points: ``flash_attention`` and ``decode_attention``.

``flash_attention`` dispatches (see :mod:`repro_torch.kernels.dispatch`):
``cuda``, the hand-written kernel, for CUDA tensors, with or without
gradients (:class:`FlashAttentionFn`: the kernel's forward, the plain
``attention_bwd_ref`` as its backward); ``torch_ref``, the plain version,
for CPU tensors and for explicit comparison;
``torch_chunked``, :func:`chunked_attention`, for every sliding-window call
on every device, as the reference's selector routes windowed calls to its
``chunked_attention`` on the TPU too (the kernel has no window and no
head_dim 256, RecurrentGemma's).  A call whose v heads are narrower or
wider than its q/k heads (latent attention's 192 and 128,
``models.mla``) takes the plain route on every device, ``torch_ref``
inside :class:`FlashAttentionFn`, so that its backward recomputes P from
the saved q, k, v and o; the kernel takes one head width.

``decode_attention`` is plain PyTorch on every device, as it is plain jnp in
the reference; a sliding window's ring cache is the caller's (the slot and
the count of valid positions, ``models.attention.attn_decode_step``).
"""

from __future__ import annotations

import math

import torch

from .. import dispatch
from . import kernel as _kernel
from . import ref as _ref

__all__ = ["FlashAttentionFn", "chunked_attention", "flash_attention", "decode_attention"]


def _pick_chunks(T: int, S: int) -> tuple[int, int]:
    """The reference's chunk sizes: query chunks of max(512, T/32) (at most
    ~32 of them), key blocks of at most 1024, each shrunk to a divisor."""
    cq = min(max(512, T // 32), T)
    while T % cq != 0:
        cq //= 2
    ck = min(1024, S)
    while S % ck != 0:
        ck //= 2
    return max(cq, 1), max(ck, 1)


def chunked_attention(q, k, v, *, causal=True, window=None, scale=None):
    """Attention in plain PyTorch, the twin of the reference's
    ``chunked_attention``: a loop over query chunks, each with an online
    softmax over only the key blocks in its causal (and windowed) range
    ``[lo, hi)``, in f32.  q: (B, T, H, dh); k, v: (B, S, KV, dh).  Query t
    sits at absolute position t + S − T (the decode alignment) and, with a
    window W, attends to keys in (t + S − T − W, t + S − T].  Returns
    (B, T, H, dh) in q's dtype.  Its products follow torch's TF32 setting
    (off by default)."""
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = (dh ** -0.5) if scale is None else scale
    cq, ck = _pick_chunks(T, S)
    off = S - T
    qg = q.reshape(B, T, KV, g, dh).float() * scale
    kf, vf = k.float(), v.float()
    ar_q = torch.arange(cq, device=q.device)
    ar_k = torch.arange(ck, device=q.device)
    outs = []
    for i in range(T // cq):
        q_blk = qg[:, i * cq : (i + 1) * cq]  # (B, cq, KV, g, dh)
        row = off + i * cq + ar_q  # absolute positions of this chunk
        hi = off + (i + 1) * cq if causal else S  # keys strictly before hi
        lo = 0 if window is None else max(0, off + i * cq - int(window) + 1)
        j0, j1 = lo // ck, math.ceil(min(hi, S) / ck)
        m = torch.full((B, KV, g, cq), float("-inf"), device=q.device)
        l = torch.zeros((B, KV, g, cq), device=q.device)
        acc = torch.zeros((B, KV, g, cq, dh), device=q.device)
        for j in range(j0, j0 + max(1, j1 - j0)):
            k_blk, v_blk = kf[:, j * ck : (j + 1) * ck], vf[:, j * ck : (j + 1) * ck]
            col = j * ck + ar_k
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk)  # (B, KV, g, cq, ck)
            mask = torch.ones((cq, ck), dtype=torch.bool, device=q.device)
            if causal:
                mask &= row[:, None] >= col[None, :]
            if window is not None:
                mask &= col[None, :] > row[:, None] - int(window)
            s = s.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
            p = torch.where(torch.isfinite(s), torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, v_blk)
            m = m_new
        o = acc / torch.where(l > 0.0, l, 1.0)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, cq, H, dh))
    return torch.cat(outs, dim=1).to(q.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable attention: the forward runs ``forward`` (the CUDA
    kernel on the card; the plain :func:`~.ref.attention_ref` where a test
    holds the Function itself on the CPU) with grad mode off, and saves q,
    k, v and the output; the backward is :func:`~.ref.attention_bwd_ref`,
    a plain recompute of P (the reference has no backward kernel to port).
    The backward needs T == S."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, forward):
        o = forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = _ref.attention_bwd_ref(q, k, v, o, do, ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def _flash_cuda(q, k, v, *, causal: bool, scale: float):
    """The kernel behind the autograd Function: the forward always
    launches it, whether or not an input requires grad."""
    return FlashAttentionFn.apply(q, k, v, causal, scale, _kernel.flash_attention_cuda)


dispatch.register_impl("flash_attention", "cuda", _flash_cuda)
dispatch.register_impl("flash_attention", "torch_ref", _ref.attention_ref)
dispatch.register_impl("flash_attention", "torch_chunked", chunked_attention)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None, impl="auto"):
    """Attention of q (B, T, H, dh) over k (B, S, KV, dh) and v (B, S, KV,
    dv), H % KV == 0.

    Causal rows follow the decode alignment: query t attends to keys
    ≤ t + S − T, and with a ``window`` W to keys > t + S − T − W.  A
    windowed call runs :func:`chunked_attention` under ``auto`` on every
    device; ``impl="cuda"`` or ``"torch_ref"`` with a window raises (neither
    has one).  A call with dv != dh runs :func:`~.ref.attention_ref` inside
    :class:`FlashAttentionFn` under ``auto`` or ``torch_ref`` on every
    device (no window); ``impl="cuda"`` raises for it.  Returns (B, T, H,
    dv) in q's dtype.
    """
    if window is not None:
        if impl not in ("auto", "torch_chunked"):
            raise ValueError(f"flash_attention: impl={impl!r} has no sliding window; windowed calls "
                             "run 'torch_chunked' (the default under 'auto')")
        impl = "torch_chunked"
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: expected q (B,T,H,dh), k (B,S,KV,dh), v (B,S,KV,dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else float(scale)
    if v.shape[3] != dh:
        if impl not in ("auto", "torch_ref"):
            raise ValueError(f"flash_attention: impl={impl!r} takes one head width; q/k heads of {dh} and v "
                             f"heads of {v.shape[3]} run 'torch_ref' (the default under 'auto')")
        _, fn = dispatch.resolve("flash_attention", "torch_ref", q, k, v)
        return FlashAttentionFn.apply(q, k, v, causal, scale, fn)
    name, fn = dispatch.resolve("flash_attention", impl, q, k, v)
    if name == "torch_chunked":
        return fn(q, k, v, causal=causal, window=window, scale=scale)
    return fn(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k_cache, v_cache, cur_len, *, scale=None):
    """Single-token decode attention against a KV cache.

    q: (B, 1, H, dh); caches: (B, S, KV, dh); ``cur_len``: an int, or a
    (B,) or scalar tensor — the number of valid cache positions.  Positions
    ≥ cur_len are masked.  As in the reference, q·scale is rounded to the
    cache's dtype and both products sum in f32 (its
    ``preferred_element_type``): the operands are upcast, so bf16 products
    stay exact.
    """
    B, _, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    g = H // KV
    scale = (dh ** -0.5) if scale is None else scale
    # The scalar takes q's dtype first, as a weakly typed jnp scalar does.
    qg = (q.reshape(B, KV, g, dh) * torch.tensor(scale, dtype=q.dtype)).to(k_cache.dtype)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float())
    pos = torch.arange(S, device=q.device)[None, :]  # (1, S)
    if isinstance(cur_len, torch.Tensor):
        cur = cur_len.to(q.device).reshape(-1, 1)  # (B, 1) or (1, 1)
    else:
        cur = int(cur_len)  # a Python int needs no copy to the device (and no sync)
    valid = pos < cur
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, 1, H, dh).to(q.dtype)
