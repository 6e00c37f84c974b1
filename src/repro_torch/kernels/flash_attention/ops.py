"""Public attention entry points: ``flash_attention`` and ``decode_attention``.

``flash_attention`` dispatches (see :mod:`repro_torch.kernels.dispatch`):
``cuda``, the hand-written kernel, for CUDA tensors; ``torch_ref``, the
plain version, for CPU tensors and for explicit comparison.  Sliding-window
attention (the reference routes it to ``chunked_attention``; only the
RecurrentGemma blocks use it) is not ported yet and raises.

``decode_attention`` is plain PyTorch on every device, as it is plain jnp in
the reference (its ring-cache window comes with the local-attention blocks).
"""

from __future__ import annotations

import torch

from .. import dispatch
from . import kernel as _kernel
from . import ref as _ref

__all__ = ["flash_attention", "decode_attention"]

dispatch.register_impl("flash_attention", "cuda", _kernel.flash_attention_cuda)
dispatch.register_impl("flash_attention", "torch_ref", _ref.attention_ref)


def flash_attention(q, k, v, *, causal=True, window=None, scale=None, impl="auto"):
    """Attention of q (B, T, H, dh) over k, v (B, S, KV, dh), H % KV == 0.

    Causal rows follow the decode alignment: query t attends to keys
    ≤ t + S − T.  Returns (B, T, H, dh) in q's dtype.
    """
    if window is not None:
        raise NotImplementedError(
            "flash_attention: sliding-window attention is not ported yet "
            "(ROADMAP queue 1, item 13.3: RG-LRU and local attention)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: expected q (B,T,H,dh), k/v (B,S,KV,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    dh = q.shape[-1]
    scale = (dh ** -0.5) if scale is None else float(scale)
    _, fn = dispatch.resolve("flash_attention", impl, q, k, v)
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
