"""The least time a ``flash_attention`` forward could take, from its shapes.

q (B, T, H, dh) attends causally over k, v (B, S, KV, dh), query t to the
keys up to t + S − T (the decode alignment), so the call needs
``4·B·H·pairs·dh`` operations (q·kᵀ and p·v), ``pairs`` being the
attended (query, key) pairs: T·(S − T) + T·(T + 1)/2, about half of the
full T·S.  It moves q, k and v read once and o written once, in their
dtype; bf16 and fp16 count against the tensor cores' bf16 rate, f32
against TF32.  The call's arguments as the dispatch observer sees them:
``(q, k, v)`` and the keyword ``causal``.
"""

_BYTES = {"torch.bfloat16": 2, "torch.float16": 2, "torch.float32": 4}


def cost(args, kwargs, peaks) -> dict:
    (_, (B, T, H, dh), dt), (_, (_, S, KV, _), _) = args[0], args[1]
    if kwargs.get("causal", True):
        pairs = T * (S - T) + T * (T + 1) / 2.0
    else:
        pairs = float(T * S)
    flops = 4.0 * B * H * pairs * dh
    size = _BYTES[dt]
    nbytes = size * (2.0 * B * T * H * dh + 2.0 * B * S * KV * dh)
    rate = peaks["flops_per_s"]["bf16" if size == 2 else "tf32"]
    return {
        "flops": flops,
        "bytes": nbytes,
        "seconds": max(flops / rate, nbytes / peaks["hbm_bytes_per_s"]),
    }
