"""The least time an ``assign_min`` call could take, from its shapes.

The op gives each of the ``B·n`` rows of ``x`` (B, n, d) its nearest of
the first ``k_valid`` rows of ``c`` (B, k, d): an index and a squared
distance.  It needs the ``2·B·n·k_valid·d`` operations of the products
x·cᵀ, counted against the highest rate at which the chip multiplies f32
inputs (TF32 on the tensor cores), so no implementation can read above
its bound; and it moves x and c read once and idx and dist written once.
The call's arguments as the dispatch observer sees them: ``(x, c,
k_valid)``, x and c batched.
"""


def cost(args, kwargs, peaks) -> dict:
    (_, (B, n, d), xdt), (_, (_, k, _), cdt), k_valid = args[:3]
    kv = k if k_valid is None else int(k_valid)
    flops = 2.0 * B * n * kv * d
    nbytes = 4.0 * (B * n * d + B * k * d) + 4.0 * B * n + 4.0 * B * n
    return {
        "flops": flops,
        "bytes": nbytes,
        "seconds": max(flops / peaks["flops_per_s"]["tf32"], nbytes / peaks["hbm_bytes_per_s"]),
    }
