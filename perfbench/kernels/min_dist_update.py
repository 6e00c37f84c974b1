"""The least time a ``min_dist_update`` call could take, from its shapes.

The op is one step of the ++ seeding: for each of the ``B·n`` rows of ``x``
(B, n, d) it computes the squared distance to its batch's new center ``c``
(B, d), lowers the running minimum ``d2`` (B, n) to it in place and writes
the logit of the next draw, reading the weights ``w`` (B, n).  It moves x
and c read once, d2 read and written, w read and the logits written:
``4·(B·n·d + B·d + 4·B·n)`` bytes.  Its ``3·B·n·d`` fp32 operations (a
difference and an FMA an element) lie far below the bandwidth's line.
The call's arguments as the dispatch observer sees them: ``(x, c, d2, w,
median)``.
"""


def cost(args, kwargs, peaks) -> dict:
    (_, (B, n, d), _) = args[0]
    flops = 3.0 * B * n * d
    nbytes = 4.0 * (B * n * d + B * d + 4 * B * n)
    return {
        "flops": flops,
        "bytes": nbytes,
        "seconds": max(flops / peaks["flops_per_s"]["fp32"], nbytes / peaks["hbm_bytes_per_s"]),
    }
