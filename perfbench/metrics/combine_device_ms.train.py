"""Device milliseconds a step spends in the Lemma-3 combine: each group's
b_g·∇ added into the float64 buffers and the sums scaled and cast, the
kernels launched under the program's ``train.combine`` spans, over the
steps."""

from harness.spans import reading

SPAN = "train.combine"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s * 1e3 / run.units
