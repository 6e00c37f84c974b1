"""Device milliseconds a step spends in AdamW (the clip included): the
kernels launched under the program's ``optimizer.adamw`` spans, over the
steps."""

from harness.spans import reading

SPAN = "optimizer.adamw"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s * 1e3 / run.units
