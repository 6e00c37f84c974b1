"""Device milliseconds a step spends in the MoE layers' expert work in the
forward (the held experts' capacity selection, dispatch and SwiGLU, and the
shared experts): the kernels launched under the program's ``moe.experts``
spans, over the steps."""

from harness.spans import reading

SPAN = "moe.experts"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s * 1e3 / run.units
