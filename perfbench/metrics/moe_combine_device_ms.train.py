"""Device milliseconds a step spends in the MoE layers' combine in the forward
(each token's held experts' outputs times their weights, added in expert
order, and the shared experts' output): the kernels launched under the
program's ``moe.combine`` spans, over the steps."""

from harness.spans import reading

SPAN = "moe.combine"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s * 1e3 / run.units
