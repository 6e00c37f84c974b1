"""Device milliseconds a step spends in the MoE layers' routing (the router in
f32, the softmax, each token's top-6 and the balance loss): the kernels
launched under the program's ``moe.route`` spans, over the steps."""

from harness.spans import reading

SPAN = "moe.route"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s * 1e3 / run.units
