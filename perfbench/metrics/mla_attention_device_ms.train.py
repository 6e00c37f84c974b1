"""Device milliseconds a step spends in the groups' latent attention forwards
(projections, latent norm, rope, the plain attention and the output
projection): the kernels launched under the program's ``mla.attention``
spans, over the steps."""

from harness.spans import reading

SPAN = "mla.attention"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s * 1e3 / run.units
