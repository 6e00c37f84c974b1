"""Device milliseconds a step spends in the groups' backwards: the kernels
launched under the program's ``train.backward`` spans, over the steps."""

from harness.spans import reading

SPAN = "train.backward"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s * 1e3 / run.units
