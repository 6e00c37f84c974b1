"""Device seconds a solve spends in Lloyd's iterations and the final
assignment: the kernels launched under the program's ``kmeans.iterate``
spans (the local solves' and the coordinator's), over the solves."""

from harness.spans import reading

SPAN = "kmeans.iterate"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s / run.units
