"""Device seconds a solve spends in the k-median++ seeding: the kernels
launched under the program's ``kmeans.seed`` spans (the local solves' and
the coordinator's), over the solves."""

from harness.spans import reading

SPAN = "kmeans.seed"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.device_s / run.units
