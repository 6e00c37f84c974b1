"""Kernels a step launches in the groups' forwards: those launched under the
program's ``train.forward`` spans, over the steps."""

from harness.spans import reading

SPAN = "train.forward"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.kernels / run.units
