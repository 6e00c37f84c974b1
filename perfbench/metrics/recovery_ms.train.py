"""Milliseconds a step's in-step recovery solve holds the device: for each
of the program's ``recovery.device_solve`` spans, from its first launched
kernel's start to its last one's end, summed, over the steps.  The solve's
kernels are small and launched one by one, so the gaps between them are
part of its cost."""

from harness.spans import reading

SPAN = "recovery.device_solve"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else sum(r.extents_s) * 1e3 / run.units
