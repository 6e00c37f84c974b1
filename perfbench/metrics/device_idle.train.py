"""Percent of the traced window in which no operation ran on the device:
one minus the union of the device's kernel, copy and fill intervals."""


def read(run):
    if not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
