"""Device seconds a solve spends in kernels launched outside every
dispatched kernel op: the eager elementwise work around the kernels."""


def read(run):
    if not run.trace.kernels():
        return None
    return run.trace.outside_ops_s() / run.units
