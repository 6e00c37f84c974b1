"""Percent of its roofline that ``min_dist_update``, the seeding's
one-center step, reached over the window's solves
(``kernels/min_dist_update.py``; attributed by op range)."""

from harness.devtrace import roofline


def read(run):
    return roofline(run, "min_dist_update")
