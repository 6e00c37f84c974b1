"""Percent of its roofline that ``assign_min`` reached over the window's
solves (``kernels/assign_min.py``; attributed by op range)."""

from harness.devtrace import roofline


def read(run):
    return roofline(run, "assign_min")
