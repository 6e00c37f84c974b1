"""Percent of its roofline that the ``flash_attention`` forward reached over
the window's steps (``kernels/flash_attention.py``; attributed by op
range: the backward runs outside the op's range and is not counted)."""

from harness.devtrace import roofline


def read(run):
    return roofline(run, "flash_attention")
