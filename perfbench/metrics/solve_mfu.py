"""Percent of the chip's TF32 peak that the window's solves reached on the
distance evaluations a solve needs (``mfu/<config>.py``): those operations
times the solves, over the window's seconds."""


def read(run):
    flops = run.files.mfu(run.config["name"]).flops(run.config, run.traffic)
    return 100.0 * flops * run.units / (run.window_s * run.peaks["flops_per_s"]["tf32"])
