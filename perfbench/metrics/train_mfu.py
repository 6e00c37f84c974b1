"""Percent of the chip's bf16 peak that the window's steps reached on the
model's operations: the operations a distinct sequence needs
(``mfu/<config>.py``) times the distinct sequences the window's steps
trained on, over the window's seconds."""


def read(run):
    per_seq = run.files.mfu(run.config["name"]).flops_per_sequence(run.config)
    seqs = sum(run.runner.counted[-run.units:]) / run.config["seq_len"]
    return 100.0 * per_seq * seqs / (run.window_s * run.peaks["flops_per_s"]["bf16"])
