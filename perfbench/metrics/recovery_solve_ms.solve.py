"""Milliseconds a solve spends in the session's host recovery solve: the
program's ``session.recovery_solve`` spans that closed in the window,
summed, over the solves; a pattern-cache hit adds nothing."""


def read(run):
    spans = [s["dur_us"] for s in run.spans if s["name"] == "session.recovery_solve"]
    if not spans:
        return None
    return sum(spans) / 1e3 / run.units
