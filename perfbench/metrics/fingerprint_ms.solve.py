"""Milliseconds a solve spends hashing the points for the session's pack
cache: the program's ``session.fingerprint`` spans, their host durations
summed, over the solves."""

from harness.spans import reading

SPAN = "session.fingerprint"


def read(run):
    r = reading(run, SPAN)
    return None if r is None else r.host_s * 1e3 / run.units
