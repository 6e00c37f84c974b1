"""The numbers that decide ``correct``, each beside its limit."""

from __future__ import annotations

import math

# What a number that is not finite (a NaN, an overflow) is reported as: a
# limit never holds it, and the result line stays valid JSON.
NOT_FINITE = 1e300


def worst_of(readings: list[dict], limits: dict) -> tuple[list[dict], int]:
    """``readings``: one ``{name: value}`` a unit of work checked.  Returns
    (each name's worst value beside its limit, how many units read over a
    limit); a value that is not finite is the worst there is."""
    worst: dict[str, float] = {}
    failed = 0
    for got in readings:
        failed += any(not (v <= limits[k]) for k, v in got.items())
        for k, v in got.items():
            v = float(v) if math.isfinite(v) else NOT_FINITE
            worst[k] = max(worst.get(k, v), v)
    return [{"name": k, "value": v, "limit": limits[k]} for k, v in worst.items()], failed
