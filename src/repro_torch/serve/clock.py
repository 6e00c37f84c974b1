"""Clock seam for the serving tier.

A copy of the reference package's ``serve/clock.py`` (standard library
only), kept in the port so that it imports nothing of the reference.

The micro-batching frontend is a *sans-io* state machine: every
time-dependent decision (batch-window close, deadline computation) takes an
explicit ``now`` sourced from a :class:`Clock`.  Production uses
:class:`SystemClock` (monotonic wall time); the deterministic concurrency
suite uses :class:`VirtualClock`, which only moves when a test calls
``advance`` — so every "concurrency" scenario is a replayable sequence of
``submit``/``advance``/``flush`` calls with zero wall-clock sleeps.
"""

from __future__ import annotations

import time

__all__ = ["SystemClock", "VirtualClock"]


class SystemClock:
    """Monotonic wall clock (production default)."""

    def now(self) -> float:
        return time.monotonic()


class VirtualClock:
    """Manually-advanced clock for deterministic tests.

    Time never moves on its own: ``now()`` returns whatever the last
    ``advance``/``set`` left it at, making batch-window behaviour a pure
    function of the call sequence.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance a clock backwards (dt={dt})")
        self._t += float(dt)
        return self._t

    def set(self, t: float) -> float:
        if t < self._t:
            raise ValueError(f"cannot set clock backwards ({t} < {self._t})")
        self._t = float(t)
        return self._t
