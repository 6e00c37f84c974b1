"""Host ranges of a traced run, logged from the benchmark's own files on the
host clock (``time.time_ns``).

* :class:`OpRecorder` is an observer for ``repro_torch.kernels.dispatch.observed``:
  every kernel op the program resolves runs inside a range
  ``perfbench.op.<op>#<call>``, and the call's argument shapes are kept, so
  a kernel's device time can be matched with the work its shapes ask for.
* :func:`wrapped` opens a range ``perfbench.layer.<label>`` around each
  call of the named functions of the program (a driver lists them), so the
  trace says what the host was in while the device sat idle.

Both exist only while a traced window is open; the untimed runs carry
neither.  :mod:`harness.devtrace` lays the ranges over the device's trace.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time

import torch

from .devtrace import OP_PREFIX

LAYER_PREFIX = "perfbench.layer."


class HostLog:
    """``(name, start ns, end ns)`` of every range closed while it is kept."""

    def __init__(self):
        self.ranges: list[tuple[str, int, int]] = []

    def timed(self, name: str, fn, *args, **kwargs):
        t0 = time.time_ns()
        try:
            return fn(*args, **kwargs)
        finally:
            self.ranges.append((name, t0, time.time_ns()))


def _shape(a):
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), str(a.dtype))
    if isinstance(a, (int, float, bool, str)) or a is None:
        return a
    return type(a).__name__


class OpRecorder:
    """``observer(op, fn, *args, **kw)``: calls ``fn`` inside a logged range
    and records ``(op, shapes of args, shapes of kwargs)``."""

    def __init__(self, log: HostLog):
        self.log = log
        self.calls: list[tuple[str, tuple, dict]] = []

    def __call__(self, op, fn, *args, **kwargs):
        i = len(self.calls)
        self.calls.append((op, tuple(_shape(a) for a in args), {k: _shape(v) for k, v in kwargs.items()}))
        return self.log.timed(f"{OP_PREFIX}{op}#{i}", fn, *args, **kwargs)


def _ranged(fn, label: str, log: HostLog):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        return log.timed(LAYER_PREFIX + label, fn, *args, **kwargs)

    return call


@contextlib.contextmanager
def wrapped(targets, log: HostLog):
    """``targets``: ``(owner, attribute, label)`` triples, an owner being a
    module or a class.  Each attribute is replaced by a ranged twin while
    the block is open (a static method stays one)."""
    saved = []
    try:
        for owner, attr, label in targets:
            raw = inspect.getattr_static(owner, attr)
            saved.append((owner, attr, raw))
            if isinstance(raw, staticmethod):
                setattr(owner, attr, staticmethod(_ranged(raw.__func__, label, log)))
            else:
                setattr(owner, attr, _ranged(raw, label, log))
        yield
    finally:
        for owner, attr, raw in reversed(saved):
            setattr(owner, attr, raw)
