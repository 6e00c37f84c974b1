"""Shape buckets and warm-up plans.

The part of the reference package's ``kernels/autotune.py`` that the port's
streaming service runs.  On a CUDA tensor every op resolves to its
hand-written kernel and on a CPU tensor to its plain version
(:mod:`repro_torch.kernels.dispatch`), so there is nothing to measure: the
reference's measured selection, its persistent winner file and their env
switches are not ported.

* **Shape buckets.**  Shapes quantize to power-of-two buckets
  (:func:`shape_bucket`), the reference's rule.
* **Warm-start.**  :func:`warmup` runs a tier's plan of callables off the
  hot path (the query engine and the serving frontend on every model
  generation): the first call of a kernel loads, and if need be builds,
  its library there instead of in the first query.  It counts failures and
  never raises them, so a caller that needs the kernels checks
  :attr:`WarmupReport.errors`.  ``REPRO_WARM_START=0`` opts the tiers out.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Tuple

import torch

__all__ = ["WarmupReport", "shape_bucket", "warm_start_enabled", "warmup"]

WARM_START_ENV = "REPRO_WARM_START"  # opt-OUT: tier warm-up plans

_OFF_VALUES = ("0", "off", "false", "no", "none", "model", "analytic")


def warm_start_enabled() -> bool:
    """Whether the tiers run their warm-up plans on every model generation
    (on by default; ``REPRO_WARM_START=0`` opts out)."""
    return os.environ.get(WARM_START_ENV, "1").strip().lower() not in _OFF_VALUES


def shape_bucket(v: int) -> int:
    """Next power of two: ragged shapes share one bucket per octave."""
    return 1 << max(int(v) - 1, 1).bit_length()


def _sync(out) -> None:
    """Wait for the device work that produced ``out`` (a tensor or a nested
    tuple / list of them), so an asynchronous failure surfaces here."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, (tuple, list)):
        for o in out:
            _sync(o)


@dataclasses.dataclass
class WarmupReport:
    """What one warm-up pass did, and how long it took off the hot path."""

    warmed: int = 0                 # plan entries completed
    errors: int = 0                 # entries that raised (never fatal)
    seconds: float = 0.0            # wall clock of the whole pass
    labels: Tuple[str, ...] = ()    # completed entry labels, in order

    def merge(self, other: "WarmupReport") -> "WarmupReport":
        return WarmupReport(
            warmed=self.warmed + other.warmed,
            errors=self.errors + other.errors,
            seconds=self.seconds + other.seconds,
            labels=self.labels + other.labels,
        )


def warmup(plan: Iterable) -> WarmupReport:
    """Run a warm-up ``plan`` off the hot path.

    ``plan`` is an iterable of zero-arg callables, or ``(label, callable)``
    pairs, each exercising one bucket the caller expects to serve: running
    it loads (and if need be builds) any kernel library not yet loaded and
    waits for the device.  Exceptions are counted, not raised: a failed
    warm-up must not take down the tier it warms.
    """
    from ..obs import trace_span

    report = WarmupReport()
    t0 = time.perf_counter()
    labels = []
    with trace_span("autotune.warmup") as sp:
        for entry in plan:
            label, fn = entry if isinstance(entry, tuple) else (None, entry)
            if label is None:
                label = getattr(fn, "__name__", "warmup")
            try:
                _sync(fn())
                report.warmed += 1
                labels.append(str(label))
            except Exception:
                report.errors += 1
        sp.set_attr(warmed=report.warmed, errors=report.errors)
    report.seconds = time.perf_counter() - t0
    report.labels = tuple(labels)
    return report
