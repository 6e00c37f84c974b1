"""Process-wide metrics: counters, gauges, histograms, one registry.

Every tier of the repo (resilience session, executors, serving frontend,
streaming session, trainer, autotune) publishes its counters here instead of
growing another private stats dataclass.  Three instrument kinds:

* :class:`Counter` — monotonic by convention, but exposes :meth:`Counter.set`
  because the repo's legacy stats objects (``SessionStats``) are *views* over
  these counters and need snapshot/restore semantics (trainer warm-up
  snapshots stats around the throwaway step).
* :class:`Gauge` — last-write-wins scalar (queue depth, EWMA health).
* :class:`Histogram` — fixed log-scale buckets (shared by every latency
  metric, so percentiles are comparable across tiers) plus a bounded raw
  sample ring: while no sample has been evicted, :meth:`HistogramSnapshot
  .percentile` is EXACT (the definition every bench emitter routes through);
  after eviction it degrades to a conservative bucket upper bound.

Instruments are addressed by ``(name, labels)`` through a
:class:`MetricsRegistry`; the process-wide default registry
(:func:`default_registry`) is what :func:`~.report.write_report` dumps in
Prometheus text format (:meth:`MetricsRegistry.render_prom`).  All methods
are thread-safe; the hot-path cost of ``counter.inc()`` is one lock-free
attribute add under the GIL plus nothing else — cheap enough to stay on even
with ``REPRO_OBS=0`` (the env flag gates *span recording*, not counters).
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import threading
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramSnapshot",
    "MetricsRegistry",
    "StatsView",
    "default_registry",
    "log_bounds",
    "percentile",
    "set_default_registry",
]

LabelSet = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[dict]) -> LabelSet:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile(sorted_samples: Sequence[float], p: float) -> float:
    """THE repo-wide percentile definition (nearest-rank, floor index):
    ``sorted_samples[min(n - 1, int(p * n))]`` with ``p`` in ``[0, 1]``.

    Historically ``bench_serve`` hand-rolled exactly this while
    ``bench_stream`` used ``np.percentile`` (linear interpolation) — two
    "p50"s that disagreed on identical samples.  Both emitters now route
    through this one definition via :meth:`HistogramSnapshot.percentile`.
    """
    n = len(sorted_samples)
    if n == 0:
        raise ValueError("percentile of an empty sample set")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"p must be in [0, 1], got {p}")
    return float(sorted_samples[min(n - 1, int(p * n))])


def log_bounds(lo: float = 1.0, hi: float = 1e8, growth: float = 2.0) -> Tuple[float, ...]:
    """Fixed log-scale bucket upper bounds: ``lo, lo·g, lo·g², … ≥ hi``.

    The default (1 µs → 100 s in ×2 octaves, 28 buckets) is shared by every
    latency histogram in the repo so percentile resolution is uniform.
    """
    if lo <= 0 or hi <= lo or growth <= 1.0:
        raise ValueError(f"need 0 < lo < hi and growth > 1, got {(lo, hi, growth)}")
    bounds = []
    b = float(lo)
    while b < hi * (1.0 - 1e-12):
        bounds.append(b)
        b *= growth
    bounds.append(b)
    return tuple(bounds)


DEFAULT_BOUNDS = log_bounds()
DEFAULT_SAMPLE_CAP = 8192


class Counter:
    """Monotonic-by-convention scalar.  ``set`` exists for view semantics."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counters only count up (inc {n}); use a Gauge")
        self.value += n

    def set(self, v: float) -> None:
        self.value = v


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


@dataclasses.dataclass(frozen=True)
class HistogramSnapshot:
    """Immutable point-in-time view of one histogram."""

    bounds: Tuple[float, ...]       # bucket upper bounds (last = +overflow cap)
    counts: Tuple[int, ...]         # len(bounds) + 1 (trailing overflow bucket)
    count: int
    total: float
    min: float                      # +inf when empty
    max: float                      # -inf when empty
    samples: Tuple[float, ...]      # sorted retained raw samples
    dropped_samples: int            # raw samples evicted from the ring

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile (see :func:`percentile`).

        Exact while every observation is still retained
        (``dropped_samples == 0``); otherwise estimated from the log-scale
        buckets (the containing bucket's upper bound — a conservative
        over-estimate, never an under-estimate).
        """
        if self.count == 0:
            raise ValueError("percentile of an empty histogram")
        if self.dropped_samples == 0:
            return percentile(self.samples, p)
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"p must be in [0, 1], got {p}")
        rank = min(self.count - 1, int(p * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum > rank:
                if i >= len(self.bounds):
                    return self.max  # overflow bucket: cap at observed max
                return min(self.bounds[i], self.max)
        return self.max  # unreachable (cum == count > rank by then)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class Histogram:
    """Fixed log-scale bucket histogram with a bounded raw-sample ring."""

    def __init__(
        self,
        bounds: Sequence[float] = DEFAULT_BOUNDS,
        *,
        sample_cap: int = DEFAULT_SAMPLE_CAP,
    ):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("bounds must be a non-empty increasing sequence")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: overflow bucket
        self._count = 0
        self._total = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._cap = max(0, int(sample_cap))
        self._samples: list = []
        self._next = 0          # ring write cursor
        self._dropped = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._count += 1
            self._total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if self._cap:
                if len(self._samples) < self._cap:
                    self._samples.append(v)
                else:
                    self._samples[self._next] = v
                    self._next = (self._next + 1) % self._cap
                    self._dropped += 1

    def observe_many(self, values: Sequence[float]) -> None:
        """Bulk :meth:`observe` under ONE lock acquisition — for hot paths
        that complete many measurements at once (a dispatched serve batch
        records every ticket's latency here in a single call)."""
        vals = [float(v) for v in values]
        if not vals:
            return
        with self._lock:
            for v in vals:
                self._counts[bisect.bisect_left(self.bounds, v)] += 1
                self._total += v
                if v < self._min:
                    self._min = v
                if v > self._max:
                    self._max = v
                if self._cap:
                    if len(self._samples) < self._cap:
                        self._samples.append(v)
                    else:
                        self._samples[self._next] = v
                        self._next = (self._next + 1) % self._cap
                        self._dropped += 1
            self._count += len(vals)

    @property
    def count(self) -> int:
        return self._count

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return HistogramSnapshot(
                bounds=self.bounds,
                counts=tuple(self._counts),
                count=self._count,
                total=self._total,
                min=self._min,
                max=self._max,
                samples=tuple(sorted(self._samples)),
                dropped_samples=self._dropped,
            )


@dataclasses.dataclass
class _Family:
    kind: str                       # "counter" | "gauge" | "histogram"
    help: str
    children: Dict[LabelSet, object] = dataclasses.field(default_factory=dict)


class MetricsRegistry:
    """Name → labeled instruments; the process-wide metrics namespace."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.RLock()

    # ------------------------------------------------------------ factories

    def _get(self, name: str, kind: str, labels: Optional[dict], help: str,
             make: Callable):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(kind=kind, help=help)
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as a {fam.kind}, "
                    f"requested as a {kind}"
                )
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = make()
            return child

    def counter(self, name: str, labels: Optional[dict] = None, *,
                help: str = "") -> Counter:
        return self._get(name, "counter", labels, help, Counter)

    def gauge(self, name: str, labels: Optional[dict] = None, *,
              help: str = "") -> Gauge:
        return self._get(name, "gauge", labels, help, Gauge)

    def histogram(
        self,
        name: str,
        labels: Optional[dict] = None,
        *,
        bounds: Sequence[float] = DEFAULT_BOUNDS,
        sample_cap: int = DEFAULT_SAMPLE_CAP,
        help: str = "",
    ) -> Histogram:
        return self._get(
            name, "histogram", labels, help,
            lambda: Histogram(bounds, sample_cap=sample_cap),
        )

    def remove(self, name: str, labels: Optional[dict] = None) -> bool:
        """Drop one labeled instrument; drop the family once empty.

        Lifecycle hook for label sets that stop existing — e.g. a node's
        ``node_straggle_ewma`` gauge after ``permanent_loss`` (a dead node's
        gauge would otherwise sit in every report decaying toward healthy).
        Returns whether the instrument existed.
        """
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return False
            existed = fam.children.pop(key, None) is not None
            if existed and not fam.children:
                del self._families[name]
            return existed

    # ------------------------------------------------------------ read side

    def families(self) -> Dict[str, str]:
        """name → kind for everything registered."""
        with self._lock:
            return {n: f.kind for n, f in self._families.items()}

    def collect(self) -> Dict[str, Dict[LabelSet, object]]:
        """Deep-enough copy for reporting: scalars for counter/gauge,
        :class:`HistogramSnapshot` for histograms."""
        out: Dict[str, Dict[LabelSet, object]] = {}
        with self._lock:
            items = [
                (name, fam.kind, dict(fam.children))
                for name, fam in self._families.items()
            ]
        for name, kind, children in items:
            out[name] = {
                key: (c.snapshot() if kind == "histogram" else c.value)
                for key, c in children.items()
            }
        return out

    def value(self, name: str, labels: Optional[dict] = None) -> float:
        """Scalar read of one counter/gauge (0 if never touched)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return 0
            child = fam.children.get(_label_key(labels))
        return 0 if child is None else child.value

    def sum(self, name: str) -> float:
        """Sum of one counter/gauge family across ALL label sets — the
        aggregation obs-report uses for per-session counters."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return 0
            children = list(fam.children.values())
        return sum(c.value for c in children)

    # ---------------------------------------------------------- text dump

    def render_prom(self) -> str:
        """Prometheus-style text exposition of every instrument."""
        lines: list[str] = []
        with self._lock:
            families = sorted(
                (name, fam.kind, fam.help, dict(fam.children))
                for name, fam in self._families.items()
            )
        for name, kind, help_, children in families:
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for key in sorted(children):
                child = children[key]
                if kind == "histogram":
                    snap = child.snapshot()
                    cum = 0
                    for b, c in zip(snap.bounds, snap.counts):
                        cum += c
                        lines.append(
                            f"{name}_bucket{_prom_labels(key, le=repr(b))} {cum}"
                        )
                    lines.append(
                        f"{name}_bucket{_prom_labels(key, le='+Inf')} {snap.count}"
                    )
                    lines.append(f"{name}_sum{_prom_labels(key)} {snap.total}")
                    lines.append(f"{name}_count{_prom_labels(key)} {snap.count}")
                else:
                    lines.append(f"{name}{_prom_labels(key)} {child.value}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_labels(key: LabelSet, **extra: str) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


class StatsView:
    """Attribute-style view over a fixed set of registry counters.

    The migration shim for the repo's legacy stats dataclasses: a subclass
    declares ``FIELDS`` (name → help) and a metric prefix, and every
    attribute read/write proxies the labeled counter in the registry — so
    ``stats.host_solves += 1`` and ``obs-report`` can never disagree, because
    there is exactly one number.
    """

    FIELDS: Dict[str, str] = {}
    PREFIX = ""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 labels: Optional[dict] = None):
        registry = registry if registry is not None else default_registry()
        object.__setattr__(self, "_labels", dict(labels or {}))
        object.__setattr__(self, "_counters", {
            f: registry.counter(self.PREFIX + f, labels=labels, help=h)
            for f, h in self.FIELDS.items()
        })

    def __getattr__(self, name):
        counters = object.__getattribute__(self, "_counters")
        try:
            c = counters[name]
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__} has no counter {name!r}"
            ) from None
        v = c.value
        return int(v) if float(v).is_integer() else v

    def __setattr__(self, name, value):
        counters = object.__getattribute__(self, "_counters")
        try:
            counters[name].set(value)
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__} has no counter {name!r}"
            ) from None

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}

    # Snapshot/restore replaces the dataclasses.replace(...) +
    # __dict__.update(...) idiom the trainer's warm-up used on the old
    # dataclass: counters are shared state, so restoring must write back
    # through the view, not swap an object.
    def snapshot(self) -> dict:
        return self.as_dict()

    def restore(self, snap: dict) -> None:
        for k, v in snap.items():
            setattr(self, k, v)


_DEFAULT: MetricsRegistry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every tier publishes into."""
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests); returns the previous one."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, reg
    return prev
