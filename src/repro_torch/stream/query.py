"""Batched nearest-center / cluster-membership query path.

The reference package's ``stream/query.py`` in PyTorch.  Serving queries
against a streaming model is its own workload: high QPS, small batches of
any size, and a model (the center set) that lags ingestion.

* **Fixed shapes.**  Query batches are padded up to power-of-two buckets
  (:func:`bucket_size`), so the warm-up sets and counters match the
  reference's.  The inner op is
  :func:`repro_torch.kernels.pairwise_dist.ops.assign_min`: the
  hand-written kernel on the card, never a plain version there.
* **One device→host transfer per batch.**  The indices, bit-cast to
  float32, and the distances are stacked on the device and copied into one
  pinned host buffer; the host synchronises once and slices off the
  padding (:class:`HostFetch`).
* **Bounded staleness, reported.**  Every result carries how many points
  (and ingest calls) arrived after the answering centers were solved.
* **Zero coupling to the build path.**  The engine holds no tree state: it
  is handed (queries, centers, staleness) by
  :class:`repro_torch.stream.session.StreamingSession`.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..analysis import compiled_path
from ..device import resolve_device
from ..kernels import autotune
from ..kernels.pairwise_dist import ops as pd
from ..obs import default_registry, trace_span

__all__ = ["DeviceCenters", "HostFetch", "QueryResult", "QueryEngine", "assign_rows", "bucket_size"]

_ENGINE_IDS = itertools.count()  # label key for per-engine registry counters

_MIN_BATCH = 64  # smallest bucket: tiny batches share one shape


def bucket_size(n: int) -> int:
    """Smallest power-of-two batch bucket holding ``n`` rows: the shape
    policy shared by the query engine, the frontier solve and the serving
    frontend's micro-batcher."""
    b = _MIN_BATCH
    while b < n:
        b <<= 1
    return b


def assign_rows(q: torch.Tensor, c: torch.Tensor, impl: str = "auto"):
    """(idx (n,) i32, unsquared distance (n,) f32) of query rows ``q``
    against centers ``c``, on their device: ``sqrt(max(d², 0))`` of the
    assignment, as the reference's jitted assigner returns it."""
    idx, d2 = pd.assign_min(q, c, impl=impl)
    return idx, torch.sqrt(torch.clamp_min(d2, 0.0))


@compiled_path("query.assign_min", kind="factory")
def _assign_run(impl: str):
    """The engine's step, ``run(q, c) -> (idx, distance)``: the callable
    the Layer-2 sync audit runs (the reference's ``_assign_run``, the raw
    form of its jitted assigner)."""

    def run(q, c):
        return assign_rows(q, c, impl)

    return run


class DeviceCenters:
    """One device copy of a model's centers per ``(id, version, shape)``:
    the model changes only when the session re-solves (a new tensor and a
    bumped version), so callers that mutate centers in place must bump the
    version.  The copy lands on ``device`` if given, else on the centers'
    own device (a tensor's), else on the card."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self._key = None
        self._dev: Optional[torch.Tensor] = None

    def __call__(self, centers, version: int) -> torch.Tensor:
        key = (id(centers), int(version), tuple(centers.shape))
        if self._key != key:
            if self.device is not None:
                dev = self.device
            elif isinstance(centers, torch.Tensor):
                dev = centers.device
            else:
                dev = resolve_device(None)
            self._dev = torch.as_tensor(centers, dtype=torch.float32).to(dev).contiguous()
            self._key = key
        return self._dev


class HostFetch:
    """One synchronisation per batch: ``(idx, dist)`` of one device become
    one (2, b) float32 tensor (idx bit-cast), copied into a pinned host
    buffer kept per shape; returns host copies (numpy) of both."""

    def __init__(self):
        self._pinned: dict = {}

    def __call__(self, idx: torch.Tensor, dist: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
        both = torch.stack([idx.view(torch.float32), dist])
        if both.device.type == "cuda":
            buf = self._pinned.get(tuple(both.shape))
            if buf is None:
                buf = self._pinned[tuple(both.shape)] = torch.empty(
                    both.shape, dtype=torch.float32, pin_memory=True
                )
            buf.copy_(both, non_blocking=True)
            torch.cuda.current_stream(both.device).synchronize()
            both = buf
        arr = both.numpy()
        return arr[0].view(np.int32).copy(), arr[1].copy()


class QueryResult(NamedTuple):
    """Answers plus the per-query staleness bound."""

    indices: np.ndarray       # (n,) int32 — nearest-center / cluster id
    distances: np.ndarray     # (n,) float32 — unsquared distance to it
    staleness_points: int     # points ingested since the centers were solved
    staleness_ingests: int    # ingest calls since the centers were solved
    version: int              # centers version that answered


class QueryEngine:
    """Stateless-model query executor over shape buckets.  ``device`` is
    where the centers live; by default the centers' own device (a tensor's),
    else the card."""

    def __init__(self, impl: str = "auto", device=None):
        self.impl = impl
        self.device = None if device is None else torch.device(device)
        self._buckets: set = set()  # (bucket, d, k) shapes this engine served
        labels = {"engine": f"q{next(_ENGINE_IDS)}"}
        reg = default_registry()
        self._c_served = reg.counter("query_served_rows", labels=labels, help="query rows answered")
        self._c_warmups = reg.counter(
            "query_warmups", labels=labels,
            help="warm-up passes run (generation bumps, explicit)",
        )
        self._device_centers = DeviceCenters(self.device)
        self._fetch = HostFetch()
        self._run = _assign_run(impl)

    @property
    def compiled_buckets(self) -> int:
        return len(self._buckets)

    @property
    def queries_served(self) -> int:
        return int(self._c_served.value)

    @property
    def warmups(self) -> int:
        return int(self._c_warmups.value)

    @compiled_path("query.warmup", kind="host")
    def warmup(self, centers, version: int = 0) -> autotune.WarmupReport:
        """Place the new centers and run every bucket this engine has served
        once, off the hot path: the first query after a model refresh pays
        neither the copy nor a kernel build.  An engine that has served
        nothing warms the smallest bucket."""
        c_dev = self._device_centers(centers, version)
        k, d = (int(s) for s in c_dev.shape)
        buckets = sorted({b for (b, bd, bk) in self._buckets if bd == d and bk == k}) or [_MIN_BATCH]
        plan = [
            (f"query[{b}x{d}]k{k}",
             lambda b=b: self._run(torch.zeros((b, d), device=c_dev.device), c_dev))
            for b in buckets
        ]
        report = autotune.warmup(plan)
        for b in buckets:
            self._buckets.add((b, d, k))
        self._c_warmups.inc()
        return report

    @compiled_path("query.assign", kind="host")
    def assign(
        self,
        queries,
        centers,
        *,
        staleness_points: int = 0,
        staleness_ingests: int = 0,
        version: int = 0,
    ) -> QueryResult:
        """Batched nearest-center assignment of ``queries`` to ``centers``."""
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2:
            raise ValueError(f"queries must be (n, d), got {q.shape}")
        n, d = q.shape
        if n == 0:
            return QueryResult(
                np.zeros((0,), np.int32), np.zeros((0,), np.float32),
                staleness_points, staleness_ingests, version,
            )
        c_dev = self._device_centers(centers, version)
        bucket = bucket_size(n)
        with trace_span("query.assign", rows=n, bucket=bucket):
            qp = np.zeros((bucket, d), np.float32)
            qp[:n] = q  # zero padding rows are sliced off on the host
            idx, dist = self._run(torch.from_numpy(qp).to(c_dev.device), c_dev)
            idx_h, dist_h = self._fetch(idx, dist)
        self._buckets.add((bucket, d, int(c_dev.shape[0])))
        self._c_served.inc(n)
        return QueryResult(
            indices=idx_h[:n],
            distances=dist_h[:n],
            staleness_points=staleness_points,
            staleness_ingests=staleness_ingests,
            version=version,
        )
