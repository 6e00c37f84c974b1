"""Serving tier (`repro_torch.serve`), the reference package's ``serve/``.

Two independent surfaces:

* **Query serving** — the front door of the clustering stack:
  :mod:`repro_torch.serve.frontend` (async micro-batching, per-tenant
  routing, admission control, assignment cache) over
  :mod:`repro_torch.serve.batcher` (sans-io shape-bucketed collection),
  :mod:`repro_torch.serve.cache` (generation-keyed result LRU) and
  :mod:`repro_torch.serve.clock` (the virtual-clock seam).
* **Model serving** — :mod:`repro_torch.serve.decode`: batched prefill and
  single-token decode for the transformer side.  Imported on demand (it
  pulls the model stack); ``import repro_torch.serve`` stays clustering-only.
"""

from .batcher import Batch, MicroBatcher, Ticket  # noqa: F401
from .cache import AssignmentCache  # noqa: F401
from .clock import SystemClock, VirtualClock  # noqa: F401
from .frontend import (  # noqa: F401
    AdmissionError,
    AsyncFrontend,
    ServingFrontend,
    TenantState,
)

__all__ = [
    "AdmissionError",
    "AssignmentCache",
    "AsyncFrontend",
    "Batch",
    "MicroBatcher",
    "ServingFrontend",
    "SystemClock",
    "Ticket",
    "TenantState",
    "VirtualClock",
]
