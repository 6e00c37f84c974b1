"""Layer 2: run the registered hot paths and audit what they dispatch (the
twin of the reference's ``analysis/jaxpr_audit.py``).

The reference traces each path to a jaxpr and lowers it; the port runs
eagerly and has neither, so this layer watches the aten ops a path
dispatches, under a ``TorchDispatchMode``.  For every
:class:`~repro_torch.analysis.hotpaths.HotPathSpec` it checks:

1. **registry cross-check**: building the spec imports the defining
   module; the spec's ``registry_name`` must then be in the
   ``@compiled_path`` registry (a spec drifting away from production
   marking is itself a finding);
2. **host syncs**: the ops that move a value to the host,
   ``_local_scalar_dense`` (behind ``.item()``, ``float()``, ``bool()``)
   and any ``_to_copy``, ``copy_`` or ``to`` onto the CPU from another
   device, are counted per bucket, and a path must count zero (the four
   audited paths are ``factory`` paths; a ``host`` path would need the
   reads it declares, and none is audited).  A scalar
   read counts when its tensor lies on a device other than the CPU, or
   holds a value computed from the call's arguments (on a CPU run, where
   the arguments stand for the device's data).  A scalar the step made
   on the host from Python numbers (the f32 schedule of
   :func:`~repro_torch.train.optimizer.cosine_schedule`) is already there;
3. **one program per bucket** (the twin of the retrace check): the two
   calls of a bucket, with different values, must dispatch the same
   sequence of ops on the same shapes and dtypes, so nothing
   value-dependent changes the launches.

A hand-written kernel is launched through ``ctypes``, which no aten hook
sees (its output allocation is seen).  On the card each ``step`` and
``factory`` path also runs under ``torch.cuda.set_sync_debug_mode("error")``,
which raises on any implicit synchronisation of a CUDA tensor, whatever
made it.  The kernels' launches and the dispatched calls are read per
path from ``kernels.dispatch``'s counters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .hotpaths import HotPathSpec, hot_path_specs

__all__ = ["PathAudit", "audit_path", "audit_hot_paths"]

_COPIES = {"_to_copy", "copy_", "to", "_copy_from", "_copy_from_and_resize"}


class _Recorder:
    """The ops a call dispatches, their shapes, and its host syncs."""

    def __init__(self):
        self.ops: list = []
        self.syncs: list = []


def _recorder_mode(rec: _Recorder, args):
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode

    from ..launch.op_analysis import tensors_of

    # The storages holding the call's data: its arguments and whatever an
    # op computes from them.
    data = weakref.WeakSet(t.untyped_storage() for t in tensors_of(args))

    def sig(tensors):
        return tuple((tuple(t.shape), str(t.dtype), t.device.type) for t in tensors)

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            name = func.overloadpacket.__name__
            ins, outs = tensors_of((args, kwargs)), tensors_of(out)
            rec.ops.append((name, sig(ins), sig(outs)))
            from_data = any(t.untyped_storage() in data for t in ins)
            if from_data:
                data.update(t.untyped_storage() for t in outs)
            if name == "_local_scalar_dense" and (from_data or ins[0].device.type != "cpu"):
                rec.syncs.append(name)
            elif name in _COPIES and any(t.device.type == "cpu" for t in outs) \
                    and any(t.device.type != "cpu" for t in ins):
                rec.syncs.append(name)
            return out

    return Mode()


@dataclasses.dataclass
class PathAudit:
    """Machine-readable audit verdict for one hot path."""

    name: str
    registry_name: str
    description: str
    device: str
    buckets: list
    registered: bool = False
    kind: Optional[str] = None
    syncs: dict = dataclasses.field(default_factory=dict)       # bucket -> host syncs over its two calls
    sync_ops: list = dataclasses.field(default_factory=list)    # "bucket:op"
    same_program: dict = dataclasses.field(default_factory=dict)  # bucket -> the two calls' op sequences equal
    ops: dict = dataclasses.field(default_factory=dict)         # bucket -> aten ops a call
    debug_mode: Optional[str] = None   # "error" when run under set_sync_debug_mode on the card
    launches: dict = dataclasses.field(default_factory=dict)    # kernel launches over the audit's calls
    calls: dict = dataclasses.field(default_factory=dict)       # dispatched ops over the audit's calls
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return (
            self.error is None
            and self.registered
            and not any(self.syncs.values())
            and bool(self.same_program) and all(self.same_program.values())
        )

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def _run_call(fn, args, rec: _Recorder, debug: bool):
    import contextlib

    import torch

    guard = contextlib.nullcontext()
    if debug:
        @contextlib.contextmanager
        def guard_fn():
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")

        guard = guard_fn()
    with guard, _recorder_mode(rec, args):
        fn(*args)


def audit_path(spec: HotPathSpec, device="cpu") -> PathAudit:
    """Run the audit for one spec on ``device``; never raises: a failure
    comes back as a non-``ok`` :class:`PathAudit`."""
    import torch

    from ..kernels import dispatch
    from .registry import registered_paths

    device = torch.device(device)
    audit = PathAudit(name=spec.name, registry_name=spec.registry_name, description=spec.description,
                      device=str(device), buckets=[])
    try:
        fn, buckets = spec.build(device)
        audit.buckets = [label for label, _ in buckets]
        info = registered_paths().get(spec.registry_name)
        audit.registered = info is not None
        audit.kind = info.kind if info else None
        debug = device.type == "cuda" and audit.kind in ("step", "factory")
        audit.debug_mode = "error" if debug else None
        launches0, calls0 = dispatch.launch_counts(), dispatch.call_counts()
        for label, calls in buckets:
            recs = []
            for args in calls:
                rec = _Recorder()
                _run_call(fn, args, rec, debug)
                recs.append(rec)
            audit.syncs[label] = sum(len(r.syncs) for r in recs)
            audit.sync_ops += [f"{label}:{op}" for r in recs for op in r.syncs]
            audit.same_program[label] = all(r.ops == recs[0].ops for r in recs)
            audit.ops[label] = len(recs[0].ops)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        audit.launches = {k: v - launches0.get(k, 0) for k, v in dispatch.launch_counts().items()
                          if v != launches0.get(k, 0)}
        audit.calls = {k: v - calls0.get(k, 0) for k, v in dispatch.call_counts().items()
                       if v != calls0.get(k, 0)}
    except Exception as e:  # a failing path is a verdict, reported with the others
        audit.error = f"{type(e).__name__}: {e}"
    return audit


def audit_hot_paths(specs: Optional[Sequence[HotPathSpec]] = None, device="cpu") -> list[PathAudit]:
    """Audit every registered hot path (default: :func:`hot_path_specs`)."""
    return [audit_path(s, device) for s in (specs if specs is not None else hot_path_specs())]
