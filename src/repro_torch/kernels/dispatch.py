"""Kernel dispatch: a registry of named implementations and a resolver.

Each op registers two implementations:

* ``cuda``      — the hand-written Hopper kernel (``csrc/``), CUDA tensors only;
* ``torch_ref`` — the plain PyTorch version, the kernel's oracle.

Attention registers a third, ``torch_chunked``: the plain chunked attention
that takes every sliding-window call, on every device (the kernel has no
window, as the reference's Pallas kernel has none).

``impl="auto"`` follows the tensors: a CUDA tensor gets the kernel, a CPU
tensor the plain version, and so does a ``meta`` tensor (``launch.dryrun``
runs the plain version for its shapes; ``impl="cuda"`` on one raises).
There is no fallback: a CUDA tensor either
launches the kernel or raises.  ``impl="torch_ref"`` on a CUDA tensor is for
explicit comparison against the kernel only.  Measured selection
(autotuning) is not ported yet.

Every kernel wrapper owns a :class:`LaunchCounter` that it bumps where it
launches its kernel, so a run can show that its main path went through the
kernels (:func:`launch_counts`, :func:`reset_launch_counts`).  The resolver
counts the calls of each op, whichever impl takes them
(:func:`call_counts`, :func:`reset_call_counts`): on the CPU, the plain
versions' calls.  While an :func:`observed` block is open, each resolved
op is called through its observer, which sees the op, the impl and the
arguments (``launch.op_analysis`` counts the op's work by its shapes).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

__all__ = [
    "IMPLS",
    "LaunchCounter",
    "call_counts",
    "impl_names",
    "launch_counts",
    "observed",
    "register_impl",
    "reset_call_counts",
    "reset_launch_counts",
    "resolve",
]

IMPLS = ("cuda", "torch_ref", "torch_chunked")

_REGISTRY: Dict[str, Dict[str, Callable]] = {}
_COUNTERS: Dict[str, "LaunchCounter"] = {}
_CALLS: Dict[str, int] = {}
_OBSERVER: Optional[Callable] = None


class LaunchCounter:
    """Number of kernel launches of one wrapper since the last reset."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        _COUNTERS[name] = self


def launch_counts() -> dict[str, int]:
    return {name: c.count for name, c in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.count = 0


def call_counts() -> dict[str, int]:
    """The calls of each op resolved since the last reset."""
    return dict(_CALLS)


def reset_call_counts() -> None:
    _CALLS.clear()


@contextlib.contextmanager
def observed(observer: Callable):
    """While the block is open, every op that :func:`resolve` hands out
    runs as ``observer(op, fn, *args, **kwargs)``, where ``fn`` is the
    resolved impl, which the observer calls and whose result it returns."""
    global _OBSERVER
    outer, _OBSERVER = _OBSERVER, observer
    try:
        yield
    finally:
        _OBSERVER = outer


def register_impl(op: str, name: str, fn: Callable) -> Callable:
    if name not in IMPLS:
        raise ValueError(f"unknown impl {name!r}; expected one of {IMPLS}")
    _REGISTRY.setdefault(op, {})[name] = fn
    return fn


def impl_names(op: str) -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY.get(op, {})))


def resolve(op: str, impl: str, *tensors: torch.Tensor) -> tuple[str, Callable]:
    """``(name, fn)`` for ``op`` on these tensors; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{op}: all tensors must lie on one device, got {sorted(map(str, devices))}")
    (device,) = devices
    if device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{op}: unsupported device {device}")
    if impl == "auto":
        name = "cuda" if device.type == "cuda" else "torch_ref"
    else:
        name = impl
    impls = _REGISTRY.get(op, {})
    if name not in impls:
        raise ValueError(f"{op}: unknown impl {impl!r}; registered: {impl_names(op)}")
    if name == "cuda" and device.type != "cuda":
        raise ValueError(f"{op}: impl='cuda' needs CUDA tensors, got {device}")
    _CALLS[op] = _CALLS.get(op, 0) + 1
    fn, observer = impls[name], _OBSERVER
    if observer is None:
        return name, fn
    return name, lambda *args, **kwargs: observer(op, fn, *args, **kwargs)
