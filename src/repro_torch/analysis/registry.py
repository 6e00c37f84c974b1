"""The ``@compiled_path`` registry: the port's copy of the reference's
``analysis/registry.py`` (which imports nothing, but the port keeps its own).

Production code marks the functions that make up (or produce, or drive) the
device hot paths; both analyzer layers key off the markers:

* the AST linter treats marked code as *compiled context* and lints it (and
  everything reachable from it through the project call graph) under the
  zero-host-work rules (:mod:`repro_torch.analysis.ast_lint`);
* the sync audit cross-checks that every audited hot path is registered
  (:mod:`repro_torch.analysis.sync_audit`).

The port runs eagerly: "compiled" names the reference's contract, a step
whose body is a fixed sequence of device launches with no value read back
to the host.  Three kinds, as in the reference:

``kind="step"``
    The decorated function's own body is step code.  Example:
    :func:`repro_torch.core.recovery.device_recovery_masked`.
``kind="factory"``
    The function's body is host-side setup that *defines* the step: its
    nested ``def``s are step code, its own top-level statements are not.
    Example: :func:`repro_torch.train.train_step.make_train_step`.
``kind="host"``
    Host-side hot-path orchestration around a step (the per-step loop).
    Every per-value device→host read here is a blocking round trip, so the
    linter holds it to one read a step (one ``.cpu()`` or ``.tolist()`` of
    a stacked tensor).  Example:
    :meth:`repro_torch.train.trainer.Trainer._device_recovery_step`.

The decorator is metadata-only (no wrapping, no runtime cost, no import of
torch), safe to apply anywhere in ``repro_torch.*``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

__all__ = ["CompiledPathInfo", "compiled_path", "registered_paths"]

KINDS = ("step", "factory", "host")


@dataclasses.dataclass(frozen=True)
class CompiledPathInfo:
    name: str      # registry key (defaults to module.qualname)
    kind: str      # "step" | "factory" | "host"
    module: str
    qualname: str


_REGISTRY: dict[str, CompiledPathInfo] = {}


def compiled_path(
    name: Union[None, str, Callable] = None, *, kind: str = "step"
) -> Callable:
    """Register a function as part of the compiled-step contract.

    Usable bare (``@compiled_path``) or parameterized
    (``@compiled_path("train_step", kind="factory")``).  Returns the
    function unchanged apart from a ``__compiled_path__`` attribute.
    """
    if callable(name):  # bare @compiled_path
        return compiled_path(None, kind=kind)(name)
    if kind not in KINDS:
        raise ValueError(f"compiled_path kind must be one of {KINDS}, got {kind!r}")

    def deco(fn: Callable) -> Callable:
        path_name = name or f"{fn.__module__}.{fn.__qualname__}"
        info = CompiledPathInfo(
            name=path_name, kind=kind,
            module=fn.__module__, qualname=fn.__qualname__,
        )
        prev = _REGISTRY.get(path_name)
        # A module run as a script (``python -m``, or a spawned rank's
        # ``__mp_main__``) is imported a second time
        # under its own name: the same function, registered again.
        same_module = prev is not None and (
            prev.module == info.module or {prev.module, info.module} & {"__main__", "__mp_main__"})
        if prev is not None and not (same_module and prev.qualname == info.qualname):
            raise ValueError(
                f"compiled_path name {path_name!r} already registered by "
                f"{prev.module}.{prev.qualname}"
            )
        _REGISTRY[path_name] = info
        try:
            fn.__compiled_path__ = info
        except (AttributeError, TypeError):  # pragma: no cover - builtins
            pass
        return fn

    return deco


def registered_paths(kind: Optional[str] = None) -> dict[str, CompiledPathInfo]:
    """Snapshot of the registry (optionally filtered by kind).  Only paths
    whose defining modules have been imported are visible — the AST linter
    discovers markers syntactically instead, so it never needs imports."""
    if kind is None:
        return dict(_REGISTRY)
    return {k: v for k, v in _REGISTRY.items() if v.kind == kind}
