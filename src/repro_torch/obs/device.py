"""Counters kept on the device.

A count that a training step makes on the card (routed tokens, dropped
tokens) would cost a blocking device-to-host read if it went into a
:class:`~repro_torch.obs.metrics.Counter` at each call.  Here each named
total is a 0-dim tensor on the device of its first value: :meth:`add`
launches one in-place add and reads nothing back, and :meth:`read` copies
every total to the host in one transfer, once, after the window that
counted.  Like the rest of ``obs``, the module imports no torch at its top.
"""

from __future__ import annotations

__all__ = ["DeviceCounters", "default_counters"]


class DeviceCounters:
    """Named running totals on the device (all on one device)."""

    def __init__(self):
        self._totals: dict = {}

    def add(self, name: str, value) -> None:
        """Add ``value``, a 0-dim integer tensor, to the total ``name``."""
        total = self._totals.get(name)
        if total is None:
            self._totals[name] = value.detach().clone()
        else:
            total.add_(value)

    def read(self) -> dict[str, int]:
        """Every total, in one device-to-host copy."""
        if not self._totals:
            return {}
        import torch

        names = sorted(self._totals)
        return dict(zip(names, torch.stack([self._totals[n] for n in names]).tolist()))

    def clear(self) -> None:
        self._totals.clear()


_DEFAULT = DeviceCounters()


def default_counters() -> DeviceCounters:
    """The process's counters, which the model layers add to."""
    return _DEFAULT
