"""Carry the reference package's state into the port, through numpy only.

The port never imports the reference package; a caller that holds its
objects passes their numpy fields here:

* an assignment's ``matrix``, ``scheme`` and ``params`` → :class:`Assignment`;
* a recovery result's fields → :class:`RecoveryResult`;
* centers, shards or any array → a tensor on the chosen device.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.assignment import Assignment
from .core.recovery import RecoveryResult

__all__ = ["to_assignment", "to_recovery", "to_tensor"]


def to_assignment(matrix, scheme: str, params: dict) -> Assignment:
    return Assignment(matrix=np.array(matrix, dtype=np.uint8), scheme=str(scheme), params=dict(params))


def to_recovery(
    *, b, b_full, a, delta: float, feasible: bool, uncovered, method: str
) -> RecoveryResult:
    return RecoveryResult(
        b=np.array(b, dtype=np.float64),
        b_full=np.array(b_full, dtype=np.float64),
        a=np.array(a, dtype=np.float64),
        delta=float(delta),
        feasible=bool(feasible),
        uncovered=np.array(uncovered, dtype=np.int64),
        method=str(method),
    )


def to_tensor(array, device, dtype=torch.float32) -> torch.Tensor:
    """A copy of a numpy array as a tensor on ``device``."""
    return torch.as_tensor(np.array(array), dtype=dtype, device=torch.device(device))
