"""Algorithm 3 — straggler-resilient distributed r-PCA via relaxed coresets
(paper §3.3.2, following Feldman–Schmidt–Sohler / Balcan et al.).

Each worker computes a local SVD ``P_i = U_i Σ_i V_iᵀ`` and sends the relaxed
coreset ``S_i = Σ_i^{(r₁)} V_iᵀ`` (only the top ``r₁ = r + ⌈r/δ⌉ − 1`` rows
are non-zero, so the message is ``r₁·d``, independent of n).  The
coordinator stacks ``√b_i · S_i`` (the b-weighting of Lemma 5 enters as √b
since the cost is squared) and returns the top-r right singular subspace.
Theorem 5: cost(P, L̂) ≤ (1+4δ)·cost(P, L*).

The SVDs and matrix products are library calls (``torch.linalg.svd``,
``torch.matmul``), as the reference leaves them to XLA; no kernel of the
port runs here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .assignment import Assignment
from .executor import Executor, get_executor
from .nodes import NodeBlock
from .recovery import RecoveryResult

__all__ = [
    "relaxed_coreset_rank",
    "local_relaxed_coresets",
    "resilient_pca",
    "centralized_pca",
    "pca_cost",
    "ResilientPCAOutput",
]

# Largest (n, d) f32 temporary the dense cost may materialize before "auto"
# streams row blocks: the reference's shared materialization budget.
MATERIALIZE_BUDGET = 32 * 1024 * 1024
_COST_BLOCK_ROWS = 4096


def relaxed_coreset_rank(r: int, delta: float) -> int:
    """r₁ = r + ⌈r/δ⌉ − 1 (paper Algorithm 3, step 4)."""
    return r + max(1, math.ceil(r / delta)) - 1


def _sketch(xs: torch.Tensor, b: torch.Tensor, r1: int) -> torch.Tensor:
    """Every node's relaxed-coreset sketch ``√b · Σ^{(r₁)} Vᵀ``, batched over
    the node axis: (s, m, d), (s,) → (s, r1, d).  A shard with fewer than
    r₁ singular values is padded with zero rows to the declared size."""
    _, sv, vt = torch.linalg.svd(xs, full_matrices=False)  # economy SVD
    r1c = min(r1, vt.shape[-2])
    sketch = sv[:, :r1c, None] * vt[:, :r1c]
    if r1c < r1:
        sketch = torch.nn.functional.pad(sketch, (0, 0, 0, r1 - r1c))
    return torch.sqrt(torch.clamp_min(b, 0.0)).to(sketch.dtype)[:, None, None] * sketch


def local_relaxed_coresets(
    xs: torch.Tensor, r1: int, *, b_full=None, executor: Union[None, str, Executor] = None
) -> torch.Tensor:
    """Local sketches through the executor seam: (s, m, d) → (s, r1, d).

    Padding rows are zeros: they only add zero singular values.  ``b_full``
    (default all ones) applies the Lemma-5 √b weighting on the device.
    ``xs`` may be a mesh rank's placed block (a ``NodeBlock``).
    """
    if not isinstance(xs, NodeBlock):
        xs = torch.as_tensor(xs, dtype=torch.float32)
    b = (
        torch.ones(xs.shape[0], dtype=torch.float32, device=xs.device)
        if b_full is None
        else torch.as_tensor(b_full, dtype=torch.float32, device=xs.device)
    )
    return get_executor(executor).map_nodes(lambda x, b: _sketch(x, b, r1), (xs, b))


def _pca_cost_dense(x, basis):
    proj = x @ basis
    return torch.sum(x * x) - torch.sum(proj * proj)


def _pca_cost_chunked(x, basis, *, bn: int = _COST_BLOCK_ROWS):
    """Streaming cost: walk row blocks so the ‖x‖² temporary and the
    projection are only ever (bn, ·) at a time.  The block sums are added
    in row order, as the reference's scan adds them."""
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, x.shape[0], bn):
        xb = x[i : i + bn]
        proj = xb @ basis
        total = total + torch.sum(xb * xb) - torch.sum(proj * proj)
    return total


_PCA_COST = {"dense": _pca_cost_dense, "chunked": _pca_cost_chunked}


def pca_cost(x: torch.Tensor, basis: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """‖P − P·V·Vᵀ‖²_F for an orthonormal (d, r) basis V.  ``impl``:
    ``"dense"``, ``"chunked"`` (row blocks of 4096), or ``"auto"``, which
    streams once the (n, d) temporary exceeds 32 MiB."""
    x = x.float()
    if impl == "auto":
        impl = "chunked" if x.numel() * 4 > MATERIALIZE_BUDGET else "dense"
    if impl not in _PCA_COST:
        raise ValueError(f"pca_cost: unknown impl {impl!r}; expected 'auto', 'dense' or 'chunked'")
    return _PCA_COST[impl](x, basis.to(x.device, torch.float32))


def centralized_pca(x: torch.Tensor, r: int) -> torch.Tensor:
    """Exact top-r right singular subspace of the full matrix (baseline)."""
    _, _, vt = torch.linalg.svd(x.float(), full_matrices=False)
    return vt[:r].T  # (d, r)


@dataclasses.dataclass
class ResilientPCAOutput:
    basis: np.ndarray  # (d, r)
    cost: float  # cost(P, L̂) on the full dataset
    r1: int
    recovery: RecoveryResult
    sketch_rows: int  # total coordinator input rows (communication proxy)


def resilient_pca(
    points: np.ndarray,
    r: int,
    delta: float,
    assignment: Assignment,
    alive: np.ndarray,
    *,
    recovery_method: Optional[str] = None,
    impl: str = "auto",
    executor: Union[None, str, Executor] = None,
    session=None,
    device=None,
) -> ResilientPCAOutput:
    """Paper Algorithm 3, end to end, on ``device`` (the card by default).
    ``impl`` selects the body of the full-data :func:`pca_cost`;
    ``session`` shares the recovery cache, the packed shards and their
    device copy across calls."""
    from .kmedian import _session_for

    device = resolve_device(device)
    session = _session_for(assignment, recovery_method, executor, session)
    _, alive, rec, ex, _, _ = session.prepare(points, alive)
    pts, xs, _ = session.device_shards(device)
    r1 = relaxed_coreset_rank(r, delta)
    contributing = int(np.sum(alive & (rec.b_full > 0)))
    s, _, d = xs.shape
    # √b is applied on the device inside the per-node step; straggler
    # sketches come back as zero rows: zero singular values, inert below.
    y = local_relaxed_coresets(xs, r1, b_full=rec.b_full, executor=ex).reshape(s * r1, d)
    basis = centralized_pca(y, r)
    cost = float(pca_cost(pts, basis, impl=impl))
    return ResilientPCAOutput(
        basis=basis.cpu().numpy(), cost=cost, r1=r1, recovery=rec,
        # Communication proxy: only contributing nodes actually send rows.
        sketch_rows=contributing * r1,
    )
