"""Weighted clustering engine: k-means++/k-median++ seeding + Lloyd iterations.

Every function takes one point set (n, d) or a batch of them (B, n, d), the
batch being the nodes of a distributed run: one kernel launch per step
covers all of them (the reference vmaps the same code).  Padding rows carry
weight 0, so they are inert in every statistic.  The assignment step uses
:mod:`repro_torch.kernels.pairwise_dist`; the update step uses
:mod:`repro_torch.kernels.weighted_segsum`.  The seeding keeps each point's
distance to its nearest chosen center and folds in one new center a step
(``min_dist_update``), where the reference reassigns every point to all k
center slots; the minimum is the same, only its rounding differs.  The
loops are Python loops with no host synchronisation inside them.

``median=True`` switches the update step from weighted means to weighted
geometric medians (Weiszfeld iterations) and the seeding/cost from d² to d —
the k-median objective of the paper's Algorithm 1.

Random draws come from an explicit ``torch.Generator`` on the data's device
(one seeded with 0 when none is given).  They differ from ``jax.random``'s stream, so parity
with the reference is checked with explicit ``init_centers``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..analysis import compiled_path
from ..kernels.pairwise_dist.ops import assign_min, min_dist_update
from ..kernels.pairwise_dist.ref import PAD_DIST, SCORE_FLOOR
from ..kernels.weighted_segsum.ops import weighted_segsum
from ..obs import trace_span
from .nodes import node_rand

__all__ = [
    "ClusteringResult",
    "plusplus_init",
    "lloyd",
    "clustering_cost",
    "resilient_cost",
]

# The seeding logits' floor (shared with ``min_dist_update``) and the
# Weiszfeld and mean divisions' guard.
_EPS = SCORE_FLOOR


class ClusteringResult(NamedTuple):
    centers: torch.Tensor     # (k, d) or (B, k, d)
    assignment: torch.Tensor  # (n,) or (B, n) i32
    cost: torch.Tensor        # () or (B,) f32 — Σ w·d (median) or Σ w·d² (means)


def _batched(x: torch.Tensor, weights: Optional[torch.Tensor]):
    """(x (B, n, d) f32, w (B, n) f32, single) from one set or a batch."""
    if x.dim() not in (2, 3):
        raise ValueError(f"expected points (n, d) or (B, n, d), got {tuple(x.shape)}")
    single = x.dim() == 2
    xb = (x.unsqueeze(0) if single else x).float().contiguous()
    if weights is None:
        w = torch.ones(xb.shape[:2], dtype=torch.float32, device=xb.device)
    else:
        w = weights.float().reshape(xb.shape[:2]).contiguous()
    return xb, w, single


def _generator(device: torch.device, generator: Optional[torch.Generator]):
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


def _logits(w: torch.Tensor, score: torch.Tensor) -> torch.Tensor:
    # Zero-weight rows (shard padding, straggler slots in fixed-shape unions)
    # get probability EXACTLY zero, not the _EPS floor — the floor applies
    # only to real points whose score underflows.
    return torch.where(
        w > 0, torch.log(torch.clamp_min(w * score, _EPS)), torch.full_like(w, -torch.inf)
    )


def _sample(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of (B, n) logits by Gumbel-max, as
    ``jax.random.categorical`` draws.  All -inf logits give row 0 (argmax
    over equal values), like the reference; no host check is needed.  On a
    mesh rank the uniforms are this block's rows of the whole node batch's
    draw (:func:`~repro_torch.core.nodes.node_rand`)."""
    u = node_rand(logits.shape, generator=gen, device=logits.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _plusplus_batched(x, w, k, median, gen, impl):
    B, n, d = x.shape
    rows = torch.arange(B, device=x.device)
    first = _sample(_logits(w, torch.ones_like(w)), gen)
    # Row 0 is the first chosen point; step i writes row i.
    centers = x[rows, first].unsqueeze(1).expand(B, k, d).contiguous()
    # Each point's squared distance to its nearest chosen center, carried
    # from step to step: a step folds in the one center the last one chose
    # (one pass over x) and gives the logits of the next draw.
    d2 = torch.full((B, n), PAD_DIST, dtype=torch.float32, device=x.device)
    for i in range(1, k):
        logits = min_dist_update(x, centers[:, i - 1], d2, w, median=median, impl=impl)
        centers[:, i] = x[rows, _sample(logits, gen)]
    return centers


def plusplus_init(
    x: torch.Tensor,
    k: int,
    *,
    weights: Optional[torch.Tensor] = None,
    median: bool = False,
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Weighted k-means++ (d²-sampling) / k-median++ (d-sampling) seeding."""
    xb, w, single = _batched(x, weights)
    with trace_span("kmeans.seed", B=xb.shape[0], n=xb.shape[1], k=k):
        centers = _plusplus_batched(xb, w, k, median, _generator(xb.device, generator), impl)
    return centers[0] if single else centers


def _weiszfeld_update(x, w, idx, centers, *, iters: int = 4, impl: str = "auto"):
    """Per-cluster weighted geometric median via Weiszfeld iterations."""
    k, d = centers.shape[-2:]
    gather = idx.long().unsqueeze(-1).expand(*idx.shape, d)
    for _ in range(iters):
        # Distance of each point to ITS cluster's current estimate.
        own = torch.gather(centers, 1, gather)
        dist = torch.sqrt(torch.clamp_min(torch.sum((x - own) ** 2, dim=-1), _EPS))
        sums, tot = weighted_segsum(x, w / dist, idx, k, impl=impl)
        new = sums / torch.clamp_min(tot, _EPS).unsqueeze(-1)
        # An empty cluster keeps its old estimate.
        centers = torch.where((tot > _EPS).unsqueeze(-1), new, centers)
    return centers


def lloyd(
    x: torch.Tensor,
    k: int,
    *,
    weights: Optional[torch.Tensor] = None,
    iters: int = 20,
    median: bool = False,
    weiszfeld_iters: int = 4,
    init_centers: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
) -> ClusteringResult:
    """Weighted Lloyd iterations from a ++-seeding (or given centers).

    ``impl`` selects the kernel implementation (see
    :mod:`repro_torch.kernels.dispatch`) for the assignment and update steps.
    """
    xb, w, single = _batched(x, weights)
    if init_centers is None:
        with trace_span("kmeans.seed", B=xb.shape[0], n=xb.shape[1], k=k):
            centers = _plusplus_batched(xb, w, k, median, _generator(xb.device, generator), impl)
    else:
        centers = init_centers.to(xb.device, torch.float32).reshape(xb.shape[0], k, -1).contiguous()
    with trace_span("kmeans.iterate", iters=iters, median=median):
        for _ in range(iters):
            idx, _ = assign_min(xb, centers, impl=impl)
            if median:
                centers = _weiszfeld_update(xb, w, idx, centers, iters=weiszfeld_iters, impl=impl)
            else:
                sums, tot = weighted_segsum(xb, w, idx, k, impl=impl)
                new = sums / torch.clamp_min(tot, _EPS).unsqueeze(-1)
                centers = torch.where((tot > _EPS).unsqueeze(-1), new, centers)
        idx, d2 = assign_min(xb, centers, impl=impl)
        dist = torch.sqrt(torch.clamp_min(d2, 0.0)) if median else d2
        cost = torch.sum(w * dist, dim=-1)
    if single:
        return ClusteringResult(centers[0], idx[0], cost[0])
    return ClusteringResult(centers, idx, cost)


def clustering_cost(
    x: torch.Tensor,
    centers: torch.Tensor,
    *,
    weights: Optional[torch.Tensor] = None,
    median: bool = False,
    impl: str = "auto",
) -> torch.Tensor:
    """cost(P, C, w): Σ w·d(p, C) (median) or Σ w·d²(p, C) (means).

    ``x`` (n, d) gives a scalar; (B, n, d) gives (B,), with ``centers``
    either shared (k, d) or per batch (B, k, d).
    """
    xb, w, single = _batched(x, weights)
    c = centers.to(xb.device, torch.float32)
    if c.dim() == 2:
        c = c.unsqueeze(0).expand(xb.shape[0], *c.shape)
    _, d2 = assign_min(xb, c.contiguous(), impl=impl)
    dist = torch.sqrt(torch.clamp_min(d2, 0.0)) if median else d2
    cost = torch.sum(w * dist, dim=-1)
    return cost[0] if single else cost


@compiled_path("kmeans.local_cost", kind="factory")
def _local_cost_fn(median: bool, impl: str):
    """Per-node shard cost against a broadcast center set (Lemma-3 ``f``),
    batched over the node axis: ``(xs (s, m, d), ws (s, m), centers (k, d))
    → (s,)``, one ``assign_min`` launch for every node."""

    def local_cost(xs, ws, centers):
        return clustering_cost(xs, centers, weights=ws, median=median, impl=impl)

    return local_cost


def resilient_cost(
    points,
    centers,
    assignment,
    alive,
    *,
    median: bool = False,
    recovery_method: Optional[str] = None,
    impl: str = "auto",
    executor=None,
    session=None,
    device=None,
) -> float:
    """Straggler-resilient estimate of cost(P, C) by Lemma 3.

    The clustering cost is additively decomposable, so each node evaluates
    its local shard cost and the recovery-weighted sum over the alive set
    satisfies ``cost ≤ Σ b_i·cost_i ≤ (1+δ)·cost``.  For the multi-round
    form with the recovery solve on the device, see
    :meth:`repro_torch.core.resilience.ResilienceSession.step_cost`.
    """
    from ..device import resolve_device
    from .kmedian import _session_for

    device = resolve_device(device)
    session = _session_for(assignment, recovery_method, executor, session)
    _, _, rec, ex, _, _ = session.prepare(points, alive)
    _, xs, ws = session.device_shards(device)
    c = torch.as_tensor(centers, dtype=torch.float32, device=device)
    b = torch.as_tensor(rec.b_full, dtype=torch.float32, device=device)
    return float(ex.resilient_reduce(_local_cost_fn(median, impl), (xs, ws), (c,), b))
