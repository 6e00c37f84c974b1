"""ε-coresets via sensitivity sampling (paper §2.2, used by Algorithm 2).

Feldman–Langberg-style construction: a bicriteria solution ``B`` (k-means++
seeding plus a few Lloyd steps) gives per-point sensitivities

    σ_i  ∝  w_i·d²(x_i, B) / cost(P, B)  +  w_i / W(cluster(x_i))

Sampling ``m`` points with probabilities ``p_i ∝ σ_i`` and reweighting by
``w_i/(m·p_i)`` yields an ε-coreset w.h.p. with ``m = Õ(k·d/ε²)``.

Every function takes one point set (n, d) or a batch of them (B, n, d), the
batch being the nodes of a distributed run, as :mod:`.kmeans` does.  The
draws come from an explicit ``torch.Generator``: they sample the same
categorical distribution as the reference's ``jax.random.categorical`` on
the logits ``log(max(p, ε))`` (a row whose weights are all zero draws
uniformly, with weight 0), but from another stream.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from ..device import resolve_device
from ..kernels.pairwise_dist.ops import assign_min
from ..kernels.weighted_segsum.ops import weighted_segsum
from . import kmeans
from .executor import Executor
from .nodes import node_rand

__all__ = [
    "Coreset",
    "sensitivity_coreset",
    "uniform_coreset",
    "resilient_coreset",
    "merge_coresets",
]

_EPS = 1e-12


class Coreset(NamedTuple):
    points: torch.Tensor   # (m, d) or (B, m, d)
    weights: torch.Tensor  # (m,) or (B, m)


def _sensitivities(x, w, centers, *, squared: bool, impl: str = "auto") -> torch.Tensor:
    """Sampling probabilities p (B, n) ∝ the sensitivities of x (B, n, d),
    weights w (B, n), against the bicriteria centers (B, k_b, d).
    Zero-weight rows get p = 0."""
    k_b = centers.shape[-2]
    idx, d2 = assign_min(x, centers, impl=impl)
    dist = d2 if squared else torch.sqrt(torch.clamp_min(d2, 0.0))
    total = torch.clamp_min(torch.sum(w * dist, dim=-1, keepdim=True), _EPS)
    _, cluster_w = weighted_segsum(x, w, idx, k_b, impl=impl)
    own_w = torch.gather(cluster_w, -1, idx.long())
    sens = w * dist / total + w / torch.clamp_min(own_w, _EPS)
    sens = torch.where(w > 0, sens, torch.zeros_like(sens))  # padded rows never sampled
    return sens / torch.clamp_min(torch.sum(sens, dim=-1, keepdim=True), _EPS)


def _draw(x, w, p, m: int, gen: torch.Generator) -> Coreset:
    """m draws with replacement per row of p (B, n) from the categorical
    distribution of the logits log(max(p, ε)), reweighted by w/(m·p).

    The draws invert the distribution's CDF (in float64): the same
    distribution as the reference's Gumbel-max draw, without its (m, n)
    noise tensor."""
    q = torch.clamp_min(p.double(), _EPS)
    cdf = torch.cumsum(q, dim=-1)
    u = node_rand((p.shape[0], m), generator=gen, dtype=torch.float64, device=p.device)
    picks = torch.searchsorted(cdf, u * cdf[:, -1:], right=True).clamp_max(p.shape[-1] - 1)
    cw = torch.gather(w, -1, picks) / (m * torch.clamp_min(torch.gather(p, -1, picks), _EPS))
    pts = torch.gather(x, 1, picks.unsqueeze(-1).expand(-1, -1, x.shape[-1]))
    return Coreset(points=pts, weights=cw)


def _unbatch(cs: Coreset, single: bool) -> Coreset:
    return Coreset(cs.points[0], cs.weights[0]) if single else cs


def sensitivity_coreset(
    x: torch.Tensor,
    k: int,
    m: int,
    *,
    weights: Optional[torch.Tensor] = None,
    squared: bool = True,
    bicriteria_iters: int = 5,
    generator: Optional[torch.Generator] = None,
    impl: str = "auto",
) -> Coreset:
    """Sensitivity-sampled ε-coreset of size ``m`` for k-means (squared=True)
    or k-median (squared=False) cost.  ``impl`` selects the kernel
    implementation (:mod:`repro_torch.kernels.dispatch`)."""
    xb, w, single = kmeans._batched(x, weights)
    gen = kmeans._generator(xb.device, generator)
    k_b = min(2 * k, xb.shape[1])  # bicriteria center count
    bic = kmeans.lloyd(
        xb, k_b, weights=w, iters=bicriteria_iters, median=not squared, generator=gen, impl=impl
    )
    p = _sensitivities(xb, w, bic.centers, squared=squared, impl=impl)
    return _unbatch(_draw(xb, w, p, m, gen), single)


def _reduce(x, w, *, k: int, m: int, squared: bool, bicriteria_iters: int, impl: str,
            generator: torch.Generator) -> Coreset:
    """Weighted sensitivity coreset of an (already weighted) summary: the
    *reduce* half of merge-and-reduce."""
    return sensitivity_coreset(
        x, k, m, weights=w, squared=squared, bicriteria_iters=bicriteria_iters,
        generator=generator, impl=impl,
    )


def _local_coreset(x, w, b, **kw) -> Coreset:
    """Every node's sensitivity coreset, batched over the node axis, with the
    Lemma-3 ``b`` weighting applied on the device."""
    cs = _reduce(x, w, **kw)
    return Coreset(cs.points, b.unsqueeze(-1).to(cs.weights.dtype) * cs.weights)


def resilient_coreset(
    points,
    k: int,
    m_per_node: int,
    assignment,
    alive,
    *,
    recovery_method: Optional[str] = None,
    squared: bool = True,
    bicriteria_iters: int = 5,
    seed: int = 0,
    impl: str = "auto",
    executor: Union[None, str, Executor] = None,
    session=None,
    device=None,
) -> Coreset:
    """Straggler-resilient distributed coreset (the communication primitive of
    Algorithm 2): every node samples an ``m_per_node``-point sensitivity
    coreset of its shard; the coordinator keeps the b-reweighted union, which
    is a ``2(ε+δ)``-coreset of the full set by Lemma 3'.

    The union keeps the fixed ``(s·m_per_node,)`` stacked shape: straggler
    rows carry weight 0 and are inert in any weighted solve downstream.
    Runs on ``device`` (the card by default); ``session`` shares the
    recovery cache, the packed shards and their device copy across calls.
    """
    from .kmedian import _session_for

    device = resolve_device(device)
    session = _session_for(assignment, recovery_method, executor, session)
    _, _, rec, ex, _, _ = session.prepare(points, alive)
    _, xs, ws = session.device_shards(device)
    s, _, d = xs.shape
    b = torch.as_tensor(rec.b_full, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def fn(x, w, b):
        return _local_coreset(
            x, w, b, k=k, m=m_per_node, squared=squared,
            bicriteria_iters=bicriteria_iters, impl=impl, generator=gen,
        )

    pts, wts = ex.map_nodes(fn, (xs, ws, b))
    return Coreset(points=pts.reshape(s * m_per_node, d), weights=wts.reshape(s * m_per_node))


def merge_coresets(*coresets: Coreset) -> Coreset:
    """Feldman–Langberg merge: the concatenation of ε-coresets of disjoint
    sets is an ε-coreset of their union (cost is additive and each summand is
    preserved to 1±ε): the *merge* half of merge-and-reduce."""
    if not coresets:
        raise ValueError("merge_coresets needs at least one coreset")
    return Coreset(
        points=torch.cat([c.points for c in coresets], dim=0),
        weights=torch.cat([c.weights for c in coresets], dim=0),
    )


def uniform_coreset(
    x: torch.Tensor,
    m: int,
    *,
    weights: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Coreset:
    """Uniform-sampling baseline (no sensitivity; weaker guarantee)."""
    xb, w, single = kmeans._batched(x, weights)
    p = w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), _EPS)
    return _unbatch(_draw(xb, w, p, m, kmeans._generator(xb.device, generator)), single)
