"""Recovery-weighted combining (Lemma 3) — the universal primitive.

Lemma 3 states that for an assignment with Property 1 and recovery vector
``b``, any additively-decomposable statistic ``F(P) = Σ_{p∈P} f(p)`` obeys

    F(P) ≤ Σ_{i∈R} b_i · F(P_i) ≤ (1+δ)·F(P).

:func:`resilient_sum` applies the combine to node-stacked tensors;
:func:`resilient_psum` is its form across the ranks of a mesh (a weighted
``all_reduce``, :mod:`repro_torch.launch.distributed`); :func:`mom_combine`
is a byzantine-robust median-of-means alternative; :func:`weighted_union`
builds the coordinator's weighted point set on the host.

Statistics may be a tensor or a tuple, named tuple, list or dict of
tensors, each with the node axis first.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["resilient_sum", "resilient_psum", "mom_combine", "weighted_union"]


def _tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of a tuple / named tuple / list /
    dict tree, leaves in the order of the tree (every rank of a mesh walks
    it the same way)."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, v) for key, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def resilient_sum(per_node_stats: Any, b_full) -> Any:
    """``Σ_i b_i · stat_i`` over every leaf, stacked on axis 0.

    ``b_full`` has one weight per node (zero for stragglers), so straggler
    contributions vanish regardless of their (stale/garbage) content.
    """

    def combine(leaf):
        leaf = torch.as_tensor(leaf)
        b = torch.as_tensor(b_full, device=leaf.device)
        w = b.reshape((-1,) + (1,) * (leaf.ndim - 1)).to(leaf.dtype)
        return torch.sum(w * leaf, dim=0)

    return _tree_map(combine, per_node_stats)


def resilient_psum(x: Any, my_weight, group) -> Any:
    """Lemma-3 combine across ranks: ``Σ_r w_r · x_r`` by one ``all_reduce``
    per leaf over the process group ``group``, the result on every rank.

    ``my_weight`` is this rank's weight (1.0 when ``x`` already carries the
    recovery weights of this rank's nodes, as after :func:`resilient_sum`).
    A rank whose nodes all straggle contributes zeros; the collective always
    runs, on every rank, in the order of the tree's leaves.
    """
    import torch.distributed as dist

    def combine(leaf):
        leaf = torch.as_tensor(leaf)
        out = leaf * torch.as_tensor(my_weight, dtype=leaf.dtype, device=leaf.device)
        dist.all_reduce(out, group=group)
        return out

    return _tree_map(combine, x)


def mom_combine(per_node_stats: Any, num_groups: int = 5) -> Any:
    """Median-of-means combine (byzantine-robust aggregator, beyond paper).

    Splits the node axis round-robin into ``num_groups`` buckets (every row
    used, bucket sizes within 1 of each other), averages within buckets, takes
    the coordinate-wise median across buckets and rescales by the node count.
    """

    def combine(leaf):
        leaf = torch.as_tensor(leaf).float()
        s = leaf.shape[0]
        g = max(1, min(num_groups, s))
        gid = torch.arange(s, device=leaf.device) % g
        sums = torch.zeros((g,) + tuple(leaf.shape[1:]), device=leaf.device)
        sums.index_add_(0, gid, leaf)
        counts = (s // g) + (torch.arange(g, device=leaf.device) < s % g).float()
        means = sums / counts.reshape((g,) + (1,) * (leaf.ndim - 1))
        # The mean of the two middle values for an even bucket count, as
        # jnp.median does (torch.median would return the lower one).
        return torch.quantile(means, 0.5, dim=0) * s

    return _tree_map(combine, per_node_stats)


def weighted_union(
    point_sets: Sequence[np.ndarray],
    weight_sets: Sequence[np.ndarray],
    b: np.ndarray,
    alive: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Union of per-node weighted point sets with Lemma-3 reweighting.

    Node ``i`` contributes points ``point_sets[i]`` with weights
    ``b_i · weight_sets[i]``.  ``alive`` selects contributing nodes
    (stragglers dropped).  Returns (points (m, d), weights (m,)).
    """
    pts, wts = [], []
    idx = range(len(point_sets)) if alive is None else np.flatnonzero(np.asarray(alive))
    for i in idx:
        if b[i] == 0.0 or len(point_sets[i]) == 0:
            continue
        pts.append(np.asarray(point_sets[i]))
        wts.append(float(b[i]) * np.asarray(weight_sets[i], dtype=np.float64))
    if not pts:
        raise ValueError("no surviving nodes with data — cannot form union")
    return np.concatenate(pts, axis=0), np.concatenate(wts, axis=0)
