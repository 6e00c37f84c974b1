"""The paper's own workload and a scaled-up production variant (the twin
of the reference's ``configs/paper_kmedian.py``, copied: it holds no
framework code).

Not a transformer: the clustering pipeline of Algorithms 1–3.  These
configs parameterize the examples (Figure 1's scale) and a production-scale
variant used to reason about coordinator and worker sizing.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    name: str
    n: int  # points
    d: int  # dimensions
    k: int  # centers
    s: int  # workers
    t: int  # straggler bound
    p_a: float  # Bernoulli assignment rate (ell = p_a * s)
    delta: float = 0.5
    coreset_size: int = 256
    pca_r: int = 8


def paper_fig1() -> ClusteringConfig:
    """Exactly the paper's §4 experiment."""
    return ClusteringConfig(
        name="paper-fig1", n=5000, d=2, k=15, s=10, t=3, p_a=0.2
    )


def production_scale() -> ClusteringConfig:
    """A variant of 1e8 points × 64 dims over 256 workers.

    Per Theorem 6 the load is O(log n) shards a worker; with shards of
    4096 points, n_shards = 24414, ell = p_a·s = 25.6, so ~2441 shards
    (10M points, 2.5 GB in f32) a worker.
    """
    return ClusteringConfig(
        name="production", n=100_000_000, d=64, k=1024, s=256, t=25, p_a=0.1,
        coreset_size=4096, pca_r=32,
    )
