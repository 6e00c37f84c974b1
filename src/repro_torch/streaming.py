"""Streaming walkthrough on the port: resilient clustering of an endless
point stream.

A `repro_torch.stream.StreamingSession` turns the paper's one-shot
pipeline into an always-on service: batches arrive, a merge-and-reduce
coreset tree keeps a bounded-memory summary whose buckets are redundantly
assigned to worker nodes (so stragglers mid-compaction lose nothing),
`solve()` refreshes a k-median model from the tree frontier, and `query()`
serves nearest-center answers with an explicit staleness bound.

Run:  PYTHONPATH=src python -m repro_torch.streaming [--device cuda|cpu]
(the card by default).  The twin of ``examples/streaming_clustering.py``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import make_scenario
from .data.synthetic import gaussian_mixture
from .device import resolve_device
from .stream import StreamingSession


def run(device=None, *, verbose: bool = True) -> dict:
    """The walkthrough; returns the max center error and the final stats."""
    device = resolve_device(device)
    say = print if verbose else (lambda *a, **kw: None)
    d, k, s = 2, 5, 6
    rng = np.random.default_rng(0)
    # One fixed mixture; batches are fresh draws from it (a stationary stream).
    _, truth_centers, _ = gaussian_mixture(10, k, d, rng=np.random.default_rng(1))

    def next_batch(n=300):
        labels = rng.integers(0, k, size=n)
        return (truth_centers[labels] + rng.normal(scale=0.05, size=(n, d))).astype(np.float32)

    sess = StreamingSession(
        d, k,
        num_nodes=s, fanout=3, leaf_size=192, coreset_size=48,
        scenario=make_scenario("iid", s, p_straggler=0.2, seed=2),
        seed=0, device=device,
    )
    say(f"stream: d={d} k={k}; s={s} worker nodes, iid stragglers p=0.2;  device={device}")
    say(f"tree: leaf={sess.buffer.leaf_size} fanout={sess.buffer.fanout} "
        f"m={sess.buffer.m} (scheme {sess.resilience.assignment.scheme})\n")

    for i in range(8):
        rep = sess.ingest(next_batch())
        dead = int((~rep["alive"]).sum())
        say(f"ingest {i}: stragglers={dead} leaves={rep['leaves']} "
            f"compactions={rep['compactions']} buckets={rep['buckets']} "
            f"levels={rep['levels']}")

    out = sess.solve(iters=15)
    # Model quality: every serving center should sit near a true center.
    centers = out.centers.cpu().numpy()
    err = np.sqrt(((centers[:, None] - truth_centers[None]) ** 2).sum(-1)).min(1)
    say(f"\nsolve: frontier={out.frontier_size} rows "
        f"(of {sess.stats['ingested_points']} ingested), cost={out.cost:.2f}, "
        f"max center error={err.max():.3f}")

    res = sess.query(next_batch(64))
    say(f"query: 64 points -> cluster ids {np.bincount(res.indices, minlength=k)}"
        f" (staleness: {res.staleness_points} points, v{res.version})")
    sess.ingest(next_batch())
    res = sess.query(next_batch(16))
    say(f"after one more ingest: staleness={res.staleness_points} points "
        f"({res.staleness_ingests} ingests behind)")

    st = sess.stats
    say(f"\nrecovery: host_solves={st['recovery_host_solves']} "
        f"cache_hits={st['recovery_cache_hits']} "
        f"blocking_compactions={st['blocking_compactions']} "
        f"patches={st['recovery_elastic_patches']}")
    if err.max() >= 0.2:
        raise AssertionError("streaming model drifted off the planted centers")
    return {"max_center_error": float(err.max()), "stats": st}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the card; raises without one)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
