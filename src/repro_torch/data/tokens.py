"""Synthetic token pipelines for LM training/serving tests and examples (a
copy of the reference's ``data/tokens.py``: numpy only, so the port keeps
its own, and its streams equal the reference's bit for bit).

Deterministic per-shard streams (seeded by shard id + step) so that the
redundant pipeline's invariant — every replica of a shard sees *identical*
data — holds across groups and across restarts by construction.
"""

from __future__ import annotations

import numpy as np

__all__ = ["shard_batch", "markov_tokens", "make_markov_table"]


def make_markov_table(vocab: int, *, seed: int = 0, concentration: float = 0.3):
    """A sparse-ish Markov transition table — gives the LM something
    learnable so loss curves in tests/examples actually descend."""
    rng = np.random.default_rng(seed)
    logits = rng.gumbel(size=(vocab, vocab)) * concentration
    # Each row strongly prefers a handful of successors.
    fav = rng.integers(0, vocab, size=(vocab, 4))
    for v in range(vocab):
        logits[v, fav[v]] += 4.0
    p = np.exp(logits - logits.max(1, keepdims=True))
    return p / p.sum(1, keepdims=True)


def markov_tokens(table, n: int, T: int, *, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    V = table.shape[0]
    out = np.empty((n, T), dtype=np.int32)
    cur = rng.integers(0, V, size=n)
    out[:, 0] = cur
    for t in range(1, T):
        u = rng.random(n)
        cdf = table[cur].cumsum(axis=1)
        cur = (u[:, None] < cdf).argmax(axis=1)
        out[:, t] = cur
    return out


def shard_batch(table, shard_id: int, step: int, mb: int, T: int) -> np.ndarray:
    """The microbatch of shard ``shard_id`` at ``step`` — a pure function of
    (shard, step), which is what makes redundant replicas consistent."""
    return markov_tokens(table, mb, T, seed=(shard_id * 1_000_003 + step) & 0x7FFFFFFF)
