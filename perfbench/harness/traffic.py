"""The one traffic generator: it reads a traffic mix's parameters
(``traffic/<name>.json``) and the run's ``--seed`` and gives every unit of
work (a solve, a training step) what it needs: an alive mask over the
workers and a seed of its own.

Straggler patterns (``"stragglers"``):

* ``{"kind": "exact", "t": t}``: exactly ``t`` of the ``nodes`` workers
  straggle.  The patterns are all ``C(nodes, t)`` sets, in an order drawn
  from the seed and without repeats until every one has come, so every seed
  gives the same set of patterns in another order.
* ``{"kind": "iid", "p": p}``: each worker straggles independently with
  probability ``p``; a mask with no alive worker is drawn again.  With
  ``"lose_every": L`` and a coverage test (does every data shard keep an
  alive holder?), unit ``u`` is drawn from the same law conditioned on
  losing a shard where ``u % L == phase`` (``"lose_phase"``, by default
  ``L − 1``) and on keeping every shard elsewhere: the units that lose a
  shard sit at the same places for every seed, at about the rate the law
  gives them, so a seed changes which patterns come and not how much data
  a window trains on.

Every stream comes from ``numpy.random.SeedSequence([seed, stream])``, so
any whole seed, however large, works and the streams do not overlap.
"""

from __future__ import annotations

import itertools

import numpy as np

STREAM_MASKS, STREAM_UNITS = 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), int(stream)]))


def alive_masks(spec: dict, nodes: int, seed: int, count: int, covers=None) -> np.ndarray:
    """``(count, nodes)`` bool: the alive mask of each unit of work.
    ``covers(mask) -> bool`` is the coverage test that ``lose_every`` needs."""
    r = rng(seed, STREAM_MASKS)
    kind = spec["kind"]
    if kind == "exact":
        t = int(spec["t"])
        patterns = [np.array(c) for c in itertools.combinations(range(nodes), t)]
        out = []
        while len(out) < count:
            out.extend(patterns[i] for i in r.permutation(len(patterns)))
        masks = np.ones((count, nodes), dtype=bool)
        for row, dead in zip(masks, out[:count]):
            row[dead] = False
        return masks
    if kind == "iid":
        p = float(spec["p"])
        every = spec.get("lose_every")
        phase = None if every is None else int(spec.get("lose_phase", int(every) - 1))
        masks = np.zeros((count, nodes), dtype=bool)
        for i in range(count):
            want = None if every is None else i % int(every) != phase
            while True:
                m = r.random(nodes) >= p
                if m.any() and (want is None or covers(m) == want):
                    break
            masks[i] = m
        return masks
    raise ValueError(f"unknown straggler kind {kind!r}")


def unit_seeds(seed: int, count: int) -> list[int]:
    """A seed for each unit of work (a solve's random draws)."""
    return [int(x) for x in rng(seed, STREAM_UNITS).integers(0, 2**31 - 1, size=count)]
