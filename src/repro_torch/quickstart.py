"""Quickstart: the paper's Figure-1 experiment, end to end, on the port.

n=5000 2-D Gaussian points (Fränti S1-style), s=10 workers, t=3 stragglers,
k=15 medians.  Compares:
  1. centralized k-median                      (reference)
  2. ignore-stragglers, non-redundant split    (paper Fig 1b)
  3. Algorithm 1, Bernoulli p_a=0.1            (Fig 1c)
  4. Algorithm 1, Bernoulli p_a=0.2            (Fig 1d)

Each Algorithm-1 line prints the recovery's ``feasible`` and the number of
``uncovered`` points beside its cost: at this seed both Bernoulli draws
leave points with no alive replica, so Property 1 does not hold there.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cuda|cpu]
(the card by default).  The twin of ``examples/quickstart.py``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .core import (
    bernoulli_assignment,
    fixed_count_stragglers,
    ignore_stragglers_kmedian,
    lloyd,
    node_loads,
    resilient_kmedian,
    singleton_assignment,
)
from .data.synthetic import franti_s1_like
from .device import resolve_device


def run(device=None, *, verbose: bool = True) -> dict[str, float]:
    """The four runs; returns their cost ratios to the centralized run."""
    device = resolve_device(device)
    n, s, t, k = 5000, 10, 3, 15
    pts, _, _ = franti_s1_like(n)
    alive = fixed_count_stragglers(s, t, np.random.default_rng(0))
    say = print if verbose else (lambda *a, **kw: None)
    say(f"dataset: n={n} d=2 k={k};  workers s={s}, stragglers t={t};  device={device}")
    say(f"straggling workers: {sorted(np.flatnonzero(~alive).tolist())}\n")

    central = lloyd(torch.from_numpy(pts).to(device), k, iters=40, median=True)
    ref = float(central.cost)
    ratios = {"centralized": 1.0}
    say(f"[1] centralized k-median                cost={ref:9.1f}  ratio=1.000")

    ign = ignore_stragglers_kmedian(
        pts, k, singleton_assignment(n, s), alive, local_iters=15, coord_iters=30,
        device=device,
    )
    ratios["ignore_stragglers"] = ign.cost / ref
    say(f"[2] ignore stragglers (no redundancy)   cost={ign.cost:9.1f}  ratio={ign.cost / ref:5.3f}")

    for tag, p_a in (("[3]", 0.1), ("[4]", 0.2)):
        a = bernoulli_assignment(n, s, ell=p_a * s, rng=np.random.default_rng(1))
        out = resilient_kmedian(
            pts, k, a, alive, local_iters=15, coord_iters=30, device=device
        )
        ratios[f"bernoulli_p{p_a}"] = out.cost / ref
        say(
            f"{tag} Algorithm 1, p_a={p_a}              cost={out.cost:9.1f}  "
            f"ratio={out.cost / ref:5.3f}   load/machine={node_loads(a).mean():.0f}  "
            f"delta={out.recovery.delta:.2f}  feasible={out.recovery.feasible}  "
            f"uncovered={len(out.recovery.uncovered)}"
        )
    return ratios


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the card; raises without one)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
