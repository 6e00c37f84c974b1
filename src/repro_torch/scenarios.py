"""Scheme × scenario sweep of the elastic resilience runtime on the port.

Each cell drives one :class:`repro_torch.core.ResilienceSession` for
``rounds`` steps of a straggler scenario: observe the mask (elastic policy
armed, patience 2), then estimate the clustering cost with
``session.step_cost`` — alive mask in, recovery solved on the device,
Lemma-3 combine out.  Five schemes (``singleton``, ``cyclic``, ``fr``,
``bernoulli`` at ℓ = 2, and ``health``, which lets the placement optimizer
pick ℓ from the scenario's probed straggle profile) × four scenarios
(``iid``, ``fixed``, ``adversarial``, ``deadline``), at the paper's size
n = 320, s = 8, k = 4 by default.

The twin of ``benchmarks/bench_scenarios.py``: the same cells,
assignments, scenario streams and probes, so a cell's events, final
assignment and counters equal the reference's, and its costs agree to f32
rounding.  Each cell runs once per executor (``"local"``, ``"mesh"``: the
mesh executor on the default process group, a world of one in this process
when none exists) and comes back as a record instead of a printed row.

Run:  PYTHONPATH=src python -m repro_torch.scenarios [--device cuda|cpu]
[--executor local|mesh|both] (the card and both executors by default).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from .core import (
    ElasticPolicy,
    ResilienceSession,
    expected_completion_time,
    lloyd,
    make_assignment,
    make_scenario,
)
from .data.synthetic import gaussian_mixture
from .device import resolve_device

__all__ = ["SCHEMES", "SCENARIOS", "probe_health", "run"]

# "health" runs LAST, as in the reference's sweep.
SCHEMES = ("singleton", "cyclic", "fr", "bernoulli", "health")
SCENARIOS = ("iid", "fixed", "adversarial", "deadline")

# Long-run straggle-profile horizon of the probe (the reference's).
PROBE_ROUNDS = 24


def _assignment(scheme: str, n: int, s: int, seed: int, health=None):
    if scheme == "health":
        # ell=None: choose_ell picks the replication factor from the
        # probed health profile (flakier cluster → more replicas).
        return make_assignment("health", n, s, ell=None, health=health)
    return make_assignment(
        scheme, n, s, ell=2, rng=np.random.default_rng(seed)
        if scheme == "bernoulli" else None,
    )


def _scenario(name: str, s: int, assignment, seed: int):
    if name == "iid":
        return make_scenario("iid", s, p_straggler=0.15, seed=seed)
    if name == "fixed":
        return make_scenario("fixed", s, t=1, seed=seed)
    if name == "adversarial":
        return make_scenario("adversarial", s, assignment=assignment, t=1)
    if name == "deadline":
        # Persistent correlated spikes — the regime elastic re-assignment
        # exists for (spiked nodes never recover within the sweep).
        return make_scenario(
            "deadline", s, seed=seed, p_spike=0.06, persistence=1.0,
            spike_scale=6.0, deadline=2.0,
        )
    raise ValueError(name)


def probe_health(scen_name: str, n: int, s: int, seed: int) -> np.ndarray:
    """Per-node long-run straggle probability of a scenario: the fraction of
    the first PROBE_ROUNDS each node misses against a uniform cyclic
    reference.  One probe per scenario, shared by every scheme."""
    base = make_assignment("cyclic", n, s, ell=2)
    scen = _scenario(scen_name, s, base, seed)
    miss = np.zeros(s, dtype=np.float64)
    for _ in range(PROBE_ROUNDS):
        miss += ~np.asarray(next(scen).alive, dtype=bool)
    return miss / PROBE_ROUNDS


def run(
    pts: Optional[np.ndarray] = None,
    centers: Optional[np.ndarray] = None,
    *,
    n: int = 320,
    s: int = 8,
    k: int = 4,
    rounds: int = 5,
    seed: int = 0,
    device=None,
    executors: tuple[str, ...] = ("local",),
    verbose: bool = True,
) -> list[dict]:
    """The 20 cells, each once per executor; one record each.

    ``pts`` default to the reference sweep's ``gaussian_mixture(n, k, 3)``
    at ``seed``; ``centers`` to a 5-iteration k-median ``lloyd`` of them on
    ``device``.  A record holds the cell's ``scheme`` and ``scenario``, its
    initial ``assignment``, the per-round ``alive`` masks, ``events`` (the
    dicts of ``observe``) and ``costs`` (``step_cost``, ``None`` for an
    all-dead round), the ``final`` assignment, the session's ``stats``,
    ``health`` (``node_health()``), ``ect`` (expected completion time of the
    final assignment under the probed profile), the per-round ``seconds``
    and its ``executor``.
    """
    device = resolve_device(device)
    if pts is None:
        pts, _, _ = gaussian_mixture(n, k, 3, rng=np.random.default_rng(seed))
    pts = np.asarray(pts, np.float32)
    if centers is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        centers = lloyd(torch.from_numpy(pts).to(device), k, iters=5, median=True,
                        generator=gen).centers.cpu().numpy()
    probes = {name: probe_health(name, n, s, seed + 1) for name in SCENARIOS}
    cells = []
    for scheme in SCHEMES:
        for scen_name in SCENARIOS:
            for ex in executors:
                q = probes[scen_name]
                a = _assignment(scheme, n, s, seed, health=q)
                scen = _scenario(scen_name, s, a, seed + 1)
                sess = ResilienceSession(
                    a, executor=ex, elastic=ElasticPolicy(enabled=True, patience=2), device=device,
                )
                rec = {"scheme": scheme, "scenario": scen_name, "executor": ex, "assignment": a,
                       "alive": [], "events": [], "costs": [], "seconds": []}
                for _ in range(rounds):
                    r0 = time.perf_counter()
                    step = next(scen)
                    ev = sess.observe(step)
                    if ev["patched"] and hasattr(scen, "rebind"):
                        scen.rebind(sess.assignment)  # re-aim the adversary
                    alive = np.asarray(step.alive, bool)
                    cost = (sess.step_cost(pts, centers, alive, median=True)
                            if alive.any() else None)
                    rec["seconds"].append(time.perf_counter() - r0)
                    rec["alive"].append(alive)
                    rec["events"].append(ev)
                    rec["costs"].append(cost)
                rec.update(final=sess.assignment, stats=sess.stats.as_dict(),
                           health=sess.node_health(),
                           ect=expected_completion_time(sess.assignment, q))
                cells.append(rec)
                if verbose:
                    st = rec["stats"]
                    last = next((c for c in reversed(rec["costs"]) if c is not None), -1.0)
                    print(f"{scheme:>9s} × {scen_name:<11s} {ex:<5s} cost={last:.1f} "
                          f"host_solves={st['host_solves']} device_solves={st['device_solves']} "
                          f"patches={st['elastic_patches']} moved_blocks={st['moved_node_blocks']} "
                          f"uncovered_rounds={st['uncovered_rounds']} "
                          f"round_ms={1e3 * float(np.median(rec['seconds'])):.1f} "
                          f"ewma_max={float(rec['health'].max()):.2f} ect={rec['ect']:.4g}")
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to run (default: the card; raises without one)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--executor", choices=("local", "mesh", "both"), default="both")
    args = ap.parse_args(argv)
    executors = ("local", "mesh") if args.executor == "both" else (args.executor,)
    run(device=args.device, rounds=args.rounds, seed=args.seed, executors=executors)


if __name__ == "__main__":
    main()
