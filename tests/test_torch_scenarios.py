"""The slice as a whole: the scheme × scenario sweep of
``benchmarks/bench_scenarios.py`` (its local grid: 5 schemes × 4 scenarios ×
5 rounds, n = 320, s = 8, k = 4) on both packages, on the CPU.

The port's side is :func:`repro_torch.scenarios.run`; the reference's side
drives the reference's own ``ResilienceSession`` through the same loop with
the sweep's own cell helpers.  Both get the same points (the sweep's
``gaussian_mixture``) and the same centers (the reference's ``lloyd``).

Exact: every event dict, every final assignment matrix, the probed health
profiles and the counters ``host_solves``, ``device_solves``,
``elastic_patches``, ``moved_node_blocks``, ``full_repacks``,
``cache_invalidations`` and ``uncovered_rounds`` (the scenario streams,
assignments and the elastic state machine are numpy on both sides).
Within 1e-6 absolute: ``node_health()``.  Within 1e-5 relative: each
round's ``step_cost`` (the device solve and the combine sum f32 in other
orders).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import ElasticPolicy as JElastic
from repro.core import ResilienceSession as JSession
from repro.core import lloyd as j_lloyd
from repro.data.synthetic import gaussian_mixture
from repro_torch import scenarios as t_scen
from repro_torch.obs import MetricsRegistry, set_default_registry

ROOT = Path(__file__).resolve().parents[1]
N, S, K, ROUNDS, SEED = 320, 8, 4, 5, 0
COUNTERS = ("host_solves", "device_solves", "elastic_patches", "moved_node_blocks",
            "full_repacks", "cache_invalidations", "uncovered_rounds")
CELLS = [(scheme, scen) for scheme in t_scen.SCHEMES for scen in t_scen.SCENARIOS]


def _bench():
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import bench_scenarios
    finally:
        sys.path.pop(0)
    return bench_scenarios


def _reference_grid(pts, centers):
    bench = _bench()
    probes = {name: bench._probe_health(name, N, S, SEED + 1, None) for name in bench.SCENARIOS}
    cells = {}
    for scheme in bench.SCHEMES:
        for scen_name in bench.SCENARIOS:
            a = bench._assignment(scheme, N, S, SEED, health=probes[scen_name])
            scen = bench._scenario(scen_name, S, a, SEED + 1)
            sess = JSession(a, executor="local", elastic=JElastic(enabled=True, patience=2))
            events, costs = [], []
            for _ in range(ROUNDS):
                step = next(scen)
                ev = sess.observe(step)
                if ev["patched"] and hasattr(scen, "rebind"):
                    scen.rebind(sess.assignment)
                events.append(ev)
                costs.append(sess.step_cost(pts, centers, step.alive, median=True)
                             if step.alive.any() else None)
            cells[(scheme, scen_name)] = {
                "events": events, "costs": costs, "final": sess.assignment,
                "stats": sess.stats.as_dict(), "health": sess.node_health(),
            }
    return probes, cells


@pytest.fixture(scope="module")
def grids():
    prev = set_default_registry(MetricsRegistry())
    try:
        pts, _, _ = gaussian_mixture(N, K, 3, rng=np.random.default_rng(SEED))
        pts = np.asarray(pts, np.float32)
        centers = np.asarray(
            j_lloyd(jax.random.PRNGKey(SEED), jnp.asarray(pts), K, iters=5, median=True).centers)
        ours = {(c["scheme"], c["scenario"]): c for c in t_scen.run(
            pts, centers, n=N, s=S, k=K, rounds=ROUNDS, seed=SEED, device="cpu", verbose=False)}
        probes, ref = _reference_grid(pts, centers)
        yield ours, ref, probes
    finally:
        set_default_registry(prev)


def test_the_grid_has_every_cell_and_probe(grids):
    ours, ref, probes = grids
    assert sorted(ours) == sorted(ref) == sorted(CELLS)
    bench = _bench()
    assert t_scen.SCHEMES == bench.SCHEMES and t_scen.SCENARIOS == bench.SCENARIOS
    for name, q in probes.items():
        np.testing.assert_array_equal(t_scen.probe_health(name, N, S, SEED + 1), q)
    assert any(c["stats"]["elastic_patches"] > 0 for c in ours.values())
    assert any(c["stats"]["moved_node_blocks"] > 0 for c in ours.values())
    assert all(c["stats"]["host_solves"] == 0 for c in ours.values())


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cell_events_assignment_and_counters_equal_the_reference(grids, cell):
    ours, ref, _ = grids
    got, want = ours[cell], ref[cell]
    assert got["events"] == want["events"]
    np.testing.assert_array_equal(got["final"].matrix, want["final"].matrix)
    assert got["final"].scheme == want["final"].scheme
    assert {k: got["stats"][k] for k in COUNTERS} == {k: want["stats"][k] for k in COUNTERS}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_cell_costs_and_health_agree_with_the_reference(grids, cell):
    ours, ref, _ = grids
    got, want = ours[cell], ref[cell]
    np.testing.assert_allclose(got["health"], want["health"], rtol=0, atol=1e-6)
    assert len(got["costs"]) == len(want["costs"]) == ROUNDS
    for c_got, c_want in zip(got["costs"], want["costs"]):
        assert (c_got is None) == (c_want is None)
        if c_want is not None:
            assert c_got == pytest.approx(c_want, rel=1e-5)
