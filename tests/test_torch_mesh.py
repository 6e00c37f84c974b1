"""The port's mesh executor (``torch.distributed``) on the CPU, over gloo.

Twins of ``tests/test_distributed_executor.py``, of the session's mesh
tests in ``tests/test_resilience.py`` and of the stream's in
``tests/test_stream.py``.  The reference runs one process over forced host
devices; the port runs one process per rank (``run_ranks``: ``spawn``, a
``FileStore``, its own deadline on every start of the ranks), and every
rank runs the same program.  World 1 runs in this process (the default
group of ``get_executor("mesh")``); the three 8-device twins share one
start of 8 ranks (module fixture), the placement checks one of 4; the
launcher, its CLI and the smoke script's rank program start 2.

Tolerances are the reference's: local↔mesh 1e-5 relative on costs (the
combine sums f32 in another order), 1e-5 absolute on frontiers; the
Figure-1 costs in the 5% band of ``tests/test_torch_kmedian.py`` of the
reference's local costs, over eight seeds (``torch.Generator`` and
``jax.random`` draw different streams).  Per-node draws do not depend on the block that holds
the node: bit for bit.
"""

import functools
import operator
import os
import time

import numpy as np
import pytest
import torch

from repro_torch.core import (
    Executor,
    LocalExecutor,
    ResilienceSession,
    bernoulli_assignment,
    clustering_cost,
    cyclic_assignment,
    fixed_count_stragglers,
    fractional_repetition_assignment,
    get_executor,
    ignore_stragglers_kmedian,
    lloyd,
    make_scenario,
    resilient_coreset,
    resilient_cost,
    resilient_kmedian,
    resilient_pca,
)
from repro_torch.core import coreset as t_coreset
from repro_torch.core import kmeans as t_kmeans
from repro_torch.core.nodes import NodeBlock, block_bounds, drawing_block
from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh_runs
from repro_torch.stream import StreamingSession

CPU = "cpu"
DEADLINE = 240.0  # seconds for one start of the ranks, setup to exit


def _ranks(fn, world, args=()):
    return D.run_ranks(fn, world, backend="gloo", device=CPU, timeout=DEADLINE, args=args)


def _small_problem(n=300, s=6, t=2, seed=0):
    pts, _, _ = gaussian_mixture(n, 5, 3, rng=np.random.default_rng(seed))
    a = bernoulli_assignment(n, s, ell=2.0, rng=np.random.default_rng(seed + 1))
    alive = fixed_count_stragglers(s, t, np.random.default_rng(seed + 2))
    return pts, a, alive


def _multiround_centers():
    import jax
    import jax.numpy as jnp

    from repro.core import lloyd as j_lloyd

    pts = np.random.default_rng(0).normal(size=(160, 3)).astype(np.float32)
    return np.asarray(j_lloyd(jax.random.PRNGKey(0), jnp.asarray(pts), 3, iters=4).centers)


@pytest.fixture(scope="module")
def eight():
    """The three 8-device twins, one start of 8 ranks."""
    centers = _multiround_centers()
    t0 = time.perf_counter()
    out = _ranks(mesh_runs.eight_rank_twins, 8, args=(centers,))
    out["seconds"] = time.perf_counter() - t0
    out["centers"] = centers
    return out


@pytest.fixture(scope="module")
def four():
    return _ranks(mesh_runs.update_rows_rank, 4)


# ------------------------------------------------------- in-process (world 1)


def test_get_executor_resolution():
    assert isinstance(get_executor(None), LocalExecutor)
    assert get_executor("local") is get_executor(None), "singleton reuse"
    mesh = get_executor("mesh")
    assert isinstance(mesh, Executor) and isinstance(mesh, D.MeshExecutor) and mesh.name == "mesh"
    assert get_executor("mesh") is mesh
    assert get_executor(mesh) is mesh
    assert mesh.describe() == "mesh[1xcpu/gloo]" and mesh.num_devices == 1
    with pytest.raises(ValueError):
        get_executor("cluster-of-toasters")


def test_kmedian_mesh_matches_local_world_1():
    pts, a, alive = _small_problem()
    kw = dict(local_iters=5, coord_iters=8, device=CPU)
    out_l = resilient_kmedian(pts, 4, a, alive, **kw)
    out_m = resilient_kmedian(pts, 4, a, alive, executor="mesh", **kw)
    assert out_m.cost == pytest.approx(out_l.cost, rel=1e-5)
    np.testing.assert_allclose(out_m.centers, out_l.centers, rtol=1e-5, atol=1e-6)


def test_pca_and_coreset_mesh_match_local_world_1():
    pts, a, alive = _small_problem(seed=7)
    p_l = resilient_pca(pts, 2, 0.5, a, alive, device=CPU)
    p_m = resilient_pca(pts, 2, 0.5, a, alive, executor="mesh", device=CPU)
    assert p_m.cost == pytest.approx(p_l.cost, rel=1e-5, abs=1e-7)
    assert p_m.sketch_rows == p_l.sketch_rows
    cs_l = resilient_coreset(pts, 4, 32, a, alive, device=CPU)
    cs_m = resilient_coreset(pts, 4, 32, a, alive, executor="mesh", device=CPU)
    np.testing.assert_allclose(cs_m.weights.numpy(), cs_l.weights.numpy(), rtol=1e-5)
    np.testing.assert_allclose(cs_m.points.numpy(), cs_l.points.numpy(), rtol=1e-5, atol=1e-6)


def test_resilient_cost_lemma3_band_both_executors():
    """Σ b·cost_i brackets the true cost (FR: δ = 0, an exact band)."""
    pts, _, _ = gaussian_mixture(240, 4, 3, rng=np.random.default_rng(3))
    a = fractional_repetition_assignment(len(pts), 6, 2)
    alive = fixed_count_stragglers(6, 1, np.random.default_rng(4))
    x = torch.from_numpy(pts)
    centers = lloyd(x, 4, iters=5, generator=torch.Generator().manual_seed(0)).centers
    true = float(clustering_cost(x, centers))
    for ex in ("local", "mesh"):
        est = resilient_cost(pts, centers.numpy(), a, alive, executor=ex, device=CPU)
        assert true * (1.0 - 1e-5) <= est <= true * (1.0 + 1e-4), ex


def test_all_dead_raises_through_the_mesh():
    pts, a, _ = _small_problem()
    dead = np.zeros(a.num_nodes, dtype=bool)
    centers = np.zeros((3, pts.shape[1]), np.float32)
    kw = dict(executor="mesh", device=CPU)
    for call in (
        lambda: resilient_kmedian(pts, 3, a, dead, local_iters=2, coord_iters=2, **kw),
        lambda: ignore_stragglers_kmedian(pts, 3, a, dead, local_iters=2, coord_iters=2, **kw),
        lambda: resilient_pca(pts, 2, 0.5, a, dead, **kw),
        lambda: resilient_coreset(pts, 3, 16, a, dead, **kw),
        lambda: resilient_cost(pts, centers, a, dead, **kw),
        lambda: ResilienceSession(a, executor="mesh", device=CPU).step_cost(pts, centers, dead),
    ):
        with pytest.raises(ValueError, match="no surviving"):
            call()


def test_straggler_pattern_is_data_not_executor_state():
    """A new alive mask is an input: the executor keeps no per-pattern
    state, and a session's step_cost solves it on the device (no host LP)."""
    pts, a, _ = _small_problem(seed=11)
    ex = get_executor("mesh")

    def state():
        return {k: (type(v), len(v) if hasattr(v, "__len__") else v) for k, v in vars(ex).items()}

    alive1 = fixed_count_stragglers(a.num_nodes, 1, np.random.default_rng(0))
    alive2 = fixed_count_stragglers(a.num_nodes, 2, np.random.default_rng(5))
    resilient_kmedian(pts, 4, a, alive1, local_iters=3, coord_iters=4, executor=ex, device=CPU)
    before = state()
    out = resilient_kmedian(pts, 4, a, alive2, local_iters=3, coord_iters=4, executor=ex, device=CPU)
    assert state() == before and np.isfinite(out.cost)
    sess = ResilienceSession(a, executor=ex, device=CPU)
    centers = out.centers
    costs = [sess.step_cost(pts, centers, al) for al in (alive1, alive2, ~alive1 | alive2)]
    assert state() == before and all(np.isfinite(costs))
    assert sess.stats.host_solves == 0 and sess.stats.device_solves == 3


def test_update_node_rows_mesh_world_1():
    ex = get_executor("mesh")
    arr = ex.place_node_stacked(np.arange(12, dtype=np.float32).reshape(6, 2), CPU)
    assert isinstance(arr, NodeBlock) and arr.shape == (6, 2) and arr.offset == 0
    out = ex.update_node_rows(arr, [1, 4], np.full((2, 2), 7.0, np.float32))
    want = np.arange(12, dtype=np.float32).reshape(6, 2)
    want[[1, 4]] = 7.0
    assert out is arr
    np.testing.assert_array_equal(ex.gather_node_stacked(out).numpy(), want)


def test_session_mesh_matches_local_world_1():
    pts = np.random.default_rng(9).normal(size=(140, 3)).astype(np.float32)
    a = cyclic_assignment(140, 6, 2)
    alive = fixed_count_stragglers(6, 1, np.random.default_rng(4))
    centers = lloyd(torch.from_numpy(pts), 3, iters=4, generator=torch.Generator().manual_seed(1)).centers
    sl = ResilienceSession(a, device=CPU)
    sm = ResilienceSession(a, executor="mesh", device=CPU)
    assert sm.step_cost(pts, centers, alive) == pytest.approx(sl.step_cost(pts, centers, alive), rel=1e-5)
    kl = sl.kmedian(pts, 3, alive, local_iters=3, coord_iters=4)
    km = sm.kmedian(pts, 3, alive, local_iters=3, coord_iters=4)
    assert km.cost == pytest.approx(kl.cost, rel=1e-5)


def test_streaming_session_mesh_world_1_matches_local():
    rng = np.random.default_rng(12)
    batches = [rng.normal(size=(128, 2)).astype(np.float32) for _ in range(5)]
    costs = []
    for ex in (None, "mesh"):
        sess = StreamingSession(2, 3, num_nodes=6, fanout=3, leaf_size=64, coreset_size=16,
                                scenario=make_scenario("iid", 6, p_straggler=0.2, seed=3),
                                executor=ex, seed=0, device=CPU)
        for b in batches:
            sess.ingest(b)
        costs.append(sess.solve(iters=6).cost)
    assert costs[1] == pytest.approx(costs[0], rel=1e-5)


# ------------------------------------------- the port's mesh vs the reference's


@pytest.mark.parametrize("entry", ["resilient_cost", "step_cost"])
def test_port_mesh_matches_reference_mesh(entry):
    """World 1 against the reference's one-device mesh, the same inputs:
    no random draw enters either.  The centers are Lloyd means, not data
    points: at a zero distance the ‖x‖² + ‖c‖² − 2x·c of both packages
    cancels to rounding, which the median cost's square root magnifies."""
    from repro.core import ResilienceSession as JSession
    from repro.core import cyclic_assignment as j_cyclic
    from repro.core import resilient_cost as j_resilient_cost

    pts, _, _ = gaussian_mixture(200, 4, 3, rng=np.random.default_rng(21))
    centers = lloyd(torch.from_numpy(pts), 4, iters=5, generator=torch.Generator().manual_seed(0)).centers.numpy()
    alive = fixed_count_stragglers(8, 2, np.random.default_rng(22))
    if entry == "resilient_cost":
        from repro.core import bernoulli_assignment as j_bern

        a, ja = (fn(200, 8, ell=3.0, rng=np.random.default_rng(23)) for fn in (bernoulli_assignment, j_bern))
        assert np.array_equal(a.matrix, ja.matrix)
        ours = resilient_cost(pts, centers, a, alive, median=True, executor="mesh", device=CPU)
        theirs = j_resilient_cost(pts, centers, ja, alive, median=True, executor="mesh")
    else:
        ours = ResilienceSession(cyclic_assignment(200, 8, 3), executor="mesh", device=CPU).step_cost(
            pts, centers, alive, median=True)
        theirs = JSession(j_cyclic(200, 8, 3), executor="mesh").step_cost(pts, centers, alive, median=True)
    assert ours == pytest.approx(float(theirs), rel=1e-5)


# ---------------------------------------------------- block-invariant draws


@pytest.mark.parametrize("world", [2, 3, 4, 8])
def test_node_draws_do_not_depend_on_the_block(world):
    """A per-node ++ seeding and a coreset draw over all s nodes equal the
    concatenation of the same calls on each rank's block, bit for bit."""
    pts, a, _ = _small_problem(n=400, s=7, seed=31)
    from repro_torch.core.kmedian import pack_local_shards

    xs, ws = (torch.from_numpy(v) for v in pack_local_shards(pts, a))
    s = xs.shape[0]

    def seeding(x, w):
        return t_kmeans.plusplus_init(x, 5, weights=w, median=True,
                                      generator=torch.Generator().manual_seed(7))

    def coreset(x, w):
        cs = t_coreset.sensitivity_coreset(x, 3, 24, weights=w,
                                           generator=torch.Generator().manual_seed(8))
        return torch.cat([cs.points, cs.weights.unsqueeze(-1)], dim=-1)

    for fn in (seeding, coreset):
        whole = fn(xs, ws)
        parts = []
        for r in range(world):
            off, rows = block_bounds(s, world, r)
            x = torch.zeros((rows, *xs.shape[1:]))
            w = torch.zeros((rows, ws.shape[1]))
            real = max(0, min(rows, s - off))
            x[:real], w[:real] = xs[off: off + real], ws[off: off + real]
            with drawing_block(off, rows, s):
                out = fn(x, w)
            assert torch.isfinite(out).all(), "padded nodes must stay finite"
            parts.append(out[:real])
        assert torch.equal(torch.cat(parts), whole), fn.__name__


# ------------------------------------------------------------- 4 ranks


def test_update_node_rows_world_4_writes_only_the_owning_block(four):
    want = np.arange(24, dtype=np.float32).reshape(6, 4)
    want[[1, 4]] = 7.0
    np.testing.assert_array_equal(four["whole"], want)
    ranks = four["ranks"]
    assert [r["offset"] for r in ranks] == [0, 2, 4, 6]
    assert [r["written"] for r in ranks] == [1, 0, 1, 0]
    for r in ranks:
        lo = r["offset"]
        changed = np.flatnonzero((r["before"] != r["after"]).any(axis=1)) + lo
        assert changed.tolist() == [x for x in (1, 4) if lo <= x < lo + 2] and r["same_storage"]


def test_elastic_patch_world_4_rewrites_only_the_owning_rank_rows(four):
    """The session's patch writes the moved rows in place on the rank that
    owns them (xs and ws: two rows per moved node); ``moved_node_blocks``
    counts the moved nodes, as the reference does."""
    st, patch, moved = four["stats"], four["patch"], four["moved"]
    assert moved and st["elastic_patches"] >= 1 and st["moved_node_blocks"] >= len(moved)
    assert st["device_copies"] == 1 and st["full_repacks"] == 0 and st["host_solves"] == 0
    assert all(p["in_place"] and p["equal"] for p in patch)
    owners = {p["offset"] for p in patch if p["written"]}
    assert owners == {block_bounds(8, 4, 0)[1] * (m // 2) for m in moved}
    assert sum(p["written"] for p in patch) == 2 * st["moved_node_blocks"]
    assert np.isfinite(four["cost_after"])


def test_resilient_psum_weights_each_rank(four):
    a, b = four["psum"]
    np.testing.assert_array_equal(a, np.full(2, sum((r + 1.0) ** 2 for r in range(4)), np.float32))
    np.testing.assert_array_equal(b, [sum(float(r) * (r + 1.0) for r in range(4))])


# ------------------------------------------------------------- 8 ranks


def test_figure1_parity_at_8_ranks(eight):
    """Mesh against local at 1e-5 on the cost ratio (the same draws, the
    same seed).  Against the reference: at k = 8 on 15 clusters one seed's
    cost moves ±6% with the ++ draws in either package (69.0–77.8 over the
    reference's seeds 0–7), so the port's mean over seeds 0–7 is held to the
    5% band of the reference's mean, and the mesh's cost to the reference's
    range widened by 5%."""
    from repro.core import bernoulli_assignment as j_bern
    from repro.core import ignore_stragglers_kmedian as j_ignore
    from repro.core import resilient_kmedian as j_kmedian
    from repro.core import singleton_assignment as j_single
    from repro.data.synthetic import franti_s1_like as j_franti

    from repro_torch.core import singleton_assignment
    from repro_torch.data.synthetic import franti_s1_like

    mesh = eight["fig1"]
    assert mesh["describe"] == "mesh[8xcpu/gloo]" and mesh["lockstep"]
    local = mesh_runs.fig1("local", CPU)
    seeds = range(8)
    kw = dict(local_iters=6, coord_iters=10)
    alive = fixed_count_stragglers(10, 3, np.random.default_rng(0))
    jp, tp = j_franti(600)[0], franti_s1_like(600)[0]
    ja, ta = (fn(600, 10, ell=2.0, rng=np.random.default_rng(1)) for fn in (j_bern, bernoulli_assignment))
    runs = {
        "resilient_kmedian": (lambda sd: j_kmedian(jp, 8, ja, alive, seed=sd, **kw).cost,
                              lambda sd: resilient_kmedian(tp, 8, ta, alive, seed=sd, device=CPU, **kw).cost),
        "ignore_stragglers_kmedian": (
            lambda sd: j_ignore(jp, 8, j_single(600, 10), alive, seed=sd, **kw).cost,
            lambda sd: ignore_stragglers_kmedian(tp, 8, singleton_assignment(600, 10), alive, seed=sd,
                                                 device=CPU, **kw).cost),
    }
    for name, (theirs, ours) in runs.items():
        assert abs(mesh[name] / local[name] - 1.0) <= 1e-5, (name, mesh[name], local[name])
        ref = np.array([theirs(sd) for sd in seeds])
        port = np.array([ours(sd) for sd in seeds])
        assert port[0] == pytest.approx(local[name], rel=1e-6)
        assert abs(port.mean() / ref.mean() - 1.0) <= 0.05, (name, port, ref)
        assert 0.95 * ref.min() <= mesh[name] <= 1.05 * ref.max(), (name, mesh[name], ref)


def test_multiround_session_parity_at_8_ranks(eight):
    mesh = eight["multiround"]
    local = mesh_runs.multiround("local", CPU, eight["centers"])
    assert mesh["lockstep"]
    assert mesh["uncovered"] == local["uncovered"] and mesh["moved_nodes"] == local["moved_nodes"]
    for a, b in zip(local["costs"], mesh["costs"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a / b - 1.0) <= 1e-5, (a, b)
    for st in (local["stats"], mesh["stats"]):
        assert st["host_solves"] == 0 and st["elastic_patches"] >= 1
    assert mesh["uncovered"][-1] == 0, "coverage restored after the patch"
    assert np.array_equal(mesh["matrix"], local["matrix"])
    assert sum(mesh["rows_written"]) == 2 * mesh["stats"]["moved_node_blocks"]


def test_streaming_session_mesh_8_ranks_end_to_end(eight):
    mesh = eight["stream"]
    local = mesh_runs.stream("local", CPU)
    ref = mesh_runs.stream("local", CPU, stragglers=False)
    assert mesh["lockstep"]
    for got in (local, mesh):
        assert abs(got["cost"] / ref["cost"] - 1.0) <= 1e-5
        assert got["levels"] == ref["levels"], "zero levels lost"
        for g, r in zip(got["frontier"], ref["frontier"]):
            np.testing.assert_allclose(g, r, atol=1e-5)
    assert mesh["host_solves"] > 0
    assert mesh["host_solves_after_replay"] == mesh["host_solves"], "repeat pattern re-solved"


# ------------------------------------------------------------- the launcher


def test_run_ranks_fails_on_a_rank_error_and_on_its_deadline():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        D.run_ranks(operator.truediv, 2, backend="gloo", device=CPU, timeout=60, args=(1, 0))
    with pytest.raises(TimeoutError):
        D.run_ranks(time.sleep, 2, backend="gloo", device=CPU, timeout=4, args=(120,))
    assert time.perf_counter() - t0 < 60
    with pytest.raises(ValueError, match="nccl"):
        D.run_ranks(time.sleep, 1, backend="nccl", device=CPU, timeout=4, args=(0,))


def test_a_backend_that_cannot_carry_the_tensors_raises():
    ex = get_executor("mesh")
    with pytest.raises(ValueError, match="backend"):
        D.node_mesh(backend="nccl")
    fake = D.MeshExecutor(D.NodeMesh(ex.mesh.group, 0, 1, "nccl", torch.device("cuda")))
    with pytest.raises(ValueError, match="nccl"):
        fake.map_nodes(lambda x: x, (torch.zeros(3, 2),))


def test_launcher_cli_prints_both_costs():
    """``python -m repro_torch.launch.distributed``: its ranks run the
    importable module's rank function, on the device asked for."""
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed", "--world", "2", "--backend", "gloo",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=DEADLINE, env={**os.environ, "PYTHONPATH": str(src)})
    assert run.returncode == 0, run.stderr[-3000:]
    out = run.stdout
    assert "mesh[2xcpu/gloo], ranks on cpu" in out and "ranks identical (b, shards, centers, costs): True" in out
    ratios = [float(line.split("ratio ")[1]) for line in out.splitlines() if "ratio " in line]
    assert len(ratios) == 2 and all(abs(r - 1.0) <= 1e-5 for r in ratios)


def test_scenario_sweep_mesh_column_matches_local():
    from repro_torch import scenarios

    cells = scenarios.run(device=CPU, rounds=3, executors=("local", "mesh"), verbose=False)
    by = {(c["scheme"], c["scenario"], c["executor"]): c for c in cells}
    assert len(cells) == 2 * len(scenarios.SCHEMES) * len(scenarios.SCENARIOS)
    for scheme in scenarios.SCHEMES:
        for scen in scenarios.SCENARIOS:
            lo, me = by[(scheme, scen, "local")], by[(scheme, scen, "mesh")]
            assert [e["uncovered"] for e in lo["events"]] == [e["uncovered"] for e in me["events"]]
            assert np.array_equal(lo["final"].matrix, me["final"].matrix)
            for key in ("host_solves", "device_solves", "elastic_patches", "moved_node_blocks"):
                assert lo["stats"][key] == me["stats"][key], (scheme, scen, key)
            for a, b in zip(lo["costs"], me["costs"]):
                assert (a is None) == (b is None) and (a is None or abs(a / b - 1.0) <= 1e-5)


def test_mesh_timing_splits_local_solves_and_collectives():
    pts, a, alive = _small_problem(seed=5)
    ex = get_executor("mesh")
    ex.timing = {}
    try:
        resilient_kmedian(pts, 3, a, alive, local_iters=2, coord_iters=2, executor=ex, device=CPU)
        timing = dict(ex.timing)
    finally:
        ex.timing = None
    assert set(timing) == {"local", "collectives"} and all(v > 0 for v in timing.values())


def test_chip_phase_rank_program_at_a_small_shape():
    """``chip_smoke.py``'s mesh phase program on 2 CPU ranks, cut to
    64,000 × 16 with k = 8 and leaves of 2000: the ranks agree by hash,
    Algorithm 1 within 1e-5 of the local executor, the session rounds with
    no host solve, the stream tree through its compactions."""
    from repro_torch.data.synthetic import gaussian_mixture as t_gm

    n, d, k = 64000, 16, 8
    centers = np.random.default_rng(1).normal(size=(k, d)).astype(np.float32)
    program = functools.partial(mesh_runs.full_width_rank, n=n, d=d, k=k, leaf=2000)
    rep = _ranks(program, 2, args=(0, centers, 4, 16))
    assert rep["describe"] == "mesh[2xcpu/gloo]"
    assert rep["alg1"]["lockstep"] and rep["session"]["lockstep"] and rep["stream"]["lockstep"]
    assert [r["block"] for r in rep["alg1"]["ranks"]] == [(0, 5), (5, 5)]
    pts, _, _ = t_gm(n, k, d, rng=np.random.default_rng(0))
    a = bernoulli_assignment(n, 10, ell=2.0, rng=np.random.default_rng(1))
    alive = fixed_count_stragglers(10, 3, np.random.default_rng(2))
    local = resilient_kmedian(pts, k, a, alive, local_iters=15, coord_iters=30, seed=0, device=CPU)
    assert abs(rep["alg1"]["cost"] / local.cost - 1.0) <= 1e-5
    ses = rep["session"]
    assert ses["stats"]["host_solves"] == 0 and ses["stats"]["device_solves"] == 4
    assert all(np.isfinite(ses["estimates"]))
    assert rep["stream"]["levels"] and all(r["host_solves"] >= 1 for r in rep["stream"]["ranks"])
