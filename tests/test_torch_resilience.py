"""The port's elastic resilience runtime (``repro_torch.core.resilience``) on
the CPU: the session tests of the reference's ``tests/test_resilience.py``
that need no mesh and no trainer, run against the port.  Centers come from
the reference's ``lloyd`` and go to both sides; where a test compares with
the reference, the same numpy inputs drive the reference's session too.

Every test gets a fresh metrics registry (the ``fresh_registry`` fixture):
session counters and node gauges live in the port's process-wide registry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ResilienceSession as JSession
from repro.core import clustering_cost as j_clustering_cost
from repro.core import lloyd as j_lloyd
from repro_torch.core import (
    ElasticPolicy,
    LocalExecutor,
    ResilienceSession,
    cyclic_assignment,
    fixed_count_stragglers,
    fractional_repetition_assignment,
    make_scenario,
    resilient_cost,
    resilient_kmedian,
)
from repro_torch.core.assignment import Assignment
from repro_torch.core.executor import get_executor
from repro_torch.core.kmedian import prepare_resilient_run
from repro_torch.core.recovery import device_recovery_masked, lp_recovery, solve_recovery
from repro_torch.obs import MetricsRegistry, set_default_registry


@pytest.fixture(autouse=True)
def fresh_registry():
    prev = set_default_registry(MetricsRegistry())
    yield
    set_default_registry(prev)


def _pts(n=160, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)).astype(np.float32)


def _centers(pts, k, seed=0, iters=4):
    return np.asarray(j_lloyd(jax.random.PRNGKey(seed), jnp.asarray(pts), k, iters=iters).centers)


def _session(a, **kw):
    return ResilienceSession(a, device="cpu", **kw)


# --------------------------------------------------- session: shared cache


def test_session_one_cache_across_algorithms():
    pts = _pts(120)
    a = cyclic_assignment(120, 6, 2)
    alive = fixed_count_stragglers(6, 1, np.random.default_rng(3))
    sess = _session(a)
    out = sess.kmedian(pts, 3, alive, local_iters=3, coord_iters=4)
    sess.cost(pts, out.centers, alive)
    sess.pca(pts, 2, 0.5, alive)
    sess.coreset(pts, 3, 16, alive)
    assert sess.stats.host_solves == 1  # one pattern, solved once, shared 4×
    assert sess.stats.cache_hits == 3
    assert sess.stats.packs == 1 and sess.stats.device_copies == 1  # one resident copy


def test_coverage_validation_computed_once_per_pattern():
    pts = _pts(90)
    a = cyclic_assignment(90, 6, 2)
    alive = np.array([True, True, False, True, True, True])
    sess = _session(a)
    sess.coreset(pts, 3, 8, alive)
    sess.coreset(pts, 3, 8, alive)
    sess.kmedian(pts, 3, alive, local_iters=2, coord_iters=2)
    assert sess.stats.coverage_checks == 1  # one pattern → one validation
    other = np.array([True, False, True, True, True, True])
    sess.cost(pts, np.zeros((3, 3), np.float32), other)
    assert sess.stats.coverage_checks == 2  # new pattern → one more
    sess.coreset(pts, 3, 8, other)
    assert sess.stats.coverage_checks == 2
    with pytest.raises(ValueError, match="no surviving"):
        sess.prepare(pts, np.zeros(6, dtype=bool))


def test_coverage_validation_invalidated_with_pattern_cache():
    sess = _session(cyclic_assignment(40, 8, 2), elastic=ElasticPolicy(enabled=True, patience=2))
    dead_67 = np.ones(8, dtype=bool)
    dead_67[[6, 7]] = False
    assert len(sess.validate_coverage(dead_67)) > 0  # adjacent cyclic nodes → coverage lost
    assert sess.stats.coverage_checks == 1
    for _ in range(3):
        sess.observe(dead_67)
    assert sess.stats.elastic_patches >= 1
    assert len(sess.validate_coverage(dead_67)) == 0
    assert sess.stats.coverage_checks == 2


def test_coverage_entry_from_caller_rec_also_invalidated():
    a = cyclic_assignment(40, 8, 2)
    sess = _session(a, elastic=ElasticPolicy(enabled=True, patience=2))
    dead = np.ones(8, dtype=bool)
    dead[[6, 7]] = False
    rec = solve_recovery(a, dead)  # host-side, bypasses sess._cache
    assert len(sess.validate_coverage(dead, rec)) > 0
    assert sess.stats.host_solves == 0
    for _ in range(3):
        sess.observe(dead)
    assert sess.stats.elastic_patches >= 1
    assert len(sess.validate_coverage(dead)) == 0  # recomputed post-patch
    assert sess.stats.coverage_checks == 2


def test_entry_points_without_session_unchanged():
    pts = _pts(100, seed=5)
    a = cyclic_assignment(100, 5, 2)
    alive = fixed_count_stragglers(5, 1, np.random.default_rng(1))
    o1 = resilient_kmedian(pts, 3, a, alive, local_iters=3, coord_iters=4, device="cpu")
    o2 = resilient_kmedian(pts, 3, a, alive, local_iters=3, coord_iters=4, device="cpu")
    assert o1.cost == pytest.approx(o2.cost)


# ------------------------------------------------------- on-device recovery


def test_step_cost_no_host_solve_lemma3_band():
    """Unseen straggler patterns are data: zero host solves, four device
    solves, the estimate in the Lemma-3 band and equal to the reference's
    step_cost on the same pattern to 1e-5."""
    pts = _pts(150, seed=7)
    a = cyclic_assignment(150, 6, 2)  # δ = 0 band for any single straggler
    centers = _centers(pts, 3)
    true = float(j_clustering_cost(jnp.asarray(pts), jnp.asarray(centers)))
    sess = _session(a)
    ref = JSession(a)
    for seed in (0, 1, 2, 3):
        alive = fixed_count_stragglers(6, 1, np.random.default_rng(seed))
        est = sess.step_cost(pts, centers, alive)
        assert true * (1 - 1e-4) <= est <= true * 1.5
        assert est == pytest.approx(ref.step_cost(pts, centers, alive), rel=1e-5)
    assert sess.stats.host_solves == 0
    assert sess.stats.device_solves == 4
    assert sess.stats.device_copies == 1  # the shards stayed resident


def test_step_cost_all_dead_raises():
    sess = _session(cyclic_assignment(40, 4, 2))
    with pytest.raises(ValueError, match="no surviving"):
        sess.step_cost(_pts(40), np.zeros((2, 3), np.float32), np.zeros(4, bool))


def test_step_cost_tracks_dataset_switches():
    a = cyclic_assignment(80, 4, 2)
    pts_a = _pts(80, seed=1)
    pts_b = pts_a + 100.0  # wildly different cost against the same centers
    centers = _centers(pts_a, 2, iters=3)
    alive = np.array([True, True, True, False])
    sess = _session(a)
    est_a = sess.step_cost(pts_a, centers, alive)
    sess.cost(pts_b, centers, alive)  # host path repacks for pts_b
    est_b = sess.step_cost(pts_b, centers, alive)
    fresh = _session(a).step_cost(pts_b, centers, alive)
    assert est_b == pytest.approx(fresh, rel=1e-6)
    assert est_b > 10 * est_a


def test_in_place_mutation_invalidates_pack_cache():
    a = cyclic_assignment(80, 4, 2)
    pts = _pts(80, seed=2)
    centers = _centers(pts, 2, iters=3)
    alive = np.array([True, True, False, True])
    sess = _session(a)
    est1 = sess.step_cost(pts, centers, alive)
    c1 = sess.cost(pts, centers, alive)
    pts *= 3.0  # in-place: same object, new contents
    est2 = sess.step_cost(pts, centers, alive)
    c2 = sess.cost(pts, centers, alive)
    fresh = _session(a)
    assert est2 == pytest.approx(fresh.step_cost(pts, centers, alive), rel=1e-6)
    assert c2 == pytest.approx(fresh.cost(pts, centers, alive), rel=1e-6)
    assert est2 != pytest.approx(est1, rel=1e-3)
    assert c2 != pytest.approx(c1, rel=1e-3)


def test_step_cost_through_b_override_and_device_recovery_weights():
    """``device_recovery_weights`` is the step's own solve; the executor's
    ``b_override`` selects given weights through the same launches."""
    pts = _pts(60, seed=3)
    a = cyclic_assignment(60, 6, 3)
    alive = np.array([1, 1, 0, 1, 0, 1], bool)
    sess = _session(a)
    b = sess.device_recovery_weights(alive)
    want = device_recovery_masked(a.matrix.astype(np.float32), alive, device="cpu").numpy()
    np.testing.assert_array_equal(b, want)
    assert sess.stats.device_solves == 1 and sess.stats.host_solves == 0
    xs, ws, A = sess._ensure_resident(pts, torch.device("cpu"))
    c = torch.from_numpy(pts[:2].copy())
    fn = lambda x, w, cc: (w.sum(-1) * 0 + torch.arange(6.0))  # noqa: E731  node i → i
    lp = lp_recovery(a, alive)
    red, b_used = get_executor().resilient_reduce_masked(
        fn, (xs, ws), (c,), A, torch.from_numpy(alive), b_override=lp.b_full)
    np.testing.assert_allclose(b_used.numpy(), lp.b_full.astype(np.float32))
    assert float(red) == pytest.approx(float(np.arange(6.0) @ lp.b_full), rel=1e-6)
    red, b_used = get_executor().resilient_reduce_masked(fn, (xs, ws), (c,), A, torch.from_numpy(alive))
    np.testing.assert_allclose(b_used.numpy(), want)


# ----------------------------------------------------- elastic re-assignment


def _persistent_spike_scenario(s=8, seed=6):
    return make_scenario(
        "deadline", s, seed=seed, p_spike=0.06, persistence=1.0,
        spike_scale=6.0, deadline=2.0,
    )


def test_elastic_repairs_coverage_disabled_loses_it():
    def run(enabled):
        sess = _session(cyclic_assignment(160, 8, 2), elastic=ElasticPolicy(enabled=enabled, patience=2))
        scen = _persistent_spike_scenario()
        uncovered = [sess.observe(next(scen))["uncovered"] for _ in range(16)]
        return sess, uncovered

    s_on, u_on = run(True)
    s_off, u_off = run(False)
    assert s_on.stats.elastic_patches >= 1
    assert all(u == 0 for u in u_on[-6:]), f"elastic must restore coverage: {u_on}"
    assert any(u > 0 for u in u_off[-6:]), f"disabled run must report loss: {u_off}"
    assert s_off.stats.uncovered_rounds > s_on.stats.uncovered_rounds


def test_elastic_patch_invalidates_only_affected_patterns():
    sess = _session(cyclic_assignment(40, 8, 2), elastic=ElasticPolicy(enabled=True, patience=2))
    dead_67 = np.ones(8, dtype=bool)
    dead_67[[6, 7]] = False
    only_67 = ~dead_67
    sess.recovery(dead_67)
    sess.recovery(only_67)
    assert sess.stats.host_solves == 2
    for _ in range(3):
        sess.observe(dead_67)
    assert sess.stats.elastic_patches >= 1
    solves_before, hits_before = sess.stats.host_solves, sess.stats.cache_hits
    sess.recovery(only_67)
    assert sess.stats.cache_hits == hits_before + 1, "unaffected entry was dropped"
    res = sess.recovery(dead_67)
    assert sess.stats.host_solves == solves_before + 1, "stale entry was kept"
    assert res.feasible and len(res.uncovered) == 0


def test_elastic_patch_repairs_recovery_after_coverage_loss():
    a = cyclic_assignment(40, 8, 2)
    sess = _session(a, elastic=ElasticPolicy(enabled=True, patience=2))
    dead = np.ones(8, dtype=bool)
    dead[[6, 7]] = False
    assert len(sess.recovery(dead).uncovered) > 0
    for _ in range(3):
        sess.observe(dead)
    assert sess.stats.elastic_patches >= 1
    assert sess.assignment.scheme.endswith("+elastic")
    res = sess.recovery(dead)
    assert len(res.uncovered) == 0 and res.feasible


def test_session_rejects_foreign_assignment_and_executor():
    pts = _pts(40, seed=4)
    a = cyclic_assignment(40, 8, 2)
    other = cyclic_assignment(40, 8, 3)  # same node count, different matrix
    sess = _session(a, elastic=ElasticPolicy(enabled=True, patience=2))
    alive = np.ones(8, dtype=bool)
    with pytest.raises(ValueError, match="not the session's assignment"):
        resilient_kmedian(pts, 2, other, alive, session=sess, local_iters=2, coord_iters=2, device="cpu")
    with pytest.raises(ValueError, match="conflicts with the session's"):
        resilient_cost(pts, np.zeros((2, 3), np.float32), a, alive,
                       session=sess, executor=LocalExecutor(), device="cpu")
    # The ORIGINAL assignment stays accepted after an elastic patch (lineage).
    dead = alive.copy()
    dead[[6, 7]] = False
    for _ in range(3):
        sess.observe(dead)
    assert sess.stats.elastic_patches >= 1
    assert sess.assignment is not a
    est = resilient_cost(pts, np.zeros((2, 3), np.float32), a, dead, session=sess, device="cpu")
    assert np.isfinite(est)


def test_recovery_method_conflict_with_session_raises():
    a = cyclic_assignment(60, 6, 2)
    sess = _session(a, recovery_method="lp")
    alive = np.array([True] * 5 + [False])
    with pytest.raises(ValueError, match="conflicts with the session"):
        resilient_kmedian(_pts(60), 3, a, alive, recovery_method="uniform", session=sess, device="cpu")
    out = sess.kmedian(_pts(60), 3, alive, local_iters=2, coord_iters=2, recovery_method="lp")
    assert np.isfinite(out.cost)


def _skewed_assignment():
    """Max load 8 on nodes 0/1; nodes 6/7 exclusively hold shards 16–19.
    Killing 6 and 7 puts those shards at risk, and the patch targets (the
    least-loaded healthy nodes 4/5, load 4 → ≤ 8) fit inside the existing
    padding — the INCREMENTAL re-pack/re-place branch."""
    mat = np.zeros((8, 20), dtype=np.uint8)
    mat[0, 0:8] = 1
    mat[1, 8:16] = 1
    mat[2, 0:8] = 1
    mat[3, 8:16] = 1
    mat[4, 0:4] = 1
    mat[5, 4:8] = 1
    mat[6, 16:20] = 1
    mat[7, 16:20] = 1
    return Assignment(matrix=mat, scheme="skewed", params={})


def test_patch_does_not_mutate_handed_out_pack():
    pts = _pts(20, seed=3)
    sess = _session(_skewed_assignment(), elastic=ElasticPolicy(enabled=True, patience=2))
    dead = np.ones(8, dtype=bool)
    dead[[6, 7]] = False
    sess.step_cost(pts, np.zeros((2, 3), np.float32), dead)
    _, _, _, _, xs, ws = prepare_resilient_run(pts, None, dead, session=sess)
    xs_snap, ws_snap = xs.copy(), ws.copy()
    for _ in range(3):
        sess.observe(dead)
    assert sess.stats.elastic_patches >= 1
    assert sess.stats.moved_node_blocks >= 1, "incremental branch did not run"
    np.testing.assert_array_equal(xs, xs_snap)
    np.testing.assert_array_equal(ws, ws_snap)
    _, _, _, _, xs2, ws2 = prepare_resilient_run(pts, None, dead, session=sess)
    assert xs2 is not xs
    assert ws2[[4, 5]].sum() > ws[[4, 5]].sum()


def test_patch_rewrites_only_the_moved_rows_of_the_resident_copy():
    """The incremental branch writes the moved node rows of the resident
    tensors in place: same storage, no new full copy, and the result equals
    a fresh packing of the patched assignment."""
    from repro_torch.core.kmedian import pack_local_shards

    pts = _pts(20, seed=3)
    sess = _session(_skewed_assignment(), elastic=ElasticPolicy(enabled=True, patience=2))
    dead = np.ones(8, dtype=bool)
    dead[[6, 7]] = False
    est0 = sess.step_cost(pts, np.zeros((2, 3), np.float32), dead)
    xs0, ws0, _ = sess._resident
    ptr_x, ptr_w, before = xs0.data_ptr(), ws0.data_ptr(), xs0.clone()
    moved = set()
    for _ in range(3):
        moved.update(sess.observe(dead)["moved_nodes"])
    assert sess.stats.elastic_patches >= 1 and moved
    xs1, ws1, A1 = sess._resident
    assert (xs1.data_ptr(), ws1.data_ptr()) == (ptr_x, ptr_w)
    assert sess.stats.device_copies == 1 and sess.stats.moved_node_blocks >= len(moved)
    want_x, want_w = pack_local_shards(pts, sess.assignment)
    np.testing.assert_array_equal(xs1.numpy(), want_x)
    np.testing.assert_array_equal(ws1.numpy(), want_w)
    np.testing.assert_array_equal(A1.numpy(), sess.assignment.matrix.astype(np.float32))
    unmoved = sorted(set(range(8)) - moved)
    assert torch.equal(xs1[unmoved], before[unmoved])
    est1 = sess.step_cost(pts, np.zeros((2, 3), np.float32), dead)
    assert sess.stats.device_copies == 1  # the patched copy stayed resident
    assert np.isfinite(est0) and np.isfinite(est1)


def test_executor_update_node_rows_local():
    ex = get_executor(None)
    arr = ex.place_node_stacked(np.arange(12, dtype=np.float32).reshape(6, 2), "cpu")
    out = ex.update_node_rows(arr, [0, 3], np.full((2, 2), 9.0, np.float32))
    assert out is arr
    want = np.arange(12, dtype=np.float32).reshape(6, 2)
    want[[0, 3]] = 9.0
    np.testing.assert_array_equal(out.numpy(), want)


def test_executor_replicated_compute_and_placement_copies():
    ex = get_executor(None)
    src = np.arange(6, dtype=np.float32)
    placed = ex.place_broadcast(src, "cpu")
    placed += 1.0  # the placed copy owns its storage
    assert src[0] == 0.0
    assert ex.replicated_compute(lambda x, y: x * y, (placed, 2.0)).tolist() == [2, 4, 6, 8, 10, 12]


# ------------------------------------- randomized recovery-parity oracle


def _recovered_gradient(b_full, A, shard_grads):
    """Lemma 3 on gradients in linear-algebra form: node i's local gradient
    is Σ_{s∈P_i} g_s; the combine is Σ_i b_i·(A g)_i = Σ_s (bᵀA)_s g_s."""
    per_node = A.astype(np.float64) @ shard_grads
    return np.asarray(b_full, np.float64) @ per_node


def test_recovery_parity_oracle_fuzzed_patterns():
    """Host LP vs on-device PGD recovered gradients pinned at 1e-5 wherever
    the exact band is achievable (FR; cyclic for any ℓ−1 stragglers), and
    band-bounded for the rest (the LP optimum is not unique there)."""
    from repro_torch.core import bernoulli_assignment

    rng = np.random.default_rng(0)
    d = 5
    cases = [
        ("fr", fractional_repetition_assignment(24, 8, 2), 1, True),
        ("fr", fractional_repetition_assignment(24, 8, 2), 3, True),
        ("cyclic", cyclic_assignment(24, 8, 2), 1, True),
        ("cyclic", cyclic_assignment(24, 8, 3), 2, False),
        ("bernoulli", bernoulli_assignment(24, 8, ell=4.0, rng=rng), 1, False),
    ]
    exact_checked = 0
    for name, a, t, exact in cases:
        A = a.matrix
        shard_grads = rng.normal(size=(a.num_shards, d))
        truth = shard_grads.sum(axis=0)
        for seed in range(6):
            alive = fixed_count_stragglers(a.num_nodes, t, np.random.default_rng(seed))
            if (A[alive].sum(axis=0) == 0).any():
                continue
            lp = lp_recovery(a, alive)
            assert lp.feasible
            b_dev = device_recovery_masked(A.astype(np.float32), alive, iters=1200, device="cpu").numpy()
            assert (b_dev[~alive] == 0).all()
            g_host = _recovered_gradient(lp.b_full, A, shard_grads)
            g_dev = _recovered_gradient(b_dev, A, shard_grads)
            scale = np.abs(truth).max()
            if exact:
                np.testing.assert_allclose(g_dev, g_host, atol=1e-5 * scale)
                np.testing.assert_allclose(g_dev, truth, atol=1e-5 * scale)
                exact_checked += 1
            else:
                gmass = np.abs(shard_grads).sum(axis=0)
                for b in (lp.b_full, b_dev):
                    ach = np.asarray(b, np.float64) @ A
                    assert ach.min() >= 1.0 - 1e-3
                    bound = (ach.max() - 1.0) * gmass + 1e-4 * scale
                    assert (np.abs(_recovered_gradient(b, A, shard_grads) - truth) <= bound).all()
    assert exact_checked >= 10


def test_recovery_parity_oracle_cost_path():
    """``session.step_cost`` (device PGD) vs the host-LP ``resilient_cost``:
    1e-5 on FR (δ = 0) for several coverage-preserving patterns."""
    pts = _pts(120, seed=11)
    a = fractional_repetition_assignment(120, 6, 2)
    centers = _centers(pts, 3, seed=2)
    sess = _session(a)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        alive = np.ones(6, dtype=bool)
        alive[rng.integers(0, 6)] = False
        if (a.matrix[alive].sum(axis=0) == 0).any():
            continue
        dev = sess.step_cost(pts, centers, alive)
        host = float(resilient_cost(pts, centers, a, alive, recovery_method="lp", device="cpu"))
        assert dev == pytest.approx(host, rel=1e-5), (seed, dev, host)
    assert sess.stats.host_solves == 0


# ------------------------------------------ permanent loss / resharding


def test_session_owns_permanent_loss_and_reshard():
    sess = _session(cyclic_assignment(8, 4, 2))
    events = []
    sess.add_patch_listener(lambda moved, om, nm: events.append((tuple(moved), om, nm)))

    res = sess.permanent_loss(3)
    assert sess.stats.reshards == 0 and len(res.uncovered) == 0
    assert sess.permanent_dead == {3}
    assert not sess.alive_mask()[3] and sess.alive_mask()[0]

    res2 = sess.permanent_loss(2)  # adjacent deaths → coverage lost
    assert sess.stats.reshards == 1
    assert len(res2.uncovered) == 0
    assert sess.assignment.scheme == "elastic_cyclic"
    assert events and len(events[0][0]) > 0
    assert sess.version == 1
    m = sess.assignment.matrix
    assert m[2].sum() == 0 and m[3].sum() == 0
    assert (m[[0, 1]].sum(axis=0) > 0).all()
    assert sess.pattern_covers(sess.alive_mask())

    sess.permanent_join(3)  # warm takeover: no reshard on joins
    assert sess.permanent_dead == {2} and sess.stats.reshards == 1


def test_permanent_loss_and_join_match_the_reference_session():
    """The same loss / join / observe sequence on both packages' sessions:
    equal matrices, versions, counters and health after each step."""
    from repro.core import assignment as j_asg

    ours = _session(cyclic_assignment(24, 6, 2))
    ref = JSession(j_asg.cyclic_assignment(24, 6, 2))
    flaky = np.array([1, 1, 1, 1, 0, 1], bool)

    def same():
        np.testing.assert_array_equal(ours.assignment.matrix, ref.assignment.matrix)
        assert ours.version == ref.version and ours.assignment.scheme == ref.assignment.scheme
        got, want = ours.stats.as_dict(), ref.stats.as_dict()
        assert {k: got[k] for k in want} == want
        np.testing.assert_allclose(ours.node_health(), ref.node_health(), atol=1e-12)

    for step in ("observe", "observe", "loss 3", "observe", "loss 2", "join 3", "observe"):
        if step == "observe":
            assert ours.observe(flaky) == ref.observe(flaky)
        elif step.startswith("loss"):
            node = int(step.split()[1])
            r1, r2 = ours.permanent_loss(node), ref.permanent_loss(node)
            np.testing.assert_allclose(r1.b_full, r2.b_full, atol=1e-9)
        else:
            ours.permanent_join(3)
            ref.permanent_join(3)
        same()
