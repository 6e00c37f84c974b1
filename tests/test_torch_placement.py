"""The port's health-aware placement optimizer (``repro_torch.core.placement``,
a copy of the reference package's) and the session features that feed it:
the reference's ``tests/test_placement.py`` run against the port, then the
port's ``health_assignment``, ``choose_ell``, cost model and
``PlacementOptimizer`` held equal to the reference's on the same inputs.
"""

import json

import numpy as np
import pytest

from repro_torch.core import (
    ElasticPolicy,
    PlacementOptimizer,
    ResilienceSession,
    choose_ell,
    cyclic_assignment,
    expected_completion_time,
    health_assignment,
    make_assignment,
    round_miss_probability,
)
from repro_torch.core.assignment import (
    Assignment,
    bernoulli_assignment,
    node_loads,
    shard_replication,
)
from repro_torch.core.stragglers import TraceScenario
from repro_torch.obs import default_registry


# ---------------------------------------------------------------- cost model


def test_expected_completion_time_model():
    a = cyclic_assignment(12, 4, 2)
    # All healthy: ECT is the all-alive makespan (perfectly balanced loads).
    assert expected_completion_time(a, np.zeros(4)) == pytest.approx(6.0)
    # Chronic stragglers co-holding shards inflate the retry term.
    q = np.array([0.0, 0.0, 0.9, 0.9])
    assert expected_completion_time(a, q) > 6.0
    # Faster nodes finish their shards sooner: doubling every capacity
    # halves the ECT.
    cap = np.full(4, 2.0)
    assert expected_completion_time(a, np.zeros(4), cap) == pytest.approx(3.0)


def test_unplaced_shard_is_a_certain_miss_not_a_silent_zero():
    m = cyclic_assignment(4, 4, 1).matrix.copy()
    m[:, 0] = 0
    bad = Assignment(matrix=m, scheme="cyclic", params={})
    assert round_miss_probability(bad.matrix, np.zeros(4)) == 1.0
    assert np.isinf(expected_completion_time(bad, np.zeros(4)))


# ------------------------------------------------------------- construction


def test_health_assignment_avoids_chronic_stragglers_and_beats_uniform():
    q = np.array([0.02, 0.03, 0.01, 0.02, 0.05, 0.03, 0.95, 0.9])
    a = make_assignment("health", 64, 8, ell=2, health=q)
    assert a.scheme == "health"
    assert (shard_replication(a) == 2).all()
    # Every shard keeps a replica on a healthy node (hard constraint) and
    # the chronic stragglers carry far less than the healthy nodes.
    healthy = q < 0.5
    assert (a.matrix[healthy].sum(axis=0) >= 1).all()
    loads = node_loads(a)
    assert loads[6] + loads[7] < loads[healthy].min()
    # Never worse than the uniform constructions under the same model —
    # they are in the candidate pool.
    for uniform in ("cyclic", "fr"):
        u = make_assignment(uniform, 64, 8, ell=2)
        assert expected_completion_time(a, q) <= expected_completion_time(u, q)


def test_choose_ell_scales_with_risk():
    assert choose_ell(16, 8, np.zeros(8)) == 1
    assert choose_ell(16, 8, np.full(8, 0.05)) == 2
    # High uniform risk saturates at the cap rather than looping forever.
    assert choose_ell(16, 8, np.full(8, 0.3), max_ell=4) == 4
    a = make_assignment("health", 16, 8, ell=None, health=np.full(8, 0.05))
    assert a.params["ell"] == 2


def test_optimizer_excludes_dead_nodes_hard():
    q = np.full(8, 0.05)
    exclude = np.zeros(8, dtype=bool)
    exclude[[2, 6]] = True
    a = PlacementOptimizer(ell=2).optimize(40, 8, q, exclude=exclude)
    assert (a.matrix[exclude] == 0).all()
    assert (shard_replication(a) == 2).all()
    with pytest.raises(ValueError, match="allowed"):
        PlacementOptimizer().optimize(8, 4, np.zeros(4), exclude=np.ones(4, bool))


def test_correlation_groups_are_spanned():
    groups = np.array([0, 0, 1, 1])
    a = health_assignment(12, 4, health=np.zeros(4), ell=2, groups=groups)
    for j in range(12):
        holders = np.flatnonzero(a.matrix[:, j])
        assert np.unique(groups[holders]).size >= 2


def test_make_assignment_rejects_unknown_scheme_listing_health():
    with pytest.raises(ValueError, match="health"):
        make_assignment("nope", 8, 4)


# ---------------------------------------------- satellite: bernoulli audit


def test_bernoulli_seed_stability_including_cover_reroll():
    a1 = bernoulli_assignment(8, 6, ell=1.0, rng=np.random.default_rng(7))
    a2 = bernoulli_assignment(8, 6, ell=1.0, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(a1.matrix, a2.matrix)
    # Tiny p forces empty columns, so the ensure_cover re-roll path runs —
    # it draws from the same generator and must be just as deterministic.
    b1 = bernoulli_assignment(16, 4, ell=0.2, rng=np.random.default_rng(3))
    b2 = bernoulli_assignment(16, 4, ell=0.2, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(b1.matrix, b2.matrix)
    assert (shard_replication(b1) >= 1).all()


def test_bernoulli_zero_row_is_inert_everywhere():
    """A node that draws no shards (all-zero ROW — legal, unlike an all-zero
    column) must flow through load accounting, shard packing, and the
    placement cost model without crashing or skewing anything."""
    from repro_torch.core.kmedian import pack_local_shards

    a = None
    for seed in range(100):
        cand = bernoulli_assignment(4, 8, ell=1.0, rng=np.random.default_rng(seed))
        if (node_loads(cand) == 0).any():
            a = cand
            break
    assert a is not None, "no zero-load draw in 100 seeds — p=(7/8)^4 per row"
    loads = node_loads(a)
    assert loads.sum() == int(a.matrix.sum())
    pts = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    xs, ws = pack_local_shards(pts, a)
    assert xs.shape[0] == 8
    assert (ws[loads == 0] == 0).all()  # empty nodes pack as weight-0 padding
    q = np.full(8, 0.2)
    ect = expected_completion_time(a, q)
    assert np.isfinite(ect) and ect > 0
    # A q=1 node must not divide-by-zero the greedy per-node score either.
    q[0] = 1.0
    h = health_assignment(4, 8, health=q, ell=2)
    assert (shard_replication(h) == 2).all()
    assert node_loads(h)[0] == 0  # and it receives nothing


# ------------------------------------------------- satellite: gauge lifecycle


def test_metrics_registry_remove():
    from repro_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.gauge("g", labels={"node": "0"}).set(1.0)
    reg.gauge("g", labels={"node": "1"}).set(2.0)
    assert reg.remove("g", {"node": "0"})
    assert not reg.remove("g", {"node": "0"})  # already gone
    assert set(reg.collect()["g"]) == {(("node", "1"),)}
    assert reg.remove("g", {"node": "1"})
    assert "g" not in reg.families()  # empty family dropped
    assert not reg.remove("never_registered")


def _session_gauge_nodes(sess):
    fam = default_registry().collect().get("node_straggle_ewma", {})
    want = sess._obs_labels["session"]
    return {
        dict(k)["node"] for k in fam if dict(k).get("session") == want
    }


def test_node_health_and_gauges_track_live_node_set():
    sess = ResilienceSession(cyclic_assignment(12, 4, 2))
    for _ in range(3):
        sess.observe(np.ones(4, dtype=bool))
    assert _session_gauge_nodes(sess) == {"0", "1", "2", "3"}
    assert sess.node_health().shape == (4,)
    sess.permanent_loss(3)
    assert sess.node_health().shape == (3,)
    assert _session_gauge_nodes(sess) == {"0", "1", "2"}
    # Later rounds must not resurrect the dead node's gauge — even when the
    # scenario mask claims it is alive — nor decay its EWMA toward healthy.
    for _ in range(5):
        sess.observe(np.ones(4, dtype=bool))
    assert _session_gauge_nodes(sess) == {"0", "1", "2"}
    assert sess._straggle_ewma[3] == 1.0
    sess.permanent_join(3)
    assert sess.node_health().shape == (4,)
    assert sess.node_health()[3] == 0.0  # fresh machine, clean record
    assert _session_gauge_nodes(sess) == {"0", "1", "2", "3"}


# --------------------------------------- satellite: repair-target selection


def _pingpong_session(tmp_path, health_aware):
    """Nodes 0–3 steady; node 4 permanently flaky from round 8; node 5 is
    chronically flaky for 8 rounds, then briefly back exactly when the patch
    fires — high EWMA, zero streak, zero load: the legacy least-loaded pick
    targets it, the health-aware pick must not."""
    masks = (
        [[1, 1, 1, 1, 1, 0]] * 8
        + [[1, 1, 1, 1, 0, 1]] * 2
        + [[1, 1, 1, 1, 0, 0]] * 2
    )
    path = tmp_path / f"pingpong_{health_aware}.jsonl"
    path.write_text("\n".join(json.dumps({"alive": m}) for m in masks) + "\n")
    mat = np.zeros((6, 6), dtype=np.uint8)
    for j in range(6):
        mat[j % 5, j] = 1
        mat[(j + 1) % 5, j] = 1  # node 5 starts empty
    sess = ResilienceSession(
        Assignment(matrix=mat, scheme="cyclic", params={"ell": 2}),
        elastic=ElasticPolicy(patience=2, health_aware=health_aware),
    )
    events = [sess.observe(step) for step in TraceScenario(6, str(path), loop=False)]
    return sess, events


def test_health_aware_repair_converges_where_legacy_pingpongs(tmp_path):
    # Legacy least-loaded pick: patch #1 lands the at-risk shards on flaky
    # node 5 (it is empty), whose next persistent streak puts the SAME
    # shards back at risk — a second patch evacuates what the first placed.
    legacy, legacy_events = _pingpong_session(tmp_path, health_aware=False)
    legacy_moves = [e["moved_nodes"] for e in legacy_events if e["patched"]]
    assert legacy.stats.elastic_patches >= 2
    assert 5 in legacy_moves[0]
    # Health-aware (EWMA, load) pick: node 5's record disqualifies it, the
    # patch lands on genuinely reliable nodes, and no later round re-patches.
    fixed, fixed_events = _pingpong_session(tmp_path, health_aware=True)
    fixed_moves = [e["moved_nodes"] for e in fixed_events if e["patched"]]
    assert fixed.stats.elastic_patches == 1
    assert all(5 not in moved for moved in fixed_moves)
    # The at-risk shards ended with ≥ 2 replicas on the steady nodes.
    steady_cover = fixed.assignment.matrix[:4].sum(axis=0)
    assert (steady_cover[[3, 4]] >= 2).all()


# ------------------------------------------------ session lifecycle rewiring


def test_permanent_loss_reoptimizes_placement_and_join_restores(tmp_path):
    a = make_assignment("health", 24, 6, ell=2)
    sess = ResilienceSession(a, placement=PlacementOptimizer(ell=2))
    # Learn heterogeneous health online: node 5 flaky, the rest steady.
    flaky = np.ones(6, dtype=bool)
    flaky[5] = False
    for _ in range(6):
        sess.observe(flaky)
    # Seed the pattern cache, then lose node 0 for good.
    sess.recovery(np.ones(6, dtype=bool))
    invalidated_before = sess.stats.cache_invalidations
    res = sess.permanent_loss(0)
    assert res.feasible
    assert sess.stats.placement_reoptimizes == 1
    assert sess.stats.reshards == 0  # re-optimize, not the legacy reshard
    assert sess.version == 1
    assert sess.assignment.scheme == "health"
    assert (sess.assignment.matrix[0] == 0).all()
    assert (shard_replication(sess.assignment) >= 1).all()
    # Invalidation went through the selective path (counted per entry), and
    # the flaky survivor carries less than the steady ones.
    assert sess.stats.cache_invalidations > invalidated_before
    loads = node_loads(sess.assignment)
    assert loads[5] <= loads[1:5].min()
    # Rejoin: health record reset, placement re-optimized, node 0 used again.
    sess.permanent_join(0)
    assert sess.stats.placement_reoptimizes == 2
    assert node_loads(sess.assignment)[0] > 0
    assert sess.node_health().shape == (6,)


def test_legacy_reshard_folds_dead_rows_onto_healthiest_survivor():
    # fr with groups {0,1} and {2,3}: losing nodes 0 AND 2 breaks coverage
    # for the shards they co-held, forcing the legacy reshard path.
    sess = ResilienceSession(make_assignment("fr", 12, 4, ell=2))
    for _ in range(4):  # node 1 flaky (but alive when it matters)
        sess.observe(np.array([True, False, True, True]))
    sess.permanent_loss(0)
    assert sess.stats.reshards == 0  # still covered after one loss
    sess.permanent_loss(2)
    assert sess.stats.reshards == 1
    assert sess.assignment.scheme == "elastic_cyclic"
    loads = node_loads(sess.assignment)
    assert loads[0] == 0 and loads[2] == 0
    # Both dead rows folded onto node 3 (EWMA ≈ 0), never the flaky node 1 —
    # the blind row-rotation of the old takeover would have used node 1.
    assert loads[3] > loads[1]


# ------------------------------------------------- parity with the reference

HEALTH_PROFILES = [
    pytest.param(np.zeros(8), id="all-healthy"),
    pytest.param(np.full(8, 0.05), id="uniform-0.05"),
    pytest.param(np.array([0.02, 0.03, 0.01, 0.02, 0.05, 0.03, 0.95, 0.9]), id="two-chronic"),
    pytest.param(np.random.default_rng(4).uniform(0.0, 0.6, size=8), id="random"),
]


@pytest.mark.parametrize("q", HEALTH_PROFILES)
@pytest.mark.parametrize("ell", [None, 2, 3])
def test_health_assignment_equals_the_reference(q, ell):
    from repro.core import placement as ref

    ours = health_assignment(64, 8, health=q, ell=ell)
    want = ref.health_assignment(64, 8, health=q, ell=ell)
    np.testing.assert_array_equal(ours.matrix, want.matrix)
    assert ours.scheme == want.scheme and ours.params == want.params
    assert expected_completion_time(ours, q) == ref.expected_completion_time(want, q)


@pytest.mark.parametrize("q", HEALTH_PROFILES)
def test_choose_ell_and_miss_probability_equal_the_reference(q):
    from repro.core import placement as ref

    for max_ell in (2, 4):
        assert choose_ell(40, 8, q, max_ell=max_ell) == ref.choose_ell(40, 8, q, max_ell=max_ell)
    m = cyclic_assignment(40, 8, 2).matrix
    assert round_miss_probability(m, q) == ref.round_miss_probability(m, q)


def test_placement_optimizer_equals_the_reference_with_exclusions():
    from repro.core import placement as ref

    q = np.random.default_rng(9).uniform(0.0, 0.5, size=8)
    exclude = np.zeros(8, dtype=bool)
    exclude[[1, 6]] = True
    ours = PlacementOptimizer(ell=2).optimize(48, 8, q, exclude=exclude)
    want = ref.PlacementOptimizer(ell=2).optimize(48, 8, q, exclude=exclude)
    np.testing.assert_array_equal(ours.matrix, want.matrix)
    assert ours.params == want.params
