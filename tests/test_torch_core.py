"""Parity of the port's core (``repro_torch.core``) with the reference.

The numpy modules (assignment, stragglers, recovery, packing) were copied,
so the same inputs must give identical outputs.  The torch modules
(aggregation, kmeans) are held against the reference's jnp path
(``impl="xla_ref"``) with explicit initial centers, since ``jax.random`` and
``torch.Generator`` draw different streams.  Everything runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as j_agg
from repro.core import assignment as j_asg
from repro.core import kmeans as j_km
from repro.core import kmedian as j_kmed
from repro.core import recovery as j_rec
from repro.core import stragglers as j_str
from repro_torch import convert, quickstart
from repro_torch.core import aggregation as t_agg
from repro_torch.core import assignment as t_asg
from repro_torch.core import kmeans as t_km
from repro_torch.core import kmedian as t_kmed
from repro_torch.core import recovery as t_rec
from repro_torch.core import stragglers as t_str
from repro_torch.core.executor import get_executor
from repro_torch.core.resilience import ResilienceSession
from repro_torch.data import synthetic as t_syn
from repro.data import synthetic as j_syn

SCHEMES = [
    ("bernoulli", 2.0), ("bernoulli", 3.0), ("cyclic", 2), ("fr", 2), ("singleton", 1),
]


def _pair(scheme, ell, seed, n=60, s=6):
    ja = j_asg.make_assignment(scheme, n, s, ell=ell, rng=np.random.default_rng(seed))
    ta = t_asg.make_assignment(scheme, n, s, ell=ell, rng=np.random.default_rng(seed))
    return ja, ta


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("scheme,ell", SCHEMES)
def test_assignment_matrices_identical(scheme, ell, seed):
    ja, ta = _pair(scheme, ell, seed)
    np.testing.assert_array_equal(ja.matrix, ta.matrix)
    assert ja.scheme == ta.scheme and ja.params == ta.params
    np.testing.assert_array_equal(j_asg.node_loads(ja), t_asg.node_loads(ta))
    assert j_asg.satisfies_property1(ja, 1, 3.0) == t_asg.satisfies_property1(ta, 1, 3.0)


def test_assignment_health_scheme_is_not_ported():
    # The "health" scheme is ported now (core/placement.py): the same
    # health vector gives the reference's matrix and parameters.
    q = np.array([0.02, 0.3, 0.01, 0.9])
    ja = j_asg.make_assignment("health", 10, 4, ell=2, health=q)
    ta = t_asg.make_assignment("health", 10, 4, ell=2, health=q)
    np.testing.assert_array_equal(ja.matrix, ta.matrix)
    assert ja.scheme == ta.scheme == "health" and ja.params == ta.params


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_straggler_masks_identical(seed):
    rng = lambda: np.random.default_rng(seed)  # noqa: E731
    np.testing.assert_array_equal(j_str.random_stragglers(9, 0.3, rng()), t_str.random_stragglers(9, 0.3, rng()))
    np.testing.assert_array_equal(j_str.fixed_count_stragglers(9, 3, rng()), t_str.fixed_count_stragglers(9, 3, rng()))
    ja, ta = _pair("bernoulli", 2.0, seed, n=40, s=8)
    np.testing.assert_array_equal(j_str.adversarial_stragglers(ja, 2), t_str.adversarial_stragglers(ta, 2))
    for name, kw in (("iid", {"p_straggler": 0.2}), ("fixed", {"t": 2}), ("deadline", {})):
        js = j_str.make_scenario(name, 8, seed=seed, **kw)
        ts = t_str.make_scenario(name, 8, seed=seed, **kw)
        for _ in range(4):
            np.testing.assert_array_equal(next(js).alive, next(ts).alive)


@pytest.mark.parametrize("method", ["lp", "nnls", "uniform", "auto"])
@pytest.mark.parametrize("scheme,ell", SCHEMES[:4])
def test_recovery_identical(scheme, ell, method):
    ja, ta = _pair(scheme, ell, 1)
    for alive in (t_str.fixed_count_stragglers(6, 1, np.random.default_rng(2)),
                  t_str.fixed_count_stragglers(6, 3, np.random.default_rng(5))):
        jr = j_rec.solve_recovery(ja, alive, method=method)
        tr = t_rec.solve_recovery(ta, alive, method=method)
        np.testing.assert_array_equal(jr.b_full, tr.b_full)
        np.testing.assert_array_equal(jr.uncovered, tr.uncovered)
        assert (jr.delta, jr.feasible, jr.method) == (tr.delta, tr.feasible, tr.method)
        np.testing.assert_array_equal(t_rec.expand_to_all_nodes(tr), jr.b_full)


def test_convert_carries_assignment_and_recovery():
    ja, _ = _pair("bernoulli", 2.0, 4)
    ta = convert.to_assignment(ja.matrix, ja.scheme, ja.params)
    alive = np.array([1, 1, 0, 1, 1, 1], bool)
    jr = j_rec.solve_recovery(ja, alive)
    tr = convert.to_recovery(b=jr.b, b_full=jr.b_full, a=jr.a, delta=jr.delta,
                             feasible=jr.feasible, uncovered=jr.uncovered, method=jr.method)
    np.testing.assert_array_equal(tr.b_full, t_rec.solve_recovery(ta, alive).b_full)
    assert tr.covered_fraction == jr.covered_fraction
    t = convert.to_tensor(ja.matrix, "cpu")
    assert t.dtype == torch.float32 and t.shape == ja.matrix.shape


@pytest.mark.parametrize("scheme,ell", SCHEMES)
def test_pack_local_shards_identical(scheme, ell):
    ja, ta = _pair(scheme, ell, 2)
    pts, _, _ = t_syn.gaussian_mixture(60, 3, 4, rng=np.random.default_rng(0))
    jx, jw = j_kmed.pack_local_shards(pts, ja)
    tx, tw = t_kmed.pack_local_shards(pts, ta)
    np.testing.assert_array_equal(jx, tx)
    np.testing.assert_array_equal(jw, tw)


def test_synthetic_data_identical():
    for fn, args in (("gaussian_mixture", (50, 3, 4)), ("franti_s1_like", (200,))):
        for a, b in zip(getattr(j_syn, fn)(*args), getattr(t_syn, fn)(*args)):
            np.testing.assert_array_equal(a, b)


def test_aggregation_matches_reference():
    rng = np.random.default_rng(0)
    stats = rng.normal(size=(7, 3, 2)).astype(np.float32)
    b = rng.uniform(0, 2, size=7)
    b[[1, 4]] = 0.0
    # f32 sums of 7 terms in another order: a few ulps.
    np.testing.assert_allclose(
        np.asarray(t_agg.resilient_sum(torch.from_numpy(stats), b)),
        np.asarray(j_agg.resilient_sum(jnp.asarray(stats), b)), rtol=1e-6, atol=1e-6,
    )
    tree = {"a": torch.from_numpy(stats), "b": (torch.from_numpy(stats[:, 0]),)}
    out = t_agg.resilient_sum(tree, b)
    assert out["a"].shape == (3, 2) and out["b"][0].shape == (2,)
    for g in (3, 4, 7):
        np.testing.assert_allclose(
            np.asarray(t_agg.mom_combine(torch.from_numpy(stats), g)),
            np.asarray(j_agg.mom_combine(jnp.asarray(stats), g)), rtol=1e-5, atol=1e-5,
        )
    pts = [rng.normal(size=(3, 2)), rng.normal(size=(2, 2))]
    wts = [np.ones(3), np.ones(2)]
    for x, y in zip(t_agg.weighted_union(pts, wts, np.array([1.5, 0.5])),
                    j_agg.weighted_union(pts, wts, np.array([1.5, 0.5]))):
        np.testing.assert_array_equal(x, y)


def _blobs(seed, n=240, k=4, d=3):
    pts, _, _ = t_syn.gaussian_mixture(n, k, d, spread=0.05, rng=np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 100)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    w[::5] = 0.0  # padding-like rows
    init = pts[rng.choice(n, size=k, replace=False)]
    return pts, w, init


@pytest.mark.parametrize("median", [False, True], ids=["mean", "median"])
@pytest.mark.parametrize("seed", [0, 1])
def test_lloyd_matches_reference_from_given_centers(median, seed):
    pts, w, init = _blobs(seed)
    jr = j_km.lloyd(jax.random.PRNGKey(0), jnp.asarray(pts), 4, weights=jnp.asarray(w), iters=8,
                    median=median, init_centers=jnp.asarray(init), impl="xla_ref")
    tr = t_km.lloyd(torch.from_numpy(pts), 4, weights=torch.from_numpy(w), iters=8,
                    median=median, init_centers=torch.from_numpy(init))
    # fp32 in another summation order over 8 Lloyd (x4 Weiszfeld) steps:
    # centers to 1e-4 of a unit-box scale, costs to 1e-4 relative.
    np.testing.assert_allclose(tr.centers.numpy(), np.asarray(jr.centers), atol=1e-4)
    np.testing.assert_array_equal(tr.assignment.numpy(), np.asarray(jr.assignment))
    np.testing.assert_allclose(float(tr.cost), float(jr.cost), rtol=1e-4)
    jc = j_km.clustering_cost(jnp.asarray(pts), jr.centers, weights=jnp.asarray(w), median=median, impl="xla_ref")
    tc = t_km.clustering_cost(torch.from_numpy(pts), tr.centers, weights=torch.from_numpy(w), median=median)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-4)


def test_lloyd_batched_equals_one_set_at_a_time():
    sets = [_blobs(s) for s in (2, 3, 4)]
    xs = torch.from_numpy(np.stack([p for p, _, _ in sets]))
    ws = torch.from_numpy(np.stack([w for _, w, _ in sets]))
    init = torch.from_numpy(np.stack([c for _, _, c in sets]))
    batch = t_km.lloyd(xs, 4, weights=ws, iters=5, median=True, init_centers=init)
    assert batch.centers.shape == (3, 4, 3) and batch.cost.shape == (3,)
    for b in range(3):
        one = t_km.lloyd(xs[b], 4, weights=ws[b], iters=5, median=True, init_centers=init[b])
        torch.testing.assert_close(batch.centers[b], one.centers)
        torch.testing.assert_close(batch.cost[b], one.cost)


def test_lloyd_empty_cluster_keeps_its_center():
    pts, w, init = _blobs(5)
    init[3] = 50.0  # far from every point: its cluster stays empty
    for median in (False, True):
        res = t_km.lloyd(torch.from_numpy(pts), 4, weights=torch.from_numpy(w), iters=3,
                         median=median, init_centers=torch.from_numpy(init))
        np.testing.assert_array_equal(res.centers[3].numpy(), init[3])


@pytest.mark.parametrize("median", [False, True])
def test_plusplus_never_picks_zero_weight_rows_and_picks_data_rows(median):
    pts, w, _ = _blobs(6)
    x, wt = torch.from_numpy(pts), torch.from_numpy(w)
    zero_rows = x[wt == 0]
    for seed in range(6):
        c = t_km.plusplus_init(x, 4, weights=wt, median=median,
                               generator=torch.Generator().manual_seed(seed))
        # Every center is a data row, and none is a weight-0 row.
        match = (c[:, None, :] == x[None]).all(-1)
        assert match.any(1).all()
        assert not (c[:, None, :] == zero_rows[None]).all(-1).any()


def test_plusplus_all_zero_weights_gives_row_zero():
    x = torch.from_numpy(_blobs(7)[0])
    c = t_km.plusplus_init(x, 3, weights=torch.zeros(x.shape[0]), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(c, x[0].expand(3, -1))


def test_plusplus_batched_draws_per_node():
    pts, w, _ = _blobs(8)
    xs = torch.from_numpy(np.stack([pts, pts[::-1].copy()]))
    ws = torch.from_numpy(np.stack([w, np.ones_like(w)]))
    c = t_km.plusplus_init(xs, 4, weights=ws, median=True, generator=torch.Generator().manual_seed(1))
    assert c.shape == (2, 4, 3)
    for b in range(2):
        ok = (c[b][:, None, :] == xs[b][ws[b] > 0][None]).all(-1).any(1)
        assert ok.all()


def test_resilient_cost_matches_reference():
    pts, _, _ = t_syn.gaussian_mixture(120, 3, 2, rng=np.random.default_rng(1))
    ja, ta = _pair("bernoulli", 3.0, 9, n=120, s=6)
    alive = np.array([1, 0, 1, 1, 1, 1], bool)
    centers = pts[:3]
    for median in (False, True):
        want = j_km.resilient_cost(pts, centers, ja, alive, median=median, impl="xla_ref")
        got = t_km.resilient_cost(pts, centers, ta, alive, median=median, device="cpu")
        assert abs(got - want) <= 1e-5 * abs(want)


def test_session_caches_solves_packs_and_device_copies():
    pts, _, _ = t_syn.gaussian_mixture(80, 3, 2, rng=np.random.default_rng(2))
    _, ta = _pair("bernoulli", 2.0, 3, n=80, s=5)
    sess = ResilienceSession(ta)
    alive = np.array([1, 1, 0, 1, 1], bool)
    for _ in range(2):
        out = sess.prepare(pts, alive)
        sess.device_shards("cpu")
    assert out[4].shape[0] == 5 and out[3] is get_executor()
    got = sess.stats.as_dict()
    assert {k: got[k] for k in ("host_solves", "cache_hits", "coverage_checks", "packs", "device_copies")} == {
        "host_solves": 1, "cache_hits": 1, "coverage_checks": 1, "packs": 1, "device_copies": 1,
    }
    assert got["device_solves"] == got["elastic_patches"] == 0
    with pytest.raises(ValueError, match="no surviving"):
        sess.prepare(pts, np.zeros(5, bool))
    mesh = get_executor("mesh")  # the torch.distributed executor, a world of one here
    assert mesh.name == "mesh" and mesh is get_executor("mesh") and mesh.num_devices == 1


def test_entry_points_raise_without_a_card_and_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, _, _ = t_syn.gaussian_mixture(40, 2, 2, rng=np.random.default_rng(0))
    _, ta = _pair("bernoulli", 2.0, 0, n=40, s=4)
    alive = np.ones(4, bool)
    calls = [
        lambda: t_kmed.resilient_kmedian(pts, 2, ta, alive),
        lambda: t_kmed.ignore_stragglers_kmedian(pts, 2, ta, alive),
        lambda: t_kmed.local_cluster_batch(np.zeros((4, 5, 2), np.float32), np.ones((4, 5), np.float32), 2),
        lambda: t_km.resilient_cost(pts, pts[:2], ta, alive),
        lambda: quickstart.run(),
        lambda: t_kmed.resilient_kmedian(pts, 2, ta, alive, device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
