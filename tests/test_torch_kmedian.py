"""Algorithm 1 end to end: the port (``repro_torch``) against the reference.

Two kinds of test.  The composed test builds both pipelines from their
pieces with the same assignment, alive set and per-node initial centers
(handed over through ``repro_torch.convert``), so no random draw differs and
every intermediate can be compared.  The band tests call the public entry
points, whose ++ seedings draw from different generators, on well-separated
data where both packages should find the planted solution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assignment as j_asg
from repro.core import kmeans as j_km
from repro.core import kmedian as j_kmed
from repro.core import recovery as j_rec
from repro.kernels.weighted_segsum import ops as j_ss
from repro_torch import convert, quickstart
from repro_torch.core import kmeans as t_km
from repro_torch.core import kmedian as t_kmed
from repro_torch.core import recovery as t_rec
from repro_torch.core.stragglers import fixed_count_stragglers
from repro_torch.data.synthetic import gaussian_mixture
from repro_torch.kernels.weighted_segsum import ops as t_ss


@pytest.mark.parametrize("seed", [0, 1])
def test_algorithm1_composed_from_pieces_matches_reference(seed):
    n, k, d, s, local_iters, coord_iters = 300, 4, 3, 6, 6, 8
    pts, _, _ = gaussian_mixture(n, k, d, spread=0.05, rng=np.random.default_rng(seed))
    ja = j_asg.bernoulli_assignment(n, s, ell=3.0, rng=np.random.default_rng(seed + 1))
    ta = convert.to_assignment(ja.matrix, ja.scheme, ja.params)
    alive = fixed_count_stragglers(s, 2, np.random.default_rng(seed + 2))

    jrec = j_rec.solve_recovery(ja, alive)
    trec = t_rec.solve_recovery(ta, alive)
    np.testing.assert_array_equal(trec.b_full, jrec.b_full)
    xs, ws = j_kmed.pack_local_shards(pts, ja)
    txs, tws = t_kmed.pack_local_shards(pts, ta)
    np.testing.assert_array_equal(txs, xs)

    # The same per-node initial centers: k distinct real rows of each shard.
    rng = np.random.default_rng(seed + 3)
    init = np.stack([xs[i][rng.choice(int(ws[i].sum()), k, replace=False)] for i in range(s)])
    first_alive = int(np.flatnonzero(alive)[0])
    key = jax.random.PRNGKey(0)

    # Reference: node by node, then the coordinator and the full cost.
    jc, jwt = [], []
    for i in range(s):
        r = j_km.lloyd(key, jnp.asarray(xs[i]), k, weights=jnp.asarray(ws[i]), iters=local_iters,
                       median=True, init_centers=jnp.asarray(init[i]), impl="xla_ref")
        _, tot = j_ss.weighted_segsum(jnp.asarray(xs[i]), jnp.asarray(ws[i]), r.assignment, k, impl="xla_ref")
        jc.append(np.asarray(r.centers))
        jwt.append(jrec.b_full[i] * np.asarray(tot))
    jy, jwy = np.concatenate(jc), np.concatenate(jwt).astype(np.float32)
    jres = j_km.lloyd(key, jnp.asarray(jy), k, weights=jnp.asarray(jwy), iters=coord_iters, median=True,
                      init_centers=jnp.asarray(jy[first_alive * k:(first_alive + 1) * k]), impl="xla_ref")
    jcost = float(j_km.clustering_cost(jnp.asarray(pts), jres.centers, median=True, impl="xla_ref"))

    # Port: all nodes in one batch, then the coordinator and the full cost.
    tres = t_km.lloyd(convert.to_tensor(txs, "cpu"), k, weights=convert.to_tensor(tws, "cpu"),
                      iters=local_iters, median=True, init_centers=convert.to_tensor(init, "cpu"))
    _, ttot = t_ss.weighted_segsum(convert.to_tensor(txs, "cpu"), convert.to_tensor(tws, "cpu"),
                                   tres.assignment, k)
    ty = tres.centers.reshape(s * k, d)
    twy = (convert.to_tensor(trec.b_full, "cpu").unsqueeze(-1) * ttot).reshape(s * k)
    tco = t_km.lloyd(ty, k, weights=twy, iters=coord_iters, median=True,
                     init_centers=ty[first_alive * k:(first_alive + 1) * k])
    tcost = float(t_km.clustering_cost(convert.to_tensor(pts, "cpu"), tco.centers, median=True))

    # fp32 in another summation order through 6 + 8 Lloyd steps (x4
    # Weiszfeld each): about 1e-4 relative.
    scale = np.abs(jy).max()
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-4 * scale)
    np.testing.assert_allclose(twy.numpy(), jwy, rtol=1e-4, atol=1e-4 * jwy.max())
    np.testing.assert_allclose(tco.centers.numpy(), np.asarray(jres.centers), atol=1e-4 * scale)
    assert abs(tcost - jcost) <= 1e-4 * jcost


@pytest.fixture(scope="module")
def planted():
    n, k, d, s = 1200, 5, 4, 6
    pts, truth, _ = gaussian_mixture(n, k, d, spread=0.02, rng=np.random.default_rng(0))
    ja = j_asg.bernoulli_assignment(n, s, ell=3.0, rng=np.random.default_rng(1))
    ta = convert.to_assignment(ja.matrix, ja.scheme, ja.params)
    alive = fixed_count_stragglers(s, 2, np.random.default_rng(2))
    planted_cost = float(j_km.clustering_cost(jnp.asarray(pts), jnp.asarray(truth), median=True, impl="xla_ref"))
    return dict(pts=pts, k=k, s=s, ja=ja, ta=ta, alive=alive, planted_cost=planted_cost)


# Both packages should land on the planted solution (the k-median optimum
# is at most the cost at the planted centers, and a missed cluster costs
# several times more), so each cost lies within 5% of the planted cost and
# of each other.
BAND = 0.05


@pytest.mark.parametrize("entry", ["resilient_kmedian", "ignore_stragglers_kmedian"])
def test_algorithm1_public_entry_points_land_in_band(planted, entry):
    p = planted
    kw = dict(local_iters=8, coord_iters=10, seed=0)
    if entry == "resilient_kmedian":
        jout = j_kmed.resilient_kmedian(p["pts"], p["k"], p["ja"], p["alive"], impl="xla_ref", **kw)
        tout = t_kmed.resilient_kmedian(p["pts"], p["k"], p["ta"], p["alive"], device="cpu", **kw)
        np.testing.assert_array_equal(tout.recovery.b_full, jout.recovery.b_full)
    else:
        sing = j_asg.singleton_assignment(len(p["pts"]), p["s"])
        tsing = convert.to_assignment(sing.matrix, sing.scheme, sing.params)
        jout = j_kmed.ignore_stragglers_kmedian(p["pts"], p["k"], sing, p["alive"], impl="xla_ref", **kw)
        tout = t_kmed.ignore_stragglers_kmedian(p["pts"], p["k"], tsing, p["alive"], device="cpu", **kw)
    assert tout.centers.shape == jout.centers.shape
    assert tout.summary_points.shape == jout.summary_points.shape
    assert (tout.summary_weights == 0).sum() == (np.asarray(jout.summary_weights) == 0).sum()
    for cost in (tout.cost, jout.cost):
        assert cost <= (1 + BAND) * p["planted_cost"]
    assert abs(tout.cost - jout.cost) <= BAND * jout.cost


def test_quickstart_twin_runs_on_cpu():
    ratios = quickstart.run("cpu", verbose=False)
    assert set(ratios) == {"centralized", "ignore_stragglers", "bernoulli_p0.1", "bernoulli_p0.2"}
    assert ratios["centralized"] == 1.0
    # The reference's CPU ratios at this seed are 1.000 / 0.876 / 0.867 /
    # 0.987: local optima of one dataset, within 25% of each other.
    assert all(0.75 < r < 1.25 for r in ratios.values())


def test_local_cluster_batch_weights_count_each_node_rows():
    pts, _, _ = gaussian_mixture(200, 3, 2, rng=np.random.default_rng(4))
    a = convert.to_assignment(j_asg.cyclic_assignment(200, 4, 2).matrix, "cyclic", {"ell": 2})
    xs, ws = t_kmed.pack_local_shards(pts, a)
    centers, wts = t_kmed.local_cluster_batch(xs, ws, 3, iters=4, device="cpu")
    assert centers.shape == (4, 3, 2) and wts.shape == (4, 3)
    torch.testing.assert_close(wts.sum(-1), torch.from_numpy(ws.sum(-1)))
