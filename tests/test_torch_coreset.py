"""Coresets (``repro_torch.core.coreset``) against the reference.

The sensitivities are deterministic given the bicriteria centers, so they
are held tightly against the reference's formula run through its public
``assign_min`` and ``weighted_segsum``.  The draws come from different
generators in the two packages, so the sampled coresets are held to the
reference tests' ε bands, each package's coreset scored by the port's
``clustering_cost`` (the reference's through ``convert.coreset_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assignment as j_asg
from repro.core import coreset as j_cs
from repro.core import kmeans as j_km
from repro.core import recovery as j_rec
from repro.kernels.pairwise_dist import ops as j_pd
from repro.kernels.weighted_segsum import ops as j_ss
from repro_torch import convert
from repro_torch.core import coreset as t_cs
from repro_torch.core import kmeans as t_km
from repro_torch.core.stragglers import fixed_count_stragglers
from repro_torch.data.synthetic import gaussian_mixture

_EPS = 1e-12


def _reference_sensitivities(x, w, centers, squared):
    """``repro/core/coreset.py``'s formula through the reference's public ops."""
    x, w, c = jnp.asarray(x), jnp.asarray(w), jnp.asarray(centers)
    idx, d2 = j_pd.assign_min(x, c, impl="xla_ref")
    dist = d2 if squared else jnp.sqrt(jnp.maximum(d2, 0.0))
    total = jnp.maximum(jnp.sum(w * dist), _EPS)
    _, cluster_w = j_ss.weighted_segsum(x, w, idx, c.shape[0], impl="xla_ref")
    sens = w * dist / total + w / jnp.maximum(cluster_w[idx], _EPS)
    sens = jnp.where(w > 0, sens, 0.0)
    return np.asarray(sens / jnp.maximum(jnp.sum(sens), _EPS))


@pytest.mark.parametrize("squared", [True, False], ids=["means", "median"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sensitivities_match_reference_formula(seed, squared):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 5)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=300).astype(np.float32)
    w[::7] = 0.0  # padding rows
    centers = x[rng.choice(300, 8, replace=False)] + 0.1
    got = t_cs._sensitivities(
        torch.from_numpy(x)[None], torch.from_numpy(w)[None], torch.from_numpy(centers)[None],
        squared=squared,
    )[0]
    want = _reference_sensitivities(x, w, centers, squared)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-12)
    assert (np.asarray(got)[::7] == 0).all()


def _epsilon_band_inputs():
    pts, _, _ = gaussian_mixture(2000, 5, 4, rng=np.random.default_rng(3))
    return pts


def _coreset(package, pts, k, m):
    if package == "jax":
        cs = j_cs.sensitivity_coreset(jax.random.PRNGKey(0), jnp.asarray(pts), k=k, m=m)
        return convert.coreset_from_jax(cs.points, cs.weights)
    gen = torch.Generator().manual_seed(0)
    return t_cs.sensitivity_coreset(torch.from_numpy(pts), k, m, generator=gen)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_sensitivity_coreset_epsilon_band(package):
    """The band of ``test_clustering.py::test_sensitivity_coreset_epsilon_band``."""
    pts = _epsilon_band_inputs()
    cs = _coreset(package, pts, 5, 500)
    assert cs.points.shape == (500, 4) and cs.weights.shape == (500,)
    x = torch.from_numpy(pts)
    rng = np.random.default_rng(4)
    for _ in range(5):
        C = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
        full = float(t_km.clustering_cost(x, C))
        approx = float(t_km.clustering_cost(cs.points, C, weights=cs.weights))
        assert abs(approx - full) / full < 0.35
    assert float(cs.weights.sum()) == pytest.approx(2000, rel=0.3)


def test_reference_coreset_scores_alike_in_both_packages():
    pts = _epsilon_band_inputs()
    cs = j_cs.sensitivity_coreset(jax.random.PRNGKey(0), jnp.asarray(pts), k=5, m=500)
    C = np.random.default_rng(4).normal(size=(5, 4)).astype(np.float32)
    want = float(j_km.clustering_cost(cs.points, jnp.asarray(C), weights=cs.weights))
    t = convert.coreset_from_jax(np.asarray(cs.points), np.asarray(cs.weights))
    got = float(t_km.clustering_cost(t.points, torch.from_numpy(C), weights=t.weights))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_uniform_coreset_weight_normalization(package):
    """The band of ``test_clustering.py::test_uniform_coreset_weight_normalization``."""
    pts, _, _ = gaussian_mixture(1000, 3, 2, rng=np.random.default_rng(6))
    if package == "jax":
        cs = j_cs.uniform_coreset(jax.random.PRNGKey(1), jnp.asarray(pts), 200)
        cs = convert.coreset_from_jax(cs.points, cs.weights)
    else:
        cs = t_cs.uniform_coreset(torch.from_numpy(pts), 200, generator=torch.Generator().manual_seed(1))
    assert cs.points.shape == (200, 2)
    assert float(cs.weights.sum()) == pytest.approx(1000, rel=0.25)


def test_zero_weight_node_draws_uniformly_with_weight_zero():
    """As ``jax.random.categorical`` on all-equal logits: a node whose
    weights are all zero draws every row alike, each with weight 0."""
    x = torch.rand(2, 50, 3)
    w = torch.ones(2, 50)
    w[1] = 0.0
    cs = t_cs.uniform_coreset(x, 400, weights=w, generator=torch.Generator().manual_seed(2))
    assert (cs.weights[1] == 0).all() and (cs.weights[0] > 0).all()
    picked = {tuple(p.tolist()) for p in cs.points[1]}
    assert len(picked) > 25  # spread over the rows, not stuck at row 0


def test_resilient_coreset_b_weighting_matches_reference():
    n, k, m, s = 600, 3, 40, 6
    pts, _, _ = gaussian_mixture(n, k, 3, rng=np.random.default_rng(7))
    ja = j_asg.bernoulli_assignment(n, s, ell=2.5, rng=np.random.default_rng(8))
    ta = convert.to_assignment(ja.matrix, ja.scheme, ja.params)
    alive = fixed_count_stragglers(s, 2, np.random.default_rng(9))
    out = t_cs.resilient_coreset(pts, k, m, ta, alive, seed=3, device="cpu")
    ref = j_cs.resilient_coreset(pts, k, m, ja, alive, seed=3)
    assert out.points.shape == np.asarray(ref.points).shape == (s * m, 3)
    assert out.weights.shape == (s * m,)
    jb = j_rec.solve_recovery(ja, alive).b_full
    zero_t = (out.weights.reshape(s, m) == 0).all(1).numpy()
    zero_j = (np.asarray(ref.weights).reshape(s, m) == 0).all(1)
    np.testing.assert_array_equal(zero_t, jb == 0)  # stragglers (and b = 0 nodes) weigh 0
    np.testing.assert_array_equal(zero_j, jb == 0)
    assert zero_t[~alive].all()
    # Given the same per-node coresets, the b-weighting is the reference's.
    from repro_torch.core.kmedian import pack_local_shards

    xs, ws = pack_local_shards(np.asarray(pts, np.float32), ta)
    plain = t_cs._local_coreset(
        torch.from_numpy(xs), torch.from_numpy(ws), torch.ones(s), k=k, m=m, squared=True,
        bicriteria_iters=5, impl="auto", generator=torch.Generator().manual_seed(3),
    )
    np.testing.assert_array_equal(out.points.numpy(), plain.points.reshape(s * m, 3).numpy())
    want = (jb[:, None].astype(np.float32) * plain.weights.numpy()).reshape(s * m)
    np.testing.assert_allclose(out.weights.numpy(), want, rtol=1e-6)


def test_merge_coresets_concatenates():
    a = t_cs.Coreset(torch.rand(3, 2), torch.rand(3))
    b = t_cs.Coreset(torch.rand(5, 2), torch.rand(5))
    m = t_cs.merge_coresets(a, b)
    assert torch.equal(m.points, torch.cat([a.points, b.points]))
    assert torch.equal(m.weights, torch.cat([a.weights, b.weights]))
    ref = j_cs.merge_coresets(
        j_cs.Coreset(jnp.asarray(a.points.numpy()), jnp.asarray(a.weights.numpy())),
        j_cs.Coreset(jnp.asarray(b.points.numpy()), jnp.asarray(b.weights.numpy())),
    )
    np.testing.assert_array_equal(np.asarray(ref.points), m.points.numpy())
    with pytest.raises(ValueError, match="at least one"):
        t_cs.merge_coresets()
