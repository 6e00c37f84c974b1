"""Algorithms 2 and 3 (``repro_torch.core.subspace``, ``.pca``) against the
reference.

Deterministic pieces are compared directly on the same numpy inputs: the
residuals and costs (rtol 1e-5), the per-cluster refit at a given assignment
(means rtol 1e-5; projectors B·Bᵀ atol 1e-4, since eigenvectors carry an
arbitrary sign), the sketches by their Gram matrices SᵀS (1e-4 of the norm),
and Algorithm 3 end to end, which draws nothing.  Algorithm 2 and
``lloyd_subspace`` draw their seeding from different generators in the two
packages, so they are held to the reference tests' bands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import assignment as j_asg
from repro.core import pca as j_pca
from repro.core import subspace as j_sub
from repro_torch import convert
from repro_torch.core import kmeans as t_km
from repro_torch.core import pca as t_pca
from repro_torch.core import subspace as t_sub
from repro_torch.core.stragglers import fixed_count_stragglers
from repro_torch.data.synthetic import gaussian_mixture, planted_subspaces


def _solution(k, d, r, seed):
    rng = np.random.default_rng(seed)
    bases = np.stack([np.linalg.qr(rng.normal(size=(d, max(r, 1))))[0][:, :r] for _ in range(k)])
    means = rng.normal(size=(k, d))
    return bases.astype(np.float32), means.astype(np.float32)


def _projectors(bases):
    b = np.asarray(bases, np.float64)
    return b @ np.swapaxes(b, -1, -2)


@pytest.mark.parametrize("r", [0, 2])
def test_subspace_residual_and_cost_match_reference(r):
    x = np.random.default_rng(0).normal(size=(200, 6)).astype(np.float32)
    w = np.random.default_rng(1).uniform(0, 2, size=200).astype(np.float32)
    bases, means = _solution(3, 6, r, seed=2)
    got = t_sub.subspace_residual_sq(torch.from_numpy(x), torch.from_numpy(bases), torch.from_numpy(means))
    want = j_sub.subspace_residual_sq(jnp.asarray(x), jnp.asarray(bases), jnp.asarray(means))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    for weights in (None, w):
        got = t_sub.subspace_cost(torch.from_numpy(x), torch.from_numpy(bases), torch.from_numpy(means),
                                  weights=None if weights is None else torch.from_numpy(weights))
        want = j_sub.subspace_cost(jnp.asarray(x), jnp.asarray(bases), jnp.asarray(means),
                                   weights=None if weights is None else jnp.asarray(weights))
        assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("r", [0, 1, 3])
def test_weighted_pca_per_cluster_matches_reference(r):
    rng = np.random.default_rng(r)
    n, d, k = 240, 5, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    idx = rng.integers(0, k - 1, size=n).astype(np.int32)  # cluster k-1 is empty: keeps its previous fit
    prev_b, prev_m = _solution(k, d, r, seed=9)
    got_b, got_m = t_sub._weighted_pca_per_cluster(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx), k, r,
        torch.from_numpy(prev_b), torch.from_numpy(prev_m),
    )
    want_b, want_m = j_sub._weighted_pca_per_cluster(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx), k, r, jnp.asarray(prev_b), jnp.asarray(prev_m)
    )
    assert got_b.shape == (k, d, r) and got_m.shape == (k, d)
    np.testing.assert_allclose(np.asarray(got_m), np.asarray(want_m), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_projectors(got_b), _projectors(want_b), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(got_b)[-1], prev_b[-1])


def test_relaxed_coreset_rank_matches_reference():
    for r in (1, 2, 5, 8):
        for delta in (0.1, 0.25, 0.5, 1.0, 3.0):
            assert t_pca.relaxed_coreset_rank(r, delta) == j_pca.relaxed_coreset_rank(r, delta)


@pytest.mark.parametrize("m,d,r1", [(40, 6, 4), (6, 5, 9)], ids=["tall", "fewer-rows-than-r1"])
def test_local_sketches_match_reference_by_gram(m, d, r1):
    rng = np.random.default_rng(m)
    xs = rng.normal(size=(4, m, d)).astype(np.float32)
    xs[1, m // 2 :] = 0.0  # padding rows
    b = np.array([1.0, 0.5, 0.0, 2.0])
    got = t_pca.local_relaxed_coresets(torch.from_numpy(xs), r1, b_full=b).numpy()
    want = np.asarray(j_pca.local_relaxed_coresets(xs, r1, b_full=b))
    assert got.shape == want.shape == (4, r1, d)
    gram = lambda s: np.swapaxes(s, -1, -2).astype(np.float64) @ s  # noqa: E731
    g_got, g_want = gram(got), gram(want)
    assert np.linalg.norm(g_got - g_want) <= 1e-4 * np.linalg.norm(g_want)
    assert (got[2] == 0).all()


@pytest.mark.parametrize("n", [300, 9000], ids=["one-block", "ragged-blocks"])
def test_pca_cost_dense_and_chunked_match_reference(n):
    x = np.random.default_rng(n).normal(size=(n, 7)).astype(np.float32)
    basis = np.linalg.qr(np.random.default_rng(1).normal(size=(7, 3)))[0].astype(np.float32)
    want = float(j_pca.pca_cost(jnp.asarray(x), jnp.asarray(basis), impl="xla_ref"))
    want_chunked = float(j_pca.pca_cost(jnp.asarray(x), jnp.asarray(basis), impl="xla_chunked"))
    for impl, ref in (("dense", want), ("chunked", want_chunked), ("auto", want)):
        got = float(t_pca.pca_cost(torch.from_numpy(x), torch.from_numpy(basis), impl=impl))
        assert got == pytest.approx(ref, rel=1e-5), impl
    with pytest.raises(ValueError, match="unknown impl"):
        t_pca.pca_cost(torch.from_numpy(x), torch.from_numpy(basis), impl="xla_ref")


def test_pca_cost_auto_streams_above_the_budget():
    n = t_pca.MATERIALIZE_BUDGET // (4 * 8) + 1  # one row over the (n, d) budget at d = 8
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(n, 8)).astype(np.float32))
    basis = torch.eye(8)[:, :2]
    assert torch.equal(t_pca.pca_cost(x, basis), t_pca.pca_cost(x, basis, impl="chunked"))


def _algorithm3_inputs(case):
    if case == "theorem5_band":  # test_clustering.py::test_algorithm3_pca_theorem5_band
        pts, _ = planted_subspaces(800, 1, 24, 4, noise=0.05, rng=np.random.default_rng(11))
        pts = pts - pts.mean(0, keepdims=True)
        ja = j_asg.bernoulli_assignment(len(pts), 10, ell=8.0, rng=np.random.default_rng(12))
        alive = fixed_count_stragglers(10, 3, np.random.default_rng(13))
        return pts, 4, 0.25, ja, alive
    # test_clustering.py::test_algorithm3_pca_exact_when_no_stragglers
    pts, _ = planted_subspaces(500, 1, 16, 3, noise=0.0, rng=np.random.default_rng(14))
    pts = pts - pts.mean(0, keepdims=True)
    return pts, 3, 0.5, j_asg.fractional_repetition_assignment(len(pts), 8, 2), np.ones(8, dtype=bool)


@pytest.mark.parametrize("case", ["theorem5_band", "exact_when_no_stragglers"])
def test_resilient_pca_matches_reference(case):
    pts, r, delta, ja, alive = _algorithm3_inputs(case)
    ta = convert.to_assignment(ja.matrix, ja.scheme, ja.params)
    got = t_pca.resilient_pca(pts, r, delta, ta, alive, device="cpu")
    want = j_pca.resilient_pca(pts, r, delta, ja, alive)
    np.testing.assert_allclose(got.recovery.b_full, want.recovery.b_full, rtol=1e-9, atol=1e-12)
    assert (got.r1, got.sketch_rows) == (want.r1, want.sketch_rows)
    np.testing.assert_allclose(_projectors(got.basis), _projectors(want.basis), atol=1e-4)
    mass = float((pts.astype(np.float64) ** 2).sum())
    if case == "theorem5_band":
        assert got.cost == pytest.approx(want.cost, rel=1e-4)
        opt = float(t_pca.pca_cost(torch.from_numpy(pts), t_pca.centralized_pca(torch.from_numpy(pts), r)))
        band = 1.0 + 4.0 * max(delta, got.recovery.delta)
        assert got.cost <= band * opt * 1.05 + 1e-6
    else:
        # Noise-free: both costs are the f32 rounding of ‖P‖² − ‖PV‖² (a few
        # 1e-6 of ‖P‖², either sign), so they are compared on that scale.
        assert abs(got.cost - want.cost) <= 1e-6 * mass
        assert got.cost <= 1e-3 * mass


def test_algorithm2_subspace_clustering_quality():
    """The band of ``test_clustering.py::test_algorithm2_subspace_clustering_quality``."""
    pts, _ = planted_subspaces(900, 3, 8, 2, noise=0.01, rng=np.random.default_rng(7))
    ja = j_asg.bernoulli_assignment(len(pts), 8, ell=3.0, rng=np.random.default_rng(8))
    ta = convert.to_assignment(ja.matrix, ja.scheme, ja.params)
    alive = fixed_count_stragglers(8, 2, np.random.default_rng(9))
    out = t_sub.resilient_subspace_clustering(pts, 2, 3, ta, alive, coreset_size=256, device="cpu")
    central = t_sub.lloyd_subspace(torch.from_numpy(pts), 3, 2, generator=torch.Generator().manual_seed(2))
    assert out.bases.shape == (3, 8, 2) and out.means.shape == (3, 8)
    assert out.coreset_points.shape[0] == 256 * int((alive & (out.recovery.b_full > 0)).sum())
    assert out.cost <= max(5.0 * float(central.cost), float(central.cost) + 2.0)
    # The reference's own central solve on the same data lands in the same band.
    j_central = j_sub.lloyd_subspace(jax.random.PRNGKey(2), jnp.asarray(pts), 3, 2)
    assert out.cost <= max(5.0 * float(j_central.cost), float(j_central.cost) + 2.0)


def test_algorithm2_r0_reduces_to_kmeans():
    """The band of ``test_clustering.py::test_algorithm2_r0_reduces_to_kmeans``."""
    pts, _, _ = gaussian_mixture(600, 4, 5, rng=np.random.default_rng(10))
    x = torch.from_numpy(pts)
    sol = t_sub.lloyd_subspace(x, 4, 0, generator=torch.Generator().manual_seed(0))
    km = t_km.lloyd(x, 4, iters=15, generator=torch.Generator().manual_seed(0))
    assert sol.bases.shape == (4, 5, 0)
    assert float(sol.cost) <= 1.5 * float(km.cost) + 1e-3


def test_solutions_score_alike_in_both_packages():
    """Each package's solution, scored by the other package's cost.  Noise
    0.1: at 0.01 the f32 cancellation ‖x − μ‖² − ‖Bᵀ(x − μ)‖² alone moves the
    cost by about 2e-5 between two summation orders."""
    pts, _ = planted_subspaces(600, 3, 8, 2, noise=0.1, rng=np.random.default_rng(7))
    j_sol = j_sub.lloyd_subspace(jax.random.PRNGKey(2), jnp.asarray(pts), 3, 2)
    bases, means = convert.subspace_from_jax(np.asarray(j_sol.bases), np.asarray(j_sol.means))
    got = float(t_sub.subspace_cost(torch.from_numpy(pts), bases, means))
    assert got == pytest.approx(float(j_sol.cost), rel=1e-5)
    t_sol = t_sub.lloyd_subspace(torch.from_numpy(pts), 3, 2, generator=torch.Generator().manual_seed(2))
    want = float(j_sub.subspace_cost(jnp.asarray(pts), jnp.asarray(t_sol.bases.numpy()), jnp.asarray(t_sol.means.numpy())))
    assert float(t_sol.cost) == pytest.approx(want, rel=1e-5)
