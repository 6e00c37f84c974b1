"""The port's on-device recovery solvers against the reference's, on the CPU.

``device_recovery_masked`` / ``device_recovery`` are the reference's
``jax_recovery_masked`` / ``jax_recovery`` in PyTorch with the same
arithmetic (8 power iterations, PGD with step 1/σ², projection, alive
masking, the final rescale on covered shards).  Both sides sum f32
matrix-vector products in other orders, so ``b`` agrees to
max|Δb| ≤ 1e-5·max|b|.  Then the reference's band tests
(``tests/test_resilience.py``) on the port: the device weights land in the
host LP's band, and an uncovered pattern stays finite with the lost shards
left at zero.
"""

import numpy as np
import pytest
import torch

from repro.core import assignment as j_asg
from repro.core import recovery as j_rec
from repro_torch.core import assignment as t_asg
from repro_torch.core import recovery as t_rec
from repro_torch.core import stragglers as t_str

# (scheme, n, s, ell): the five cases of the parity bound.
CASES = [
    pytest.param("cyclic", 60, 8, 3, id="cyclic-60-8-3"),
    pytest.param("fr", 64, 8, 2, id="fr-64-8-2"),
    pytest.param("bernoulli", 60, 10, 4.0, id="bernoulli-60-10-4"),
    pytest.param("fr", 20000, 10, 5, id="fr-20000-10-5"),
    pytest.param("bernoulli", 20000, 10, 2.0, id="bernoulli-20000-10-2"),
]


def _case(scheme, n, s, ell, seed=0):
    a = t_asg.make_assignment(scheme, n, s, ell=ell, rng=np.random.default_rng(seed))
    alive = t_str.fixed_count_stragglers(s, 2, np.random.default_rng(seed + 1))
    return a, alive


@pytest.mark.parametrize("iters", [300, 500])
@pytest.mark.parametrize("scheme,n,s,ell", CASES)
def test_device_recovery_masked_matches_the_reference(scheme, n, s, ell, iters):
    a, alive = _case(scheme, n, s, ell)
    A = a.matrix.astype(np.float32)
    want = np.asarray(j_rec.jax_recovery_masked(A, alive, iters=iters))
    got = t_rec.device_recovery_masked(A, alive, iters=iters, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (s,)
    got = got.numpy()
    assert (got[~alive] == 0).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("scheme,n,s,ell", CASES[:3])
def test_device_recovery_unmasked_matches_the_reference(scheme, n, s, ell):
    a, alive = _case(scheme, n, s, ell)
    A_R = a.matrix[alive].astype(np.float32)
    want = np.asarray(j_rec.jax_recovery(A_R))
    got = t_rec.device_recovery(A_R, device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_solve_recovery_device_method_matches_the_reference_jax_method():
    ja = j_asg.cyclic_assignment(60, 8, 3)
    ta = t_asg.cyclic_assignment(60, 8, 3)
    alive = np.array([1, 1, 0, 1, 1, 0, 1, 1], bool)
    want = j_rec.solve_recovery(ja, alive, method="jax")
    got = t_rec.solve_recovery(ta, alive, method="device", device="cpu")
    assert got.method == "device" and want.method == "jax"
    assert got.feasible == want.feasible
    np.testing.assert_array_equal(got.uncovered, want.uncovered)
    assert np.abs(got.b_full - want.b_full).max() <= 1e-5 * np.abs(want.b_full).max()
    assert got.delta == pytest.approx(want.delta, abs=1e-5)


def test_solve_recovery_jax_method_names_the_device_method():
    with pytest.raises(ValueError, match="method='device'"):
        t_rec.solve_recovery(t_asg.cyclic_assignment(12, 4, 2), np.ones(4, bool), method="jax")


@pytest.mark.parametrize("scheme,n,s,ell", CASES[:3])
def test_device_recovery_masked_lands_in_the_lp_band(scheme, n, s, ell):
    """Device-solver weights land in the LP's feasibility band on all three
    construction families (the reference's test_resilience.py:360)."""
    a, alive = _case(scheme, n, s, ell)
    lp = t_rec.lp_recovery(a, alive)
    b = t_rec.device_recovery_masked(
        a.matrix.astype(np.float32), alive, iters=500, device="cpu").numpy()
    assert (b[~alive] == 0).all(), "stragglers must get zero weight"
    ach = b @ a.matrix
    covered = a.matrix[alive].sum(axis=0) > 0
    assert lp.feasible
    assert ach[covered].min() >= 1.0 - 1e-3
    assert ach[covered].max() <= 4.0 * (1.0 + lp.delta)


def test_device_recovery_masked_uncovered_shard_pattern():
    a = t_asg.singleton_assignment(30, 6)
    alive = np.array([True, True, False, True, True, True])
    lp = t_rec.lp_recovery(a, alive)
    assert len(lp.uncovered) > 0
    b = t_rec.device_recovery_masked(
        a.matrix.astype(np.float32), alive, iters=300, device="cpu").numpy()
    ach = b @ a.matrix
    covered = a.matrix[alive].sum(axis=0) > 0
    assert np.isfinite(b).all()
    assert (ach[~covered] == 0).all()  # lost shards stay lost, no NaN/Inf
    assert ach[covered].min() >= 1.0 - 1e-3  # covered band still achieved
    np.testing.assert_array_equal(np.flatnonzero(~covered), lp.uncovered)


def test_device_recovery_masked_takes_tensors_and_degenerate_patterns():
    """Tensors already on the device pass straight through; an all-dead
    pattern gives all-zero weights (no covered shard, nothing to rescale)."""
    A = torch.from_numpy(t_asg.cyclic_assignment(24, 6, 2).matrix.astype(np.float32))
    b = t_rec.device_recovery_masked(A, torch.zeros(6, dtype=torch.bool), device="cpu")
    assert torch.equal(b, torch.zeros(6))
    b = t_rec.device_recovery_masked(A, torch.ones(6, dtype=torch.bool), device="cpu")
    assert torch.allclose(b @ A, torch.ones(24), atol=1e-5)
