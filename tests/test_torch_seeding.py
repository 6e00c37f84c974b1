"""The ++ seeding's running minimum: ``min_dist_update`` and the loop of
``kmeans._plusplus_batched`` over it, on the CPU.

The op's plain version is held to a float64 direct computation: the
squared distances at 1e-6 relative, and the logits, log(max(w·score,
1e-12)), at 1e-6 absolute, which is 1e-6 relative on w·score.  A zero-weight
row's logit is exactly −inf and a point at distance 0 takes the floor's
logit.  The loop's running distance after i steps is the minimum over the
first i chosen centers (1e-5 relative against float64; against
``pairwise_sqdist_ref``'s ‖x‖² + ‖c‖² − 2x·c within 1e-5 of the norms, the
decomposition's own error), and the loop draws the centers that the
reference's form of the loop, a full ``assign_min`` over every slot at each
step, draws from the same generator.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import kmeans as t_km
from repro_torch.kernels import dispatch
from repro_torch.kernels.pairwise_dist import kernel as pd_kernel
from repro_torch.kernels.pairwise_dist import ops as pd_ops
from repro_torch.kernels.pairwise_dist import ref as pd_ref


def _inputs(B=3, n=200, d=16, seed=0):
    """x (B, n, d), c (B, d), a running d2 (B, n) that lies under the new
    distance on about half the rows, and weights (B, n) with zero rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, n, d)).astype(np.float32) * 3.0
    c = rng.normal(size=(B, d)).astype(np.float32) * 3.0
    dist = ((x.astype(np.float64) - c[:, None].astype(np.float64)) ** 2).sum(-1)
    d2 = (dist * rng.uniform(0.5, 1.5, size=(B, n))).astype(np.float32)
    w = rng.uniform(0.1, 2.0, size=(B, n)).astype(np.float32)
    w[rng.random((B, n)) < 0.2] = 0.0
    return x, c, d2, w


def _float64(x, c, d2, w, median):
    dist = ((x.astype(np.float64) - c[:, None].astype(np.float64)) ** 2).sum(-1)
    nd = np.minimum(d2.astype(np.float64), dist)
    score = np.sqrt(nd) if median else nd
    with np.errstate(divide="ignore"):
        logits = np.where(w > 0, np.log(np.maximum(w * score, 1e-12)), -np.inf)
    return nd, logits


@pytest.mark.parametrize("median", [False, True], ids=["means", "median"])
def test_plain_min_dist_update_matches_float64(median):
    x, c, d2, w = _inputs()
    want_d2, want_logits = _float64(x, c, d2, w, median)
    got_d2 = torch.from_numpy(d2.copy())
    logits = pd_ops.min_dist_update(torch.from_numpy(x), torch.from_numpy(c), got_d2, torch.from_numpy(w),
                                    median=median)
    assert logits.dtype == torch.float32 and logits.shape == (3, 200)
    np.testing.assert_allclose(got_d2.numpy(), want_d2, rtol=1e-6, atol=0)
    kept = d2 <= want_d2  # rows whose running minimum the new center does not lower keep their bits
    np.testing.assert_array_equal(got_d2.numpy()[kept], d2[kept])
    real = w > 0
    np.testing.assert_array_equal(logits.numpy()[~real], -np.inf)
    np.testing.assert_allclose(logits.numpy()[real], want_logits[real], rtol=0, atol=1e-6)


@pytest.mark.parametrize("median", [False, True], ids=["means", "median"])
def test_zero_weight_is_minus_inf_and_distance_zero_takes_the_floor(median):
    x, c, d2, w = _inputs(B=2, n=50, d=5, seed=1)
    x[0, 7] = c[0]  # a real point on the center: distance exactly 0
    w[0, 7] = 1.5
    w[1, :10] = 0.0
    got_d2 = torch.from_numpy(d2.copy())
    logits = pd_ops.min_dist_update(torch.from_numpy(x), torch.from_numpy(c), got_d2, torch.from_numpy(w),
                                    median=median)
    assert got_d2[0, 7].item() == 0.0
    assert logits[0, 7].item() == torch.log(torch.tensor(pd_ref.SCORE_FLOOR, dtype=torch.float32)).item()
    assert bool(torch.isneginf(logits[1, :10]).all())
    assert bool(torch.isfinite(logits[torch.from_numpy(w) > 0]).all())
    # The same logits as the seeding's own _logits of the updated distances.
    score = torch.sqrt(torch.clamp_min(got_d2, 0.0)) if median else got_d2
    assert torch.equal(logits, t_km._logits(torch.from_numpy(w), score))


def _recording(monkeypatch):
    """Each step's running distance, copied as the loop hands it on."""
    steps = []
    inner = t_km.min_dist_update

    def update(x, c, d2, w, **kwargs):
        out = inner(x, c, d2, w, **kwargs)
        steps.append(d2.clone())
        return out

    monkeypatch.setattr(t_km, "min_dist_update", update)
    return steps


@pytest.mark.parametrize("median", [False, True], ids=["means", "median"])
def test_running_distance_is_the_minimum_over_the_chosen_centers(monkeypatch, median):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 300, 8)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, size=(2, 300)).astype(np.float32))
    steps = _recording(monkeypatch)
    k = 9
    centers = t_km.plusplus_init(x, k, weights=w, median=median, generator=torch.Generator().manual_seed(2))
    assert len(steps) == k - 1
    x64 = x.double()
    norms = (x64 ** 2).sum(-1)
    for i, d2 in enumerate(steps, start=1):
        chosen = centers[:, :i]
        exact = ((x64[:, :, None] - chosen.double()[:, None]) ** 2).sum(-1).min(-1).values
        torch.testing.assert_close(d2.double(), exact, rtol=1e-5, atol=0)
        ref = pd_ref.pairwise_sqdist_ref(x, chosen).min(-1).values.double()
        scale = norms + (chosen.double() ** 2).sum(-1).max(-1).values[:, None]
        assert bool(((d2.double() - ref).abs() <= 1e-5 * scale).all()), i
    # A chosen point is at distance exactly 0 from then on.
    last = steps[-1]
    for b in range(2):
        on = (x[b][:, None] == centers[b, : k - 1][None]).all(-1).any(-1)
        assert bool((last[b][on] == 0).all())


def _plusplus_full_passes(x, w, k, median, gen):
    """The reference's form of the loop: every step reassigns each point to
    all k slots (unchosen slots hold the first center)."""
    B, n, d = x.shape
    rows = torch.arange(B)
    first = t_km._sample(t_km._logits(w, torch.ones_like(w)), gen)
    centers = x[rows, first].unsqueeze(1).expand(B, k, d).contiguous()
    for i in range(1, k):
        _, d2 = pd_ops.assign_min(x, centers)
        score = torch.sqrt(torch.clamp_min(d2, 0.0)) if median else d2
        centers[:, i] = x[rows, t_km._sample(t_km._logits(w, score), gen)]
    return centers


@pytest.mark.parametrize("median", [False, True], ids=["means", "median"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeding_draws_what_full_passes_draw(median, seed):
    rng = np.random.default_rng(10 + seed)
    x = torch.from_numpy((rng.normal(size=(3, 150, 6)) + rng.integers(0, 20, size=(3, 150, 1))).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.0, 2.0, size=(3, 150)).astype(np.float32))
    w[:, ::7] = 0.0
    got = t_km.plusplus_init(x, 12, weights=w, median=median, generator=torch.Generator().manual_seed(seed))
    want = _plusplus_full_passes(x, w, 12, median, torch.Generator().manual_seed(seed))
    assert torch.equal(got, want)


def test_seeding_calls_min_dist_update_k_minus_1_times_and_assign_min_never():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 64, 3)).astype(np.float32))
    dispatch.reset_call_counts()
    t_km.plusplus_init(x, 7, median=True, generator=torch.Generator().manual_seed(0))
    counts = dispatch.call_counts()
    assert counts.get("min_dist_update") == 6 and counts.get("assign_min", 0) == 0


def test_op_analysis_counts_each_seeding_step_by_its_shapes():
    from repro_torch.launch.op_analysis import analyze

    x = torch.from_numpy(np.random.default_rng(5).normal(size=(4, 64, 3)).astype(np.float32))
    got = analyze(t_km.plusplus_init, x, 7, median=True, generator=torch.Generator().manual_seed(0))
    assert got["kernel_ops"] == {"min_dist_update": 6}
    assert got["flops_by_op"]["kernel:min_dist_update"] == 6 * 3.0 * 4 * 64 * 3  # a difference and an FMA


def test_min_dist_update_on_meta_runs_the_plain_version():
    dispatch.reset_launch_counts()
    x = torch.empty((2, 100, 8), device="meta")
    d2 = torch.empty((2, 100), device="meta")
    logits = pd_ops.min_dist_update(x, x[:, 0], d2, d2, median=True)
    assert logits.shape == (2, 100) and logits.device.type == "meta"
    assert not any(dispatch.launch_counts().values())


def test_min_dist_update_rejects_mismatched_shapes():
    x = torch.zeros((2, 10, 4))
    d2, w = torch.zeros((2, 10)), torch.ones((2, 10))
    with pytest.raises(ValueError, match="expected x"):
        pd_ops.min_dist_update(x, torch.zeros((2, 3)), d2, w, median=False)
    with pytest.raises(ValueError, match="expected x"):
        pd_ops.min_dist_update(x[0], torch.zeros(4), d2[0], w[0], median=False)
    with pytest.raises(TypeError, match="float32"):
        pd_ops.min_dist_update(x, x[:, 0], d2.double(), w, median=False)
    with pytest.raises(ValueError, match="CUDA"):
        pd_kernel.min_dist_update_cuda(x, x[:, 0], d2, w, False)
