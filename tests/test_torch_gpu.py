"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks for a CUDA card in a fixture and skips
without one.  Run them on a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it runs where only PyTorch is installed; the
CPU parity tests in ``test_torch_kernels.py`` share its cases and checks.

Tolerances: the kernel and the plain version compute in fp32 with the same
‖x‖²+‖c‖²−2x·cᵀ decomposition but other summation orders, so distances
agree to a few ulps of ‖x‖²+‖c‖² (rtol 1e-5, atol 1e-5·max); indices must
agree except at near ties (the two nearest squared distances within 1e-5 of
‖x‖² + d²).  Segment sums differ only in summation order: 1e-5 relative to
Σ|w·x|.  The segment sum must give the same bits on every run.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.pairwise_dist import ops as pd_ops
from repro_torch.kernels.pairwise_dist import ref as pd_ref
from repro_torch.kernels.weighted_segsum import ops as ss_ops

# (n, k, d, k_valid, duplicate centers)
ASSIGN_CASES = [
    pytest.param(37, 15, 2, None, False, id="k15-not-block-multiple-d2"),
    pytest.param(50, 13, 13, None, False, id="d13"),
    pytest.param(40, 20, 13, 13, False, id="k_valid-masking"),
    pytest.param(33, 12, 2, None, True, id="duplicate-center-ties"),
    pytest.param(64, 70, 2, None, False, id="k70-over-one-tile"),
]

# (n, k, d, batch)
SEGSUM_CASES = [
    pytest.param(37, 15, 2, 1, id="k15-d2"),
    pytest.param(50, 13, 13, 1, id="d13"),
    pytest.param(40, 9, 3, 3, id="batched-B3"),
]


def _assign_inputs(n, k, d, k_valid, dup, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    if dup:
        c[1::2] = c[0::2]
    if k_valid is not None:
        c[k_valid:] = 0.0  # padded centers are zeros, masked by index
    return x, c


def _decided(x, c, kv):
    """Rows whose two nearest centers are more than 1e-5 apart relative to
    ‖x‖² + d², the magnitude whose rounding the decomposition carries."""
    d2 = np.sort(np.asarray(pd_ref.pairwise_sqdist_ref(torch.from_numpy(x), torch.from_numpy(c)))[:, :kv], axis=1)
    return (d2[:, 1] - d2[:, 0]) > 1e-5 * ((x.astype(np.float64) ** 2).sum(1) + d2[:, 1])


def _check_assign(x, c, kv, idx, dist, want_idx, want_dist):
    dist, want_dist = np.asarray(dist), np.asarray(want_dist)
    np.testing.assert_allclose(dist, want_dist, rtol=1e-5, atol=1e-5 * want_dist.max())
    ok = _decided(x, c, kv)
    np.testing.assert_array_equal(np.asarray(idx)[ok], np.asarray(want_idx)[ok])



def _segsum_inputs(n, k, d, batch, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, n, d)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, size=(batch, n)).astype(np.float32)
    w[:, ::4] = 0.0  # weight-0 padded rows
    idx = rng.integers(0, k - 2, size=(batch, n)).astype(np.int32)  # clusters k-2, k-1 empty
    idx[:, 1::7] = -1  # outside [0, k): adds nothing
    idx[:, 2::9] = k + 3
    return x, w, idx


def _check_segsum(x, w, idx, sums, tot, want_sums, want_tot):
    scale = np.abs(x).max() * np.abs(w).sum()
    np.testing.assert_allclose(np.asarray(sums), np.asarray(want_sums), rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(tot), np.asarray(want_tot), rtol=1e-5, atol=1e-5 * np.abs(w).sum())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc for sm_90a and run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d,k_valid,dup", ASSIGN_CASES + [pytest.param(5000, 256, 128, None, False, id="d128-k256")])
def test_assign_min_kernel_matches_plain_on_card(cuda_device, n, k, d, k_valid, dup):
    x, c = _assign_inputs(n, k, d, k_valid, dup, seed=11)
    kv = k if k_valid is None else k_valid
    xt, ct = torch.from_numpy(x).to(cuda_device), torch.from_numpy(c).to(cuda_device)
    before = dispatch.launch_counts()["assign_min"]
    idx, dist = pd_ops.assign_min(xt, ct, k_valid=k_valid)
    assert dispatch.launch_counts()["assign_min"] == before + 1
    want_idx, want_dist = pd_ops.assign_min(xt, ct, k_valid=k_valid, impl="torch_ref")
    torch.cuda.synchronize()
    _check_assign(x, c, kv, idx.cpu(), dist.cpu(), want_idx.cpu(), want_dist.cpu())
    if dup:
        assert (idx.cpu() % 2 == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,d,batch", SEGSUM_CASES + [pytest.param(9000, 1000, 5, 2, id="k1000-tiled")])
def test_weighted_segsum_kernel_matches_plain_on_card(cuda_device, n, k, d, batch):
    x, w, idx = (torch.from_numpy(a).to(cuda_device) for a in _segsum_inputs(n, k, d, batch, seed=13))
    s1, t1 = ss_ops.weighted_segsum(x, w, idx, k)
    s2, t2 = ss_ops.weighted_segsum(x, w, idx, k)
    assert torch.equal(s1, s2) and torch.equal(t1, t2)  # deterministic: same bits
    want_s, want_t = ss_ops.weighted_segsum(x, w, idx, k, impl="torch_ref")
    torch.cuda.synchronize()
    _check_segsum(x.cpu().numpy(), w.cpu().numpy(), idx.cpu().numpy(), s1.cpu(), t1.cpu(), want_s.cpu(), want_t.cpu())
