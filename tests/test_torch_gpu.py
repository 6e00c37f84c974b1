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

The seeding's one-center step (``min_dist_update``): both sides sum the
direct differences (x − c)² in fp32, in other orders, so the running
squared distances agree at 1e-6 relative; the logits, log(max(w·score,
1e-12)), within 1e-6 + 1e-6·|logit| (1e-6 relative on w·score and an ulp
of the log); zero-weight rows are exactly −inf on both, and a point on the
center reads exactly 0.  One ``plusplus_init`` at k launches it k − 1
times and ``assign_min`` never.

Full squared distances (``pairwise_sqdist``): both sides sum the same
products of fp32 values in other orders, so an element may differ by a few
ulps of ‖x_i‖² + ‖c_j‖²: |Δ| ≤ 1e-5·(‖x_i‖² + ‖c_j‖²) + 1e-6, and no output
is negative.

3xTF32 ``assign_min`` (``TF32_ASSIGN_CASES``): the kernel's dot products run
on the TF32 tensor cores with each fp32 operand split into two TF32 pieces,
which keeps them within about 2^-22 of |x||c|; the same tolerances hold, and
two runs give the same bits.

``assign_min`` returns the chosen center's distance summed directly in
fp32, not the tensor cores' ‖x‖²+‖c‖²−2x·c: the truncating fp32
accumulation of the products puts that minimum high by a few ulps of |x||c|
every time, which a sum of minima keeps whole.  Over 60,000 points near
their centers at |x|² ≈ 43 the minima's mean error stays under 1e-7 of
their mean, and a ``step_cost`` through the kernel agrees with the plain
path to 1e-5.

The resilience runtime on the card: ``device_recovery_masked`` within
1e-5·max|b| of the CPU, also with TF32 allowed for matmuls (its products
are matrix-vector products, which TF32 never enters); the solve and the
Lemma-3 combine make no synchronising call; an elastic patch rewrites only
the moved node rows of the resident shards, in place.

The mesh executor on the card: a world of one over NCCL and two ranks over
gloo on one card run Algorithm 1 within 1e-5 of the local executor, with
both kernels launched on every rank.

The MoE combine on the card gives the same bits on every run, equal to the
serial expert-by-expert sum on the CPU.  The xLSTM blocks run no kernel of
the port: a block at full width in f32 on the card lies within 1e-5 of its
scale of the same block on the CPU (cuBLAS and the CPU's GEMMs sum in other
orders).  Nor do RecurrentGemma's: the windowed chunked attention on the
card against the masked dense oracle (rtol 2e-5, atol 2e-4, the band of
the reference's chunked tests), the smoke model's ring decode against its
forward and its CPU run at 1e-5 of the logits' scale.

Flash attention: f32 inputs rtol 1e-5, atol 1e-5 (the kernel sums three
bf16 pieces of each f32 value on the tensor cores, about 2^-24 of each
product, in another order than the plain version's f32 GEMMs); bf16 inputs
rtol 2^-7, atol 1e-3 (both sides sum exact products in f32 in other orders
and round the output to bf16, so they may differ by one bf16 ulp).

Flash attention's gradients (``ops.FlashAttentionFn``: the kernel forward,
the plain ``attention_bwd_ref`` backward) against ``torch.autograd.grad`` of
the plain ``attention_ref``: max|Δ| of dq, dk and dv within 2e-2 of each
one's max in bf16 (the two forwards' outputs differ by a bf16 ulp, which
enters rowsum(dO∘O), and each gradient is rounded to bf16), 1e-4 in f32.
A smoke model's train step on the card launches the kernel once a layer
and its loss lies within 2e-2 of the step through the plain attention.
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import deepseek_moe_16b, qwen3_4b
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serve import decode as D
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

# 3xTF32 tiles of 128 rows x 128 centers, with d staged in chunks of 32:
# ragged n, k of 1, 7, one tile and one more, two tiles; d = 2 and 13 (the
# 4-byte copies), 64 and 128 (16-byte copies), 130 (a ragged last chunk)
TF32_ASSIGN_CASES = [
    pytest.param(n, k, d, id=f"n{n}-k{k}-d{d}")
    for n in (127, 129) for k in (1, 7, 129, 256) for d in (2, 13, 64, 128, 130)
]

# (n, k, d, duplicate rows): ragged n and k, d in {2, 13, 64}, k over one
# 64-wide tile, k = 1, and exact duplicates among the rows and centers
SQDIST_CASES = [
    pytest.param(37, 15, 2, False, id="n37-k15-d2"),
    pytest.param(50, 13, 13, False, id="n50-k13-d13"),
    pytest.param(130, 70, 64, False, id="k70-over-one-tile-d64"),
    pytest.param(65, 1, 13, False, id="k1-d13"),
    pytest.param(33, 12, 2, True, id="duplicate-rows-d2"),
    pytest.param(40, 20, 64, True, id="duplicate-rows-d64"),
]

# (B, n, d): the local solve's shape and the coordinator's (16-byte loads),
# d = 3 (4-byte loads, most lanes of the warp idle), d = 130 (4-byte loads,
# a ragged last stride of the warp), d = 8 (two 16-byte units), n off any
# block's row count, B = 1
MIN_DIST_CASES = [
    pytest.param(10, 400000, 128, id="local-solve"),
    pytest.param(1, 10240, 128, id="coordinator"),
    pytest.param(3, 1001, 3, id="d3"),
    pytest.param(2, 777, 130, id="d130"),
    pytest.param(4, 999, 8, id="d8"),
    pytest.param(1, 33, 128, id="B1-n33"),
]

# (n, k, d, batch)
SEGSUM_CASES = [
    pytest.param(37, 15, 2, 1, id="k15-d2"),
    pytest.param(50, 13, 13, 1, id="d13"),
    pytest.param(40, 9, 3, 3, id="batched-B3"),
]

# The streamed weighted_segsum: row ranges of ROWS_PER_CHUNK = 2048 rows.
# n = 2048m - 1, 2048m, 2048m + 1 at d = 128 (whole rows by one bulk copy per
# stage, the whole (k, d+1) accumulator of k = 256 in shared memory); k =
# 1000 at d = 128 (slices of columns: (k, d+1) exceeds the budget); k =
# 12000 at d = 4 (not even 32 columns of all k fit: k tiles); d = 13
# (unaligned rows: 4-byte copies); B = 10 with batch 3 all zero weights
SEGSUM_STREAM_CASES = [
    pytest.param(4096 + dn, 256, 128, 1, id=f"n{4096 + dn}-k256-d128") for dn in (-1, 0, 1)
] + [
    pytest.param(4097, 1000, 128, 1, id="k1000-d128-column-slices"),
    pytest.param(5000, 12000, 4, 1, id="k12000-d4-k-tiles"),
    pytest.param(4097, 256, 13, 2, id="d13-unaligned-B2"),
    pytest.param(2049, 64, 128, 10, id="B10-one-batch-zero-weights"),
]


# The 3xTF32 wgmma tile of pairwise_sqdist: k = 256 (one 256-center tile),
# 300 and 513 (ragged second and third tiles; 513 and 7 store with 4-byte
# stores, k*4 not a multiple of 16), d = 13 (unaligned rows), n = 1 and 129
# (ragged row tiles), n = 40000 (more row tiles than SMs: the persistent
# blocks walk several), duplicate rows (distances clamped at 0)
SQDIST_TILE_CASES = [
    pytest.param(129, 256, 128, False, id="n129-k256-d128"),
    pytest.param(1, 256, 128, False, id="n1-k256-d128"),
    pytest.param(129, 300, 128, False, id="n129-k300-d128"),
    pytest.param(300, 513, 64, False, id="n300-k513-d64"),
    pytest.param(129, 513, 13, False, id="n129-k513-d13"),
    pytest.param(1, 7, 13, False, id="n1-k7-d13"),
    pytest.param(40000, 256, 128, False, id="n40000-k256-d128-persistent"),
    pytest.param(258, 256, 128, True, id="duplicate-rows-k256-d128"),
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
    if kv < 2:  # one candidate: nothing to decide between
        return np.ones(x.shape[0], dtype=bool)
    d2 = np.sort(np.asarray(pd_ref.pairwise_sqdist_ref(torch.from_numpy(x), torch.from_numpy(c)))[:, :kv], axis=1)
    return (d2[:, 1] - d2[:, 0]) > 1e-5 * ((x.astype(np.float64) ** 2).sum(1) + d2[:, 1])


def _check_assign(x, c, kv, idx, dist, want_idx, want_dist):
    dist, want_dist = np.asarray(dist), np.asarray(want_dist)
    np.testing.assert_allclose(dist, want_dist, rtol=1e-5, atol=1e-5 * want_dist.max())
    ok = _decided(x, c, kv)
    np.testing.assert_array_equal(np.asarray(idx)[ok], np.asarray(want_idx)[ok])



def _sqdist_inputs(n, k, d, dup, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    if dup:  # duplicate rows, and centers equal to rows: distances of exactly 0
        x[1::2] = x[0::2][: x[1::2].shape[0]]
        c[: min(k, n) : 2] = x[: min(k, n) : 2]
    return x, c


def _check_sqdist_on_card(x, c, got, want):
    """The kernel's bound against the plain version (see the module doc)."""
    x2 = (x.double() ** 2).sum(1)[:, None]
    c2 = (c.double() ** 2).sum(1)[None, :]
    err = (got.double() - want.double()).abs()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool((got >= 0).all())
    assert bool((err <= 1e-5 * (x2 + c2) + 1e-6).all()), float(err.max())


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


# (B, T, S, H, KV, dh): T == S at two tile-multiples and a ragged 100, and
# T < S (a query block at the end of the key timeline); dh 16 takes the
# mma-sync kernel in bf16, dh 64 the tma-wgmma one
FLASH_CASES = [
    pytest.param(2, t, t, 4, kv, dh, id=f"T{t}-KV{kv}-dh{dh}")
    for t in (8, 64, 100) for kv in (1, 2, 4) for dh in (16, 64)
] + [
    pytest.param(2, 16, 32, 4, kv, dh, id=f"T16-S32-KV{kv}-dh{dh}")
    for kv in (1, 2, 4) for dh in (16, 64)
]

# bf16 at dh 64 and 128 (the tma-wgmma kernel): T = S at the edges of its
# 128-row query tile and 128-key tile, T < S with S - T = 37, KV of 1 (one kv
# head for all) and 8 (one each); causal unless the id says otherwise
WGMMA_FLASH_CASES = [
    pytest.param(1, t, t, 8, kv, dh, True, id=f"T{t}-KV{kv}-dh{dh}")
    for t in (127, 128, 129, 300) for kv in (1, 8) for dh in (64, 128)
] + [
    pytest.param(2, t, t + 37, 8, kv, dh, True, id=f"T{t}-S{t + 37}-KV{kv}-dh{dh}")
    for t in (100, 263) for kv in (1, 8) for dh in (64, 128)
] + [
    pytest.param(1, 129, 129, 8, 2, dh, False, id=f"T129-noncausal-dh{dh}") for dh in (64, 128)
]

FLASH_TOL = {
    torch.float32: dict(rtol=1e-5, atol=1e-5),
    torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3),
}


def _flash_inputs(B, T, S, H, KV, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    return q, k, v


def _check_flash(got, want, dtype):
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), **FLASH_TOL[dtype])


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
@pytest.mark.parametrize("n,k,d", TF32_ASSIGN_CASES)
def test_assign_min_tf32_tiles_match_plain_on_card(cuda_device, n, k, d):
    x, c = _assign_inputs(n, k, d, None, False, seed=n + 7 * k + d)
    xt, ct = torch.from_numpy(x).to(cuda_device), torch.from_numpy(c).to(cuda_device)
    before = dispatch.launch_counts()["assign_min"]
    idx, dist = pd_ops.assign_min(xt, ct)
    idx2, dist2 = pd_ops.assign_min(xt, ct)
    assert dispatch.launch_counts()["assign_min"] == before + 2
    assert torch.equal(idx, idx2) and torch.equal(dist, dist2)  # same bits on every run
    want_idx, want_dist = pd_ops.assign_min(xt, ct, impl="torch_ref")
    torch.cuda.synchronize()
    _check_assign(x, c, k, idx.cpu(), dist.cpu(), want_idx.cpu(), want_dist.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("k_valid", [None, 200], ids=["all-valid", "k_valid200"])
def test_assign_min_tf32_batched_duplicates_on_card(cuda_device, k_valid):
    # B = 10 nodes, two center tiles, every center duplicated (pairs 2j, 2j+1
    # lie in one 8-column fragment, pairs j, j+128 in two tiles)
    rng = np.random.default_rng(29)
    x = rng.normal(size=(10, 129, 128)).astype(np.float32)
    c = rng.normal(size=(10, 256, 128)).astype(np.float32)
    c[:, 1:128:2] = c[:, 0:128:2]
    c[:, 128:] = c[:, :128]
    kv = 256 if k_valid is None else k_valid
    xt, ct = torch.from_numpy(x).to(cuda_device), torch.from_numpy(c).to(cuda_device)
    idx, dist = pd_ops.assign_min(xt, ct, k_valid=k_valid)
    idx2, dist2 = pd_ops.assign_min(xt, ct, k_valid=k_valid)
    assert torch.equal(idx, idx2) and torch.equal(dist, dist2)
    want_idx, want_dist = pd_ops.assign_min(xt, ct, k_valid=k_valid, impl="torch_ref")
    torch.cuda.synchronize()
    idx, dist = idx.cpu().numpy(), dist.cpu().numpy()
    assert ((idx % 2) == 0).all() and (idx < 128).all()  # the first of every set of equal centers
    assert (idx < kv).all()
    for b in range(10):
        _check_assign(x[b], c[b], kv, idx[b], dist[b], want_idx[b].cpu(), want_dist[b].cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("median", [False, True], ids=["means", "median"])
@pytest.mark.parametrize("B,n,d", MIN_DIST_CASES)
def test_min_dist_update_kernel_matches_plain_on_card(cuda_device, B, n, d, median):
    g = torch.Generator(device=cuda_device).manual_seed(B * 1000 + d)
    x = torch.randn((B, n, d), generator=g, device=cuda_device) * 8.0
    x += torch.rand((B, 1, d), generator=g, device=cuda_device) * 64.0
    centers = x[:, :5].clone()  # c is a column of a (B, k, d) center set, as the seeding passes it
    c = centers[:, 2]
    x[:, n // 2] = c  # a point on the center: distance exactly 0
    dist = ((x - c[:, None]) ** 2).sum(-1)
    d2 = dist * (0.5 + torch.rand((B, n), generator=g, device=cuda_device))  # about half the rows keep theirs
    w = torch.rand((B, n), generator=g, device=cuda_device) * 2.0
    w[torch.rand((B, n), generator=g, device=cuda_device) < 0.2] = 0.0
    w[:, n // 2] = 1.0
    d2_k, d2_p = d2.clone(), d2.clone()
    before = dispatch.launch_counts()["min_dist_update"]
    got = pd_ops.min_dist_update(x, c, d2_k, w, median=median)
    assert dispatch.launch_counts()["min_dist_update"] == before + 1
    want = pd_ops.min_dist_update(x, c, d2_p, w, median=median, impl="torch_ref")
    torch.cuda.synchronize()
    torch.testing.assert_close(d2_k, d2_p, rtol=1e-6, atol=0)
    assert bool((d2_k[:, n // 2] == 0).all())
    zero = w == 0
    assert bool(torch.isneginf(got[zero]).all()) and bool(torch.isfinite(got[~zero]).all())
    torch.testing.assert_close(got[~zero], want[~zero], rtol=1e-6, atol=1e-6)
    floor = torch.log(torch.tensor(pd_ref.SCORE_FLOOR, dtype=torch.float32))
    assert bool((got[:, n // 2].cpu() == floor).all())


@pytest.mark.gpu
def test_plusplus_launches_min_dist_update_k_minus_1_times_on_card(cuda_device):
    from repro_torch.core.kmeans import plusplus_init

    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((3, 5000, 128), generator=g, device=cuda_device)
    w = torch.rand((3, 5000), generator=g, device=cuda_device)
    before = dispatch.launch_counts()
    centers = plusplus_init(x, 64, weights=w, median=True, generator=torch.Generator(device=cuda_device).manual_seed(1))
    after = dispatch.launch_counts()
    assert after["min_dist_update"] - before["min_dist_update"] == 63
    assert after["assign_min"] == before["assign_min"]
    for b in range(3):  # every center is a row of its node's points
        assert bool((centers[b][:, None] == x[b][None]).all(-1).any(-1).all())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,k,d,dup",
    SQDIST_CASES + [pytest.param(5000, 256, 128, False, id="d128-k256"),
                    pytest.param(3, 300, 7, False, id="n3-k300")] + SQDIST_TILE_CASES,
)
def test_pairwise_sqdist_kernel_matches_plain_on_card(cuda_device, n, k, d, dup):
    x, c = (torch.from_numpy(a).to(cuda_device) for a in _sqdist_inputs(n, k, d, dup, seed=23))
    before = dispatch.launch_counts()["pairwise_sqdist"]
    got = pd_ops.pairwise_sqdist(x, c)
    assert dispatch.launch_counts()["pairwise_sqdist"] == before + 1
    again = pd_ops.pairwise_sqdist(x, c)
    want = pd_ops.pairwise_sqdist(x, c, impl="torch_ref")
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # the same bits on every run
    _check_sqdist_on_card(x.cpu(), c.cpu(), got.cpu(), want.cpu())


@pytest.mark.gpu
def test_pairwise_sqdist_kernel_edges_on_card(cuda_device):
    x = torch.rand(10, 4, device=cuda_device)
    before = dispatch.launch_counts()["pairwise_sqdist"]
    assert pd_ops.pairwise_sqdist(x[:0], x).shape == (0, 10)  # n = 0: no launch
    assert dispatch.launch_counts()["pairwise_sqdist"] == before
    with pytest.raises(ValueError, match="d must be positive"):
        pd_ops.pairwise_sqdist(x[:, :0], x[:, :0])
    with pytest.raises(TypeError, match="float32"):
        pd_ops.pairwise_sqdist(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        pd_ops.pairwise_sqdist(x.T.contiguous().T, x)
    with pytest.raises(ValueError, match="one device"):
        pd_ops.pairwise_sqdist(x, x.cpu())


@pytest.mark.gpu
def test_resilient_pca_on_card_matches_cpu(cuda_device):
    from repro_torch.core import bernoulli_assignment, fixed_count_stragglers, resilient_pca
    from repro_torch.data.synthetic import planted_subspaces

    pts, _ = planted_subspaces(800, 1, 24, 4, noise=0.05, rng=np.random.default_rng(11))
    pts = pts - pts.mean(0, keepdims=True)
    a = bernoulli_assignment(len(pts), 10, ell=8.0, rng=np.random.default_rng(12))
    alive = fixed_count_stragglers(10, 3, np.random.default_rng(13))
    on_card = resilient_pca(pts, 4, 0.25, a, alive, device=cuda_device)
    on_cpu = resilient_pca(pts, 4, 0.25, a, alive, device="cpu")
    assert on_card.cost == pytest.approx(on_cpu.cost, rel=1e-3)
    assert (on_card.r1, on_card.sketch_rows) == (on_cpu.r1, on_cpu.sketch_rows)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n,k,d,batch", SEGSUM_CASES + [pytest.param(9000, 1000, 5, 2, id="k1000-tiled")] + SEGSUM_STREAM_CASES)
def test_weighted_segsum_kernel_matches_plain_on_card(cuda_device, n, k, d, batch):
    x, w, idx = _segsum_inputs(n, k, d, batch, seed=13)
    if batch == 10:
        w[3] = 0.0  # one batch of zero weights
    x, w, idx = (torch.from_numpy(a).to(cuda_device) for a in (x, w, idx))
    before = dispatch.launch_counts()["weighted_segsum"]
    s1, t1 = ss_ops.weighted_segsum(x, w, idx, k)
    s2, t2 = ss_ops.weighted_segsum(x, w, idx, k)
    assert dispatch.launch_counts()["weighted_segsum"] == before + 2
    assert torch.equal(s1, s2) and torch.equal(t1, t2)  # deterministic: same bits
    want_s, want_t = ss_ops.weighted_segsum(x, w, idx, k, impl="torch_ref")
    sa, ta = ss_ops.weighted_segsum(x.abs(), w.abs(), idx, k, impl="torch_ref")
    torch.cuda.synchronize()
    _check_segsum(x.cpu().numpy(), w.cpu().numpy(), idx.cpu().numpy(), s1.cpu(), t1.cpu(), want_s.cpu(), want_t.cpu())
    # 1e-5 of Σ|w·x| per (cluster, column), as chip_smoke.py holds it
    assert bool(((s1 - want_s).abs() <= 1e-5 * sa).all()) and bool(((t1 - want_t).abs() <= 1e-5 * ta).all())
    if batch == 10:
        assert not bool(s1[3].any()) and not bool(t1[3].any())




@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize(
    "B,T,S,H,KV,dh",
    FLASH_CASES + [pytest.param(4, 2048, 2048, 32, 8, 128, id="prefill-T2048-H32-KV8-dh128")],
)
def test_flash_attention_kernel_matches_plain_on_card(cuda_device, B, T, S, H, KV, dh, dtype):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in _flash_inputs(B, T, S, H, KV, dh, seed=17))
    before = dispatch.launch_counts()["flash_attention"]
    got = fa_ops.flash_attention(q, k, v)
    assert dispatch.launch_counts()["flash_attention"] == before + 1
    want = fa_ops.flash_attention(q, k, v, impl="torch_ref")
    torch.cuda.synchronize()
    _check_flash(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,S,H,KV,dh,causal", WGMMA_FLASH_CASES)
def test_flash_attention_tma_wgmma_matches_plain_on_card(cuda_device, B, T, S, H, KV, dh, causal):
    assert fa_kernel.route(torch.bfloat16, dh) == "tma-wgmma"
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _flash_inputs(B, T, S, H, KV, dh, seed=T + S + dh))
    before = dispatch.launch_counts()["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    assert dispatch.launch_counts()["flash_attention"] == before + 1
    want = fa_ops.flash_attention(q, k, v, causal=causal, impl="torch_ref")
    torch.cuda.synchronize()
    _check_flash(got, want, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_tma_wgmma_reads_strided_views_on_card(cuda_device, dh):
    # q, k and v as head slices of one fused (B, T, H + 2·KV, dh) tensor, and
    # that tensor a slice of a wider one: row strides that are not H·dh
    B, T, H, KV = 2, 200, 8, 2
    wide = np.random.default_rng(31).normal(size=(B, T, H + 2 * KV + 3, dh)).astype(np.float32)
    fused = torch.from_numpy(wide).to(cuda_device, torch.bfloat16)[:, :, 1 : 1 + H + 2 * KV]
    q, k, v = fused[:, :, :H], fused[:, :, H : H + KV], fused[:, :, H + KV :]
    assert q.stride(1) != H * dh and k.stride(1) != KV * dh
    before = dispatch.launch_counts()["flash_attention"]
    got = fa_ops.flash_attention(q, k, v)
    assert dispatch.launch_counts()["flash_attention"] == before + 1
    want = fa_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), impl="torch_ref")
    torch.cuda.synchronize()
    assert got.is_contiguous()
    _check_flash(got, want, torch.bfloat16)


@pytest.mark.gpu
def test_flash_attention_kernel_reads_strided_views_and_refuses_other_widths(cuda_device):
    # q, k and v as head slices of one fused (B, T, H + 2·KV, dh) tensor:
    # the kernel reads them in place from their strides.
    B, T, H, KV, dh = 2, 80, 4, 2, 64
    fused = torch.from_numpy(np.random.default_rng(19).normal(size=(B, T, H + 2 * KV, dh)).astype(np.float32))
    fused = fused.to(cuda_device, torch.bfloat16)
    q, k, v = fused[:, :, :H], fused[:, :, H : H + KV], fused[:, :, H + KV :]
    assert not q.is_contiguous()
    got = fa_ops.flash_attention(q, k, v)
    want = fa_ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), impl="torch_ref")
    torch.cuda.synchronize()
    _check_flash(got, want, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 24"):
        fa_ops.flash_attention(q[..., :24], k[..., :24], v[..., :24])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("B,T,H,KV,dh", [(2, 100, 8, 2, 64), (1, 300, 14, 2, 64), (2, 130, 4, 4, 128)])
def test_flash_attention_gradients_match_autograd_of_plain_on_card(cuda_device, B, T, H, KV, dh, dtype):
    arrays = _flash_inputs(B, T, T, H, KV, dh, seed=T + H)
    leaves = [torch.from_numpy(a).to(cuda_device, dtype).requires_grad_() for a in arrays]
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    do = torch.randn((B, T, H, dh), generator=torch.Generator().manual_seed(dh)).to(cuda_device, dtype)
    before = dispatch.launch_counts()["flash_attention"]
    out = fa_ops.flash_attention(*leaves)
    assert dispatch.launch_counts()["flash_attention"] == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    want = torch.autograd.grad(fa_ops.flash_attention(*plain, impl="torch_ref"), plain, do)
    band = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, want):
        assert g.dtype == dtype and float((g.float() - w.float()).abs().max()) <= band * float(w.float().abs().max())
    with pytest.raises(RuntimeError, match="no gradient"):
        fa_kernel.flash_attention_cuda(*leaves, causal=True, scale=dh ** -0.5)


@pytest.mark.gpu
def test_train_step_on_card_runs_the_kernel_forward(cuda_device):
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS

    cfg = qwen3_4b.smoke_config()
    tokens = torch.randint(0, cfg.vocab, (4, 64), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(3))
    batch = {"tokens": tokens, "group_weights": torch.tensor([1.0, 0.0, 2.0, 1.0], device=cuda_device)}
    losses = []
    for impl in ("auto", "torch_ref"):
        state = TS.init_train_state(cfg, generator=torch.Generator(device=cuda_device).manual_seed(4))
        step = TS.make_train_step(cfg, T.ModelContext(attn_impl=impl), O.AdamWConfig())
        before = dispatch.launch_counts()["flash_attention"]
        state, metrics = step(state, batch)
        launched = dispatch.launch_counts()["flash_attention"] - before
        assert launched == (cfg.n_layers if impl == "auto" else 0)
        assert all(bool(p.isfinite().all()) for p in state.params.parameters()) and state.opt.step == 1
        losses.append(float(metrics["loss"]))
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[1])


@pytest.mark.gpu
def test_device_recovery_step_on_card_through_the_kernel_and_the_plain_attention(cuda_device):
    """One step of the mesh-native resilient trainer at the smoke size, FR
    with one straggler: through the kernel (one flash launch a layer and a
    group) and through the plain attention, from the same weights; the
    recovery solved on the card, no host solve; the losses within the bf16
    band, the updated parameters finite."""
    from repro_torch.train import optimizer as O
    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = qwen3_4b.smoke_config()
    tc = TrainerConfig(num_groups=4, num_shards=4, redundancy=2, scheme="fr", microbatch=1, seq_len=64, steps=1,
                       device_recovery=True, resident_steps=1, warm_start=False)
    records = []
    for impl in ("auto", "torch_ref"):
        init = TS.init_train_state(cfg, generator=torch.Generator(device=cuda_device).manual_seed(4))
        t = Trainer(cfg, tc, O.AdamWConfig(), T.ModelContext(attn_impl=impl), device=cuda_device,
                    initial_state=init)
        state, _ = t.init_state()
        before = dispatch.launch_counts()["flash_attention"]
        state, rec = t._device_recovery_step(state, 0, np.array([True, False, True, True]))
        launched = dispatch.launch_counts()["flash_attention"] - before
        assert launched == (tc.num_groups * cfg.n_layers if impl == "auto" else 0)
        assert not rec["fallback"] and rec["host_solves"] == 0 and rec["device_solves"] == 1
        assert abs(rec["b_sum"] - 2.0) <= 1e-4
        assert all(bool(p.isfinite().all()) for p in state.params.parameters()) and state.opt.step == 1
        records.append(rec)
    assert abs(records[0]["loss"] - records[1]["loss"]) <= 2e-2 * abs(records[1]["loss"])


@pytest.mark.gpu
def test_serving_on_card_prefills_through_the_kernel_and_decodes_without_it(cuda_device):
    cfg = qwen3_4b.smoke_config()
    model = T.init_params(cfg, generator=torch.Generator(device=cuda_device).manual_seed(0))
    model = T.cast_params(model, cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 100), device=cuda_device,
                           generator=torch.Generator(device=cuda_device).manual_seed(1))
    before = dispatch.launch_counts()["flash_attention"]
    logits, cache = D.make_prefill_fn(cfg, T.ModelContext())(model, {"tokens": tokens})
    assert dispatch.launch_counts()["flash_attention"] == before + cfg.n_layers
    want, _ = D.make_prefill_fn(cfg, T.ModelContext(attn_impl="torch_ref"))(model, {"tokens": tokens})
    torch.testing.assert_close(logits.float(), want.float(), rtol=2e-2, atol=2e-2)  # the bf16 band
    out = D.greedy_generate(model, cfg, tokens[:, :8], steps=4)
    assert dispatch.launch_counts()["flash_attention"] == before + cfg.n_layers  # decode: plain attention
    assert out.shape == (2, 4) and out.device.type == "cuda"


@pytest.mark.gpu
def test_moe_prefill_on_card_matches_its_cpu_run_by_the_flip_rule(cuda_device):
    """deepseek-moe-16b's smoke model, bf16: the card's prefill (the flash
    kernel, cuBLAS, atomic scatter-adds) against the same weights' CPU run.
    An ulp at a near tie may flip a routing decision, so: with no routing
    difference the logits lie within the bf16 band; otherwise every layer up
    to and including the first that differs has its K cache within 2e-2
    relative in norm (tests/test_torch_moe.py).  Then the card runs again
    with the CPU run's decisions replayed, and the logits and every layer's
    K and V caches lie within the band."""
    cfg = deepseek_moe_16b.smoke_config()
    cpu_model = T.init_params(cfg, generator=torch.Generator().manual_seed(0))
    model = T.model_from_state_dict(cfg, {k: v.to(cuda_device) for k, v in cpu_model.state_dict().items()})
    tokens = torch.randint(0, cfg.vocab, (2, 100), generator=torch.Generator().manual_seed(1))
    prefill = D.make_prefill_fn(cfg, T.ModelContext())
    before = dispatch.launch_counts()["flash_attention"]
    with M.recorded_routing() as got:
        logits, cache = prefill(model, {"tokens": tokens.to(cuda_device)})
    assert dispatch.launch_counts()["flash_attention"] == before + cfg.n_layers
    with M.recorded_routing() as ref:
        want, want_cache = prefill(cpu_model, {"tokens": tokens})
    differ = M.routing_differences(got, ref)
    first = next((li for li, c in enumerate(differ) if c), None)

    def gap(c, li, key):
        a, b = c[li][key].float().cpu(), want_cache[li][key].float()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    if first is None:
        torch.testing.assert_close(logits.float().cpu(), want.float(), rtol=2e-2, atol=2e-2)
    for li in range(cfg.n_layers if first is None else first + 1):
        assert gap(cache, li, "k") <= 2e-2, (li, differ)
    with M.recorded_routing(replay=ref):
        logits, cache = prefill(model, {"tokens": tokens.to(cuda_device)})
    torch.testing.assert_close(logits.float().cpu(), want.float(), rtol=2e-2, atol=2e-2)
    for li in range(cfg.n_layers):
        assert gap(cache, li, "k") <= 2e-2 and gap(cache, li, "v") <= 2e-2, (li, differ)


def _serial_combine(weighted, idx, n):
    """The reference's serial scatter-add on the CPU, expert by expert (one
    expert's kept tokens are distinct: one rounded add a row a step)."""
    flat = torch.zeros((n, weighted.shape[-1]), dtype=weighted.dtype)
    for e in range(weighted.shape[0]):
        flat[idx[e]] = flat[idx[e]] + weighted[e]
    return flat


@pytest.mark.gpu
def test_moe_combine_on_card_is_deterministic_and_serial(cuda_device):
    """The MoE combine at 4096 tokens, 64 experts top-6, capacity 480 (it
    binds at the busy experts, and quiet ones keep zero-weight slots), bf16:
    two runs on the card equal bit for bit, and equal to the serial sum on
    the CPU of the same outputs and kept tokens."""
    n, E, k, d = 4096, 64, 6, 512
    g = torch.Generator().manual_seed(21)
    scores = torch.rand((n, E), generator=g) * torch.linspace(0.5, 1.5, E)  # busy and quiet experts
    vals, experts = M._topk(scores, k)
    w = torch.zeros((n, E)).scatter_(1, experts, vals)
    cap = M.capacity(n, deepseek_moe_16b.config().moe)
    load = (w > 0).sum(0)
    assert cap == 480 and int(load.max()) > cap and int(load.min()) < cap
    vals, idx = M._topk(w.T, cap)
    out = torch.randn((E, cap, d), generator=g).bfloat16()
    want = _serial_combine(out * vals[..., None].bfloat16(), idx, n)
    runs = [M._combine(out.to(cuda_device), idx.to(cuda_device), vals.to(cuda_device), n, k) for _ in range(2)]
    torch.cuda.synchronize()
    assert runs[0].dtype == torch.bfloat16 and torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0].cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_block_at_full_width_on_card_matches_cpu(cuda_device, kind):
    """One block of xlstm-1.3b at full width (d_model 2048, 4 heads: mLSTM
    heads of 1024) in f32: 512 tokens through the forward (two chunks of
    256 for the mLSTM), then 4 decode steps from its zero state; outputs and
    states on the card within 1e-5 of their scale of the CPU's (TF32 off)."""
    from repro_torch.models import xlstm as X
    from repro_torch.models.registry import get_config

    cfg = get_config("xlstm-1.3b", compute_dtype="float32")
    block = X.MLSTMBlock if kind == "mlstm" else X.SLSTMBlock
    cpu = block(cfg, dtype=torch.float32, device="cpu", generator=torch.Generator().manual_seed(22))
    card = block(cfg, dtype=torch.float32, device="meta", generator=None)
    card.load_state_dict({name: t.to(cuda_device) for name, t in cpu.state_dict().items()}, assign=True)
    apply = X.mlstm_apply if kind == "mlstm" else X.slstm_apply
    step = X.mlstm_decode_step if kind == "mlstm" else X.slstm_decode_step
    init = X.mlstm_init_state if kind == "mlstm" else X.slstm_init_state
    x = torch.randn((1, 512, cfg.d_model), generator=torch.Generator().manual_seed(23))

    def gap(a, b):
        return float((a.cpu() - b).abs().max() / b.abs().max())

    with torch.no_grad():
        assert gap(apply(card, x.to(cuda_device), cfg), apply(cpu, x, cfg)) <= 1e-5
        s_cpu, s_card = init(cfg, 1, device="cpu"), init(cfg, 1, device=cuda_device)
        for t in range(4):
            o_cpu, s_cpu = step(cpu, s_cpu, x[:, t : t + 1], cfg)
            o_card, s_card = step(card, s_card, x[:, t : t + 1].to(cuda_device), cfg)
            assert gap(o_card, o_cpu) <= 1e-5, t
            assert max(gap(s_card[key], s_cpu[key]) for key in s_cpu if s_cpu[key].abs().max() > 0) <= 1e-5, t


@pytest.mark.gpu
def test_windowed_chunked_attention_on_card_matches_the_masked_oracle(cuda_device):
    """RecurrentGemma's local attention at its head width (16 heads over 1
    KV head of 256), T = 2048, window 512, f32: the chunked attention on
    the card (skipping key blocks outside each chunk's window) against the
    dense masked oracle, at the band of tests/test_kernels.py's windowed
    chunked test (rtol 2e-5, atol 2e-4), with no kernel launch."""
    B, T_len, H, KV, dh, W = 1, 2048, 16, 1, 256, 512
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _flash_inputs(B, T_len, T_len, H, KV, dh, seed=31))
    before = dict(dispatch.launch_counts())
    got = fa_ops.flash_attention(q, k, v, causal=True, window=W)
    assert dispatch.launch_counts() == before
    s = torch.einsum("bthd,bshd->bhts", q, k.repeat_interleave(H // KV, 2)) * dh**-0.5
    pos = torch.arange(T_len, device=cuda_device)
    mask = (pos[:, None] >= pos[None, :]) & (pos[None, :] > pos[:, None] - W)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    want = torch.einsum("bhts,bshd->bthd", p, v.repeat_interleave(H // KV, 2))
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
    with pytest.raises(ValueError, match="has no sliding window"):
        fa_ops.flash_attention(q, k, v, window=W, impl="cuda")


@pytest.mark.gpu
def test_recurrentgemma_ring_decode_on_card(cuda_device):
    """recurrentgemma-9b's smoke model (window 32) in f32 on the card: 80
    tokens teacher-forced through decode_step (the ring wraps twice)
    against forward_train, within 1e-5 of the logits' scale (the CPU gives
    2.2e-6), and each step's logits against the same model's CPU decode at
    1e-5 of the scale; no kernel launch.  The same decode with the window
    raised to 128 (no wrap) parts from the window-32 forward past the
    window: the ring is what binds."""
    import dataclasses

    from repro_torch.configs import recurrentgemma_9b

    cfg = dataclasses.replace(recurrentgemma_9b.smoke_config(), compute_dtype="float32")
    cpu = T.init_params(cfg, generator=torch.Generator().manual_seed(20))
    card = T.model_from_state_dict(cfg, {name: t.to(cuda_device) for name, t in cpu.state_dict().items()})
    n = 80
    tokens = torch.randint(0, cfg.vocab, (2, n), generator=torch.Generator().manual_seed(21))

    def gap(a, b):
        return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max())

    def decode(model, c, toks):
        cache, outs = T.init_cache(c, 2, n, device=toks.device), []
        for t in range(n):
            lg, cache = T.decode_step(model, cache, toks[:, t : t + 1], t, c, T.ModelContext())
            outs.append(lg[:, 0])
        return torch.stack(outs, 1)

    before = dict(dispatch.launch_counts())
    full, _, _ = T.forward_train(card, {"tokens": tokens.to(cuda_device)}, cfg, T.ModelContext())
    stepped = decode(card, cfg, tokens.to(cuda_device))
    assert dispatch.launch_counts() == before
    assert gap(stepped, full) <= 1e-5 and gap(stepped, decode(cpu, cfg, tokens)) <= 1e-5
    wide = decode(card, dataclasses.replace(cfg, window=128), tokens.to(cuda_device))
    assert gap(wide[:, 32:], full[:, 32:]) > 1e-2


# ------------------------------------------------- the resilience runtime

RECOVERY_CASES = [
    pytest.param("cyclic", 60, 8, 3, id="cyclic-60-8-3"),
    pytest.param("fr", 64, 8, 2, id="fr-64-8-2"),
    pytest.param("bernoulli", 60, 10, 4.0, id="bernoulli-60-10-4"),
    pytest.param("fr", 20000, 10, 5, id="fr-20000-10-5"),
    pytest.param("bernoulli", 20000, 10, 2.0, id="bernoulli-20000-10-2"),
]


def _recovery_case(scheme, n, s, ell):
    from repro_torch.core import fixed_count_stragglers, make_assignment

    a = make_assignment(scheme, n, s, ell=ell, rng=np.random.default_rng(0))
    return a, fixed_count_stragglers(s, 2, np.random.default_rng(1))


@pytest.mark.gpu
@pytest.mark.parametrize("allow_tf32", [False, True], ids=["tf32-off", "tf32-allowed"])
@pytest.mark.parametrize("scheme,n,s,ell", RECOVERY_CASES)
def test_device_recovery_masked_on_card_matches_cpu(cuda_device, scheme, n, s, ell, allow_tf32):
    """The solve's products are f32 matrix-vector products: even with TF32
    allowed for matmuls, the card's b stays within 1e-5·max|b| of the CPU's."""
    from repro_torch.core.recovery import device_recovery_masked

    a, alive = _recovery_case(scheme, n, s, ell)
    A = a.matrix.astype(np.float32)
    want = device_recovery_masked(A, alive, device="cpu").numpy()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    try:
        got = device_recovery_masked(A, alive, device=cuda_device)
        assert got.device.type == "cuda"
        got = got.cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert (got[~alive] == 0).all()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _session_inputs(n=4000, d=32, k=16, seed=5, generating=False):
    """Gaussian-mixture points and k centers: random rows, or the mixture's
    own centers (every point near its center, |x|^2 ≈ d/3 against d2 ≈
    0.0016 d: the regime where a biased distance shows in a cost)."""
    from repro_torch.data.synthetic import gaussian_mixture

    pts, gen_centers, _ = gaussian_mixture(n, k, d, rng=np.random.default_rng(seed))
    if generating:
        return pts, gen_centers
    return pts, pts[np.random.default_rng(seed + 1).choice(n, k, replace=False)]


@pytest.mark.gpu
def test_assign_min_minima_carry_no_bias_on_card(cuda_device):
    """The kernel recomputes the chosen center's distance directly: near
    their centers and far from the origin (|x|^2 ≈ 43, d2 ≈ 0.2), where the
    tensor cores' truncating accumulation put d2 1e-4 high on average, the
    minima agree with float64 without a bias."""
    pts, centers = _session_inputs(n=60000, d=128, k=256, generating=True)
    x = torch.from_numpy(pts.reshape(2, 30000, 128)).to(cuda_device)
    c = torch.from_numpy(centers).to(cuda_device).unsqueeze(0).expand(2, -1, -1).contiguous()
    idx, dist = pd_ops.assign_min(x, c)
    own = torch.gather(c.double(), 1, idx.long().unsqueeze(-1).expand(-1, -1, 128))
    d64 = ((x.double() - own) ** 2).sum(-1)
    err = dist.double() - d64
    assert abs(float(err.mean())) <= 1e-7 * float(d64.mean())
    assert float(err.abs().max()) <= 1e-5 * float(d64.max())
    cost, cost64 = float(torch.sqrt(dist.double()).sum()), float(torch.sqrt(d64).sum())
    assert abs(cost - cost64) <= 1e-6 * cost64


@pytest.mark.gpu
@pytest.mark.parametrize("median", [False, True], ids=["means", "median"])
@pytest.mark.parametrize("shape", [(4000, 32, 16, False), (40000, 128, 256, True)],
                         ids=["rows-d32", "mixture-centers-d128"])
def test_step_cost_through_the_kernel_matches_torch_ref_on_card(cuda_device, median, shape):
    from repro_torch.core import ResilienceSession, cyclic_assignment

    n, d, k, generating = shape
    pts, centers = _session_inputs(n, d, k, generating=generating)
    a = cyclic_assignment(len(pts), 10, 4)
    alive = np.ones(10, bool)
    alive[[1, 4, 8]] = False
    sess = ResilienceSession(a, device=cuda_device)
    before = dispatch.launch_counts()["assign_min"]
    got = sess.step_cost(pts, centers, alive, median=median)
    assert dispatch.launch_counts()["assign_min"] == before + 1  # all 10 nodes, one launch
    want = sess.step_cost(pts, centers, alive, median=median, impl="torch_ref")
    on_cpu = ResilienceSession(a, device="cpu").step_cost(pts, centers, alive, median=median)
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(on_cpu, rel=1e-5)
    assert sess.stats.device_solves == 2 and sess.stats.host_solves == 0
    assert sess.stats.device_copies == 1


@pytest.mark.gpu
def test_solve_and_combine_do_not_sync_with_the_host(cuda_device):
    """Under torch.cuda.set_sync_debug_mode("error") every synchronising
    call raises: the solve and the Lemma-3 combine make none."""
    from repro_torch.core import cyclic_assignment, get_executor
    from repro_torch.core.kmeans import _local_cost_fn
    from repro_torch.core.kmedian import pack_local_shards
    from repro_torch.core.recovery import device_recovery_masked

    pts, centers = _session_inputs()
    a = cyclic_assignment(len(pts), 10, 4)
    xs, ws = pack_local_shards(pts, a)
    alive_np = np.ones(10, bool)
    alive_np[[0, 5, 6]] = False
    A, alive, xs, ws, c = (torch.from_numpy(v).to(cuda_device) for v in (
        a.matrix.astype(np.float32), alive_np, xs, ws, centers))
    ex = get_executor()
    fn = _local_cost_fn(True, "auto")
    ex.resilient_reduce_masked(fn, (xs, ws), (c,), A, alive)  # builds and loads the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        b = device_recovery_masked(A, alive, device=cuda_device)
        est, b_full = ex.resilient_reduce_masked(fn, (xs, ws), (c,), A, alive)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(b, b_full)
    assert float(est) == pytest.approx(float(ex.resilient_reduce(fn, (xs, ws), (c,), b_full)), rel=1e-6)


@pytest.mark.gpu
def test_update_node_rows_moves_only_the_patched_rows_on_card(cuda_device):
    from repro_torch.core import ElasticPolicy, ResilienceSession, get_executor
    from repro_torch.core.assignment import Assignment
    from repro_torch.core.kmedian import pack_local_shards

    ex = get_executor()
    arr = ex.place_node_stacked(np.arange(24, dtype=np.float32).reshape(6, 4), cuda_device)
    ptr = arr.data_ptr()
    out = ex.update_node_rows(arr, [1, 4], np.full((2, 4), 7.0, np.float32))
    want = np.arange(24, dtype=np.float32).reshape(6, 4)
    want[[1, 4]] = 7.0
    assert out.data_ptr() == ptr and out.device.type == "cuda"
    np.testing.assert_array_equal(out.cpu().numpy(), want)

    # A patch inside the existing padding (loads ≤ the max of 8): the session
    # rewrites the moved rows of its resident copy in place.
    mat = np.zeros((8, 20), dtype=np.uint8)
    mat[0, 0:8] = mat[2, 0:8] = 1
    mat[1, 8:16] = mat[3, 8:16] = 1
    mat[4, 0:4] = 1
    mat[5, 4:8] = 1
    mat[6, 16:20] = mat[7, 16:20] = 1
    pts = np.random.default_rng(3).normal(size=(20, 3)).astype(np.float32)
    sess = ResilienceSession(Assignment(matrix=mat, scheme="skewed", params={}),
                             elastic=ElasticPolicy(enabled=True, patience=2), device=cuda_device)
    dead = np.ones(8, dtype=bool)
    dead[[6, 7]] = False
    sess.step_cost(pts, np.zeros((2, 3), np.float32), dead)
    xs0, ws0, _ = sess._resident
    ptrs, before = (xs0.data_ptr(), ws0.data_ptr()), xs0.clone()
    moved = set()
    for _ in range(3):
        moved.update(sess.observe(dead)["moved_nodes"])
    xs1, ws1, _ = sess._resident
    assert moved and (xs1.data_ptr(), ws1.data_ptr()) == ptrs
    assert sess.stats.device_copies == 1  # no full re-upload
    want_x, want_w = pack_local_shards(pts, sess.assignment)
    np.testing.assert_array_equal(xs1.cpu().numpy(), want_x)
    np.testing.assert_array_equal(ws1.cpu().numpy(), want_w)
    unmoved = sorted(set(range(8)) - moved)
    assert torch.equal(xs1[unmoved], before[unmoved])


# ------------------------------------------------ the streaming service


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 16, 128])
@pytest.mark.parametrize("k", [4, 32, 256])
def test_query_engine_and_frontend_dispatch_through_the_kernel_on_card(cuda_device, d, k):
    """The query engine's and the frontend's batches through ``assign_min``
    on the card against the plain version (indices outside near ties,
    squared distances in ``_check_assign``'s band) and against float64
    (unsquared distances rtol 1e-5: the kernel sums the chosen distance
    directly, the plain version's ‖x‖²+‖c‖²−2x·c cancels); one launch per
    batch and per dispatch; every frontend answer bit for bit the engine's."""
    from repro_torch.serve import ServingFrontend, VirtualClock
    from repro_torch.stream.query import QueryEngine

    rng = np.random.default_rng(d * 1000 + k)
    c_np = rng.normal(size=(k, d)).astype(np.float32)
    centers = torch.from_numpy(c_np).to(cuda_device)
    engine, plain = QueryEngine(), QueryEngine(impl="torch_ref")
    assert engine.warmup(centers, 1).errors == 0
    for n in (1, 63, 64, 1000):
        q = rng.normal(size=(n, d)).astype(np.float32)
        before = dispatch.launch_counts()["assign_min"]
        got = engine.assign(q, centers, version=1)
        assert dispatch.launch_counts()["assign_min"] == before + 1
        want = plain.assign(q, centers, version=1)
        _check_assign(q, c_np, k, got.indices, got.distances.astype(np.float64) ** 2,
                      want.indices, want.distances.astype(np.float64) ** 2)
        exact = np.sqrt(((q.astype(np.float64)[:, None] - c_np[None]) ** 2).sum(-1))
        np.testing.assert_allclose(got.distances, exact[np.arange(n), got.indices], rtol=1e-5, atol=1e-7)

    fixed = types.SimpleNamespace(  # a session whose model never moves
        resilience=types.SimpleNamespace(add_patch_listener=lambda cb: None),
        centers=centers, version=1, generation=(1, 0),
        staleness={"points": 0, "ingests": 0, "version": 1}, ensure_model=lambda: centers,
    )
    clk = VirtualClock()
    fe = ServingFrontend(window=0.002, max_batch=256, cache_size=0, clock=clk)
    fe.add_tenant("t", fixed)
    assert fe.warmup().errors == 0
    before = dispatch.launch_counts()["assign_min"]
    tickets = [fe.submit("t", rng.normal(size=(int(m), d)).astype(np.float32))
               for m in rng.integers(1, 17, size=60)]
    clk.advance(0.002)
    fe.flush()
    fe.drain()
    assert dispatch.launch_counts()["assign_min"] - before == fe.dispatches >= 2
    for t in tickets:
        want = engine.assign(t.queries, centers, version=1)
        np.testing.assert_array_equal(t.result.indices, want.indices)
        np.testing.assert_array_equal(t.result.distances, want.distances)


@pytest.mark.gpu
def test_fr_stream_tree_under_stragglers_equals_the_all_alive_tree_on_card(cuda_device):
    """Compactions through the kernels on the card: the FR tree under a
    coverage-preserving pattern equals the all-alive tree at 1e-5; a query
    after the solve's warm-up launches ``assign_min`` once."""
    from repro_torch.stream import StreamingSession

    rng = np.random.default_rng(4)
    batches = [rng.normal(size=(192, 8)).astype(np.float32) for _ in range(9)]
    dead = np.ones(6, dtype=bool)
    dead[2] = False
    trees = []
    for mask in (None, dead):
        sess = StreamingSession(8, 5, num_nodes=6, fanout=3, leaf_size=64, coreset_size=16, seed=1,
                                device=cuda_device)
        for b in batches:
            sess.ingest(b, alive=mask)
        trees.append(sess)
    assert trees[1].stats["compactions"] == trees[0].stats["compactions"] > 0
    assert trees[1].stats["blocking_compactions"] == 0
    for a, b in zip(trees[0].frontier(), trees[1].frontier()):
        assert a.device.type == "cuda"
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=1e-5)
    sess = trees[1]
    sess.solve(iters=5)
    before = dispatch.launch_counts()["assign_min"]
    res = sess.query(rng.normal(size=(10, 8)).astype(np.float32))
    assert dispatch.launch_counts()["assign_min"] == before + 1
    assert res.indices.shape == (10,) and np.isfinite(res.distances).all()


@pytest.mark.gpu
def test_warmups_report_no_error_on_card(cuda_device):
    from repro_torch.kernels import autotune
    from repro_torch.stream.query import QueryEngine

    c = torch.randn(32, 16, device=cuda_device)
    engine = QueryEngine()
    assert engine.warmup(c, 1).errors == 0
    engine.assign(np.zeros((300, 16), np.float32), c, version=1)
    report = engine.warmup(c, 1)
    assert (report.warmed, report.errors) == (2, 0)
    # An entry that fails on the card is counted, not raised.
    bad = autotune.warmup([lambda: pd_ops.assign_min(c[None], c, impl="cuda")])
    assert (bad.warmed, bad.errors) == (0, 1)


# ------------------------------------------------ the mesh executor on the card


@pytest.mark.gpu
@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_mesh_on_card_matches_the_local_executor(cuda_device, world, backend):
    """Algorithm 1 through the mesh on the card (a world of one over NCCL;
    two ranks over gloo, both on card 0) against the local executor, 1e-5
    on the cost; the ranks identical by hash; both kernels launched on every
    rank."""
    from repro_torch.core import resilient_kmedian
    from repro_torch.kernels import _build
    from repro_torch.launch import distributed as mesh_dist
    from repro_torch.launch import mesh_runs

    _build.build(("assign_min", "weighted_segsum", "min_dist_update"))  # once, before the ranks load them
    n, d, k, s, seed = 20000, 16, 8, 6, 0
    mesh = mesh_dist.run_ranks(mesh_runs.alg1_rank, world, backend=backend, device="cuda", timeout=300,
                               args=(n, d, k, s, seed))
    pts, a, alive = mesh_runs.alg1_problem(n, d, k, s, seed)
    local = resilient_kmedian(pts, k, a, alive, local_iters=5, coord_iters=8, seed=seed, device=cuda_device)
    assert mesh["describe"] == f"mesh[{world}x{torch.cuda.get_device_name(0)}/{backend}]"
    assert mesh["lockstep"]
    assert abs(mesh["cost"] / local.cost - 1.0) <= 1e-5
    assert len(mesh["launches"]) == world
    assert all(c["assign_min"] > 0 and c["weighted_segsum"] > 0 for c in mesh["launches"])


@pytest.mark.gpu
def test_mesh_train_step_on_card_matches_the_meshless_step(cuda_device, tmp_path):
    """One train step of 2 layers at qwen3-1.7b's width (f32 parameters,
    bf16 compute, 8 x 512 tokens) on a (1, 2) mesh of two gloo ranks on the
    card, remat full (``mesh_runs.train_mesh_rank``, the rank program of
    ``chip_smoke.py``'s phase "train mesh"), against the meshless gradient
    of the same weights and batch: every gradient block within 2e-2 of its
    parameter's scale (the bf16 band), the loss within 1e-5 and the grad
    norm within 1e-3 relative, 2 flash launches a layer a rank (the forward
    and its recompute), the moments on ``state_shardings``' blocks."""
    from repro_torch.kernels import _build
    from repro_torch.launch import distributed as mesh_dist
    from repro_torch.launch import mesh_runs
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import init_train_state, make_grad_fn

    _build.build(("flash_attention",))  # once, before the ranks load it
    overrides, seed = {"n_layers": 2}, 0
    cfg = get_config("qwen3-1.7b", **overrides)
    state = init_train_state(cfg, generator=torch.Generator(device=cuda_device).manual_seed(seed))
    batch = mesh_runs.train_mesh_batches(cfg, seed, cuda_device, 1)[0]
    loss, _, grads = make_grad_fn(cfg, T.ModelContext())(state.params, batch)
    path = str(tmp_path / "oracle.pt")
    torch.save({"grads": {n: g.cpu() for n, g in grads.items()}, "loss": float(loss),
                "grad_norm": float(global_norm(grads)), "top": max(float(g.abs().max()) for g in grads.values())},
               path)
    del state, grads
    torch.cuda.empty_cache()
    rep = mesh_dist.run_ranks(mesh_runs.train_mesh_rank, 2, backend="gloo", device="cuda", timeout=600,
                              args=(seed, (1, 2), path, "full", overrides))
    for r in rep["ranks"]:
        assert r["launches"]["flash_attention"] == 2 * cfg.n_layers, r["launches"]
        assert r["flash_shape"] == (8, 512, 512, cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.head_dim)
        assert r["grad_gap"] <= 2e-2, (r["grad_gap"], r["grad_gap_at"])
        assert abs(r["loss"] - rep["oracle_loss"]) <= 1e-5 * abs(rep["oracle_loss"])
        assert abs(r["grad_norm"] - rep["oracle_grad_norm"]) <= 1e-3 * rep["oracle_grad_norm"]
        assert r["moments_ok"] and r["sums"]["calls"].get("split_bwd", 0) > 0


def test_compressed_mesh_train_step_on_card_without_remat(cuda_device, tmp_path):
    """The step of ``test_mesh_train_step_on_card_matches_the_meshless_step``
    under remat none and with compression (``train_mesh_rank(compress=True)``):
    the flash Function saves its output, which the heads' gather reads, and
    gloo's broadcast of a CUDA tensor writes its source in place, so a
    gather must broadcast a copy (a checkpointed mesh trainer failed so on
    the card); the oracle's gradient compressed through the mesh path bit
    for bit the meshless compression narrowed, the buffers on
    ``state_shardings``' blocks, one flash launch a layer a rank."""
    from repro_torch.kernels import _build
    from repro_torch.launch import distributed as mesh_dist
    from repro_torch.launch import mesh_runs
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import get_config
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import init_train_state, make_grad_fn

    _build.build(("flash_attention",))
    overrides, seed = {"n_layers": 2}, 0
    cfg = get_config("qwen3-1.7b", **overrides)
    state = init_train_state(cfg, generator=torch.Generator(device=cuda_device).manual_seed(seed))
    batch = mesh_runs.train_mesh_batches(cfg, seed, cuda_device, 1)[0]
    loss, _, grads = make_grad_fn(cfg, T.ModelContext())(state.params, batch)
    path = str(tmp_path / "oracle.pt")
    torch.save({"grads": {n: g.cpu() for n, g in grads.items()}, "loss": float(loss),
                "grad_norm": float(global_norm(grads)), "top": max(float(g.abs().max()) for g in grads.values())},
               path)
    del state, grads
    torch.cuda.empty_cache()
    rep = mesh_dist.run_ranks(mesh_runs.train_mesh_rank, 2, backend="gloo", device="cuda", timeout=600,
                              args=(seed, (1, 2), path, "none", overrides, 512, True))
    for r in rep["ranks"]:
        assert r["launches"]["flash_attention"] == cfg.n_layers, r["launches"]
        assert r["grad_gap"] <= 2e-2, (r["grad_gap"], r["grad_gap_at"])
        assert r["compression"]["bitwise"] and r["ef_ok"] and r["moments_ok"]
        head = r["compression"]["lm_head"]
        assert head["scale"] == head["whole_scale"] and head["block"] == 296
