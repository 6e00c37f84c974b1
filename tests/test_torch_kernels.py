"""Parity of the port's kernels (``repro_torch.kernels``) with the reference.

On the CPU the port's ops run their plain PyTorch versions; they are held
against the reference's Pallas kernels in interpret mode and its jnp
oracles, on the same numpy inputs.  The cases and the checks (with their
tolerances) are shared with ``test_torch_gpu.py``, which holds the CUDA
kernels against the plain versions on the card.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise_dist import kernel as j_pd_kernel
from repro.kernels.pairwise_dist import ref as j_pd_ref
from repro.kernels.weighted_segsum import kernel as j_ss_kernel
from repro.kernels.weighted_segsum import ref as j_ss_ref
from repro_torch.kernels import _build, dispatch
from repro_torch.kernels.pairwise_dist import ops as pd_ops
from repro_torch.kernels.pairwise_dist import ref as pd_ref
from repro_torch.kernels.weighted_segsum import ops as ss_ops
from repro.kernels.pairwise_dist import ops as j_pd_ops
from tests.test_torch_gpu import (
    ASSIGN_CASES,
    SEGSUM_CASES,
    SQDIST_CASES,
    _assign_inputs,
    _check_assign,
    _check_segsum,
    _segsum_inputs,
    _sqdist_inputs,
)

def _pad_rows(a, m, value=0.0):
    rem = (-a.shape[0]) % m
    if rem == 0:
        return a
    pad = np.full((rem,) + a.shape[1:], value, dtype=a.dtype)
    return np.concatenate([a, pad])



@pytest.mark.parametrize("n,k,d,k_valid,dup", ASSIGN_CASES)
def test_assign_min_plain_matches_pallas_interpret(n, k, d, k_valid, dup):
    x, c = _assign_inputs(n, k, d, k_valid, dup, seed=n * k + d)
    kv = k if k_valid is None else k_valid
    j_idx, j_dist = j_pd_kernel.assign_min_kernel_call(
        jnp.asarray(_pad_rows(x, 8)), jnp.asarray(_pad_rows(c, 8)),
        bn=8, bk=8, k_valid=kv, interpret=True,
    )
    idx, dist = pd_ops.assign_min(torch.from_numpy(x), torch.from_numpy(c), k_valid=k_valid)
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    assert int(idx.max()) < kv
    _check_assign(x, c, kv, idx, dist, np.asarray(j_idx)[:n], np.asarray(j_dist)[:n])
    if dup:  # exact ties resolve to the earlier of two equal centers
        assert (np.asarray(idx) % 2 == 0).all()
        np.testing.assert_array_equal(np.asarray(idx), np.asarray(j_idx)[:n])


@pytest.mark.parametrize("n,k,d,k_valid,dup", [c for c in ASSIGN_CASES if c.values[3] is None])
def test_assign_min_plain_matches_jnp_ref(n, k, d, k_valid, dup):
    x, c = _assign_inputs(n, k, d, k_valid, dup, seed=3 * n + k)
    j_idx, j_dist = j_pd_ref.assign_min_ref(jnp.asarray(x), jnp.asarray(c))
    idx, dist = pd_ops.assign_min(torch.from_numpy(x), torch.from_numpy(c))
    _check_assign(x, c, k, idx, dist, j_idx, j_dist)


def test_assign_min_batched_matches_per_batch_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 29, 5)).astype(np.float32)
    c = rng.normal(size=(3, 11, 5)).astype(np.float32)
    idx, dist = pd_ops.assign_min(torch.from_numpy(x), torch.from_numpy(c), k_valid=9)
    assert idx.shape == (3, 29) and dist.shape == (3, 29)
    for b in range(3):
        j_idx, j_dist = j_pd_kernel.assign_min_kernel_call(
            jnp.asarray(_pad_rows(x[b], 8)), jnp.asarray(_pad_rows(c[b], 8)),
            bn=8, bk=8, k_valid=9, interpret=True,
        )
        _check_assign(x[b], c[b], 9, idx[b], dist[b], np.asarray(j_idx)[:29], np.asarray(j_dist)[:29])


def test_assign_min_no_valid_center_gives_pad():
    x = torch.ones(4, 3)
    idx, dist = pd_ops.assign_min(x, torch.zeros(5, 3), k_valid=0)
    assert (idx == 0).all() and (dist == pd_ref.PAD_DIST).all()


@pytest.mark.parametrize("n,k,d,batch", SEGSUM_CASES)
def test_weighted_segsum_plain_matches_pallas_interpret(n, k, d, batch):
    x, w, idx = _segsum_inputs(n, k, d, batch, seed=n + k + d)
    sums, tot = ss_ops.weighted_segsum(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(idx), k)
    assert sums.shape == (batch, k, d) and tot.shape == (batch, k)
    assert (np.asarray(tot)[:, -2:] == 0).all() and (np.asarray(sums)[:, -2:] == 0).all()
    for b in range(batch):
        j_sums, j_tot = j_ss_kernel.weighted_segsum_kernel_call(
            jnp.asarray(_pad_rows(x[b], 8)), jnp.asarray(_pad_rows(w[b], 8)),
            jnp.asarray(_pad_rows(idx[b], 8)), k, bn=8, interpret=True,
        )
        _check_segsum(x[b], w[b], idx[b], sums[b], tot[b], j_sums, j_tot)


@pytest.mark.parametrize("n,k,d,batch", SEGSUM_CASES)
def test_weighted_segsum_plain_matches_jnp_ref(n, k, d, batch):
    x, w, idx = _segsum_inputs(n, k, d, batch, seed=7 * n + k)
    for b in range(batch):
        sums, tot = ss_ops.weighted_segsum(
            torch.from_numpy(x[b]), torch.from_numpy(w[b]), torch.from_numpy(idx[b]), k
        )
        j_sums, j_tot = j_ss_ref.weighted_segsum_ref(jnp.asarray(x[b]), jnp.asarray(w[b]), jnp.asarray(idx[b]), k)
        _check_segsum(x[b], w[b], idx[b], sums, tot, j_sums, j_tot)


@pytest.mark.parametrize("j_impl", ["xla_ref", "pallas_interpret"])
@pytest.mark.parametrize("n,k,d,dup", SQDIST_CASES)
def test_pairwise_sqdist_plain_matches_reference(n, k, d, dup, j_impl):
    x, c = _sqdist_inputs(n, k, d, dup, seed=5 * n + k + d)
    got = pd_ops.pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(c))
    want = np.asarray(j_pd_ops.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c), impl=j_impl))
    assert got.dtype == torch.float32 and got.shape == (n, k)
    assert bool((got >= 0).all())
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4 * want.max())


def test_pairwise_sqdist_refuses_what_the_kernel_refuses():
    x = torch.rand(6, 3)
    assert pd_ops.pairwise_sqdist(x[:0], x).shape == (0, 6)
    with pytest.raises(ValueError, match="d must be positive"):
        pd_ops.pairwise_sqdist(x[:, :0], x[:, :0])
    with pytest.raises(TypeError, match="float32"):
        pd_ops.pairwise_sqdist(x.double(), x.double())
    with pytest.raises(ValueError, match=r"expected \(n, d\)"):
        pd_ops.pairwise_sqdist(x[None], x)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        pd_ops.pairwise_sqdist(x, x, impl="cuda")


# ------------------------------------------------------------- dispatch


@pytest.mark.parametrize("op", ["assign_min", "weighted_segsum", "pairwise_sqdist"])
def test_dispatch_cpu_tensor_gets_plain_version(op):
    t = torch.zeros(3, 2)
    name, _ = dispatch.resolve(op, "auto", t)
    assert name == "torch_ref"
    assert dispatch.impl_names(op) == ("cuda", "torch_ref")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.resolve(op, "cuda", t)
    with pytest.raises(ValueError, match="unknown impl"):
        dispatch.resolve(op, "pallas", t)
    # A meta tensor takes the plain version (the dry run's route); a device
    # with no route still raises (a stand-in: resolve reads ``.device`` only).
    assert dispatch.resolve(op, "auto", torch.zeros(3, 2, device="meta"))[0] == "torch_ref"
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve(op, "auto", types.SimpleNamespace(device=torch.device("xpu")))


def test_plain_runs_on_cpu_do_not_count_as_launches():
    dispatch.reset_launch_counts()
    x = torch.rand(20, 3)
    idx, _ = pd_ops.assign_min(x, x[:4])
    ss_ops.weighted_segsum(x, torch.ones(20), idx, 4)
    pd_ops.pairwise_sqdist(x, x[:4])
    counts = dispatch.launch_counts()  # every registered kernel, flash_attention's too
    assert counts["assign_min"] == 0 and counts["weighted_segsum"] == 0
    assert counts["pairwise_sqdist"] == 0
    assert set(counts.values()) == {0}


def test_kernel_sources_build_for_sm90a_with_a_c_entry_point():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in src
        assert "atomicAdd" not in src  # deterministic: no float atomics


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    # The two tile kernels include csrc/tf32_tile.cuh: editing it renames
    # (rebuilds) their libraries, and editing another source does not.
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    for name in ("assign_min", "pairwise_sqdist"):
        assert '#include "tf32_tile.cuh"' in (csrc / f"{name}.cu").read_text()
    before = {name: _build._library(name) for name in _build.SOURCES}
    header = csrc / "tf32_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build._library(name) for name in _build.SOURCES}
    assert after["assign_min"] != before["assign_min"]
    assert after["pairwise_sqdist"] != before["pairwise_sqdist"]
    src = csrc / "weighted_segsum.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    again = {name: _build._library(name) for name in _build.SOURCES}
    assert again["weighted_segsum"] != after["weighted_segsum"]
    for name in ("assign_min", "pairwise_sqdist", "flash_attention"):
        assert again[name] == after[name]
