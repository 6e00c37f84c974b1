"""The numerics of the 3xTF32 ``assign_min`` kernel, emulated with numpy,
and the flash wrapper's choice of kernel.

``csrc/assign_min.cu`` splits each fp32 operand as it is loaded into a
fragment: big = cvt.rna.tf32(v) (10 explicit mantissa bits, round to nearest,
ties away from zero), small = cvt.rna.tf32(v − big), and sums small·big,
big·small and big·big in fp32 on the tensor cores.  This file runs that
arithmetic on the CPU (products of TF32 values are exact in fp32; each
8-wide step of the mma is summed exactly and rounded once to fp32) and
holds the distances to the float64 ones within 1e-5·(‖x‖² + ‖c‖²), the
tolerance of the kernel's tests, before the card does.  A single TF32 pass
does not meet it.  ``csrc/pairwise_sqdist.cu`` runs the same tile and
clamps it; its band (1e-5·(‖x‖² + ‖c‖²) + 1e-6) is held here too.

No JAX here; the cases are those of ``test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.pairwise_dist import ref as pd_ref
from tests.test_torch_gpu import ASSIGN_CASES, _assign_inputs, _sqdist_inputs


def _tf32(a):
    """cvt.rna.tf32.f32: keep 10 explicit mantissa bits, round to nearest,
    ties away from zero (sign-magnitude bits: add half an ulp, truncate)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    big = _tf32(a)
    return big, _tf32(a - big)


def _emulated_sqdist(x, c, passes=3):
    """The kernel's d2 = max(‖x‖² + ‖c‖² − 2·x·c, 0) in fp32, with x·c as
    3xTF32 (``passes=3``) or one TF32 pass (``passes=1``)."""
    n, d = x.shape
    xb, xs = _split(x)
    cb, cs = _split(c)
    if passes == 1:
        terms = [(xb, cb)]
    else:
        terms = [(xs, cb), (xb, cs), (xb, cb)]  # the kernel's order
    acc = np.zeros((n, c.shape[0]), dtype=np.float32)
    for k0 in range(0, d, 8):  # one m16n8k8 step: 8 exact products, rounded once
        for a, b in terms:
            step = a[:, k0:k0 + 8].astype(np.float64) @ b[:, k0:k0 + 8].astype(np.float64).T
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    xn = np.zeros(n, dtype=np.float32)
    cn = np.zeros(c.shape[0], dtype=np.float32)
    for j in range(d):  # sequential fp32 multiply-adds, as the kernel's norms
        xn = (xn + x[:, j] * x[:, j]).astype(np.float32)
        cn = (cn + c[:, j] * c[:, j]).astype(np.float32)
    d2 = xn[:, None] + cn[None, :] - np.float32(2.0) * acc
    return np.maximum(d2, np.float32(0.0))


def _exact(x, c):
    diff = x.astype(np.float64)[:, None, :] - c.astype(np.float64)[None, :, :]
    return (diff * diff).sum(-1)


def _scale(x, c):
    return (x.astype(np.float64) ** 2).sum(1)[:, None] + (c.astype(np.float64) ** 2).sum(1)[None, :]


@pytest.mark.parametrize(
    "n,k,d,k_valid,dup",
    ASSIGN_CASES + [pytest.param(200, 256, 128, None, True, id="d128-k256-duplicates")],
)
def test_3xtf32_distances_within_1e5_of_float64(n, k, d, k_valid, dup):
    x, c = _assign_inputs(n, k, d, k_valid, dup, seed=41 + n + d)
    got = _emulated_sqdist(x, c)
    err = np.abs(got.astype(np.float64) - _exact(x, c))
    assert (err <= 1e-5 * _scale(x, c)).all(), float((err / _scale(x, c)).max())
    if dup:  # exact duplicate centers: bitwise equal d2, so the first index wins
        np.testing.assert_array_equal(got[:, 1::2], got[:, 0::2][:, : got[:, 1::2].shape[1]])
        kv = k if k_valid is None else k_valid
        assert (np.argmin(got[:, :kv], axis=1) % 2 == 0).all()


def test_3xtf32_keeps_the_index_where_one_tf32_pass_does_not():
    # d = 128, the full-width shape: one pass errs by about 2^-11 of the
    # scale, 3xTF32 by about 2^-22; the index follows the float64 argmin on
    # every row whose two nearest centers are 1e-5 of the scale apart
    x, c = _assign_inputs(300, 256, 128, None, False, seed=43)
    exact, scale = _exact(x, c), _scale(x, c)
    three, one = _emulated_sqdist(x, c), _emulated_sqdist(x, c, passes=1)
    assert (np.abs(three - exact) <= 1e-5 * scale).all()
    assert (np.abs(one - exact) > 1e-5 * scale).any()
    top2 = np.sort(exact, axis=1)[:, :2]
    decided = (top2[:, 1] - top2[:, 0]) > 1e-5 * scale[np.arange(300), np.argmin(exact, axis=1)]
    np.testing.assert_array_equal(np.argmin(three, axis=1)[decided], np.argmin(exact, axis=1)[decided])


@pytest.mark.parametrize("dup", [False, True], ids=["distinct", "duplicate-rows"])
def test_3xtf32_sqdist_at_full_width_within_the_pairwise_sqdist_band(dup):
    # pairwise_sqdist's tile at the full-width decomposition (d = 128, k =
    # 256), clamp included: within 1e-5 (|x|^2 + |c|^2) + 1e-6 of float64
    # and of the plain version, nothing negative; with duplicate rows and
    # centers equal to rows, the exact distances of 0 among them
    x, c = _sqdist_inputs(300, 256, 128, dup, seed=47)
    got = _emulated_sqdist(x, c)
    band = 1e-5 * _scale(x, c) + 1e-6
    assert (got >= 0).all()
    assert (np.abs(got.astype(np.float64) - _exact(x, c)) <= band).all()
    plain = np.asarray(pd_ref.pairwise_sqdist_ref(torch.from_numpy(x), torch.from_numpy(c)))
    assert (np.abs(got.astype(np.float64) - plain) <= band).all()
    if dup:
        assert (_exact(x, c) == 0).any()


def test_tf32_rounding_is_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32's spacing at 1.0
    a = np.array([1.0, 1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4, 3.0e-3],
                 dtype=np.float32)
    got = _tf32(a)
    np.testing.assert_array_equal(got[:4], np.array([1.0, 1.0 + one_ulp, -(1.0 + one_ulp), 1.0],
                                                    dtype=np.float32))
    big, small = _split(a)
    assert (big.view(np.uint32) & 0x1FFF == 0).all() and (small.view(np.uint32) & 0x1FFF == 0).all()
    assert np.abs((big.astype(np.float64) + small) - a).max() <= 2.0 ** -22 * np.abs(a).max()


@pytest.mark.parametrize(
    "dtype,dh,want",
    [(torch.bfloat16, 64, "tma-wgmma"), (torch.bfloat16, 128, "tma-wgmma"),
     (torch.bfloat16, 16, "mma-sync"), (torch.bfloat16, 32, "mma-sync")]
    + [(torch.float32, dh, "mma-sync") for dh in (16, 32, 64, 128)],
)
def test_flash_route_by_dtype_and_head_dim(dtype, dh, want):
    assert fa_kernel.route(dtype, dh) == want
    assert fa_kernel.ROUTES[want] in ("flash_attention_tma_launch", "flash_attention_launch")


@pytest.mark.parametrize("dtype,dh,exc", [
    (torch.bfloat16, 24, ValueError), (torch.float32, 256, ValueError),
    (torch.float16, 128, TypeError), (torch.float64, 64, TypeError),
])
def test_flash_route_refuses_other_dtypes_and_widths(dtype, dh, exc):
    with pytest.raises(exc):
        fa_kernel.route(dtype, dh)
