"""The summation order of the ``weighted_segsum`` kernel, emulated with numpy.

``csrc/weighted_segsum.cu`` sums each (cluster, column) of a range of
``ROWS_PER_CHUNK`` rows in row order, in float32, with every w·x rounded
before it is added; then it sums the ranges' partials in range order.  Its
threads take the rows in groups of 8: the group's accumulator entries are
loaded together, each row adds to the latest earlier value of its cluster
in the group (or to the loaded one), and the results are stored in row
order.  This file holds that order within 1e-5 of Σ|w·x| against a float64
sum before the card does (the tolerance of the kernel's checks), at the
range length the kernel uses, and shows that the grouped updates give the
bits of the plain sequential sum.

No JAX here.
"""

import numpy as np
import pytest

from repro_torch.kernels.weighted_segsum.kernel import ROWS_PER_CHUNK


def _rows(x, w):
    """[w·x, w] per row in float32: the kernel's d + 1 columns (w·1 = w)."""
    return np.concatenate([(w[:, None] * x).astype(np.float32), w[:, None]], axis=1)


def _emulated_segsum(x, w, idx, k, rows=ROWS_PER_CHUNK):
    """Each range's (cluster, column) sums in row order (np.cumsum adds in
    sequence), then the ranges in order, all in float32."""
    wx = _rows(x, w)
    out = np.zeros((k, wx.shape[1]), dtype=np.float32)
    for r0 in range(0, len(x), rows):
        part = np.zeros_like(out)
        ids, vals = idx[r0:r0 + rows], wx[r0:r0 + rows]
        for c in np.unique(ids[(ids >= 0) & (ids < k)]):
            part[c] = np.cumsum(vals[ids == c], axis=0, dtype=np.float32)[-1]
        out = (out + part).astype(np.float32)
    return out


def _inputs(n, k, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.uniform(0.0, 2.0, size=n).astype(np.float32)
    idx = rng.integers(-1, k + 1, size=n).astype(np.int32)  # some rows outside [0, k)
    return x, w, idx


@pytest.mark.parametrize("k", [1, 15, 256])
def test_range_order_within_1e5_of_float64(k):
    # three full ranges and a ragged fourth; d + 1 = 129 columns, as at full width
    x, w, idx = _inputs(3 * ROWS_PER_CHUNK + 77, k, 128, seed=k)
    got = _emulated_segsum(x, w, idx, k)
    keep = (idx >= 0) & (idx < k)
    onehot = np.zeros((len(x), k))
    onehot[np.flatnonzero(keep), idx[keep]] = 1.0
    wx = np.concatenate([w[:, None].astype(np.float64) * x, w[:, None]], axis=1)
    exact = onehot.T @ wx
    scale = onehot.T @ np.abs(wx)  # Σ|w·x| per (cluster, column)
    err = np.abs(got.astype(np.float64) - exact)
    assert (err <= 1e-5 * scale).all(), float((err / np.maximum(scale, 1e-30)).max())


def _grouped(vals, ids, k, group=8):
    """The kernel's updates of one column, in groups of `group` rows."""
    acc = np.zeros(k + 1, dtype=np.float32)  # row k: the spare row of rows outside [0, k)
    for g0 in range(0, len(vals), group):
        cq = [c if 0 <= c < k else k for c in ids[g0:g0 + group]]
        a = [acc[c] for c in cq]  # loaded together
        for q in range(len(cq)):
            base = a[q]
            for p in range(q):
                if cq[p] == cq[q]:
                    base = a[p]  # the latest earlier value of the same cluster
            a[q] = np.float32(base + vals[g0 + q])
        for q, c in enumerate(cq):  # stored in row order: the last write wins
            acc[c] = a[q]
    return acc[:k]


@pytest.mark.parametrize("k", [1, 3, 256])
def test_grouped_updates_equal_the_sequential_sum(k):
    # few clusters: most groups repeat a cluster, some several times
    x, w, idx = _inputs(203, k, 3, seed=7 + k)
    wx = _rows(x, w)
    for col in range(wx.shape[1]):
        got = _grouped(wx[:, col], idx, k)
        want = np.zeros(k, dtype=np.float32)
        for v, c in zip(wx[:, col], idx):
            if 0 <= c < k:
                want[c] = np.float32(want[c] + v)
        np.testing.assert_array_equal(got, want)
