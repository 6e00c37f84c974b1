"""The seeding step's roofline arithmetic against values worked by hand."""

import pytest

from harness import files

PEAKS = files.peaks()


def tensor(*shape, dtype="torch.float32"):
    return ("tensor", tuple(shape), dtype)


def test_min_dist_update_at_the_local_solve_shape():
    # (10, 400000, 128): bytes 4·(10·400000·128 + 10·128 + 4·10·400000)
    # = 2,112,005,120, 6.3045e-4 s at 3.35 TB/s; 3·10·400000·128 = 1.536e9
    # operations, 2.29e-5 s at 67 TF/s fp32: bytes bind.
    x, c, v = tensor(10, 400000, 128), tensor(10, 128), tensor(10, 400000)
    got = files.kernel("min_dist_update").cost((x, c, v, v, True), {}, PEAKS)
    assert got["bytes"] == 2_112_005_120
    assert got["flops"] == 1.536e9
    assert got["seconds"] == pytest.approx(6.3045e-4, rel=1e-4)
    assert got["seconds"] == 2_112_005_120 / 3.35e12


def test_min_dist_update_at_the_coordinator_shape():
    # (1, 10240, 128): 4·(10240·128 + 128 + 4·10240) = 5,407,232 bytes.
    x, c, v = tensor(1, 10240, 128), tensor(1, 128), tensor(1, 10240)
    got = files.kernel("min_dist_update").cost((x, c, v, v, True), {}, PEAKS)
    assert got["bytes"] == 5_407_232 and got["seconds"] == 5_407_232 / 3.35e12
