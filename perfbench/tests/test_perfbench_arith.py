"""The roofline and MFU arithmetic against values worked by hand."""

import pytest

from harness import files

PEAKS = files.peaks()


def tensor(*shape, dtype="torch.float32"):
    return ("tensor", tuple(shape), dtype)


def test_assign_min_at_the_local_solve_shape():
    # (10, 400000, 1024, 128): 2·10·400000·1024·128 = 1.048576e12 operations
    # against 495 TF/s = 2.118335e-3 s; bytes 4·(10·400000·128 + 10·1024·128)
    # + 8·10·400000 = 2.0837243e9, 6.2201e-4 s at 3.35 TB/s: compute-bound.
    c = files.kernel("assign_min").cost((tensor(10, 400000, 128), tensor(10, 1024, 128), 1024), {}, PEAKS)
    assert c["flops"] == 1.048576e12
    assert c["bytes"] == 4.0 * (10 * 400000 * 128 + 10 * 1024 * 128) + 8.0 * 10 * 400000
    assert c["seconds"] == pytest.approx(1.048576e12 / 495e12)


def test_assign_min_counts_valid_centers_only():
    full = files.kernel("assign_min").cost((tensor(1, 100, 8), tensor(1, 16, 8), 16), {}, PEAKS)
    part = files.kernel("assign_min").cost((tensor(1, 100, 8), tensor(1, 16, 8), 4), {}, PEAKS)
    assert full["flops"] == 4 * part["flops"] == 2.0 * 100 * 16 * 8


def test_flash_forward_at_one_groups_training_shape():
    # (3, 512, 512, 16, 8, 128) bf16, causal: 512·513/2 = 131328 pairs,
    # 4·3·16·131328·128 = 3.227516928e9 operations (3.2634e-6 s at 989 TF/s);
    # bytes 2·(2·3·512·16·128 + 2·3·512·8·128) = 18874368 (5.6341e-6 s): bytes bind.
    q = tensor(3, 512, 16, 128, dtype="torch.bfloat16")
    kv = tensor(3, 512, 8, 128, dtype="torch.bfloat16")
    c = files.kernel("flash_attention").cost((q, kv, kv), {"causal": True, "scale": 0.08}, PEAKS)
    assert c["flops"] == 4.0 * 3 * 16 * 131328 * 128
    assert c["bytes"] == 18874368
    assert c["seconds"] == pytest.approx(18874368 / 3.35e12)


def test_solve_flops():
    """Algorithm 1 at k=1024, 7 alive workers of 400000 points each."""
    cfg, traffic = files.config("sift1m-s10-cyclic4"), files.traffic("closed-k1024-t3")
    d, k, m, a = 128, 1024, 400000, 7
    local = a * 2 * d * ((k - 1) * m + 21 * m * k + 20 * 4 * m)
    coord = 2 * d * ((k - 1) * a * k + 41 * a * k * k + 40 * 4 * a * k)
    full = 2 * d * 1000000 * k
    assert files.mfu("sift1m-s10-cyclic4").flops(cfg, traffic) == local + coord + full


def test_train_flops_per_sequence():
    """qwen3-1.7b, tied: 28 layers of 50,331,648 matmul weights and the
    151936 × 2048 head, 6 operations a weight a token over 512 tokens,
    plus 12·16·128·28·(512·513/2) for causal attention."""
    cfg = files.config("qwen3-1.7b-fr4")
    layer = 2048 * 2048 + 2 * 2048 * 1024 + 2048 * 2048 + 3 * 2048 * 6144
    assert layer == 50331648
    want = 6.0 * (28 * layer + 151936 * 2048) * 512 + 12.0 * 16 * 128 * 28 * 131328
    assert files.mfu("qwen3-1.7b-fr4").flops_per_sequence(cfg) == want


def test_peaks_are_the_data_sheets():
    assert PEAKS["flops_per_s"]["bf16"] == 989e12 and PEAKS["flops_per_s"]["tf32"] == 495e12
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12
