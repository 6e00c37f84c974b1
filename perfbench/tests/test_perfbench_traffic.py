"""The traffic generator: the same seed gives the same units, any large
seed works, and every seed gives the same set of patterns."""

import numpy as np

from harness.traffic import alive_masks, unit_seeds

BIG = 2**31 + 12345


def test_exact_patterns_come_once_each_in_a_seeded_order():
    a = alive_masks({"kind": "exact", "t": 3}, 10, BIG, 120)
    assert (a.sum(axis=1) == 7).all()
    assert len({r.tobytes() for r in a}) == 120
    assert (alive_masks({"kind": "exact", "t": 3}, 10, BIG, 120) == a).all()
    b = alive_masks({"kind": "exact", "t": 3}, 10, BIG + 1, 120)
    assert sorted(r.tobytes() for r in a) == sorted(r.tobytes() for r in b)
    assert not (a == b).all()


def test_iid_masks_never_all_dead():
    m = alive_masks({"kind": "iid", "p": 0.9}, 4, BIG, 2000)
    assert m.any(axis=1).all()
    assert 0.05 < 1 - m.mean() < 0.95


def test_unit_seeds_fit_31_bits():
    s = unit_seeds(2**40 + 7, 64)
    assert s == unit_seeds(2**40 + 7, 64) and all(0 <= x < 2**31 for x in s)
    assert len(set(s)) == 64
    assert np.asarray(s).dtype.kind == "i"


def test_iid_losses_sit_at_the_same_steps_for_every_seed():
    pairs = [[0, 2], [1, 3]]  # fractional repetition over 4 groups: the groups of each shard pair

    def covers(m):
        return all(m[a] or m[b] for a, b in pairs)

    spec = {"kind": "iid", "p": 0.15, "lose_every": 22}
    for seed in (BIG, BIG + 1):
        m = alive_masks(spec, 4, seed, 220, covers)
        lost = [i for i in range(220) if not covers(m[i])]
        assert lost == list(range(21, 220, 22))
        m = alive_masks({**spec, "lose_phase": 0}, 4, seed, 220, covers)
        assert [i for i in range(220) if not covers(m[i])] == list(range(0, 220, 22))
    a, b = alive_masks(spec, 4, BIG, 220, covers), alive_masks(spec, 4, BIG + 1, 220, covers)
    assert not (a == b).all()
