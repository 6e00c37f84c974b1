"""The mesh-native resilient trainer on ``MeshExecutor`` over gloo ranks,
on the CPU: the twin of ``tests/test_training.py:459``, whose reference
runs one process over 8 forced host devices.  The port runs one process
per rank (``run_ranks``) and holds each rank's result against the local
executor's in this process.

* World 2: the parity run (qwen3-4b's smoke config in f32, FR ℓ = 2 over
  4 groups, deadline stragglers, one pattern uncovered on the way) and
  the elastic patch (cyclic, 6 groups, ``[1, 1, 1, 1, 0, 0]`` persistent,
  patience 2, headroom 2): the parameters within 1e-6 of the local
  executor's (the groups' gradients are summed in float64 on each rank
  and across the ranks, so the split does not move them), the rows of
  the patch written only by the rank that owns them.
* World 3 with G = 4 (blocks of 2, two padded rows): the degenerate
  host fallback (singleton, one group dead) through the padded node axis,
  within 1e-6 of the local executor.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs.qwen3_4b import smoke_config
from repro_torch.launch import distributed as D
from repro_torch.launch import mesh_runs

DEADLINE = 240.0  # seconds for one start of the ranks, setup to exit
OCFG = dict(lr=5e-3, warmup_steps=2, total_steps=5)


def _cfg():
    return dataclasses.replace(smoke_config(), compute_dtype="float32").validate()


def _trace(tmp_path, name, rows):
    path = tmp_path / f"{name}.jsonl"
    path.write_text("".join(json.dumps({"alive": r}) + "\n" for r in rows))
    return str(path)


def _runs(tmp_path, world):
    common = dict(microbatch=1, seq_len=16, resident_steps=2)
    if world == 2:
        return {
            "parity": (_cfg(), dict(num_groups=4, num_shards=4, redundancy=2, scheme="cyclic", steps=5,
                                    straggler_deadline=1.4, **common), OCFG),
            "patch": (_cfg(), dict(num_groups=6, num_shards=6, redundancy=2, scheme="cyclic", steps=6,
                                   straggler_scenario="trace",
                                   scenario_kwargs={"path": _trace(tmp_path, "patch", [[1, 1, 1, 1, 0, 0]] * 8)},
                                   elastic_patience=2, patch_headroom=2, **common), OCFG),
        }
    return {"fallback": (_cfg(), dict(num_groups=4, num_shards=4, redundancy=1, scheme="singleton", steps=3,
                                      straggler_scenario="trace",
                                      scenario_kwargs={"path": _trace(tmp_path, "fallback", [[1, 0, 1, 1]] * 3)},
                                      **dict(common, resident_steps=1)), OCFG)}


def _start(world, tmp_path_factory):
    runs = _runs(tmp_path_factory.mktemp(f"world{world}"), world)
    mesh = D.run_ranks(mesh_runs.train_rank, world, backend="gloo", device="cpu", timeout=DEADLINE, args=(runs,))
    # The local twin runs in this process with a rank's one thread: under
    # the suite's parallel workers more threads only oversubscribe the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(D.rank_threads(1, "cpu"))
    try:
        local = {name: mesh_runs.train("local", "cpu", *spec) for name, spec in runs.items()}
    finally:
        torch.set_num_threads(threads)
    return world, mesh, local


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _start(2, tmp_path_factory)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return _start(3, tmp_path_factory)


def _assert_params_close(mesh, local):
    assert set(mesh) == set(local)
    for name, a in mesh.items():
        np.testing.assert_allclose(a, local[name], rtol=0, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("fixture", ["world2", "world3"])
def test_mesh_trainer_matches_the_local_executor(fixture, request):
    world, mesh, local = request.getfixturevalue(fixture)
    for name, rec in mesh.items():
        assert rec["lockstep"], f"{name}: the ranks' parameters or histories differ"
        assert rec["describe"].startswith(f"mesh[{world}x")
        _assert_params_close(rec["params"], local[name]["params"])
        keys = ("stragglers", "fallback", "host_solves", "device_solves", "patches")
        assert [[h.get(k) for k in keys] for h in rec["history"]] == \
            [[h.get(k) for k in keys] for h in local[name]["history"]]
        np.testing.assert_allclose([h["loss"] for h in rec["history"]],
                                   [h["loss"] for h in local[name]["history"]], rtol=1e-6)
        assert rec["stats"] == local[name]["stats"]


def test_mesh_trainer_parity_and_elastic_patch_world_2(world2):
    _, mesh, local = world2
    parity = mesh["parity"]
    assert any(h["fallback"] for h in parity["history"]) and not all(h["fallback"] for h in parity["history"])
    assert sum(h["stragglers"] for h in parity["history"]) > 0
    patch = mesh["patch"]
    s = patch["stats"]
    assert s["elastic_patches"] >= 1 and s["moved_node_blocks"] >= 1 and s["full_repacks"] == 0
    assert patch["history"][0]["fallback"] is True and patch["history"][-1]["fallback"] is False
    # Each moved row is written once, by the rank whose block holds it
    # (tokens and validity: two arrays), and the blocks are the local
    # executor's rows.
    assert sum(patch["rows_written"]) == 2 * s["moved_node_blocks"]
    np.testing.assert_array_equal(np.concatenate(patch["valid_blocks"]), local["patch"]["valid"])


def test_mesh_trainer_padded_fallback_world_3(world3):
    """World 3 over G = 4: blocks of 2 rows, the last rank's half padding;
    ``b_override`` lines up with the padded node axis."""
    _, mesh, local = world3
    rec = mesh["fallback"]
    assert all(h["fallback"] for h in rec["history"]) and rec["stats"]["host_solves"] == 1
    assert [b.shape[0] for b in rec["valid_blocks"]] == [2, 2, 2]
    np.testing.assert_array_equal(np.concatenate(rec["valid_blocks"])[:4], local["fallback"]["valid"])
    assert not np.concatenate(rec["valid_blocks"])[4:].any()
