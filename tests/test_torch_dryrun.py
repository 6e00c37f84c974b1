"""The port's multi-pod dry run (``repro_torch.launch.dryrun``), its tables
(``launch.make_tables``) and the ``meta`` route of ``kernels.dispatch``.

The dry run runs a cell's step as rank 0 of a ``fake`` process group on
``meta`` tensors; here it runs in a subprocess (the fake group must not
meet the process groups other tests open in this process), at the smoke
widths.  Its parameter bytes, FLOPs and collectives are held to a real
4-rank gloo run of the same step (``launch.distributed.run_ranks``) under
``op_analysis.analyze``; its skip rules, ``model_flops`` and table
renderer to the reference's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SMOKE = {"vocab": 256, "d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "head_dim": 16}
# The keys of the reference's lower_cell record (src/repro/launch/dryrun.py:138-173).
REF_KEYS = {"arch", "shape", "mesh", "chips", "layout", "remat", "moe_routing", "cache_layout", "accum_steps",
            "kind", "lower_s", "compile_s", "flops_per_device", "bytes_per_device", "xla_cost_flops_loop_once",
            "collectives", "model_flops", "active_params", "total_params", "memory", "roofline"}


def _dryrun(out: Path, *args: str) -> dict:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-1.7b", "--out", str(out), *args]
    for k, v in SMOKE.items():
        cmd += ["--override", f"{k}={v}"]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    got = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=str(ROOT), env=env)
    assert got.returncode == 0, got.stdout[-2000:] + got.stderr[-4000:]
    return json.loads(out.read_text().splitlines()[-1])


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """A smoke train cell on (2, 2) and on the production (16, 16) mesh,
    both in one JSON-lines file."""
    out = tmp_path_factory.mktemp("dryrun") / "dryrun.jsonl"
    small = _dryrun(out, "--shape", "train_4k", "--mesh-shape", "2x2", "--batch", "8", "--seq-len", "64",
                    "--num-groups", "2", "--compress")
    pod = _dryrun(out, "--shape", "train_4k", "--batch", "256", "--seq-len", "64")
    return {"path": out, "small": small, "pod": pod}


# ------------------------------------------------------------ meta route


@pytest.mark.parametrize("op", ["flash_attention", "assign_min", "pairwise_sqdist", "weighted_segsum",
                                "min_dist_update"])
def test_resolve_on_meta_gives_the_plain_version_never_cuda(op):
    import repro_torch.kernels.flash_attention.ops  # noqa: F401  registers the ops
    import repro_torch.kernels.pairwise_dist.ops  # noqa: F401
    import repro_torch.kernels.weighted_segsum.ops  # noqa: F401
    from repro_torch.kernels import dispatch

    t = torch.empty((4, 8), device="meta")
    assert dispatch.resolve(op, "auto", t, t)[0] == "torch_ref"
    cpu = torch.empty((4, 8))
    assert dispatch.resolve(op, "auto", cpu, cpu)[0] == "torch_ref"
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        dispatch.resolve(op, "cuda", t, t)
    if op == "flash_attention":
        assert dispatch.resolve(op, "torch_chunked", t, t)[0] == "torch_chunked"


def test_plain_versions_run_on_meta_and_count_no_launch():
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.pairwise_dist.ops import assign_min

    dispatch.reset_launch_counts()
    q = torch.empty((2, 64, 4, 16), device="meta")
    k = torch.empty((2, 64, 2, 16), device="meta")
    assert flash_attention(q, k, k).shape == (2, 64, 4, 16)
    idx, d2 = assign_min(torch.empty((100, 8), device="meta"), torch.empty((5, 8), device="meta"))
    assert idx.shape == d2.shape == (100,) and idx.device.type == "meta"
    assert not any(dispatch.launch_counts().values())


# ------------------------------------------------------------ the dry run


def test_dry_run_equals_a_real_gloo_run_of_the_same_step(records):
    """Fake world of 4 on (2, 2), meta tensors, against 4 gloo ranks with
    drawn values, a compressed train step (phase "train mesh"'s): the
    parameter bytes a rank, the FLOPs and the collectives by kind, calls
    and bytes, equal."""
    from repro_torch.launch import distributed as mesh_dist
    from repro_torch.launch import mesh_runs

    rec = records["small"]
    rep = mesh_dist.run_ranks(mesh_runs.dryrun_twin_rank, 4, backend="gloo", device="cpu", timeout=240,
                              args=("qwen3-1.7b", "train", (2, 2), 8, 64, SMOKE, "full", 2, True))
    r0 = rep["ranks"][0]
    assert r0["coords"] == (0, 0)
    assert r0["param_bytes"] == rec["memory"]["param_bytes"]
    assert len({r["param_bytes"] for r in rep["ranks"]}) == 1
    assert r0["flops"] == rec["flops_per_device"]
    assert r0["by_kind"] == rec["collectives"]["by_kind"]
    assert r0["calls_by_kind"] == rec["collectives"]["calls_by_kind"] and "pmax" in r0["calls_by_kind"]
    assert r0["kernel_ops"] == rec["kernel_ops"] == {"flash_attention": 2 * SMOKE["n_layers"]}


def test_production_mesh_cell_has_the_references_keys(records):
    rec = records["pod"]
    assert REF_KEYS <= set(rec), REF_KEYS - set(rec)
    assert (rec["mesh"], rec["chips"], rec["kind"]) == ("16x16", 256, "train")
    assert rec["compile_s"] is None and rec["xla_cost_flops_loop_once"] is None
    assert rec["memory"]["generated_code_bytes"] is None
    mem = rec["memory"]
    assert mem["argument_bytes"] > mem["param_bytes"] > 0 and mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    assert rec["flops_per_device"] > 0 and rec["collectives"]["total_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_skip_reasons_equal_the_references():
    from repro.launch import specs as ref_specs
    from repro.models.registry import get_config as ref_config

    from repro_torch.configs import REFERENCE_ARCHS
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models.registry import get_config

    skipped = 0
    for arch in REFERENCE_ARCHS:
        for name, shape in specs.SHAPES.items():
            ok, why = specs.cell_is_applicable(get_config(arch), shape)
            assert (ok, why) == ref_specs.cell_is_applicable(ref_config(arch), ref_specs.SHAPES[name])
            if not ok:
                skipped += 1
                assert lower_cell(arch, name) == {"arch": arch, "shape": name, "skipped": why}
    assert skipped > 0
    # A decode under cache layout seq is a record (its fake group in a
    # subprocess), at 4 of qwen3-4b's 36 layers: the cache is each layer's
    # K and V of 8 rows x 2048 slots (32768 / 16 model ranks) x all 8 KV
    # heads x 128 in bf16, and the softmax's statistics are summed over
    # model (a pmax and two sums a layer, beside the embedding's sum).
    code = ("import json; from repro_torch.launch.dryrun import lower_cell; print(json.dumps(lower_cell("
            "'qwen3-4b', 'decode_32k', cache_layout='seq', cfg_overrides={'n_layers': 4})))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240, cwd=str(ROOT),
                         env=env)
    assert got.returncode == 0, got.stderr[-4000:]
    rec = json.loads(got.stdout.strip().splitlines()[-1])
    assert "skipped" not in rec and (rec["cache_layout"], rec["mesh"], rec["kind"]) == ("seq", "16x16", "decode")
    tokens = 128 * 4  # the (128, 1) int32 global tokens_t, whose storage the rank's rows view
    assert rec["memory"]["argument_bytes"] - rec["memory"]["param_bytes"] - tokens == 8 * 2048 * 8 * 128 * 2 * 2 * 4
    calls = rec["collectives"]["calls_by_kind"]
    assert calls["pmax"] == 4 and calls["sum"] == 2 * 4 + 1


def test_long_500k_keeps_its_one_row_whole_and_splits_the_ring_under_seq():
    """recurrentgemma-9b's long_500k cell (one row: the data shards do not
    divide it, so every rank keeps it whole, as the reference's
    ``batch_shardings`` replicates it) at 5 of its 38 layers, one local
    attention layer among them, under both cache layouts: a record each,
    the ring of 2048 slots split over the 16 model ranks under seq, and the
    softmax's statistics summed over model (a pmax and two sums)."""
    code = ("import json; from repro_torch.launch.dryrun import lower_cell; print(json.dumps({lay: lower_cell("
            "'recurrentgemma-9b', 'long_500k', cache_layout=lay, cfg_overrides={'n_layers': 5}) "
            "for lay in ('feature', 'seq')}))")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=240, cwd=str(ROOT),
                         env=env)
    assert got.returncode == 0, got.stderr[-4000:]
    rec = json.loads(got.stdout.strip().splitlines()[-1])
    for lay in ("feature", "seq"):
        assert not {"skipped", "error"} & set(rec[lay]) and rec[lay]["cache_layout"] == lay
    ring = 2048 * 1 * 256 * 2 * 2  # one row, 2048 slots, 1 KV head of 256, bf16, K and V
    assert rec["feature"]["memory"]["argument_bytes"] - rec["seq"]["memory"]["argument_bytes"] == ring - ring // 16
    calls = [rec[lay]["collectives"]["calls_by_kind"] for lay in ("feature", "seq")]
    assert calls[1]["pmax"] == 1 and calls[1]["sum"] - calls[0]["sum"] == 2


def _model_flops_cases():
    from repro_torch.configs import REFERENCE_ARCHS
    from repro_torch.launch.specs import SHAPES

    return [(a, s) for a in REFERENCE_ARCHS for s in SHAPES]


@pytest.mark.parametrize("arch,shape", _model_flops_cases())
def test_model_flops_equal_the_references(arch, shape):
    from repro.launch import roofline as ref_roofline
    from repro.launch import specs as ref_specs
    from repro.models.registry import get_config as ref_config

    from repro_torch.launch import roofline, specs
    from repro_torch.models.registry import get_config

    got = roofline.model_flops(get_config(arch), specs.SHAPES[shape])
    want = ref_roofline.model_flops(ref_config(arch), ref_specs.SHAPES[shape])
    assert {k: got[k] for k in ("model_flops", "active_params", "total_params")} == \
        {k: want[k] for k in ("model_flops", "active_params", "total_params")}


def _numbers(table: str) -> list:
    """The numeric cells of a markdown table, row by row."""
    rows = []
    for line in table.splitlines()[2:]:
        cells = []
        for cell in line.strip("|").split("|"):
            cell = cell.strip().strip("*")
            try:
                cells.append(float(cell))
            except ValueError:
                continue
        rows.append(cells)
    return rows


def test_make_tables_numeric_columns_equal_the_references(records, tmp_path):
    from repro.launch import make_tables as ref_tables

    from repro_torch.launch import make_tables

    cells = make_tables.load(str(records["path"]))
    ref_cells = ref_tables.load(str(records["path"]))
    assert len(cells) == 2
    for mesh in ("16x16", "2x2"):
        got, want = make_tables.roofline_table(cells, mesh), ref_tables.roofline_table(ref_cells, mesh)
        assert _numbers(got) == _numbers(want) and len(got.splitlines()) == 3
    # The reference's raw table reads compile_s, which the port's dry run
    # leaves null: it is given the analysis seconds in a copy.
    for d in ref_cells.values():
        d["compile_s"] = d["lower_s"]
    assert _numbers(make_tables.dryrun_table(cells)) == _numbers(ref_tables.dryrun_table(ref_cells))
