"""``BENCHMARK.json`` and the files it names: names, units, keys, bounds, and every cell and metric complete."""

import json
import math
import re

from harness import files

MAN = files.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MAN)) <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32 and all(LINE.match(w) for w in MAN["command"])
    assert MAN["paths"] == ["perfbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in MAN[group]]
        assert len(names) == len(set(names)), group
        for x in MAN[group]:
            assert NAME.match(x["name"]), x["name"]
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MAN["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert LINE.match(w["why"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in MAN["per_layer"]:
        assert LINE.match(m["layer"])


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in MAN["end_to_end"])


def test_every_config_has_a_cell_and_every_cell_its_files():
    cells = {w["name"]: w for w in MAN["workloads"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for c in MAN["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        assert files.config(c["name"])["name"] == c["name"]
        assert (files.BENCH / "configs" / f"{c['name']}.py").is_file()
        assert (files.BENCH / "controls" / f"{c['name']}.py").is_file()
        assert (files.BENCH / "drivers" / f"{files.config(c['name'])['driver']}.py").is_file()
    for w in cells.values():
        assert files.traffic(w["traffic"])
        assert files.workload(w["name"])["limits"]


def test_moves_and_reports():
    """Every per-layer metric moves an end-to-end metric that each of its
    cells reports; every cell reports setup_s, another end-to-end metric and
    a per-layer one; each metric has its reader."""
    cells = [w["name"] for w in MAN["workloads"]]
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        assert (files.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for cell in cells:
        ends, per = files.cell_metrics(MAN, cell)
        names = {m["name"] for m in ends}
        assert "setup_s" in names and len(names) >= 2
        assert per


def test_check_budget_fits_a_full_benchmark():
    """2 + 14 runs a cell, each allowed run_seconds + 60, 2 × 90 s a cell
    to compile, 1200 s spare: 24 cells within 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (MAN["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_four_chip_cells_are_few():
    fours = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert fours <= max(1, math.floor(0.25 * len(MAN["workloads"])))


def test_a_per_layer_metric_without_cells_goes_where_its_end_to_end_metric_does():
    """The contract lets a later entry leave out ``workloads``: it is then
    reported in every cell that reports the metric it moves."""
    man = {**MAN, "per_layer": MAN["per_layer"] + [
        {"name": "later.metric", "unit": "%", "better": "higher", "source": "device_trace", "layer": "device",
         "moves": "solve_s"}]}
    for cell in (w["name"] for w in MAN["workloads"]):
        ends, per = files.cell_metrics(man, cell)
        assert ("later.metric" in {m["name"] for m in per}) == ("solve_s" in {m["name"] for m in ends})
