"""The manifest (``BENCHMARK.json``) and the files it names, found by name.

A cell names a configuration and a traffic mix.  Everything that belongs to
one of them sits in a file of its own under ``perfbench/``:

* ``configs/<config>.json``   the configuration as it is run; its key
  ``driver`` names the driver;
* ``configs/<config>.py``     the configuration's plain reference;
* ``traffic/<traffic>.json``  the traffic mix's parameters;
* ``workloads/<cell>.json``   the cell's limits of ``correct``;
* ``drivers/<driver>.py``     the code that sets the system up and drives it;
* ``metrics/<metric>.py``     one reader per per-layer metric;
* ``kernels/<op>.py``         a kernel op's operations and bytes by shape;
* ``mfu/<config>.py``         the operations a unit of work needs.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def by_name(items, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r}")


def load_module(path: Path, tag: str):
    """The module in ``path`` under a private name: file names hold dots
    and dashes, which ``import`` statements cannot name."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    name = f"perfbench_{tag}_" + re.sub(r"\W", "_", path.stem)
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def config(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def reference(name: str):
    return load_module(BENCH / "configs" / f"{name}.py", "ref")


def traffic(name: str) -> dict:
    return read_json(BENCH / "traffic" / f"{name}.json")


def workload(name: str) -> dict:
    return read_json(BENCH / "workloads" / f"{name}.json")


def driver(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py", "driver")


def metric(name: str):
    return load_module(BENCH / "metrics" / f"{name}.py", "metric")


def kernel(op: str):
    return load_module(BENCH / "kernels" / f"{op}.py", "kernel")


def mfu(config_name: str):
    return load_module(BENCH / "mfu" / f"{config_name}.py", "mfu")


def peaks() -> dict:
    return read_json(BENCH / "harness" / "peaks.json")


def cell_metrics(man: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports: those
    whose ``workloads`` list it, or that have no such list; a per-layer
    metric without the list is reported where its end-to-end metric is."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [
        m for m in man["per_layer"]
        if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]
    return e2e, layer
