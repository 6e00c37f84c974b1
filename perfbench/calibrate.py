#!/usr/bin/env python3
"""Readings from which a cell's limits of ``correct`` are set.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,13 [--read control] [--units 1]

For each seed it sets the cell up (without the warm-up unit), drives
``--units`` units of work as the window would, and prints the numbers the
check compares, one JSON line a seed.  ``--read NAME`` reads instead what
``controls/<config>.py`` names so: where the module's ``PLANTED`` has the
name, its context manager (the control, the plain reference in the
precision below the configuration's, put in the program's place, or a fault
planted in the program) is open for the whole run; otherwise
``NAME(runner)`` returns the readings of the control or of a fault read on
the reference.  The lower reading of a limit is the largest over a dozen
sound seeds or more; the upper the smallest over the control's (for a
training cell also over its faults').  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--units", type=int, default=1)
    p.add_argument("--read", default="", help="a control or fault of controls/<config>.py")
    args = p.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    import run

    run.cache_env()
    import torch

    from harness import files

    cell = files.by_name(files.manifest()["workloads"], args.workload, "workload")
    cfg, traffic = files.config(cell["config"]), files.traffic(cell["traffic"])
    limits = files.workload(cell["name"])["limits"]
    driver = files.driver(cfg["driver"])
    device = torch.device("cuda", 0)
    controls = files.load_module(BENCH / "controls" / f"{cfg['name']}.py", "control") if args.read else None
    installs = controls is not None and args.read in getattr(controls, "PLANTED", {})
    with controls.PLANTED[args.read](cfg) if installs else contextlib.nullcontext():
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            runner = driver.setup(cfg, traffic, seed, device, warm=False)
            for u in range(args.units):
                runner.step(u)
            if controls is not None and not installs:
                readings = getattr(controls, args.read)(runner)
            else:
                checks, _ = runner.check(limits)
                readings = {c["name"]: c["value"] for c in checks}
            del runner
            torch.cuda.empty_cache()
            print(json.dumps({"cell": cell["name"], "seed": seed, "read": args.read or "program",
                              "seconds": time.perf_counter() - t0, "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
