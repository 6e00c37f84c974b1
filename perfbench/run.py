#!/usr/bin/env python3
"""Run one cell of the benchmark on the card(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; everything it needs is found by name under ``perfbench/``
(see ``perfbench/harness/files.py``).  A run:

1. sets up the system under test from the seed (data, weights, the program's
   own set-up) and drives one unit of work to warm every shape the cell
   uses: ``setup_s`` runs from the process's start to here;
2. drives units of work (solves, training steps) back to back until
   ``--seconds`` have passed; the unit in flight then finishes, and the
   window is the time until it has, the device synchronised;
3. with ``--trace 1``, runs the window under ``torch.profiler`` and reports
   the cell's per-layer metrics instead of its end-to-end ones;
4. frees the program's state and holds what the window produced against the
   plain reference (``configs/<config>.py``), each number beside its limit
   (``workloads/<cell>.json``);
5. prints the result as the last line of standard output, and the numbers
   compared as the last lines of standard error.

It exits nonzero, printing no result, without enough CUDA devices, or if
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.
The program's kernel libraries, and the bytecode of the modules a run
imports, are built into ``.perfbench_cache/`` in the checkout, so only a
checkout's first run builds them.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, and the bytecode of every module imported from here on:
    an installation without it compiles each module from its source in
    every process, several seconds of set-up."""
    cache = ROOT / ".perfbench_cache"
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache / "build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def drive(runner, seconds: float) -> tuple[float, int]:
    """Units back to back until ``seconds`` have passed; (window s, units).
    Each unit's seconds go to standard error."""
    t0 = last = time.perf_counter()
    each = []
    while True:
        runner.step(len(each))
        now = time.perf_counter()
        each.append(now - last)
        last = now
        if now - t0 >= seconds:
            print("perfbench: unit seconds " + " ".join(f"{x:.4f}" for x in each), file=sys.stderr)
            return now - t0, len(each)


def traced(runner, seconds: float):
    """The window under the profiler, recording the device's activity
    alone: (window s, units, trace, op calls, the program's spans that
    closed in it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from harness.devtrace import DeviceTrace
    from harness.ranges import HostLog, OpRecorder, wrapped
    from repro_torch.kernels import dispatch
    from repro_torch.obs import default_buffer

    log = HostLog()
    recorder = OpRecorder(log)
    torch.cuda._sleep(1000)  # loads the marker's kernel before the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with dispatch.observed(recorder), wrapped(runner.layer_targets(), log):
            default_buffer().clear()
            w0 = time.time_ns()
            offset = w0 - time.perf_counter_ns()
            m0 = time.time_ns()
            torch.cuda._sleep(1000)  # the marker that ties the host clock to the trace's
            marker = (m0, time.time_ns())
            window_s, units = drive(runner, seconds)
            w1 = time.time_ns()
            spans = default_buffer().rows()
    ranges = log.ranges + [(s["name"], offset + int(s["ts"] * 1e9), offset + int(s["ts"] * 1e9 + s["dur_us"] * 1e3))
                           for s in spans]
    trace = DeviceTrace(prof.profiler.kineto_results.events(), (w0, w1), ranges, marker)
    return window_s, units, trace, recorder.calls, spans


def execute(args, device, *, chips: int = 1, cfg_over=None, traffic_over=None, limits_over=None) -> dict:
    """Steps 1–4 of a run on ``device``: the result, its ``checks`` last.
    The ``*_over`` dicts replace keys of the cell's files (the tests run a
    cell at a tiny size on the CPU)."""
    import torch

    from harness import files

    man = files.manifest()
    cell = files.by_name(man["workloads"], args.workload, "workload")
    cfg = {**files.config(cell["config"]), **(cfg_over or {})}
    traffic = {**files.traffic(cell["traffic"]), **(traffic_over or {})}
    limits = {**files.workload(cell["name"])["limits"], **(limits_over or {})}
    e2e, layer = files.cell_metrics(man, cell["name"])
    runner = files.driver(cfg["driver"]).setup(cfg, traffic, args.seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - _T0

    if args.trace:
        window_s, units, trace, calls, spans = traced(runner, args.seconds)
    else:
        window_s, units = drive(runner, args.seconds)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0}

    metrics = {}
    breakdown = None
    if args.trace:
        view = SimpleNamespace(cell=cell, config=cfg, traffic=traffic, runner=runner, units=units, window_s=window_s,
                               trace=trace, calls=calls, spans=spans, peaks=files.peaks(), files=files)
        for m in layer:
            value = files.metric(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        print(f"perfbench: trace of {len(trace.ops)} device ops, {len(trace.kernels())} kernels "
              f"({trace.unlaunched} with no launch record; the marker's launch recorded: {trace.marker_launched}), "
              f"{len(trace.ranges)} host ranges, {len(calls)} op calls", file=sys.stderr)
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
        breakdown = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
        del trace, view
    else:
        values = runner.end_to_end(window_s, units)
        values["setup_s"] = setup_s
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    t_check = time.perf_counter()
    checks, failed = runner.check(limits)
    print(f"perfbench: setup {setup_s:.3f} s, window {window_s:.3f} s over {units} units, "
          f"check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    correct = bool(checks) and failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": units, "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    from harness import files

    cell = files.by_name(files.manifest()["workloads"], args.workload, "workload")
    import torch

    chips = int(cell["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s), {have} available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    print(f"perfbench: CUDA context ready {time.perf_counter() - _T0:.3f} s after the start", file=sys.stderr)
    result = execute(args, device, chips=chips)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
