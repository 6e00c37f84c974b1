"""Render the dry-run and roofline tables from a ``launch.dryrun`` JSON-lines
file (the twin of the reference's ``launch/make_tables.py``), printed to
stdout.  The "what would move the bottleneck" column is in H100 terms:
tensor cores, HBM3 and NVLink, the hand-written flash kernel.  The port's
dry run compiles nothing: the raw record's time column is the analysis
seconds (``lower_s``).

    PYTHONPATH=src python -m repro_torch.launch.make_tables results/dryrun.jsonl
"""

from __future__ import annotations

import json
import sys
from collections import OrderedDict


def load(path: str) -> "OrderedDict[tuple, dict]":
    cells: "OrderedDict[tuple, dict]" = OrderedDict()
    with open(path) as f:
        for line in f:
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (d.get("arch"), d.get("shape"), d.get("mesh", "-"))
            cells[key] = d  # last write wins (re-runs override)
    return cells


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if b < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def roofline_table(cells, mesh_filter: str = "16x16") -> str:
    rows = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | dominant "
        "| MODEL_TF | useful | roofline frac | what would move the bottleneck |",
        "|---|---|---|---|---|---|---|---|---|---|"[:-1],
    ]
    suggestions = {
        ("memory", "train"): "less remat recompute traffic / larger per-device batch (arith. intensity)",
        ("memory", "prefill"): "the hand-written flash kernel keeps scores on chip: cut activation traffic",
        ("memory", "decode"): "batch growth or quantized KV cache (bytes/step ≈ cache read from HBM3)",
        ("collective", "train"): "overlap FSDP all-gathers with compute over NVLink; bf16 collectives",
        ("collective", "prefill"): "reshard logits head; reduce-scatter instead of all-reduce",
        ("collective", "decode"): "seq-sharded KV cache (partial-softmax psum) kills resharding copies",
        ("compute", "train"): "already tensor-core-bound: raise useful_ratio by trimming remat",
        ("compute", "prefill"): "already tensor-core-bound",
        ("compute", "decode"): "already tensor-core-bound",
    }
    for (arch, shape, mesh), d in cells.items():
        if mesh != mesh_filter or "roofline" not in d:
            continue
        r = d["roofline"]
        kind = d.get("kind", "train")
        sug = suggestions.get((r["dominant"], kind), "-")
        rows.append(
            f"| {arch} | {shape} | {r['compute_s']*1e3:.2f} | {r['memory_s']*1e3:.2f} "
            f"| {r['collective_s']*1e3:.2f} | **{r['dominant']}** "
            f"| {r['model_flops']/1e12:.1f} | {r['useful_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {sug} |"
        )
    return "\n".join(rows)


def dryrun_table(cells) -> str:
    rows = [
        "| arch | shape | mesh | analysis (s) | FLOPs/dev | bytes/dev | coll bytes/dev | collective mix |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape, mesh), d in cells.items():
        if "skipped" in d:
            rows.append(f"| {arch} | {shape} | {mesh} | SKIP (sub-quadratic rule) | | | | |")
            continue
        if "error" in d:
            rows.append(f"| {arch} | {shape} | {mesh} | FAIL | | | | {d['error'][:60]} |")
            continue
        mix = ", ".join(
            f"{k.replace('all-', 'a')}:{fmt_bytes(v)}"
            for k, v in sorted(d["collectives"]["by_kind"].items(), key=lambda kv: -kv[1])[:3]
        )
        rows.append(
            f"| {arch} | {shape} | {mesh} | {d['lower_s']:.1f} "
            f"| {d['flops_per_device']:.2e} | {fmt_bytes(d['bytes_per_device'])} "
            f"| {fmt_bytes(d['collectives']['total_bytes'])} | {mix} |"
        )
    return "\n".join(rows)


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun.jsonl"
    cells = load(path)
    live = [d for d in cells.values() if "roofline" in d]
    skipped = [d for d in cells.values() if "skipped" in d]
    failed = [d for d in cells.values() if "error" in d]
    print(f"### Dry-run summary: {len(live)} analysed, {len(skipped)} skipped, {len(failed)} failed\n")
    print("#### Roofline table — single pod 16×16 (256 chips)\n")
    print(roofline_table(cells, "16x16"))
    print("\n#### Multi-pod deltas — 2×16×16 (512 chips)\n")
    print(roofline_table(cells, "2x16x16"))
    print("\n#### Raw dry-run record\n")
    print(dryrun_table(cells))


if __name__ == "__main__":
    main()
