"""``python -m repro_torch.analysis``: the port's analysis gate, both layers
(the twin of the reference's ``tools/lint.py``).

Layer 1 (AST lint) runs the host-sync rules over ``src/repro_torch`` and
filters the findings through the port's baseline
(``src/repro_torch/analysis/lint_baseline.json``; override with
``REPRO_TORCH_LINT_BASELINE``, an empty value disables it).  Layer 2 (sync
audit) runs the four registered hot paths on ``--device`` (the card unless
``--device cpu``) and asserts zero host syncs and one program a bucket.

Exit code 1 with one line per failure (new lint finding / failed audit),
0 when clean: the reference's contract.  A machine-readable report is
written to ``--emit`` when given (never to the reference's ANALYSIS.json).

    PYTHONPATH=src python -m repro_torch.analysis [--layer {1,2,all}] [--update-baseline]
                                                  [--device cpu] [--emit PATH] [paths...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import baseline as bl
from .ast_lint import RULES, lint_paths

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_PATHS = [os.path.join("src", "repro_torch")]


def run_layer1(paths: list[str], update_baseline: bool) -> tuple[int, dict]:
    findings = lint_paths(paths)
    bpath = bl.baseline_path(REPO_ROOT)
    if update_baseline:
        target = bpath or os.path.join(REPO_ROOT, bl.DEFAULT_RELPATH)
        bl.save_baseline(target, [f for f in findings if f.fatal])
        print(f"lint: baseline refreshed -> {os.path.relpath(target, REPO_ROOT)} "
              f"({sum(f.fatal for f in findings)} findings)")
    new, old = bl.split_findings(findings, bl.load_baseline(bpath))
    failures = [f for f in new if f.fatal]
    for f in failures:
        print(f.format(), file=sys.stderr)
    report = {
        "rules": {r: {"severity": s, "title": t} for r, (s, t) in sorted(RULES.items())},
        "baseline": os.path.relpath(bpath, REPO_ROOT) if bpath else None,
        "findings_total": len(findings),
        "findings_baselined": len(old),
        "findings_new": len(new),
        "failures": [
            {"rule": f.rule, "severity": f.severity, "path": f.path, "line": f.line, "qualname": f.qualname,
             "message": f.message, "fingerprint": f.fingerprint}
            for f in failures
        ],
        "info": [{"rule": f.rule, "path": f.path, "line": f.line, "message": f.message}
                 for f in new if not f.fatal],
    }
    return (1 if failures else 0), report


def run_layer2(device: str) -> tuple[int, dict]:
    from .sync_audit import audit_hot_paths

    audits = audit_hot_paths(device=device)
    rc = 0
    for a in audits:
        if not a.ok:
            rc = 1
            why = a.error or (f"registered={a.registered} syncs={a.sync_ops} same_program={a.same_program}")
            print(f"audit: {a.name} ({a.registry_name}) FAILED: {why}", file=sys.stderr)
    return rc, {"paths": [a.as_dict() for a in audits]}


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="source roots (default: src/repro_torch)")
    ap.add_argument("--layer", choices=("1", "2", "all"), default="all")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current fatal findings")
    ap.add_argument("--device", default="cuda", help="where layer 2 runs the hot paths (default: cuda)")
    ap.add_argument("--emit", default="", help="machine-readable report path ('' to skip)")
    args = ap.parse_args(argv)

    paths = [p if os.path.isabs(p) else os.path.join(REPO_ROOT, p) for p in (args.paths or DEFAULT_PATHS)]
    report: dict = {"tool": "repro_torch.analysis", "layers": {}}
    rc = 0
    if args.layer in ("1", "all"):
        rc1, rep1 = run_layer1(paths, args.update_baseline)
        rc |= rc1
        report["layers"]["ast_lint"] = rep1
        print(f"lint: layer1 {rep1['findings_total']} findings ({rep1['findings_baselined']} baselined, "
              f"{len(rep1['failures'])} failing, {len(rep1['info'])} info)")
    if args.layer in ("2", "all"):
        rc2, rep2 = run_layer2(args.device)
        rc |= rc2
        report["layers"]["sync_audit"] = rep2
        ok = sum(p["ok"] for p in rep2["paths"])
        syncs = {p["name"]: sum(p["syncs"].values()) for p in rep2["paths"]}
        print(f"lint: layer2 {ok}/{len(rep2['paths'])} hot paths audit clean on {args.device}; host syncs {syncs}")
    report["ok"] = rc == 0
    if args.emit:
        out = os.path.abspath(args.emit)
        if out == os.path.join(REPO_ROOT, "ANALYSIS.json"):
            raise SystemExit("the reference's ANALYSIS.json is not the port's report: give another --emit path")
        with open(out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
        print(f"lint: report -> {out}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
