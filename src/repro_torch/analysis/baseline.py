"""Checked-in baseline for the port's Layer-1 findings (the twin of the
reference's ``analysis/baseline.py``, with the port's own file).

Known findings, each triaged, are recorded (fingerprinted) in
``src/repro_torch/analysis/lint_baseline.json`` and stop failing the gate,
while anything *new* still fails it.  Fingerprints hash ``rule | module |
qualname | stripped-source-line``: stable across line-number churn,
invalidated the moment the flagged line changes (so a "fixed" finding
cannot silently regress under its old entry).

Override the baseline path with ``REPRO_TORCH_LINT_BASELINE=/path/to.json``
(``REPRO_TORCH_LINT_BASELINE=`` empty disables the baseline: every finding
counts).  Refresh with ``python -m repro_torch.analysis --update-baseline``
after deliberate triage, never to bury a regression.  The reference's
``REPRO_LINT_BASELINE`` and ``tools/lint_baseline.json`` are its own.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from .ast_lint import Finding

__all__ = ["baseline_path", "load_baseline", "make_baseline", "save_baseline", "split_findings"]

ENV_VAR = "REPRO_TORCH_LINT_BASELINE"
DEFAULT_RELPATH = os.path.join("src", "repro_torch", "analysis", "lint_baseline.json")


def baseline_path(repo_root: str) -> Optional[str]:
    """Resolve the baseline file path; None means "no baseline in effect"."""
    if ENV_VAR in os.environ:
        override = os.environ[ENV_VAR]
        return override or None
    return os.path.join(repo_root, DEFAULT_RELPATH)


def load_baseline(path: Optional[str]) -> set[str]:
    """Fingerprint set from a baseline file (missing file → empty set)."""
    if not path or not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return {e["fingerprint"] for e in data.get("findings", [])}


def make_baseline(findings: Iterable[Finding]) -> dict:
    """Serializable baseline doc.  Context fields are for the human reading
    the diff — only ``fingerprint`` is consulted when filtering."""
    return {
        "comment": (
            "Known Layer-1 lint findings of the port, suppressed by fingerprint. "
            "Regenerate with: python -m repro_torch.analysis --update-baseline. "
            "Fingerprints bind to the flagged source line — editing the "
            "line invalidates the entry."
        ),
        "findings": [
            {
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "module": f.module,
                "qualname": f.qualname,
                "snippet": f.snippet,
                "message": f.message,
            }
            for f in sorted(findings, key=lambda f: (f.module, f.line, f.rule))
        ],
    }


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(make_baseline(findings), fh, indent=2)
        fh.write("\n")


def split_findings(
    findings: Iterable[Finding], baseline: set[str]
) -> tuple[list[Finding], list[Finding]]:
    """(new, baselined) partition."""
    new: list[Finding] = []
    old: list[Finding] = []
    for f in findings:
        (old if f.fingerprint in baseline else new).append(f)
    return new, old
