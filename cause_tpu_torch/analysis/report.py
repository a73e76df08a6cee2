"""Reporters (text / JSON) and the findings baseline.

The baseline freezes accepted pre-existing findings so the gate
blocks only NEW ones: fingerprints are line-number independent
(rule + relative path + stripped source line), so edits elsewhere in a
file never unfreeze a frozen finding, while touching the flagged line
itself re-opens it — the right default for a ratchet.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Set

from .core import AnalysisResult, Finding, fingerprint

SCHEMA_VERSION = 1


def _fingerprints(result: AnalysisResult) -> Dict[int, str]:
    """id(finding) -> fingerprint, with an occurrence index folded in
    for duplicates: two identical flagged lines in one file must NOT
    share a fingerprint, or freezing the first would silently baseline
    every future copy. Occurrences are numbered in line order, so the
    (line-number independent) base hash still survives unrelated edits
    while a NEW duplicate gets a new, unfrozen fingerprint."""
    seen: Dict[str, int] = {}
    out: Dict[int, str] = {}
    for f in sorted(result.findings, key=lambda f: (f.path, f.line,
                                                    f.rule, f.col)):
        base = fingerprint(f, result.root)
        n = seen.get(base, 0)
        seen[base] = n + 1
        out[id(f)] = base if n == 0 else f"{base}#{n}"
    return out


def to_json(result: AnalysisResult,
            baseline_filtered: int = 0) -> dict:
    counts: dict = {}
    for f in result.findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    fps = _fingerprints(result)
    return {
        "version": SCHEMA_VERSION,
        "tool": "causelint",
        "files": result.files,
        "total": len(result.findings),
        "suppressed": len(result.suppressed),
        "baseline_filtered": baseline_filtered,
        "counts": counts,
        "findings": [
            {
                "rule": f.rule,
                "family": f.family,
                "path": f.path,
                "line": f.line,
                "col": f.col,
                "message": f.message,
                "snippet": f.snippet,
                "fingerprint": fps[id(f)],
            }
            for f in result.findings
        ],
    }


def render_text(result: AnalysisResult,
                baseline_filtered: int = 0) -> str:
    lines: List[str] = []
    for f in result.findings:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} {f.message}")
        if f.snippet:
            lines.append(f"    {f.snippet}")
    tail = (f"causelint: {len(result.findings)} finding(s) in "
            f"{result.files} file(s)")
    extras = []
    if result.suppressed:
        extras.append(f"{len(result.suppressed)} suppressed")
    if baseline_filtered:
        extras.append(f"{baseline_filtered} baselined")
    if extras:
        tail += " (" + ", ".join(extras) + ")"
    lines.append(tail)
    return "\n".join(lines)


def load_baseline(path: str) -> Set[str]:
    """Fingerprints frozen by an earlier ``--write-baseline`` run. A
    missing file is an empty baseline (first run bootstraps)."""
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except FileNotFoundError:
        return set()
    fps = data.get("fingerprints", []) if isinstance(data, dict) else []
    return {str(x) for x in fps}


def write_baseline(path: str, result: AnalysisResult) -> int:
    fps = sorted(set(_fingerprints(result).values()))
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": SCHEMA_VERSION, "tool": "causelint",
                   "fingerprints": fps}, f, indent=2, sort_keys=True)
        f.write("\n")
    return len(fps)


def apply_baseline(result: AnalysisResult,
                   baseline: Optional[Set[str]]) -> int:
    """Drop findings whose fingerprint is frozen; returns the count."""
    if not baseline:
        return 0
    fps = _fingerprints(result)
    kept: List[Finding] = []
    dropped = 0
    for f in result.findings:
        if fps[id(f)] in baseline:
            dropped += 1
        else:
            kept.append(f)
    result.findings = kept
    return dropped
