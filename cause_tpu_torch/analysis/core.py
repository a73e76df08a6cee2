"""causelint core: file collection, suppressions, rule execution.

Wiring only — the interesting logic lives in ``callgraph`` (the
jit-reachability answer) and ``rules`` (the TID/JPH/OBS/LCA families).
Stdlib-only end to end: the lint runs before torch (or even numpy) is
installed.

Suppression syntax, per line::

    something_flagged()   # causelint: disable=TID002 -- reason
    # causelint: disable-next-line=JPH001,JPH002 -- reason
    the_flagged_line()

Rule tokens may be full ids (``TID002``), family prefixes (``TID``),
or ``all``. The ``-- reason`` tail is free text; write one — a
suppression is a recorded decision, not an escape hatch.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import subprocess
import tokenize
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .callgraph import ModuleInfo, build_program
from .rules import Context, Finding, REGISTRY, RULESET_VERSION

# importing these populates REGISTRY with the LCK/DUR/EVD families
from . import concurrency as _concurrency  # noqa: F401  (registration)
from . import protocol as _protocol        # noqa: F401  (registration)

_SUPPRESS_RE = re.compile(
    r"#\s*causelint:\s*disable(?P<next>-next-line)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_*,\s]+?)"
    r"(?:\s*--\s*(?P<reason>.*))?$"
)


@dataclass
class Suppression:
    line: int          # the line the suppression APPLIES to
    tokens: Set[str]
    reason: str
    used: bool = False


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    files: int = 0
    root: str = "."

    @property
    def exit_code(self) -> int:
        return 1 if self.findings else 0


def parse_suppressions(lines: List[str]) -> Dict[int, List[Suppression]]:
    """Suppressions from REAL comments only: the source is tokenized so
    a ``# causelint: disable=...`` example inside a docstring (this
    module has one) never registers as a live suppression. Files that
    fail to tokenize fall back to raw-line matching — they already get
    a GEN001 parse finding, so no rule finding needs suppressing."""
    try:
        comments = [
            (tok.start[0], tok.string)
            for tok in tokenize.generate_tokens(
                io.StringIO("\n".join(lines) + "\n").readline)
            if tok.type == tokenize.COMMENT
        ]
    except (tokenize.TokenError, IndentationError, SyntaxError,
            ValueError):
        comments = list(enumerate(lines, start=1))
    out: Dict[int, List[Suppression]] = {}
    for i, text in comments:
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        tokens = {t.strip() for t in m.group("rules").split(",")
                  if t.strip()}
        target = i + 1 if m.group("next") else i
        out.setdefault(target, []).append(
            Suppression(target, tokens, (m.group("reason") or "").strip())
        )
    return out


def _matches(tokens: Set[str], rule_id: str) -> bool:
    return any(t in ("all", "*") or t == rule_id
               or (t.isalpha() and rule_id.startswith(t))
               for t in tokens)


def collect_files(paths: List[str]) -> List[str]:
    """Every .py file under the given paths (sorted, deduped);
    __pycache__ and hidden directories are skipped."""
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if not d.startswith(".")
                               and d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
    seen: Set[str] = set()
    uniq = []
    for p in sorted(out):
        ap = os.path.abspath(p)
        if ap not in seen:
            seen.add(ap)
            uniq.append(p)
    return uniq


def _default_root(files: List[str]) -> str:
    """cwd when every analyzed file lives under it (the normal
    from-the-repo invocation), else the files' common ancestor.
    Module names — and with them the package-scoped rules (OBS001's
    obs scope, DUR002/EVD001's serve/net scopes) — derive from paths
    relative to this root; falling back to bare stems for
    outside-the-root files would silently disable those rules when
    the CLI is invoked from elsewhere with absolute paths."""
    cwd = os.getcwd()
    ab = [os.path.abspath(f) for f in files]
    prefix = cwd.rstrip(os.sep) + os.sep
    if not ab or all(f.startswith(prefix) for f in ab):
        return cwd
    return os.path.commonpath([os.path.dirname(f) for f in ab])


def fingerprint(f: Finding, root: str) -> str:
    """Line-number-independent identity of a finding, for baselines:
    unrelated edits above a frozen finding must not unfreeze it."""
    rel = os.path.relpath(os.path.abspath(f.path), os.path.abspath(root))
    h = hashlib.sha1(
        f"{f.rule}|{rel}|{f.snippet.strip()}".encode()
    ).hexdigest()
    return h[:20]


def run(paths: List[str], root: Optional[str] = None,
        rule_ids: Optional[List[str]] = None) -> AnalysisResult:
    """Analyze ``paths`` and return every unsuppressed finding.
    ``rule_ids=None`` runs every rule; an explicit empty list runs
    none (GEN findings — parse errors, unused suppressions — are the
    core's own and always emitted on full runs)."""
    files = collect_files(paths)
    root = root or _default_root(files)
    program = build_program(files, root)
    ctx = Context(program)
    full_run = rule_ids is None
    selected = [REGISTRY[r]
                for r in (sorted(REGISTRY) if full_run else rule_ids)
                if r in REGISTRY]
    result = AnalysisResult(files=len(files), root=root)
    for module in program.modules:
        result.findings.extend(_check_module(ctx, module, selected))
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    # suppressions apply last, so families can be filtered uniformly
    by_path = {m.path: parse_suppressions(m.lines)
               for m in program.modules}
    kept: List[Finding] = []
    for f in result.findings:
        hit = next(
            (s for s in by_path.get(f.path, {}).get(f.line, ())
             if _matches(s.tokens, f.rule)), None)
        if hit is not None:
            hit.used = True
            result.suppressed.append(f)
        else:
            kept.append(f)
    # a suppression nothing matched is a stale recorded decision —
    # report it so the ratchet cannot leak. Full runs only: with a
    # rule subset selected, "unused" would just mean "rule not run".
    if full_run:
        lines_of = {m.path: m.lines for m in program.modules}
        for path, supps in by_path.items():
            for slist in supps.values():
                for s in slist:
                    if not s.used:
                        lines = lines_of.get(path, [])
                        snippet = (lines[s.line - 1].strip()
                                   if 0 < s.line <= len(lines) else "")
                        kept.append(Finding(
                            "GEN002", path, s.line, 0,
                            "suppression matched no finding "
                            f"({', '.join(sorted(s.tokens))}) — the "
                            "code it guarded is gone or the rule id "
                            "is wrong; delete it", snippet))
        kept.sort(key=lambda f: (f.path, f.line, f.rule))
    result.findings = kept
    return result


# --------------------------------------------------- incremental runs

def _hash_files(files: List[str], root: str) -> Dict[str, str]:
    """relpath -> content sha1 for every analyzed file (the cache
    key, alongside the rule-set version)."""
    out: Dict[str, str] = {}
    aroot = os.path.abspath(root)
    for p in files:
        rel = os.path.relpath(os.path.abspath(p), aroot)
        try:
            with open(p, "rb") as f:
                out[rel] = hashlib.sha1(f.read()).hexdigest()
        except OSError:
            out[rel] = ""
    return out


def _finding_to_list(f: Finding) -> list:
    return [f.rule, f.path, f.line, f.col, f.message, f.snippet]


def cached_run(paths: List[str], root: Optional[str] = None,
               rule_ids: Optional[List[str]] = None,
               cache_path: Optional[str] = None) -> AnalysisResult:
    """``run()`` behind a content-hash memo: when every analyzed
    file's sha1 and the rule-set version match the cache, the previous
    verdict replays without parsing a single file (the warm path).
    ANY change re-runs the WHOLE analysis — the call graph is
    cross-module, so per-file verdict reuse would be unsound (a
    signature change in one file creates findings in another). A
    ``RULESET_VERSION`` bump invalidates every cached verdict even
    when no analyzed file changed."""
    if cache_path is None:
        return run(paths, root=root, rule_ids=rule_ids)
    files = collect_files(paths)
    root = root or _default_root(files)
    hashes = _hash_files(files, root)
    key_rules = sorted(rule_ids) if rule_ids is not None else None
    try:
        with open(cache_path) as f:
            cached = json.load(f)
    except (OSError, ValueError):
        cached = None
    if (isinstance(cached, dict)
            and cached.get("ruleset") == RULESET_VERSION
            and cached.get("rules") == key_rules
            and cached.get("hashes") == hashes):
        res = AnalysisResult(files=len(files), root=root)
        res.findings = [Finding(*v) for v in cached["findings"]]
        res.suppressed = [Finding(*v) for v in cached["suppressed"]]
        return res
    res = run(paths, root=root, rule_ids=rule_ids)
    payload = {
        "ruleset": RULESET_VERSION,
        "rules": key_rules,
        "hashes": hashes,
        "findings": [_finding_to_list(f) for f in res.findings],
        "suppressed": [_finding_to_list(f) for f in res.suppressed],
    }
    tmp = f"{cache_path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, cache_path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    return res


def changed_files(paths: List[str], ref: str,
                  root: Optional[str] = None) -> Optional[List[str]]:
    """The subset of ``collect_files(paths)`` that differs from git
    ``ref`` (tracked diffs plus untracked files). None when git is
    unavailable or ``ref`` does not resolve — callers fall back to a
    full run rather than silently analyzing nothing."""
    root = root or os.getcwd()
    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", "-z", ref, "--"],
            capture_output=True, text=True, cwd=root, timeout=60)
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard", "-z"],
            capture_output=True, text=True, cwd=root, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    if diff.returncode != 0 or untracked.returncode != 0:
        return None
    changed = {p for out in (diff.stdout, untracked.stdout)
               for p in out.split("\0") if p}
    aroot = os.path.abspath(root)
    out = []
    for p in collect_files(paths):
        rel = os.path.relpath(os.path.abspath(p), aroot)
        if rel in changed:
            out.append(p)
    return out


def _check_module(ctx: Context, module: ModuleInfo,
                  selected) -> List[Finding]:
    findings: List[Finding] = []
    if module.parse_error is not None:
        e = module.parse_error
        findings.append(Finding(
            "GEN001", module.path, getattr(e, "lineno", 1) or 1, 0,
            f"file does not parse: {e.msg if hasattr(e, 'msg') else e}",
            ""))
        return findings
    for spec in selected:
        findings.extend(spec.check(ctx, module))
    return findings


def list_rules() -> List[tuple]:
    """(rule_id, help) pairs, plus the GEN family the core owns."""
    out = [(rid, REGISTRY[rid].help) for rid in sorted(REGISTRY)]
    out.append(("GEN001", "file does not parse (syntax error)"))
    out.append(("GEN002",
                "suppression comment matched no finding (stale "
                "recorded decision; full runs only)"))
    return sorted(out)


# re-export for consumers that only import core
__all__ = [
    "AnalysisResult",
    "Finding",
    "cached_run",
    "changed_files",
    "collect_files",
    "fingerprint",
    "list_rules",
    "parse_suppressions",
    "run",
]
