"""``python -m cause_tpu_torch.analysis [paths...]`` — the causelint CLI.

Exit codes: 0 = clean (after suppressions and baseline), 1 = findings,
2 = usage error. Stdlib-only: it runs from a bare checkout, before
torch or numpy is installed.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import core, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.analysis",
        description=("causelint: trace-identity (TID), jit-purity "
                     "(JPH), obs-off invariance (OBS), lane-cache "
                     "aliasing (LCA), concurrency (LCK), durability "
                     "(DUR) and refusal-evidence (EVD) static "
                     "analysis"),
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze (default: "
                         "cause_tpu_torch/ chip_smoke.py where present)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--rules",
                    help="comma-separated rule ids to run "
                         "(default: all)")
    ap.add_argument("--baseline", metavar="FILE",
                    help="freeze findings recorded in FILE (see "
                         "--write-baseline); only NEW findings gate")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="record current findings into FILE and exit 0")
    ap.add_argument("--cache", metavar="FILE",
                    help="memoize the verdict keyed on file sha1s + "
                         "rule-set version; a warm hit replays the "
                         "result without parsing anything")
    ap.add_argument("--changed", metavar="GIT_REF",
                    help="report only findings in files that differ "
                         "from GIT_REF (tracked diffs + untracked); "
                         "exits 0 fast when nothing changed. The "
                         "whole program is still analyzed (the call "
                         "graph is cross-module) — combine with "
                         "--cache to make that cheap")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, help_text in core.list_rules():
            print(f"{rid}  {help_text}")
        return 0

    paths = args.paths
    if not paths:
        paths = [p for p in ("cause_tpu_torch", "chip_smoke.py")
                 if os.path.exists(p)]
        if not paths:
            print("causelint: no paths given and no default layout "
                  "found", file=sys.stderr)
            return 2
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        print(f"causelint: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2

    rule_ids = None
    if args.rules:
        rule_ids = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rule_ids
                   if r not in dict(core.list_rules())]
        if unknown:
            print(f"causelint: unknown rule(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2
        # GEN rules are the core's own and cannot be toggled; an
        # explicitly emptied selection still reports parse errors
        rule_ids = [r for r in rule_ids if not r.startswith("GEN")]

    # --changed narrows the REPORT, not the analysis: the call graph
    # is cross-module (a helper in an unchanged file can prove a
    # changed file's refusal path emits evidence), so analyzing only
    # the diff would both miss and invent findings. The whole program
    # is still analyzed — the cache makes that cheap — and findings
    # are then filtered to files that differ from the ref.
    changed_set = None
    if args.changed:
        subset = core.changed_files(paths, args.changed)
        if subset is None:
            print(f"causelint: cannot diff against {args.changed!r} "
                  "(not a git checkout, or the ref does not resolve); "
                  "running the full analysis", file=sys.stderr)
        elif not subset:
            print(f"causelint: no analyzed files changed vs "
                  f"{args.changed}")
            return 0
        else:
            changed_set = {os.path.abspath(p) for p in subset}

    result = core.cached_run(paths, rule_ids=rule_ids,
                             cache_path=args.cache)
    if changed_set is not None:
        result.findings = [f for f in result.findings
                           if os.path.abspath(f.path) in changed_set]
        result.suppressed = [f for f in result.suppressed
                             if os.path.abspath(f.path) in changed_set]

    if args.write_baseline:
        n = report.write_baseline(args.write_baseline, result)
        print(f"causelint: froze {n} finding(s) into "
              f"{args.write_baseline}")
        return 0

    baseline_filtered = 0
    if args.baseline:
        baseline_filtered = report.apply_baseline(
            result, report.load_baseline(args.baseline))

    if args.format == "json":
        import json

        print(json.dumps(report.to_json(result, baseline_filtered),
                         indent=2, sort_keys=True))
    else:
        print(report.render_text(result, baseline_filtered))
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
