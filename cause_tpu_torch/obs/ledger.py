"""The persistent perf ledger: every run artifact as an append-only,
platform-partitioned JSONL trajectory.

A copy of ``cause_tpu.obs.ledger`` with its own default file,
``measurements_torch/ledger.jsonl`` (not committed: listed in
``.gitignore``), so the port never appends to the JAX package's
committed ledger and none of that ledger's rows (TPU or CPU numbers)
are read as the port's. Rows carry their provenance (source artifact,
platform, kernel, config, schema version, devprof cost digest), and
the checker enforces two rules:

- **strict platform partitioning** — rows are only ever compared to
  rows with the *identical* ``platform`` string, so a card row
  (``gpu``) is never compared with a ``cpu`` or ``tpu`` row;
- **fallback quarantine** — fallback rows (and failed runs) are kept
  for the record but excluded from every baseline/regression
  comparison.

``check()`` computes the per-partition trajectory and a regression
verdict: *deterministic* cost metrics (obs counters, the devprof
digest: kernel launches per program) gate on every platform; *wall
time* gates only inside the card's own partitions (``gpu`` rows).
The reference's ``backfill()`` of its committed TPU artifacts is not
copied: those are not the port's numbers.

CLI (see ``python -m cause_tpu_torch.obs ledger --help``)::

    python -m cause_tpu_torch.obs ledger --ingest RUN.json --obs side.jsonl
    python -m cause_tpu_torch.obs ledger --check

Stdlib-only, like the rest of ``cause_tpu_torch.obs``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from .perfetto import load_jsonl, merged_final_counters

__all__ = [
    "LEDGER_SCHEMA",
    "default_path",
    "load",
    "append",
    "normalize_bench",
    "devprof_digest",
    "costmodel_row_digest",
    "ingest",
    "ingest_record",
    "check",
    "main",
]

LEDGER_SCHEMA = 1

# deterministic-metric tolerance: a real algorithmic regression moves
# these by integer factors; 5% is the reference's margin
DET_TOL = 0.05
# wall-time tolerance inside the card's own partitions: generous — a
# shared host and power-limit throttling jitter the wall, a >25% p50
# slide is not noise
WALL_TOL = 0.25
# the card's platform tag: its rows gate wall time and give the gap
# report its headline; never compared with another platform's rows
CHIP_PLATFORM = "gpu"
# the deterministic devprof metrics the checker compares: the kernel
# launches per program (the card cannot give XLA's flops or bytes)
DET_METRICS = ("launches", "flops", "bytes_accessed")


def default_path() -> str:
    """``CAUSE_TPU_LEDGER`` if set, else
    ``measurements_torch/ledger.jsonl`` next to the repo root (this
    module lives in cause_tpu_torch/obs/; the file is not committed)."""
    env = os.environ.get("CAUSE_TPU_LEDGER", "").strip()
    if env:
        return env
    root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "measurements_torch", "ledger.jsonl")


def load(path: Optional[str] = None) -> List[dict]:
    """All ledger rows, oldest first (torn/garbage lines skipped —
    same parser as the obs sidecars)."""
    path = path or default_path()
    if not os.path.exists(path):
        return []
    return load_jsonl(path)


def append(row: dict, path: Optional[str] = None) -> dict:
    """Append one row (O_APPEND single write, like the obs sink —
    concurrent writers interleave at line granularity)."""
    path = path or default_path()
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, (json.dumps(row, default=str) + "\n").encode())
    finally:
        os.close(fd)
    return row


def normalize_bench(artifact: dict, source: str = "") -> dict:
    """One bench artifact -> one ledger row.

    Accepts both a raw run's JSON line and a wrapper format
    (``{"n", "cmd", "rc", "tail", "parsed"}``); a wrapper whose ``parsed`` is null (the
    all-attempts-failed round) becomes a quarantined ``platform:
    "none"`` row so the trajectory records the failure without ever
    comparing against it."""
    rec = artifact
    if isinstance(artifact, dict) and "parsed" in artifact \
            and ("cmd" in artifact or "rc" in artifact):
        rec = artifact.get("parsed")
    if not isinstance(rec, dict):
        rec = {}
    platform = str(rec.get("platform", "") or "none")
    metric = str(rec.get("metric", "") or "")
    value = rec.get("value")
    fallback = bool(rec.get(
        "fallback", platform in ("cpu-fallback", "none")))
    row = {
        "schema": LEDGER_SCHEMA,
        "kind": "bench",
        "source": source,
        "ingested_us": time.time_ns() // 1000,
        "platform": platform,
        "fallback": fallback,
        "smoke": bool(rec.get("smoke", "[smoke size]" in metric)),
        "kernel": rec.get("kernel"),
        "config": rec.get("config"),
        "metric": metric,
        "value_ms": value,
        "single_dispatch_ms": rec.get("single_dispatch_ms"),
        "vs_target": rec.get("vs_target", rec.get("vs_baseline")),
        "artifact_schema_version": rec.get("schema_version"),
        # quarantined rows are recorded, never compared
        "quarantined": fallback or value is None,
    }
    if rec.get("checksum_deviation"):
        row["checksum_deviation"] = True
    if rec.get("error"):
        row["error"] = str(rec["error"])[:300]
    return row


def devprof_digest(obs_jsonl: str) -> dict:
    """The deterministic-metric digest of one run's obs sidecar: the
    summed devprof program costs plus each pid's LAST counter snapshot
    merged across pids (bench parent + abandoned children share one
    sidecar; see ``python -m cause_tpu_torch.obs --summary`` for the same
    per-pid rule)."""
    out: dict = {"devprof": {}, "counters": {}}
    if not obs_jsonl or not os.path.exists(obs_jsonl):
        return out
    events = load_jsonl(obs_jsonl)
    cost_sum: Dict[str, float] = {}
    n_programs = 0
    for e in events:
        if e.get("ev") == "event" and e.get("name") == "devprof.program":
            cost = (e.get("fields") or {}).get("cost") or {}
            n_programs += 1
            for k, v in cost.items():
                if isinstance(v, (int, float)):
                    cost_sum[k] = cost_sum.get(k, 0) + v
    if n_programs:
        cost_sum["programs"] = n_programs
        out["devprof"] = cost_sum
    out["counters"] = merged_final_counters(events)
    return out


def ingest_record(rec: dict, source: str = "", obs_jsonl: str = "",
                  path: Optional[str] = None,
                  kind: str = "bench",
                  extra: Optional[dict] = None) -> dict:
    """Append one already-parsed artifact record as a normalized row,
    with the sidecar's devprof/counter digest when an obs JSONL is
    given. The in-memory half of ``ingest()``, for a caller that holds
    its artifact line already parsed. ``extra`` merges additional
    row fields verbatim (the gap CLI's ``--kind gap`` summary rides
    here) without ever overriding the normalized provenance keys."""
    row = normalize_bench(rec, source=source)
    row["kind"] = kind
    if kind != "bench":
        # harvest/soak/gap artifacts carry no bench-shaped value_ms,
        # so the bench heuristic would quarantine every one of them
        # and the deterministic-metric gate would be silently inert
        # for the non-bench kinds — for those rows only a fallback
        # platform quarantines
        row["quarantined"] = bool(row["fallback"])
    if obs_jsonl:
        digest = devprof_digest(obs_jsonl)
        if digest.get("devprof"):
            row["devprof"] = digest["devprof"]
        if digest.get("counters"):
            row["counters"] = digest["counters"]
        cost = costmodel_row_digest(obs_jsonl)
        if cost:
            row["cost"] = cost
    if extra:
        for k, v in extra.items():
            row.setdefault(k, v)
    return append(row, path)


def costmodel_row_digest(obs_jsonl: str) -> dict:
    """The cost-model extension of a ledger row: the sidecar's
    ``wave.cost`` aggregate (waves, dispatches, delta ops, slope
    verdict — ``costmodel.costmodel_digest``). Empty when the stream
    carries no wave.cost events, so older ingests are unchanged."""
    if not obs_jsonl or not os.path.exists(obs_jsonl):
        return {}
    from .costmodel import costmodel_digest

    return costmodel_digest(load_jsonl(obs_jsonl))


def ingest(artifact_path: str, source: str = "",
           obs_jsonl: str = "", path: Optional[str] = None,
           kind: str = "bench") -> dict:
    """Parse a bench/harvest/soak artifact file (the LAST JSON line of
    the file — bench artifacts are often tee'd logs) and append the
    normalized row via ``ingest_record``."""
    rec = None
    with open(artifact_path) as f:
        text = f.read()
    try:
        rec = json.loads(text)
    except ValueError:
        for line in reversed(text.splitlines()):
            line = line.strip()
            if not line:
                continue
            try:
                parsed = json.loads(line)
            except ValueError:
                continue
            if isinstance(parsed, dict):
                rec = parsed
                break
    if not isinstance(rec, dict):
        raise ValueError(f"{artifact_path}: no JSON artifact found")
    return ingest_record(rec, source=source
                         or os.path.basename(artifact_path),
                         obs_jsonl=obs_jsonl, path=path, kind=kind)


# ------------------------------------------------------------- checker


def _partition_key(row: dict) -> Tuple:
    """The ONLY grouping rows are ever compared within: same kind
    (bench rows never gate against harvest/soak rows), identical
    platform string, same size class, same kernel, same config (the
    allstream/beststream A/B flips select different sort/gather
    algorithms — different flops, different wall time). Anything else
    is a different experiment."""
    return (row.get("kind") or "bench", row.get("platform"),
            bool(row.get("smoke")),
            row.get("kernel") or "?", row.get("config") or "default")


def check(path: Optional[str] = None,
          rows: Optional[List[dict]] = None) -> dict:
    """The trajectory + regression verdict. Returns::

        {"rows": N, "partitions": {...}, "regressions": [...],
         "ok": bool}

    Regression kinds: ``devprof`` (a ``DET_METRICS`` cost grew past
    DET_TOL vs the previous row that recorded it), ``counters``
    (``program_cache.miss`` grew), ``wall_time`` (a ``gpu`` p50 slid
    past WALL_TOL vs the partition's best). Quarantined rows never participate; rows are NEVER compared
    across different ``platform`` values."""
    rows = load(path) if rows is None else rows
    parts: Dict[Tuple, List[dict]] = {}
    quarantined = 0
    for r in rows:
        if r.get("quarantined"):
            quarantined += 1
            continue
        parts.setdefault(_partition_key(r), []).append(r)

    regressions: List[dict] = []
    partitions: Dict[str, dict] = {}
    for key, series in parts.items():
        kind, platform, smoke, kernel, config = key
        label = (f"{platform}|{'smoke' if smoke else 'full'}"
                 f"|{kernel}|{config}")
        if kind != "bench":
            label = f"{kind}|{label}"
        partitions[label] = {
            "rows": len(series),
            "trajectory": [
                {"source": r.get("source"), "value_ms": r.get("value_ms")}
                for r in series
            ],
        }
        if len(series) < 2:
            continue
        latest = series[-1]
        prev = series[:-1]

        def _regress(kind, metric, before, after, against):
            regressions.append({
                "kind": kind, "partition": label, "metric": metric,
                "before": before, "after": after,
                "against": against.get("source"),
                "source": latest.get("source"),
            })

        lat_dev = latest.get("devprof") or {}
        if lat_dev:
            for r in reversed(prev):
                ref = r.get("devprof") or {}
                if not ref:
                    continue
                for m in DET_METRICS:
                    b, a = ref.get(m), lat_dev.get(m)
                    if b and a and a > b * (1 + DET_TOL):
                        _regress("devprof", m, b, a, r)
                break
        lat_ctr = latest.get("counters") or {}
        if lat_ctr.get("program_cache.miss") is not None:
            for r in reversed(prev):
                ref = (r.get("counters") or {}).get("program_cache.miss")
                if ref is None:
                    continue
                if lat_ctr["program_cache.miss"] > ref:
                    _regress("counters", "program_cache.miss", ref,
                             lat_ctr["program_cache.miss"], r)
                break
        if platform == CHIP_PLATFORM and latest.get("value_ms"):
            best = [r for r in prev if r.get("value_ms")]
            if best:
                ref = min(best, key=lambda r: r["value_ms"])
                if latest["value_ms"] > ref["value_ms"] * (1 + WALL_TOL):
                    _regress("wall_time", "value_ms", ref["value_ms"],
                             latest["value_ms"], ref)

    return {
        "rows": len(rows),
        "quarantined": quarantined,
        "partitions": partitions,
        "regressions": regressions,
        "ok": not regressions,
    }


def pending(path: Optional[str] = None,
            rows: Optional[List[dict]] = None) -> dict:
    """The chip-pending claim matrix: every (kind, smoke, kernel,
    config) experiment that has rows but NO un-quarantined
    ``platform == "gpu"`` row — every claim the ledger is still owed
    card evidence for. Quarantined rows never claim."""
    rows = load(path) if rows is None else rows
    groups: Dict[Tuple, Dict] = {}
    for r in rows:
        if r.get("quarantined"):
            continue
        kind, platform, smoke, kernel, config = _partition_key(r)
        g = groups.setdefault((kind, smoke, kernel, config), {
            "platforms": {}, "latest_source": None})
        g["platforms"][platform] = \
            g["platforms"].get(platform, 0) + 1
        g["latest_source"] = r.get("source") or g["latest_source"]
    pend = []
    claimed = 0
    for (kind, smoke, kernel, config), g in sorted(
            groups.items(), key=lambda kv: [str(x) for x in kv[0]]):
        if any(str(p) == CHIP_PLATFORM for p in g["platforms"]):
            claimed += 1
            continue
        pend.append({
            "kind": kind, "smoke": smoke, "kernel": kernel,
            "config": config,
            "platforms": dict(sorted(g["platforms"].items(),
                                     key=lambda kv: str(kv[0]))),
            "latest_source": g["latest_source"],
        })
    return {"partitions": len(groups), "claimed": claimed,
            "pending": pend}


def render_pending(matrix: dict) -> str:
    lines = [f"chip-pending claim matrix: {len(matrix['pending'])} "
             f"pending / {matrix['partitions']} partition(s) "
             f"({matrix['claimed']} {CHIP_PLATFORM}-claimed)"]
    if not matrix["pending"]:
        lines.append(f"  (every partition has a {CHIP_PLATFORM} row — "
                     "nothing owed)")
        return "\n".join(lines)
    lines.append(f"  {'kind':<9s} {'size':<6s} {'kernel':<22s} "
                 f"{'config':<22s} evidence so far")
    for p in matrix["pending"]:
        ev = ", ".join(f"{plat}:{n}"
                       for plat, n in p["platforms"].items())
        lines.append(
            f"  {p['kind']:<9s} {'smoke' if p['smoke'] else 'full':<6s} "
            f"{p['kernel']:<22s} {p['config']:<22s} {ev}")
    return "\n".join(lines)


# ----------------------------------------------------------------- CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.obs ledger",
        description="Persistent platform-partitioned perf ledger: "
                    "ingest run artifacts, gate on regressions.")
    ap.add_argument("--ledger", default="",
                    help="ledger path (default: CAUSE_TPU_LEDGER or "
                         "measurements_torch/ledger.jsonl)")
    ap.add_argument("--ingest", default="",
                    help="bench artifact file to append (last JSON "
                         "line wins)")
    ap.add_argument("--obs", default="",
                    help="obs JSONL sidecar of the --ingest run "
                         "(devprof/counter digest lands in the row)")
    ap.add_argument("--source", default="",
                    help="source tag for --ingest rows")
    ap.add_argument("--kind", default="bench",
                    help="row kind for --ingest (bench/harvest/soak/"
                         "gap — gap rows carry a north-star summary "
                         "and gate like any non-bench kind: platform-"
                         "partitioned, quarantined only on fallback)")
    ap.add_argument("--check", action="store_true",
                    help="regression verdict; exit 1 on any regression")
    ap.add_argument("--pending", action="store_true",
                    help="render the chip-pending claim matrix: every "
                         "kind/config partition lacking an "
                         "un-quarantined gpu row")
    ap.add_argument("--json", action="store_true",
                    help="with --pending: emit the matrix as JSON")
    a = ap.parse_args(argv)
    path = a.ledger or None

    did_something = False
    if a.ingest:
        row = ingest(a.ingest, source=a.source, obs_jsonl=a.obs,
                     path=path, kind=a.kind)
        print(f"ledger: ingested {row['platform']} row from "
              f"{a.ingest}", file=sys.stderr)
        did_something = True
    if a.pending:
        matrix = pending(path)
        print(json.dumps(matrix, indent=1) if a.json
              else render_pending(matrix))
        did_something = True
    if a.check:
        verdict = check(path)
        print(json.dumps(verdict, indent=1))
        return 0 if verdict["ok"] else 1
    if not did_something:
        ap.print_help(sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
