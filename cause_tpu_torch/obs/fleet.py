"""Fleet health from an obs event stream: ``python -m cause_tpu_torch.obs
fleet events.jsonl``.

The read side of ``cause_tpu_torch.obs.semantic``: given any obs JSONL (a
soak sidecar, a CI fleet smoke, a 600k-round overnight run), aggregate
the CRDT-semantic vocabulary into one operator-facing report —

- **fleet shape** — documents observed, replica pairs (and replicas:
  a pair is two replicas), waves run;
- **convergence** — the staleness histogram of the LAST wave per
  document (how many pairs are 0, 1, 2... waves behind the fleet's
  modal digest) and every ``divergence`` incident with its
  first-differing-site provenance;
- **degradation rates** — delta-sync rounds vs full-bag fallbacks,
  wave pairs vs host-merge fallbacks vs overflow retries, session
  token-budget overflows;
- **GC** — compaction runs, nodes examined/reclaimed, safety-valve
  declines;
- **collections** — lazy-weave materializations and the last
  tombstone ratio;
- **convergence lag** — the ``obs.lag`` tracer's summary (ops
  converged, create→converged p50/p99, SLO verdict) when the stream
  carries ``lag.window`` records; the full distribution and the
  per-replica worst offenders render through
  ``python -m cause_tpu_torch.obs lag``.

Multiple JSONL streams (a multi-process soak's per-process sidecars)
merge by timestamp before aggregation, so "the last wave per
document" is well-defined across processes. Counters are merged with
the shared per-pid last-snapshot rule
(``perfetto.merged_final_counters``), so a sidecar shared by a parent
and an abandoned child reports the sum, not whichever flushed last.
Stdlib-only, importable without jax, like the rest of ``cause_tpu_torch.obs``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

from .lag import LagReducer
from .perfetto import CountersReducer, load_streams

__all__ = ["FleetReducer", "fleet_report", "render", "load_streams",
           "main"]


def _rate(part: float, whole: float) -> float:
    return round(part / whole, 4) if whole else 0.0


class FleetReducer:
    """Incremental form of :func:`fleet_report`: feed obs records one
    at a time (a live tail, an in-process subscriber queue) and render
    the fleet-health report at any point. ``fleet_report`` is this
    reducer fed with the whole stream — one shared body, bit-equal by
    construction (the ``obs.live`` acceptance property).

    State is bounded by fleet shape, not stream length: one last-wave
    record per document (the semantic monitor's own LRU rule bounds
    distinct documents at the write side), one counter snapshot per
    pid, one lag record per (pid, epoch) — plus the divergence
    incident list, bounded at ``incidents_max`` (drops are counted,
    never silent; a healthy fleet mints zero incidents)."""

    __slots__ = ("records", "_last_wave", "_waves", "_incidents",
                 "incidents_dropped", "incidents_max", "_counters",
                 "lag")

    def __init__(self, incidents_max: int = 10000):
        self.records = 0
        self._last_wave: Dict[str, dict] = {}
        self._waves = 0
        self._incidents: List[dict] = []
        self.incidents_dropped = 0
        self.incidents_max = int(incidents_max)
        self._counters = CountersReducer()
        self.lag = LagReducer()

    def feed_counters(self, e: dict) -> None:
        """Overlay a counters snapshot WITHOUT counting it as a
        stream record — the in-process live attachment samples the
        counter registry directly (counters only reach the stream at
        flush), and that overlay must not make the fold's record
        count disagree with the sidecar it mirrors."""
        self._counters.feed(e)

    def feed(self, e: dict) -> None:
        """Consume one obs record (spans and foreign events are
        counted but otherwise free)."""
        self.records += 1
        self._counters.feed(e)
        self.lag.feed(e)
        if e.get("ev") != "event":
            return
        name = e.get("name")
        if name == "wave.digest":
            f = e.get("fields") or {}
            # the LAST wave per DOCUMENT (stream order, regardless of
            # wave/session source) is its current state — a doc
            # observed by both merge_wave and a FleetSession is still
            # ONE doc, and summing per-source histograms would double
            # -count its pairs and report agreed_documents > documents
            self._last_wave[str(f.get("uuid"))] = f
            self._waves += 1
        elif name == "divergence":
            f = e.get("fields") or {}
            if len(self._incidents) >= self.incidents_max:
                self.incidents_dropped += 1
                return
            self._incidents.append({
                "uuid": f.get("uuid"), "source": f.get("source"),
                "wave": f.get("wave"), "pair": f.get("pair"),
                "site": f.get("site"),
                "site_expected": f.get("site_expected"),
                "site_got": f.get("site_got"),
                "disagreeing": f.get("disagreeing"),
            })

    def report(self) -> dict:
        """The fleet-health dict (see :func:`fleet_report`)."""
        counters = self._counters.totals()
        staleness: Dict[str, int] = {}
        pairs = 0
        agreed_now = 0
        for f in self._last_wave.values():
            pairs = max(pairs, int(f.get("pairs") or 0))
            if f.get("agreed"):
                agreed_now += 1
            for bucket, n in (f.get("staleness") or {}).items():
                staleness[str(bucket)] = staleness.get(str(bucket), 0) + n

        delta_rounds = counters.get("sync.delta_rounds", 0)
        full_bag = counters.get("sync.full_bag", 0)
        wave_pairs = counters.get("wave.pairs", 0)
        fallback = counters.get("wave.fallback", 0)
        poisoned = counters.get("wave.poisoned", 0)
        overflow = counters.get("wave.overflow_retry", 0)
        examined = counters.get("gc.nodes_examined", 0)
        reclaimed = counters.get("gc.nodes_reclaimed", 0)
        rejects = counters.get("sync.reject", 0)
        quarantines = counters.get("sync.quarantine", 0)
        readmits = counters.get("sync.readmit", 0)
        rec_steps = counters.get("recovery.steps", 0)

        out = {
            "events": self.records,
            "documents": len(self._last_wave),
            "waves": self._waves,
            "pairs": pairs,
            "replicas": 2 * pairs,
            "agreed_documents": agreed_now,
            "staleness": dict(sorted(staleness.items(),
                                     key=lambda kv: int(kv[0]))),
            "divergence_incidents": list(self._incidents),
            "sync": {
                "delta_rounds": delta_rounds,
                "delta_nodes": counters.get("sync.delta_nodes", 0),
                "full_bag": full_bag,
                "full_bag_rate": _rate(full_bag,
                                       delta_rounds + full_bag),
                # validate-before-apply rejects and the replica
                # quarantine they escalate to (quarantined = entries
                # minus re-admissions — the CURRENT quarantine count)
                "rejects": rejects,
                "quarantines": quarantines,
                "readmits": readmits,
                "quarantined": max(0, quarantines - readmits),
            },
            "wave": {
                "pairs": wave_pairs,
                "fallback": fallback,
                "fallback_rate": _rate(fallback, wave_pairs),
                "poisoned": poisoned,
                "overflow_retries": overflow,
                "session_overflow":
                    counters.get("fleet.session_overflow", 0),
            },
            # the recovery ladder's evidence — every declared
            # delta->full->double_budget->host transition, retries of
            # transient dispatch failures, checkpoint restores, and
            # the storm axis (steps per wave) the live alert reads
            "recovery": {
                "steps": rec_steps,
                "by_step": {
                    step: counters[f"recovery.step.{step}"]
                    for step in ("full", "double_budget", "host")
                    if counters.get(f"recovery.step.{step}")
                },
                "retries": counters.get("recovery.retry", 0),
                "exhausted": counters.get("recovery.exhausted", 0),
                "restores": counters.get("recovery.restores", 0),
                "chaos_injected": sum(
                    v for k, v in counters.items()
                    if k.startswith("chaos.injected.")),
                "per_wave": _rate(rec_steps, self._waves),
            },
            "gc": {
                "runs": counters.get("gc.runs", 0),
                "nodes_examined": examined,
                "nodes_reclaimed": reclaimed,
                "reclaim_rate": _rate(reclaimed, examined),
                "safety_valve": counters.get("gc.safety_valve", 0),
            },
            "collections": {
                "lazy_materializations":
                    counters.get("collection.lazy_materialize", 0),
            },
            "lag": self._lag_section(),
        }
        if self.incidents_dropped:
            out["divergence_incidents_dropped"] = self.incidents_dropped
        return out

    def _lag_section(self) -> dict:
        """The compact convergence-lag block of the fleet report (the
        full distribution lives in ``python -m cause_tpu_torch.obs lag``)."""
        rep = self.lag.report()
        conv = rep["converged"]
        return {
            "ops_converged": rep["ops_converged"],
            "pending": rep["pending"],
            "p50_ms": conv["p50_ms"],
            "p99_ms": conv["p99_ms"],
            "slo": rep["slo"],
        }


def fleet_report(events: List[dict]) -> dict:
    """Aggregate one obs event stream into the fleet-health dict the
    CLI renders (see module docstring for the sections). Total: the
    report is well-defined on an EMPTY stream — every section zeroes
    out — because an operator's first question to a broken run is
    "did anything record at all?". The batch form of
    :class:`FleetReducer` — one shared body, so the live fold cannot
    drift from this report."""
    r = FleetReducer()
    for e in events:
        r.feed(e)
    return r.report()


def render(report: dict) -> str:
    """The human layout of ``fleet_report`` — one glanceable block."""
    lines = [
        f"fleet: {report['replicas']} replicas "
        f"({report['pairs']} pairs, {report['documents']} document(s)), "
        f"{report['waves']} wave(s), {report['events']} events",
        f"  converged now: {report['agreed_documents']}"
        f"/{report['documents']} document(s)",
    ]
    if report["staleness"]:
        hist = "  ".join(f"{k} wave(s) behind: {v} pair(s)"
                         for k, v in report["staleness"].items())
        lines.append(f"  staleness: {hist}")
    else:
        lines.append("  staleness: no wave digests recorded")
    inc = report["divergence_incidents"]
    lines.append(f"  divergence incidents: {len(inc)}")
    for d in inc[:10]:
        lines.append(
            f"    wave {d['wave']} pair {d['pair']}: first differing "
            f"site {d['site']!r} (expected {d['site_expected']}, got "
            f"{d['site_got']}; {d['disagreeing']} pair(s) disagree)")
    if len(inc) > 10:
        lines.append(f"    ... {len(inc) - 10} more")
    s = report["sync"]
    lines.append(
        f"  sync: {s['delta_rounds']} delta round(s) "
        f"({s['delta_nodes']} nodes), {s['full_bag']} full-bag "
        f"fallback(s) ({100 * s['full_bag_rate']:.1f}%)")
    if s.get("rejects") or s.get("quarantines"):
        lines.append(
            f"  ingest: {s['rejects']} payload reject(s), "
            f"{s['quarantines']} quarantine(s), {s['readmits']} "
            f"readmission(s) ({s['quarantined']} replica(s) "
            f"quarantined now)")
    w = report["wave"]
    lines.append(
        f"  waves: {w['pairs']} pair-merges, {w['fallback']} host "
        f"fallback(s) ({100 * w['fallback_rate']:.1f}%), "
        f"{w['poisoned']} poisoned, {w['overflow_retries']} overflow "
        f"retrie(s), {w['session_overflow']} session overflow(s)")
    rec = report.get("recovery") or {}
    if rec.get("steps") or rec.get("retries") or rec.get("restores") \
            or rec.get("chaos_injected"):
        by = ", ".join(f"{k}: {v}" for k, v in
                       (rec.get("by_step") or {}).items())
        lines.append(
            f"  recovery: {rec['steps']} ladder step(s)"
            + (f" ({by})" if by else "")
            + f", {rec['retries']} retrie(s), "
              f"{rec['restores']} restore(s), "
              f"{rec['chaos_injected']} chaos fault(s) injected "
              f"({rec['per_wave']:.2f} step(s)/wave)")
    g = report["gc"]
    lines.append(
        f"  gc: {g['runs']} run(s), {g['nodes_examined']} examined, "
        f"{g['nodes_reclaimed']} reclaimed "
        f"({100 * g['reclaim_rate']:.1f}%), {g['safety_valve']} "
        f"safety-valve decline(s)")
    lines.append(
        f"  collections: "
        f"{report['collections']['lazy_materializations']} lazy "
        f"materialization(s)")
    lag = report.get("lag") or {}
    slo = lag.get("slo") or {}
    if lag.get("ops_converged"):
        lines.append(
            f"  lag: {lag['ops_converged']} op(s) converged "
            f"(p50 {lag['p50_ms']:g} ms, p99 {lag['p99_ms']:g} ms, "
            f"{lag['pending']} pending), SLO {slo['target_ms']:g} ms "
            f"-> {slo['verdict']}")
    elif lag.get("pending"):
        # zero converged with ops pending is a STUCK fleet, not an
        # untraced one — the distinction an operator pages on
        lines.append(
            f"  lag: 0 ops converged, {lag['pending']} PENDING "
            f"(no wave reached fleet-wide digest agreement)")
    else:
        lines.append("  lag: no convergence-lag records")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.obs fleet",
        description="Render fleet health (replicas, staleness, "
                    "divergence incidents, overflow/fallback/GC rates, "
                    "convergence-lag summary) from one or more obs "
                    "JSONL event streams (multiple streams — a multi-"
                    "process soak's sidecars — merge by timestamp).")
    ap.add_argument("jsonl", nargs="+",
                    help="obs event file(s) (JSON lines)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    a = ap.parse_args(argv)
    for path in a.jsonl:
        if not os.path.exists(path):
            print(f"fleet: no such file: {path}", file=sys.stderr)
            return 2
    report = fleet_report(load_streams(a.jsonl))
    if a.json:
        print(json.dumps(report, indent=1))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
