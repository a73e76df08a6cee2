"""Journey reconstruction: clock-skew-corrected causal chains from
``xtrace`` hop streams, with per-hop SLO decomposition.

``xtrace`` (the write side) emits one ``xtrace.hop`` record per hop a
trace takes — mint → send → recv → admit → journal → tick → wave →
apply → converged — each from whatever process the hop ran in, into
that process's own obs sidecar. This module is the read side: feed it
the merged streams and it re-links the hops per trace, maps every
process's raw wall timestamps onto ONE timebase (the median of the
``xtrace.clock`` offset samples the hello/ping exchanges produced),
and answers the two questions the per-process layers cannot:

- **where did THIS op's time go?** — :func:`JourneyFold.journey`
  returns one trace's corrected, causally-ordered hop timeline with
  per-step deltas and orphan flags (a hop whose parent span never
  appears has lost evidence — the journey is incomplete, not merely
  slow);
- **where does the FLEET's p99 go?** — :func:`JourneyFold.report`
  folds every finished journey's step deltas into per-edge mergeable
  histograms (``mint→send``, ``send→recv`` — the wire edge —
  ``admit→journal``, ``tick→wave``, ``apply→converged``, ...), so the
  end-to-end SLO decomposes into the hop that actually owns the tail.

Clock correction: every ``xtrace.clock`` record is one NTP-style
half-RTT estimate of ``remote_clock - local_clock`` from an observer
pid to a remote pid. The fold takes the per-edge median (robust to the
odd delayed exchange), picks the most-observed remote pid as the
reference timebase (the server — every client measured an edge to it),
and shifts each observer pid's hop timestamps by its median offset.
Pids with no edge to the reference stay uncorrected (same-host
processes share a clock anyway); cross-host journeys without a clock
edge render, but their wire-edge deltas are labeled by the caller's
own skew.

Retention is tail-based: the live fold (``obs watch``) keeps full hop
detail only for the worst journeys by total latency (everything else
folds into the histograms and is dropped), bounded by
``exemplar_max``; the CLI constructs the fold with ``retain_all=True``
and keeps everything, so any trace id printed by ``obs lag`` can be
drilled into.

Read side only: works with obs OFF (analyzing someone else's
sidecars); stdlib only, no jax/numpy.

CLI::

    python -m cause_tpu_torch.obs journey <trace_id> a.jsonl b.jsonl ...
    python -m cause_tpu_torch.obs journey --worst 5 a.jsonl b.jsonl ...
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .lag import LagHistogram
from .xtrace import HOP_ORDER

__all__ = ["JourneyFold", "journey_report", "render_report",
           "render_journey", "main"]

# retained traces (retain_all mode; live mode evicts far earlier)
_TRACE_MAX = 8192
# hops kept per trace (a pathological retransmit storm stays bounded)
_TRACE_HOPS_MAX = 512
# clock offset samples kept per (pid, remote_pid) edge
_CLOCK_SAMPLES_MAX = 256
# finished-trace ids remembered so late hops don't resurrect a
# finalized journey (live mode)
_DONE_MAX = 8192

# terminal hop names: seeing one ends the journey (live finalization)
_TERMINAL = ("converged", "shed")

_HOP_RANK = {name: i for i, name in enumerate(HOP_ORDER)}


class JourneyFold:
    """Incremental journey reconstructor: feed obs records one at a
    time (`feed`), read per-trace timelines (`journey`), the worst
    offenders (`worst`) or the fleet-wide per-hop decomposition
    (`report`) at any point.

    ``retain_all=True`` (the CLI) keeps every trace's hops resident
    (bounded by ``_TRACE_MAX``); the default live mode finalizes a
    journey at its terminal hop (``converged``/``shed``), folds its
    step deltas into the histograms, and retains full hop detail only
    while it is among the ``exemplar_max`` worst by total latency —
    the tail-based exemplar rule."""

    __slots__ = ("retain_all", "slo_ms", "exemplar_max", "_traces",
                 "_clock", "_done", "_edge_hists", "_total_hist",
                 "_complete", "_shed", "_orphan_hops", "_finalized",
                 "_exemplars")

    def __init__(self, retain_all: bool = False,
                 slo_ms: Optional[float] = None,
                 exemplar_max: int = 8):
        self.retain_all = bool(retain_all)
        self.slo_ms = float(slo_ms) if slo_ms is not None else None
        self.exemplar_max = int(exemplar_max)
        # trace id -> {"hops": [raw hop dicts], "spans": set}
        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        # (pid, remote_pid) -> [offset_us samples]
        self._clock: Dict[Tuple[int, int], List[float]] = {}
        self._done: "OrderedDict[str, None]" = OrderedDict()
        # live-mode aggregates (retain_all computes these in report())
        self._edge_hists: Dict[str, LagHistogram] = {}
        self._total_hist = LagHistogram()
        self._complete = 0
        self._shed = 0
        self._orphan_hops = 0
        self._finalized = 0
        # finalized worst journeys kept in full: [(total_ms, journey)]
        self._exemplars: List[Tuple[float, dict]] = []

    # ---------------------------------------------------------- feed

    def feed(self, e: dict) -> None:
        """Consume one obs record (non-xtrace records are free)."""
        if e.get("ev") != "event":
            return
        name = e.get("name")
        if name == "xtrace.clock":
            f = e.get("fields") or {}
            off = f.get("offset_us")
            rpid = f.get("remote_pid")
            pid = e.get("pid")
            if isinstance(off, (int, float)) and isinstance(rpid, int) \
                    and isinstance(pid, int) and pid != rpid:
                xs = self._clock.setdefault((pid, rpid), [])
                xs.append(float(off))
                del xs[:-_CLOCK_SAMPLES_MAX]
            return
        if name != "xtrace.hop":
            return
        f = e.get("fields") or {}
        tid = f.get("trace")
        if not isinstance(tid, str) or not tid:
            return
        if not self.retain_all and tid in self._done:
            return
        entry = self._traces.pop(tid, None)
        if entry is None:
            entry = {"hops": [], "spans": set()}
        self._traces[tid] = entry
        hop = {
            "hop": str(f.get("hop") or "?"),
            "span": str(f.get("span") or ""),
            "parent": str(f.get("parent") or ""),
            "pid": e.get("pid") if isinstance(e.get("pid"), int) else 0,
            "ts_us": (int(e["ts_us"])
                      if isinstance(e.get("ts_us"), (int, float)) else 0),
            "attrs": {k: v for k, v in f.items()
                      if k not in ("trace", "span", "parent", "hop")},
        }
        if len(entry["hops"]) < _TRACE_HOPS_MAX:
            entry["hops"].append(hop)
            if hop["span"]:
                entry["spans"].add(hop["span"])
        if not self.retain_all and hop["hop"] in _TERMINAL:
            self._finalize_live(tid, entry)
        while len(self._traces) > _TRACE_MAX:
            old_tid, old = self._traces.popitem(last=False)
            if not self.retain_all:
                # evicted in flight: still fold what it has
                self._finalize_live(old_tid, old)

    def feed_many(self, events) -> None:
        for e in events:
            self.feed(e)

    # --------------------------------------------------------- clock

    def offsets(self) -> Tuple[Dict[int, float], Optional[int]]:
        """Per-pid correction (add to that pid's raw ``ts_us`` to land
        on the reference timebase) and the reference pid. The
        reference is the most-observed REMOTE pid — the server every
        client took clock samples against; with no samples at all,
        every pid stays uncorrected (one-process streams)."""
        med: Dict[Tuple[int, int], float] = {}
        for edge, xs in self._clock.items():
            med[edge] = sorted(xs)[len(xs) // 2]
        votes: Dict[int, int] = {}
        for (_pid, rpid), _off in med.items():
            votes[rpid] = votes.get(rpid, 0) + 1
        if not votes:
            return {}, None
        ref = max(votes, key=lambda r: (votes[r], -r))
        out: Dict[int, float] = {ref: 0.0}
        for (pid, rpid), off in med.items():
            # offset = remote - local, so local + offset = remote time
            if rpid == ref:
                out.setdefault(pid, off)
        for (pid, rpid), off in med.items():
            # the reverse edge: the ref measured SOMEONE ELSE's clock
            if pid == ref:
                out.setdefault(rpid, -off)
        return out, ref

    # ---------------------------------------------------- finalizing

    def _build(self, tid: str, entry: dict,
               offsets: Dict[int, float]) -> dict:
        """One trace's journey: corrected causally-ordered hops with
        per-step deltas, orphan flags, the per-edge decomposition and
        the mint→terminal total."""
        hops = []
        spans = entry["spans"]
        for h in entry["hops"]:
            corrected = h["ts_us"] + offsets.get(h["pid"], 0.0)
            hops.append(dict(h, ts_corrected_us=corrected,
                             orphan=bool(h["parent"]
                                         and h["parent"] not in spans)))
        # causal order: corrected time first; the hop vocabulary rank
        # breaks exact ties (one-process streams share a clock, so
        # same-microsecond mint/send pairs keep their causal order)
        hops.sort(key=lambda h: (h["ts_corrected_us"],
                                 _HOP_RANK.get(h["hop"], len(HOP_ORDER))))
        prev_ts = None
        for h in hops:
            h["dt_ms"] = (round((h["ts_corrected_us"] - prev_ts) / 1000.0, 3)
                          if prev_ts is not None else 0.0)
            prev_ts = h["ts_corrected_us"]
        orphans = sum(1 for h in hops if h["orphan"])
        # the decomposition edges: first corrected ts per hop name,
        # consecutive present names in vocabulary order
        first_ts: Dict[str, float] = {}
        for h in hops:
            first_ts.setdefault(h["hop"], h["ts_corrected_us"])
        # observed (corrected) order, vocabulary rank breaking exact
        # ties: the truthful chain — a local apply can land before the
        # wave-completion stamp, a remote apply after it
        names = sorted(first_ts,
                       key=lambda n: (first_ts[n],
                                      _HOP_RANK.get(n, len(HOP_ORDER))))
        edges: Dict[str, float] = {}
        for a, b in zip(names, names[1:]):
            edges[f"{a}→{b}"] = round(
                (first_ts[b] - first_ts[a]) / 1000.0, 3)
        terminal = None
        for h in reversed(hops):
            if h["hop"] in _TERMINAL:
                terminal = h["hop"]
                break
        total_ms = None
        if hops:
            if "mint" in first_ts and terminal == "converged":
                total_ms = round(
                    (first_ts["converged"] - first_ts["mint"]) / 1000.0, 3)
            else:
                total_ms = round((hops[-1]["ts_corrected_us"]
                                  - hops[0]["ts_corrected_us"]) / 1000.0, 3)
        return {
            "trace": tid,
            "hops": hops,
            "pids": sorted({h["pid"] for h in hops}),
            "orphans": orphans,
            "terminal": terminal,
            "complete": bool(terminal == "converged" and not orphans
                             and "mint" in first_ts),
            "total_ms": total_ms,
            "edges": edges,
        }

    def _fold_journey(self, j: dict) -> None:
        for edge, ms in j["edges"].items():
            self._edge_hists.setdefault(
                edge, LagHistogram()).record_us(ms * 1000.0)
        if j["terminal"] == "converged" and j["total_ms"] is not None:
            self._total_hist.record_us(j["total_ms"] * 1000.0)
        if j["complete"]:
            self._complete += 1
        if j["terminal"] == "shed":
            self._shed += 1
        self._orphan_hops += j["orphans"]
        self._finalized += 1

    def _finalize_live(self, tid: str, entry: dict) -> None:
        """Live-mode journey end: fold the aggregates, keep full hop
        detail only for the tail (worst-N over the SLO)."""
        offsets, _ref = self.offsets()
        j = self._build(tid, entry, offsets)
        self._fold_journey(j)
        self._traces.pop(tid, None)
        self._done[tid] = None
        while len(self._done) > _DONE_MAX:
            self._done.popitem(last=False)
        total = j["total_ms"] or 0.0
        if self.slo_ms is not None and total <= self.slo_ms \
                and not j["orphans"]:
            return  # inside SLO and evidence-complete: aggregate only
        self._exemplars.append((total, j))
        self._exemplars.sort(key=lambda p: -p[0])
        del self._exemplars[self.exemplar_max:]

    # ---------------------------------------------------------- read

    def journey(self, trace_id: str) -> Optional[dict]:
        """One trace's reconstructed journey (retained traces and
        live-mode exemplars), or None."""
        tid = str(trace_id)
        entry = self._traces.get(tid)
        if entry is not None:
            offsets, _ref = self.offsets()
            return self._build(tid, entry, offsets)
        for _total, j in self._exemplars:
            if j["trace"] == tid:
                return j
        return None

    def worst(self, n: int = 5) -> List[dict]:
        """The ``n`` worst journeys by total latency (terminal ones
        first — an in-flight trace's total is a lower bound)."""
        offsets, _ref = self.offsets()
        js = [self._build(tid, entry, offsets)
              for tid, entry in self._traces.items()]
        js.extend(j for _t, j in self._exemplars)
        js.sort(key=lambda j: -(j["total_ms"] or 0.0))
        return js[:max(0, int(n))]

    def report(self) -> dict:
        """The fleet-wide journey report: counts, clock edges, the
        total distribution and the per-edge decomposition (sorted by
        total time owned — the hop that owns the p99 leads)."""
        offsets, ref = self.offsets()
        if self.retain_all:
            edge_hists: Dict[str, LagHistogram] = {}
            total_hist = LagHistogram()
            complete = shed = orphan_hops = finalized = inflight = 0
            for tid, entry in self._traces.items():
                j = self._build(tid, entry, offsets)
                for edge, ms in j["edges"].items():
                    edge_hists.setdefault(
                        edge, LagHistogram()).record_us(ms * 1000.0)
                if j["terminal"] == "converged" \
                        and j["total_ms"] is not None:
                    total_hist.record_us(j["total_ms"] * 1000.0)
                if j["terminal"] is None:
                    inflight += 1
                else:
                    finalized += 1
                if j["complete"]:
                    complete += 1
                if j["terminal"] == "shed":
                    shed += 1
                orphan_hops += j["orphans"]
        else:
            edge_hists = self._edge_hists
            total_hist = self._total_hist
            complete, shed = self._complete, self._shed
            orphan_hops = self._orphan_hops
            finalized = self._finalized
            inflight = len(self._traces)

        def dist(h: LagHistogram) -> dict:
            return {
                "count": h.count,
                "p50_ms": h.quantile_ms(0.50),
                "p95_ms": h.quantile_ms(0.95),
                "p99_ms": h.quantile_ms(0.99),
                "mean_ms": h.mean_ms(),
                "max_ms": (round(h.max_us / 1000.0, 4)
                           if h.max_us is not None else None),
            }

        def edge_rank(item):
            name = item[0].split("→", 1)[0]
            return _HOP_RANK.get(name, len(HOP_ORDER))

        edges = [dict(edge=name, total_ms=round(h.sum_us / 1000.0, 3),
                      **dist(h))
                 for name, h in sorted(edge_hists.items(),
                                       key=edge_rank)]
        clock_edges = []
        for (pid, rpid), xs in sorted(self._clock.items()):
            clock_edges.append({
                "pid": pid, "remote_pid": rpid, "samples": len(xs),
                "offset_us": round(sorted(xs)[len(xs) // 2], 1),
            })
        return {
            "traces": finalized + inflight,
            "finalized": finalized,
            "complete": complete,
            "shed": shed,
            "inflight": inflight,
            "orphan_hops": orphan_hops,
            "clock": {"ref_pid": ref, "edges": clock_edges},
            "total": dist(total_hist),
            "edges": edges,
        }

    def summary(self) -> dict:
        """The compact live-dashboard section (``obs watch``): scalar
        axes only, plus the worst exemplar's trace id — the drill-down
        handle the full CLI accepts."""
        rep = self.report()
        worst = self._exemplars[0] if self._exemplars else None
        return {
            "active": bool(rep["traces"] or self._clock),
            "traces": rep["traces"],
            "complete": rep["complete"],
            "shed": rep["shed"],
            "inflight": rep["inflight"],
            "orphan_hops": rep["orphan_hops"],
            "total_p50_ms": rep["total"]["p50_ms"],
            "total_p99_ms": rep["total"]["p99_ms"],
            "worst_trace": worst[1]["trace"] if worst else None,
            "worst_total_ms": worst[0] if worst else None,
            "clock_edges": len(rep["clock"]["edges"]),
        }


def journey_report(events, slo_ms: Optional[float] = None) -> dict:
    """Batch form: the whole (merged) stream in, the journey report
    out — :class:`JourneyFold` fed once, ``retain_all`` semantics."""
    fold = JourneyFold(retain_all=True, slo_ms=slo_ms)
    fold.feed_many(events)
    return fold.report()


# ---------------------------------------------------------- rendering


def render_journey(j: dict) -> str:
    """One trace's human timeline."""
    head = (f"trace {j['trace']}: "
            + (f"{j['total_ms']:g} ms" if j["total_ms"] is not None
               else "in flight")
            + f", {len(j['hops'])} hop(s) across "
            f"{len(j['pids'])} process(es)")
    if j["terminal"]:
        head += f", terminal={j['terminal']}"
    if j["orphans"]:
        head += f", {j['orphans']} ORPHAN hop(s)"
    lines = [head]
    t0 = j["hops"][0]["ts_corrected_us"] if j["hops"] else 0.0
    for h in j["hops"]:
        at = (h["ts_corrected_us"] - t0) / 1000.0
        attrs = " ".join(f"{k}={v}" for k, v in sorted(h["attrs"].items()))
        lines.append(
            f"  +{at:9.3f} ms  {h['hop']:<9s} pid {h['pid']}"
            + (f"  [ORPHAN parent={h['parent']}]" if h["orphan"] else "")
            + (f"  {attrs}" if attrs else ""))
    if j["edges"]:
        steps = "  ".join(f"{e} {ms:g}ms"
                          for e, ms in j["edges"].items())
        lines.append(f"  decomposition: {steps}")
    return "\n".join(lines)


def render_report(report: dict) -> str:
    """The fleet-wide journey block."""
    lines = [
        f"journeys: {report['traces']} trace(s) — "
        f"{report['complete']} complete, {report['shed']} shed, "
        f"{report['inflight']} in flight, "
        f"{report['orphan_hops']} orphan hop(s)",
    ]
    t = report["total"]
    if t["count"]:
        lines.append(
            f"  mint→converged: p50 {t['p50_ms']:g} ms  "
            f"p95 {t['p95_ms']:g}  p99 {t['p99_ms']:g}  "
            f"max {t['max_ms']:g}  (n={t['count']})")
    ck = report["clock"]
    if ck["edges"]:
        parts = ", ".join(
            f"{c['pid']}→{c['remote_pid']}: {c['offset_us']:+g} us "
            f"(n={c['samples']})" for c in ck["edges"][:6])
        lines.append(f"  clock (ref pid {ck['ref_pid']}): {parts}"
                     + (f", ... {len(ck['edges']) - 6} more"
                        if len(ck["edges"]) > 6 else ""))
    if report["edges"]:
        lines.append("  per-hop decomposition (time owned):")
        ranked = sorted(report["edges"], key=lambda e: -e["total_ms"])
        for e in report["edges"]:
            mark = " ◀" if ranked and e is ranked[0] else ""
            lines.append(
                f"    {e['edge']:<20s} p50 {e['p50_ms']:g} ms  "
                f"p95 {e['p95_ms']:g}  max {e['max_ms']:g}  "
                f"(n={e['count']}, Σ {e['total_ms']:g} ms){mark}")
    return "\n".join(lines)


# ----------------------------------------------------------------- CLI


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import re
    import sys

    from .perfetto import load_streams

    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.obs journey",
        description="Reconstruct cross-process op journeys from obs "
                    "JSONL stream(s): clock-skew-corrected causal hop "
                    "timelines per trace id, worst offenders, and the "
                    "fleet-wide per-hop latency decomposition. "
                    "Multiple streams (one per process) merge.")
    ap.add_argument("trace", nargs="?", default=None,
                    help="a trace id (as printed by `obs lag` / "
                         "op.lag records); omit with --worst")
    ap.add_argument("jsonl", nargs="*",
                    help="obs event file(s) (JSON lines)")
    ap.add_argument("--file", action="append", default=None,
                    metavar="PATH", dest="files",
                    help="obs event file (repeatable; unambiguous "
                         "alternative to the positional file list — "
                         "a positional that is both 16-hex and an "
                         "existing path always means the trace id)")
    ap.add_argument("--worst", type=int, default=None, metavar="N",
                    help="show the N worst journeys by total latency "
                         "instead of one trace id")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="journey SLO in ms (annotates the report)")
    ap.add_argument("--json", action="store_true",
                    help="emit JSON instead of text")
    a = ap.parse_args(argv)

    files = list(a.files or []) + list(a.jsonl)
    trace = a.trace
    # `journey --worst 5 a.jsonl b.jsonl`: the first file lands in the
    # optional trace slot. A bare 16-hex token is ALWAYS a trace id —
    # an unlucky file named like one (`ls > deadbeef...`)
    # silently won the os.path.exists tiebreak and was read as a
    # stream; now only a non-id-shaped existing path demotes to the
    # file list (--file skips the heuristic entirely).
    if trace is not None and not re.fullmatch(r"[0-9a-f]{16}", trace) \
            and os.path.exists(trace):
        files.insert(0, trace)
        trace = None
    if not files:
        ap.error("no obs stream files given")
    for path in files:
        if not os.path.exists(path):
            print(f"journey: no such file: {path}", file=sys.stderr)
            return 2
    if trace is None and a.worst is None:
        a.worst = 5

    fold = JourneyFold(retain_all=True, slo_ms=a.slo_ms)
    fold.feed_many(load_streams(files))

    if trace is not None:
        j = fold.journey(trace)
        if j is None:
            print(f"journey: trace {trace} not found in "
                  f"{len(files)} stream(s)", file=sys.stderr)
            return 1
        print(json.dumps(j, indent=1) if a.json else render_journey(j))
        return 0

    report = fold.report()
    worst = fold.worst(a.worst)
    if a.json:
        print(json.dumps({"report": report, "worst": worst}, indent=1))
        return 0
    print(render_report(report))
    if worst:
        print(f"\nworst {len(worst)} journey(s):")
        for j in worst:
            print(render_journey(j))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
