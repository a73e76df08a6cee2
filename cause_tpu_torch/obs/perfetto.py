"""Chrome-trace/Perfetto export of obs event streams.

Converts the JSONL event schema of ``cause_tpu_torch.obs.core`` into the
Chrome Trace Event JSON format that https://ui.perfetto.dev (and
chrome://tracing) open directly:

- ``span`` events become complete ("ph": "X") slices on a
  per-process/per-thread track, with the span attributes AND the
  ``TRACE_SWITCHES`` program-identity snapshot as args;
- ``event`` records become instant events ("ph": "i", thread scope);
  events in the CRDT-semantic vocabulary (``semantic.
  SEMANTIC_EVENT_PREFIXES`` — ``sync.*``, ``wave.digest``,
  ``divergence``, ``gc.*``, ``collection.*``, ``fleet.*``) are routed
  onto their own NAMED instant-event track per family (a synthetic
  tid with ``thread_name`` metadata), so fleet health reads as
  labelled swim-lanes above the span tracks instead of dots buried in
  whichever thread happened to emit them;
- ``counters`` snapshots become one counter track per metric
  ("ph": "C"), so program-cache hit/miss rates and fallback counts
  plot as time series next to the spans they explain;
- ``gauge`` records (every ``obs.gauge(...).set()``) become counter
  -track samples too, at set-time resolution — devprof's live-array
  and device-memory gauges render as curves, not flush-time steps.

Stdlib-only, like the rest of ``cause_tpu_torch.obs``.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional

__all__ = ["to_chrome_trace", "export_perfetto", "load_jsonl",
           "load_streams", "CountersReducer", "merged_final_counters"]

# synthetic-tid base for the named semantic tracks: far above any real
# OS thread id's low bits mattering for display, stable across runs so
# diffs of exported traces stay comparable
_SEMANTIC_TID_BASE = 0x5EA00000


def _semantic_family(name: str) -> Optional[str]:
    """The semantic track family of an instant event's name, or None
    for ordinary (thread-track) events."""
    from .semantic import SEMANTIC_EVENT_PREFIXES

    for prefix in SEMANTIC_EVENT_PREFIXES:
        if name == prefix or name.startswith(prefix):
            return prefix.rstrip(".")
    return None


def load_jsonl(path: str) -> List[dict]:
    """Parse an obs JSONL file (skipping any torn/garbage lines — an
    abandoned writer may have lost the race with process death)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict):
                out.append(obj)
    return out


def load_streams(paths: Iterable[str]) -> List[dict]:
    """Load one or more obs JSONL streams as ONE event list — the one
    multi-stream merge rule the ``fleet`` and ``lag`` CLIs share.
    Multiple streams merge by record timestamp (stable sort:
    same-timestamp records keep their per-file order), so
    per-document "last wave" state and cumulative per-pid records
    aggregate correctly across a multi-process soak's sidecars; a
    single stream is returned in file order, untouched."""
    paths = list(paths)
    events: List[dict] = []
    for p in paths:
        events.extend(load_jsonl(p))
    if len(paths) > 1:
        events.sort(key=lambda e: e.get("ts_us") or 0)
    return events


class CountersReducer:
    """Incremental form of :func:`merged_final_counters`: feed obs
    records one at a time (a live tail), read the merged totals at any
    point. Counter snapshots are cumulative PER PROCESS, so the state
    is each pid's LAST snapshot; :meth:`totals` sums across pids in
    first-seen-pid order — the identical fold the batch function runs,
    so the two are bit-equal on the same stream."""

    __slots__ = ("_per_pid", "include_gauges")

    def __init__(self, include_gauges: bool = False):
        self._per_pid: dict = {}
        self.include_gauges = include_gauges

    def feed(self, e: dict) -> None:
        if e.get("ev") != "counters":
            return
        merged = dict(e.get("counters") or {})
        if self.include_gauges:
            merged.update(e.get("gauges") or {})
        self._per_pid[e.get("pid", 0)] = merged

    def totals(self) -> dict:
        out: dict = {}
        for snap in self._per_pid.values():
            for name, value in snap.items():
                out[name] = out.get(name, 0) + value
        return out


def merged_final_counters(events: Iterable[dict],
                          include_gauges: bool = False) -> dict:
    """The stream's final counter values: counter snapshots are
    cumulative PER PROCESS, so keep each pid's LAST snapshot and sum
    across pids (a shared sidecar interleaves parent + abandoned-child
    flushes — last-wins across pids would report whichever process
    flushed last). The one merge rule shared by ``--summary``, the
    ledger's devprof digest and the live fold (which runs the same
    body incrementally via :class:`CountersReducer`)."""
    r = CountersReducer(include_gauges=include_gauges)
    for e in events:
        r.feed(e)
    return r.totals()


def _args_of(e: dict) -> dict:
    args = {}
    for k, v in (e.get("attrs") or {}).items():
        args[k] = v
    for k, v in (e.get("switches") or {}).items():
        args[k] = v
    if e.get("platform"):
        args["platform"] = e["platform"]
    return args


def to_chrome_trace(events: Iterable[dict]) -> dict:
    """The Chrome Trace Event envelope for an obs event stream."""
    trace: List[dict] = []
    pids = set()
    # (pid, family) -> synthetic tid for the named semantic tracks;
    # allocation order is first-seen, names come from thread_name
    # metadata emitted at the end
    semantic_tids: dict = {}
    for e in events:
        ev = e.get("ev")
        pid = e.get("pid", 0)
        pids.add(pid)
        if ev == "span":
            trace.append({
                "name": e.get("name", "?"),
                "cat": "obs",
                "ph": "X",
                "ts": e.get("ts_us", 0),
                "dur": max(1, e.get("dur_us", 1)),
                "pid": pid,
                "tid": e.get("tid", 0),
                "args": _args_of(e),
            })
        elif ev == "event":
            args = dict(e.get("fields") or {})
            if e.get("platform"):
                args.setdefault("platform", e["platform"])
            name = e.get("name", "?")
            family = _semantic_family(name)
            if family is not None:
                tid = semantic_tids.setdefault(
                    (pid, family),
                    _SEMANTIC_TID_BASE + len(semantic_tids))
            else:
                tid = e.get("tid", 0)
            trace.append({
                "name": name,
                "cat": "obs.semantic" if family is not None else "obs",
                "ph": "i",
                "s": "t",
                "ts": e.get("ts_us", 0),
                "pid": pid,
                "tid": tid,
                "args": args,
            })
        elif ev == "gauge":
            trace.append({
                "name": e.get("name", "?"),
                "cat": "obs",
                "ph": "C",
                "ts": e.get("ts_us", 0),
                "pid": pid,
                "args": {"value": e.get("value", 0)},
            })
        elif ev == "counters":
            ts = e.get("ts_us", 0)
            merged = dict(e.get("counters") or {})
            merged.update(e.get("gauges") or {})
            for name, value in sorted(merged.items()):
                trace.append({
                    "name": name,
                    "cat": "obs",
                    "ph": "C",
                    "ts": ts,
                    "pid": pid,
                    "args": {"value": value},
                })
    for pid in sorted(pids):
        trace.append({
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": f"cause_tpu pid {pid}"},
        })
    for (pid, family), tid in sorted(semantic_tids.items(),
                                     key=lambda kv: kv[1]):
        trace.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": f"semantic:{family}"},
        })
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def export_perfetto(path: str, events: Optional[Iterable[dict]] = None,
                    jsonl: Optional[str] = None) -> int:
    """Write a Perfetto-openable trace JSON to ``path`` from either an
    in-memory event list, a JSONL file, or (default) the live ring
    buffer. Returns the number of trace events written."""
    if events is None:
        if jsonl is not None:
            events = load_jsonl(jsonl)
        else:
            from .core import events as _ring

            events = _ring()
    doc = to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])
