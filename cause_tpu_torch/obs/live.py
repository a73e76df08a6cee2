"""Live telemetry: streaming aggregation + alert rules over obs
streams AS THEY ARE PRODUCED.

The other obs layers are post-hoc: JSONL sidecars analyzed after the
run by ``obs fleet``/``gap``/``lag``. The sync service needs the
opposite shape — a live feedback loop where the admission controller
reads sliding lag and headroom gauges WHILE the fleet runs. This module
is the read side running concurrently with the write side:

- **the incremental fold engine** (:class:`LiveFold`) — consumes obs
  records one at a time and maintains rolling fleet/cost/lag state:
  the fleet-health report (documents, staleness, divergence
  incidents, full-bag rate), the convergence-lag distributions with
  SLO attainment + burn rate (sliding p50/p95/p99 from the mergeable
  pow2 histograms), the wave cost totals with the
  O(doc)-vs-O(delta) slope, ``fleet.token_headroom`` minima,
  waves/sec, dispatch counts, and per-event-name recency (the wedge
  signal). It is built ON the batch reducers (``FleetReducer``,
  ``LagReducer``, ``CostReducer``), so its folds are bit-equal to the
  post-hoc ``lag_summary``/``fleet_report``/``costmodel_digest`` on
  the same stream — the same last-per-(pid, reset-epoch) summation
  rules ``obs.lag`` defines;
- **feeds** — in-process via the bounded subscriber hook on the
  sink (:func:`attach` → :class:`LiveAttachment`), cross-process by
  tailing one or more O_APPEND JSONL sidecars
  (:class:`StreamTailer` / :class:`MultiTailer`, rotation-aware:
  an inode change or truncation reopens from byte zero);
- **the alert-rule registry** — declarative threshold / absence /
  burn-rate rules over the snapshot (:func:`parse_rule`,
  :func:`default_rules`: ``"burn>2"``, ``"absence:wave.digest:120"``
  — the wedge detector — and ``"full_bag_rate>0.2"``), evaluated
  edge-triggered by :class:`LiveMonitor`: each rule fires ONE
  ``live.alert`` record per excursion (re-arming on recovery) and
  invokes registered callbacks — the signal surface item 4's dynamic
  batch-sizing controller subscribes to;
- **periodic rollups** — ``live.snapshot`` records (compact scalar
  summary of the fold) for the sidecar, Perfetto (named
  ``semantic:live`` track) and the ``obs watch`` dashboard /
  Prometheus endpoint (``cause_tpu_torch.obs.watch``).

Contract (same as the rest of ``cause_tpu_torch.obs``): stdlib + core only,
importable without jax/numpy. The read-side classes work with obs OFF
(tailing someone else's sidecar needs no local recording); the
write-side entry points are inert — :func:`attach` returns None, and
``live.alert``/``live.snapshot`` are only ever emitted through
``core.event`` (a no-op when disabled), so the obs-off invariance
(no records, no env reads, no subscriber state, byte-identical
program-cache keys) holds for the entire layer — pinned by
tests/test_live.py. On jit-reachable paths, call sites must sit
behind ``obs.enabled()`` guards — causelint rule OBS007 gates that.
"""

from __future__ import annotations

import os
import json
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from . import core
from .costmodel import CostReducer
from .fleet import FleetReducer
from .journey import JourneyFold

__all__ = [
    "LiveFold",
    "Rule",
    "parse_rule",
    "default_rules",
    "DEFAULT_RULE_SPECS",
    "LiveMonitor",
    "LiveAttachment",
    "attach",
    "StreamTailer",
    "MultiTailer",
    "snapshot_path",
]

# rolling waves/sec window (seconds): long enough to smooth a bursty
# fleet, short enough that a wedge shows as the rate falling to zero
# within a couple of dashboard refreshes
_RATE_WINDOW_S = 60.0
# wave timestamps retained for the rate estimate (bounded memory)
_RATE_TS_MAX = 8192


class LiveFold:
    """The incremental fold engine: one obs record in, rolling state
    updated. Wraps the batch-equal reducers (fleet/lag/counters/cost)
    and adds the live-only axes no post-hoc report needs — event
    recency, waves/sec, token-headroom minima. Pure read side: safe
    to run with obs off (a monitor tailing a foreign sidecar)."""

    __slots__ = ("fleet", "cost", "journeys", "first_ts_us",
                 "last_ts_us", "last_seen_us", "_wave_ts",
                 "headroom_min", "headroom_last", "heartbeat",
                 "serve_gauges", "_shed_ts", "shed_total",
                 "serve_ticks", "net_gauges", "net_counts",
                 "_reconnect_ts", "disk_faults", "journal_torn",
                 "obs_gauges")

    def __init__(self):
        self.fleet = FleetReducer()
        self.cost = CostReducer()
        # the distributed-tracing axes: streaming journey
        # reconstruction with tail-based exemplar retention — only
        # SLO-breaching (or orphaned) journeys keep full hop detail;
        # everything else folds into the per-edge histograms
        self.journeys = JourneyFold(slo_ms=100.0)
        self.first_ts_us: Optional[int] = None
        self.last_ts_us: Optional[int] = None
        # event name -> newest ts_us (the absence rules' input)
        self.last_seen_us: Dict[str, int] = {}
        self._wave_ts: deque = deque(maxlen=_RATE_TS_MAX)
        # token-headroom gauges: site ("wave"/"session") -> min / last
        self.headroom_min: Dict[str, float] = {}
        self.headroom_last: Dict[str, float] = {}
        # the newest run.heartbeat fields (wedge triage: which ladder
        # item / wave stage was alive last)
        self.heartbeat: Optional[dict] = None
        # the sync service's live axes: last-seen serve gauges
        # (queue_depth / resident_docs / t_batch_ms), shed-event
        # timestamps (the shed_rate window), tick count. A stream with
        # no serve.* records at all renders serve.active=False and the
        # serve absence rule stays silent (a batch soak is not a dead
        # service — it is not a service).
        self.serve_gauges: Dict[str, float] = {}
        self._shed_ts: deque = deque(maxlen=_RATE_TS_MAX)
        self.shed_total = 0
        self.serve_ticks = 0
        # the network transport's live axes: last-seen net
        # gauges (outbound_depth / connections), event counts
        # (connects, reconnects, nacks, duplicate evidence, sheds)
        # and the reconnect timestamps behind reconnects_per_min —
        # the flap detector. A stream with no net.* records renders
        # net.active=False and the net rules stay silent (a batch
        # soak is not a dead transport — it is not a transport).
        self.net_gauges: Dict[str, float] = {}
        self.net_counts: Dict[str, int] = {}
        self._reconnect_ts: deque = deque(maxlen=_RATE_TS_MAX)
        # the durable-storage axes: every evidenced storage
        # degradation (``serve.disk``: torn/bitrot/enospc/fsync/
        # rename) and every torn-or-corrupt journal line surfaced by
        # a replay (``serve.journal_torn`` carries the per-replay
        # counts in its fields)
        self.disk_faults = 0
        self.journal_torn = 0
        # the telemetry plane's own health: ``obs.dropped.*``
        # gauges (per-subscriber drop counters — a saturated bounded
        # queue used to drop silently into a field nobody watched)
        # and whatever else the shipping layer gauges under ``obs.``
        self.obs_gauges: Dict[str, float] = {}

    def feed(self, e: dict) -> None:
        self.fleet.feed(e)
        self.cost.feed(e)
        self.journeys.feed(e)
        ts = e.get("ts_us")
        if isinstance(ts, (int, float)):
            ts = int(ts)
            if self.first_ts_us is None or ts < self.first_ts_us:
                self.first_ts_us = ts
            if self.last_ts_us is None or ts > self.last_ts_us:
                self.last_ts_us = ts
        ev = e.get("ev")
        name = e.get("name")
        if ev == "event" and name:
            if isinstance(ts, int):
                prev = self.last_seen_us.get(name)
                if prev is None or ts > prev:
                    self.last_seen_us[name] = ts
                if name == "wave.digest":
                    self._wave_ts.append(ts)
            if name == "run.heartbeat":
                hb = dict(e.get("fields") or {})
                if isinstance(ts, int):
                    hb["ts_us"] = ts
                self.heartbeat = hb
            elif name == "serve.tick":
                self.serve_ticks += 1
                # every tick carries the controller's current window —
                # read it here so a stable controller (no change, no
                # gauge emission) still shows its T_batch on the
                # dashboard
                tb = (e.get("fields") or {}).get("t_batch_ms")
                if isinstance(tb, (int, float)):
                    self.serve_gauges["t_batch_ms"] = float(tb)
            elif name == "serve.shed":
                self.shed_total += 1
                if isinstance(ts, int):
                    self._shed_ts.append(ts)
            elif name == "serve.disk":
                self.disk_faults += 1
            elif name == "serve.journal_torn":
                f = e.get("fields") or {}
                n = 0
                for k in ("skipped", "corrupt"):
                    v = f.get(k)
                    if isinstance(v, (int, float)):
                        n += int(v)
                self.journal_torn += max(1, n)
            elif isinstance(name, str) and name.startswith("net."):
                key = name[len("net."):]
                self.net_counts[key] = self.net_counts.get(key, 0) + 1
                if name == "net.reconnect" and isinstance(ts, int):
                    self._reconnect_ts.append(ts)
                elif name == "net.dup_ops":
                    ops = (e.get("fields") or {}).get("ops")
                    if isinstance(ops, (int, float)):
                        self.net_counts["dup_ops_suppressed"] = \
                            self.net_counts.get("dup_ops_suppressed",
                                                0) + int(ops)
        elif ev == "gauge" and isinstance(name, str):
            if name.startswith("fleet.token_headroom."):
                site = name[len("fleet.token_headroom."):]
                v = e.get("value")
                if isinstance(v, (int, float)):
                    self.headroom_last[site] = v
                    cur = self.headroom_min.get(site)
                    self.headroom_min[site] = (v if cur is None
                                               else min(cur, v))
            elif name.startswith("serve."):
                v = e.get("value")
                if isinstance(v, (int, float)):
                    self.serve_gauges[name[len("serve."):]] = v
            elif name.startswith("net."):
                v = e.get("value")
                if isinstance(v, (int, float)):
                    self.net_gauges[name[len("net."):]] = v
            elif name.startswith("obs."):
                v = e.get("value")
                if isinstance(v, (int, float)):
                    self.obs_gauges[name[len("obs."):]] = v

    def feed_many(self, events: Iterable[dict]) -> None:
        for e in events:
            self.feed(e)

    # ------------------------------------------------------ snapshot

    def now_us(self) -> int:
        """The fold's notion of "now": wall clock, floored by the
        newest record's timestamp so a replay of an old stream
        (``--once``) measures ages against the stream's own end, not
        against today."""
        wall = time.time_ns() // 1000
        if self.last_ts_us is not None and self.last_ts_us > wall:
            return self.last_ts_us
        return wall

    def waves_per_s(self, now_us: int,
                    window_s: float = _RATE_WINDOW_S) -> float:
        cutoff = now_us - int(window_s * 1e6)
        n = sum(1 for t in self._wave_ts if t >= cutoff)
        return round(n / window_s, 4)

    def shed_rate(self, now_us: int,
                  window_s: float = _RATE_WINDOW_S) -> float:
        """``serve.shed`` events per second over the rate window —
        the default ``shed_rate>0`` alert's axis: ANY shedding inside
        the window is an excursion (overload is a declared policy,
        and a declared policy firing is operator news)."""
        cutoff = now_us - int(window_s * 1e6)
        n = sum(1 for t in self._shed_ts if t >= cutoff)
        return round(n / window_s, 4)

    def reconnects_per_min(self, now_us: int,
                           window_s: float = _RATE_WINDOW_S) -> float:
        """``net.reconnect`` events per minute over the rate window —
        the default ``reconnects_per_min>k`` alert's axis: a transport
        that keeps healing is a transport that keeps failing (flap
        detection), even though every individual reconnect is the
        designed behavior."""
        cutoff = now_us - int(window_s * 1e6)
        n = sum(1 for t in self._reconnect_ts if t >= cutoff)
        return round(n * 60.0 / window_s, 4)

    def _obs_dropped(self) -> Optional[float]:
        """Total subscriber-queue drops across every bounded
        subscriber: the gauges are per-source
        (``obs.dropped.<source>``) because one healthy subscriber
        would mask another's saturation under a single shared name.
        The bare un-suffixed spelling still counts. None (never a
        fake 0) when nothing gauged drops yet — the ``obs_dropped>0``
        rule must stay inert on streams without the gauge."""
        vals = [v for k, v in self.obs_gauges.items()
                if k == "dropped" or k.startswith("dropped.")]
        if not vals:
            return None
        return sum(vals)

    def _net_outbound(self) -> Optional[float]:
        """Total queued outbound ops across every client: the gauges
        are per-client (``net.outbound_depth.<client_id>``) because a
        single shared gauge would be last-writer-wins — one drained
        client would mask another's growing partition backlog. The
        bare un-suffixed spelling still counts (hand-rolled
        streams)."""
        vals = [v for k, v in self.net_gauges.items()
                if k == "outbound_depth"
                or k.startswith("outbound_depth.")]
        if not vals:
            return None
        return sum(vals)

    def ages_s(self, now_us: int) -> Dict[str, float]:
        """Seconds since each event name was last seen (the absence
        rules' axis), plus ``"any"`` — since ANY record landed."""
        out = {name: round(max(0, now_us - ts) / 1e6, 3)
               for name, ts in self.last_seen_us.items()}
        if self.last_ts_us is not None:
            out["any"] = round(max(0, now_us - self.last_ts_us) / 1e6, 3)
        return out

    def snapshot(self, now_us: Optional[int] = None) -> dict:
        """The rolling state as one dict — the alert rules' input and
        the dashboard's render source. Sections mirror the post-hoc
        reports (``fleet_report``'s shape for fleet/sync/wave/gc,
        ``lag_summary``'s for lag, ``costmodel_digest``'s for cost),
        plus the live-only axes (rates, ages, headroom, heartbeat)."""
        now = self.now_us() if now_us is None else int(now_us)
        rep = self.fleet.report()
        incidents = rep.pop("divergence_incidents")
        snap = {
            "ts_us": now,
            "records": rep["events"],
            "fleet": {
                "documents": rep["documents"],
                "waves": rep["waves"],
                "pairs": rep["pairs"],
                "replicas": rep["replicas"],
                "agreed_documents": rep["agreed_documents"],
                "staleness": rep["staleness"],
                "divergence_incidents": len(incidents),
                "last_incidents": incidents[-3:],
            },
            "sync": rep["sync"],
            "wave": rep["wave"],
            "gc": rep["gc"],
            "recovery": rep["recovery"],
            "lag": dict(self.fleet.lag.report()),
            "cost": self.cost.digest(),
            "rates": {"waves_per_s": self.waves_per_s(now)},
            "headroom": {
                "min": (min(self.headroom_min.values())
                        if self.headroom_min else None),
                "min_by_site": dict(self.headroom_min),
                "last_by_site": dict(self.headroom_last),
            },
            "heartbeat": self.heartbeat,
            "serve": {
                "active": bool(self.serve_ticks or self.shed_total
                               or self.serve_gauges
                               or any(n.startswith("serve.")
                                      for n in self.last_seen_us)),
                "ticks": self.serve_ticks,
                "queue_depth": self.serve_gauges.get("queue_depth"),
                "resident_docs":
                    self.serve_gauges.get("resident_docs"),
                "t_batch_ms": self.serve_gauges.get("t_batch_ms"),
                "shed_rate": self.shed_rate(now),
                "sheds": self.shed_total,
                "disk_faults": self.disk_faults,
                "journal_torn": self.journal_torn,
                "wal_segments": self.serve_gauges.get("wal_segments"),
                "wal_bytes": self.serve_gauges.get("wal_bytes"),
            },
            "net": {
                "active": bool(self.net_counts or self.net_gauges
                               or any(n.startswith("net.")
                                      for n in self.last_seen_us)),
                "connects": self.net_counts.get("connect", 0),
                "reconnects": self.net_counts.get("reconnect", 0),
                "reconnects_per_min": self.reconnects_per_min(now),
                "disconnects": self.net_counts.get("disconnect", 0),
                "nacks": self.net_counts.get("nack", 0),
                "dup_frames": self.net_counts.get("dup_frame", 0),
                "dup_ops_suppressed":
                    self.net_counts.get("dup_ops_suppressed", 0),
                "ooo_frames": self.net_counts.get("ooo_frame", 0),
                "sheds": self.net_counts.get("shed", 0),
                "heartbeats": self.net_counts.get("heartbeat", 0),
                "outbound_depth": self._net_outbound(),
                "connections": self.net_gauges.get("connections"),
            },
            "obs": {
                "dropped": self._obs_dropped(),
            },
            "journey": self.journeys.summary(),
            "ages_s": self.ages_s(now),
        }
        if self.cost.waves:
            by_path = self.cost.curves_by_path()
            if len(by_path) > 1:
                snap["cost"]["by_path"] = {
                    k: v.get("verdict") for k, v in by_path.items()}
        return snap


# ------------------------------------------------------------- rules


def snapshot_path(snap: dict, path: str):
    """Resolve a dotted path (``"sync.full_bag_rate"``) into a
    snapshot dict; None when any segment is missing."""
    cur = snap
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


# threshold-rule aliases: the operator-facing names for the snapshot
# paths an admission controller (and the CLI --rules flag) cares about
RULE_ALIASES = {
    "burn": "lag.slo.burn_rate",
    "attainment": "lag.slo.attainment",
    "p50": "lag.converged.p50_ms",
    "p95": "lag.converged.p95_ms",
    "p99": "lag.converged.p99_ms",
    "window_p99": "lag.window.p99_ms",
    "pending": "lag.pending",
    "full_bag_rate": "sync.full_bag_rate",
    "fallback_rate": "wave.fallback_rate",
    "session_overflow": "wave.session_overflow",
    "divergence": "fleet.divergence_incidents",
    "headroom": "headroom.min",
    "waves_per_s": "rates.waves_per_s",
    "stale": "stale_s",
    # the chaos/recovery axes — rejected ingest payloads, the
    # current replica-quarantine count, and the recovery-storm rate
    # (declared ladder steps per wave)
    "rejects": "sync.rejects",
    "quarantined": "sync.quarantined",
    "recovery_per_wave": "recovery.per_wave",
    "recovery_retries": "recovery.retries",
    # the sync service's admission axes — bounded-queue depth,
    # the shed-event rate over the sliding window, and the residency
    # manager's device-resident tenant count
    "queue_depth": "serve.queue_depth",
    "shed_rate": "serve.shed_rate",
    "resident_docs": "serve.resident_docs",
    # the network transport's axes — reconnect flap rate, wire
    # NACK count, client outbound backlog, duplicate evidence
    "reconnects_per_min": "net.reconnects_per_min",
    "net_nacks": "net.nacks",
    "net_outbound": "net.outbound_depth",
    "net_dup_frames": "net.dup_frames",
    "net_connections": "net.connections",
    # the durable-storage axes — evidenced storage faults,
    # torn/corrupt journal lines seen by replays, live WAL size
    "disk_faults": "serve.disk_faults",
    "journal_torn": "serve.journal_torn",
    "wal_bytes": "serve.wal_bytes",
    "wal_segments": "serve.wal_segments",
    # the telemetry plane's own drop evidence — total bounded-
    # subscriber drops gauged under obs.dropped[.source]
    "obs_dropped": "obs.dropped",
}

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
}


class Rule:
    """One declarative alert rule, edge-triggered: :meth:`check`
    returns the alert fields exactly once per excursion (the rule
    re-arms when the condition clears), so a persistent breach costs
    one ``live.alert``, not one per snapshot tick — the CI smoke's
    "forced breach fires EXACTLY ONE alert" contract.

    Kinds:

    - ``threshold`` — ``<path><op><value>`` over the snapshot
      (aliases in :data:`RULE_ALIASES`); a missing/None value never
      fires (you cannot breach a percentile that does not exist yet);
    - ``absence`` — ``absence:<event>:<seconds>``: fires when the
      named event has not been seen for the given span (measured
      against the newest record when the event never appeared — a
      stream that is producing OTHER records but no ``wave.digest``
      is a wedged fleet, not an idle one). An empty stream never
      fires;
    - ``burn`` is just a threshold alias (``burn>2`` reads the SLO
      burn rate ``lag_summary`` computes).
    """

    __slots__ = ("spec", "kind", "path", "op", "limit", "event",
                 "window_s", "firing")

    def __init__(self, spec: str, kind: str, path: str = "",
                 op: str = ">", limit: float = 0.0, event: str = "",
                 window_s: float = 0.0):
        self.spec = spec
        self.kind = kind
        self.path = path
        self.op = op
        self.limit = limit
        self.event = event
        self.window_s = window_s
        self.firing = False

    def _condition(self, snap: dict) -> Optional[dict]:
        if self.kind == "absence":
            age = (snap.get("ages_s") or {}).get(self.event)
            if age is None and snap.get("records"):
                # never seen: judge against the stream's own span —
                # other records flowing while this event stays absent
                # IS the wedge shape; a silent (empty) stream is not.
                # Exception: serve.*/net.* events are judged only on
                # streams that show the respective activity — a batch
                # soak that never ran a service (or a transport) is
                # not a dead one, it is not one at all (the default
                # absence:serve.tick / absence:net.heartbeat rules
                # must not page on every long batch stream)
                prefix = self.event.split(".", 1)[0]
                if prefix not in ("serve", "net") \
                        or (snap.get(prefix) or {}).get("active"):
                    age = snap.get("span_s")
            if age is None or age <= self.window_s:
                return None
            return {"age_s": age, "window_s": self.window_s,
                    "event": self.event}
        value = snapshot_path(snap, self.path)
        if not isinstance(value, (int, float)):
            return None
        if _OPS[self.op](float(value), self.limit):
            return {"value": value, "limit": self.limit, "op": self.op,
                    "path": self.path}
        return None

    def check(self, snap: dict) -> Optional[dict]:
        hit = self._condition(snap)
        if hit is None:
            self.firing = False
            return None
        if self.firing:
            return None  # still in the same excursion
        self.firing = True
        hit["rule"] = self.spec
        hit["kind"] = self.kind
        return hit


def parse_rule(spec: str) -> Rule:
    """One rule from its declarative spec string (see :class:`Rule`).
    Raises ``ValueError`` on a malformed spec — a watch run with a
    typo'd rule must fail loudly, not silently monitor nothing."""
    s = spec.strip()
    if s.startswith("absence:"):
        parts = s.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"absence rule must be absence:<event>:<seconds>: "
                f"{spec!r}")
        try:
            window = float(parts[2])
        except ValueError:
            raise ValueError(f"absence window is not a number: {spec!r}")
        return Rule(s, "absence", event=parts[1], window_s=window)
    for op in (">=", "<=", ">", "<"):  # two-char ops first
        if op in s:
            path, _, raw = s.partition(op)
            path = path.strip()
            try:
                limit = float(raw.strip())
            except ValueError:
                raise ValueError(f"threshold is not a number: {spec!r}")
            if not path:
                raise ValueError(f"empty snapshot path: {spec!r}")
            return Rule(s, "threshold",
                        path=RULE_ALIASES.get(path, path), op=op,
                        limit=limit)
    raise ValueError(
        f"unrecognized rule {spec!r} (want <path><op><value> or "
        f"absence:<event>:<seconds>)")


# the shipped defaults: SLO burn past 2x (the error budget is being
# eaten at least twice as fast as sustainable), the wedge detector
# (a fleet that stopped waving for 120 s while still emitting other
# records), the finding that full-bag fallbacks are the dominant
# degradation mode, and the robustness pair — ANY replica
# sitting in quarantine is an operator page (a corrupt or hostile
# peer is being refused), and a recovery STORM (more than one
# declared ladder step per wave, sustained) means the fleet is paying
# O(doc) degradations every round instead of riding the delta path
DEFAULT_RULE_SPECS = ("burn>2", "absence:wave.digest:120",
                      "full_bag_rate>0.2", "quarantined>0",
                      "recovery_per_wave>1",
                      # the sync-service pair: ANY shed inside
                      # the rate window (the overload policy firing is
                      # operator news), and a service whose tick
                      # heartbeat goes absent for 60 s — the in-stream
                      # twin of SyncService's own watchdog, inert on
                      # streams with no serve activity (Rule._condition)
                      "shed_rate>0", "absence:serve.tick:60",
                      # the transport pair: a replication link
                      # whose heartbeat evidence goes absent for 120 s
                      # (clients keepalive on a seconds cadence, so
                      # this is a genuinely dead/blackholed transport,
                      # not an idle one), and a reconnect FLAP — more
                      # than 6 heals a minute means the link keeps
                      # dying; each individual reconnect is designed
                      # behavior, the sustained rate is the incident.
                      # Both inert on streams with no net activity
                      # (absence via Rule._condition's activity gate;
                      # the threshold reads a rate that stays 0.0
                      # until net.reconnect records flow)
                      "absence:net.heartbeat:120",
                      "reconnects_per_min>6",
                      # the storage pair: ANY evidenced disk
                      # fault (torn write, bit-rot, ENOSPC, failed
                      # fsync/rename — each one is a degradation the
                      # operator should know happened even though the
                      # service absorbed it), and ANY torn/corrupt
                      # journal line surfaced by a replay (a torn tail
                      # is expected after a crash, CRC corruption
                      # never is — both deserve a page, not a buried
                      # counter). Inert on serve-less streams: both
                      # paths live under the snapshot's "serve"
                      # section, whose counters stay 0 with no serve
                      # records, and Rule._condition's activity gate
                      # keeps them silent there
                      "disk_faults>0", "journal_torn>0",
                      # the telemetry plane's own health: ANY
                      # bounded-subscriber drop is operator news — the
                      # telemetry is best-effort by contract, but a
                      # saturated queue means the dashboard is now
                      # lying by omission and the operator must know
                      # how much. Inert on streams without the gauge
                      # (a missing value never fires a threshold rule)
                      "obs_dropped>0")


def default_rules() -> List[Rule]:
    return [parse_rule(s) for s in DEFAULT_RULE_SPECS]


# ----------------------------------------------------------- monitor


class LiveMonitor:
    """The fold + the rule registry + the emit side, as one object:
    ``feed`` records, ``evaluate`` the rules (emitting ``live.alert``
    obs events — when obs is on — and firing callbacks), ``snapshot``
    the rolling state (optionally emitting a ``live.snapshot``
    record). Thread-safe: the in-process attachment polls from
    whatever thread the caller owns while a Prometheus endpoint reads
    snapshots from the server thread."""

    def __init__(self, rules: Optional[Iterable] = None,
                 on_alert: Iterable[Callable[[dict], None]] = (),
                 source: str = "live"):
        self.fold = LiveFold()
        if rules is None:
            self.rules = default_rules()
        else:
            self.rules = [r if isinstance(r, Rule) else parse_rule(r)
                          for r in rules]
        self.on_alert = list(on_alert)
        self.source = str(source)
        self.alerts: List[dict] = []
        self.snapshots_emitted = 0
        self._lock = threading.Lock()

    def add_callback(self, fn: Callable[[dict], None]) -> None:
        """Register an alert callback (the batch-sizing controller's
        subscription point)."""
        self.on_alert.append(fn)

    def feed(self, events: Iterable[dict]) -> None:
        with self._lock:
            self.fold.feed_many(events)

    def overlay_counters(self, counters: dict, gauges: dict,
                         pid: Optional[int] = None) -> None:
        """Overlay the in-process counter registry onto the fold
        (same per-pid last-snapshot merge rule as a flushed
        ``counters`` record) WITHOUT counting a stream record — the
        fold's record count must keep matching the sidecar."""
        with self._lock:
            self.fold.fleet.feed_counters({
                "ev": "counters",
                "pid": os.getpid() if pid is None else pid,
                "counters": counters,
                "gauges": gauges,
            })

    def snapshot(self, now_us: Optional[int] = None) -> dict:
        with self._lock:
            snap = self.fold.snapshot(now_us)
            # the absence rules' never-seen fallback axis: the span of
            # the stream itself (see Rule._condition)
            if self.fold.first_ts_us is not None \
                    and self.fold.last_ts_us is not None:
                snap["span_s"] = round(
                    (snap["ts_us"] - self.fold.first_ts_us) / 1e6, 3)
                # wall-clock staleness, independent of the chosen
                # "now": a sidecar that stopped growing half an hour
                # ago is a dead run even when --once replays it
                # against its own recorded end (rule alias "stale")
                snap["stale_s"] = round(max(
                    0, time.time_ns() // 1000
                    - self.fold.last_ts_us) / 1e6, 3)
            snap["alerts_total"] = len(self.alerts)
            return snap

    def evaluate(self, now_us: Optional[int] = None,
                 snap: Optional[dict] = None) -> List[dict]:
        """Run every rule against the (given or fresh) snapshot;
        returns the alerts that fired on THIS call (edge-triggered —
        an unchanged excursion returns nothing)."""
        if snap is None:
            snap = self.snapshot(now_us)
        fired: List[dict] = []
        # rule state (edge-trigger flags) mutates under the monitor
        # lock: two threads evaluating through one excursion must not
        # both see firing=False and double-emit — "exactly one alert
        # per excursion" is a contract, not a best effort. Emission
        # and callbacks run OUTSIDE the lock (a callback may touch
        # the monitor).
        with self._lock:
            for rule in self.rules:
                hit = rule.check(snap)
                if hit is None:
                    continue
                hit["ts_us"] = snap["ts_us"]
                hit["source"] = self.source
                self.alerts.append(hit)
                fired.append(hit)
        for hit in fired:
            if core.enabled():
                core.event("live.alert", **hit)
                core.counter("live.alerts").inc()
            for fn in self.on_alert:
                try:
                    fn(hit)
                except Exception:  # noqa: BLE001 - telemetry never raises
                    pass
        return fired

    def emit_snapshot(self, now_us: Optional[int] = None) -> dict:
        """One compact ``live.snapshot`` record into the obs stream
        (no-op emit when obs is off; the dict is returned either
        way). Compact on purpose: the rollup is a dashboard row, not
        a dump of the whole fold."""
        snap = self.snapshot(now_us)
        lag = snap.get("lag") or {}
        conv = lag.get("converged") or {}
        slo = lag.get("slo") or {}
        cost = snap.get("cost") or {}
        fields = {
            "source": self.source,
            "records": snap["records"],
            "documents": snap["fleet"]["documents"],
            "waves": snap["fleet"]["waves"],
            "agreed_documents": snap["fleet"]["agreed_documents"],
            "divergence_incidents":
                snap["fleet"]["divergence_incidents"],
            "waves_per_s": snap["rates"]["waves_per_s"],
            "full_bag_rate": snap["sync"]["full_bag_rate"],
            "ops_converged": lag.get("ops_converged", 0),
            "pending": lag.get("pending", 0),
            "p50_ms": conv.get("p50_ms"),
            "p95_ms": conv.get("p95_ms"),
            "p99_ms": conv.get("p99_ms"),
            "slo_ms": slo.get("target_ms"),
            "attainment": slo.get("attainment"),
            "burn_rate": slo.get("burn_rate"),
            "verdict": slo.get("verdict"),
            "dispatches": cost.get("dispatches", 0),
            "headroom_min": snap["headroom"]["min"],
            "quarantined": snap["sync"].get("quarantined", 0),
            "recovery_steps": snap["recovery"].get("steps", 0),
            "alerts_total": snap["alerts_total"],
        }
        srv = snap.get("serve") or {}
        if srv.get("active"):
            # the service's dashboard row rides the same compact
            # record; batch streams keep their shape untouched
            fields.update(
                queue_depth=srv.get("queue_depth"),
                shed_rate=srv.get("shed_rate"),
                resident_docs=srv.get("resident_docs"),
                t_batch_ms=srv.get("t_batch_ms"),
                serve_ticks=srv.get("ticks"),
            )
        net = snap.get("net") or {}
        if net.get("active"):
            # the transport's axes ride along only when a transport
            # actually ran (same contract as the serve section)
            fields.update(
                net_reconnects=net.get("reconnects"),
                reconnects_per_min=net.get("reconnects_per_min"),
                net_nacks=net.get("nacks"),
                net_dup_frames=net.get("dup_frames"),
                net_dup_ops=net.get("dup_ops_suppressed"),
                net_outbound=net.get("outbound_depth"),
            )
        if core.enabled():
            core.event("live.snapshot", **fields)
            with self._lock:
                self.snapshots_emitted += 1
        return snap


# ------------------------------------------------- in-process attach


class LiveAttachment:
    """A live monitor wired to THIS process's obs sink via the
    subscriber hook: :meth:`poll` drains the bounded queue into the
    fold, overlays the in-process counter registry (counters only
    reach the stream at ``flush()`` — a live reader must not wait for
    one), evaluates the rules and optionally emits a snapshot.
    Detach with :meth:`close`."""

    __slots__ = ("sub", "monitor", "_dropped_gauged")

    def __init__(self, sub, monitor: LiveMonitor):
        self.sub = sub
        self.monitor = monitor
        self._dropped_gauged = 0

    def poll(self, emit_snapshot: bool = False,
             evaluate: bool = True) -> dict:
        """Drain + fold + (evaluate, snapshot). Returns the fresh
        snapshot dict (its ``alerts_total`` includes anything fired
        by this call)."""
        # a saturated bounded queue used to drop silently into
        # a field nobody watched — gauge it BEFORE draining so the
        # gauge record rides this very drain and the ``obs_dropped>0``
        # default rule fires on the same poll that discovered the
        # saturation. (Gauging into a still-full queue costs one more
        # drop; the gauge intentionally trails by that record — the
        # rule only needs "any", and the count converges once the
        # queue drains.)
        if self.sub.dropped != self._dropped_gauged and core.enabled():
            self._dropped_gauged = self.sub.dropped
            core.gauge(
                f"obs.dropped.{self.monitor.source}").set(
                    self.sub.dropped)
        self.monitor.feed(self.sub.drain())
        snap_regs = core.counters_snapshot()
        if snap_regs["counters"] or snap_regs["gauges"]:
            # flush-equivalent overlay: same per-pid last-snapshot
            # merge rule, sourced from the registry instead of the
            # stream, and NOT counted as a record (the fold's record
            # count keeps matching the sidecar)
            self.monitor.overlay_counters(snap_regs["counters"],
                                          snap_regs["gauges"])
        if evaluate:
            self.monitor.evaluate()
        if emit_snapshot:
            return self.monitor.emit_snapshot()
        return self.monitor.snapshot()

    @property
    def dropped(self) -> int:
        """Records the bounded queue dropped (a stalled poller)."""
        return self.sub.dropped

    @property
    def closed(self) -> bool:
        """True once detached — including by an ``obs.reset()`` /
        ``configure(reset=True)``, which drops every subscriber with
        the rest of the obs state. A closed attachment drains nothing
        forever; the holder must re-``attach()`` against the new
        state (and decide what to do with the fold so far)."""
        return self.sub.closed

    def close(self) -> None:
        core.unsubscribe(self.sub)


def attach(rules: Optional[Iterable] = None,
           on_alert: Iterable[Callable[[dict], None]] = (),
           maxlen: int = 8192,
           source: str = "live") -> Optional[LiveAttachment]:
    """Attach a live monitor to this process's obs sink. Returns None
    when obs is disabled — the obs-off contract is zero subscriber
    state, zero records, zero overhead."""
    sub = core.subscribe(maxlen)
    if sub is None:
        return None
    return LiveAttachment(sub, LiveMonitor(rules=rules,
                                           on_alert=on_alert,
                                           source=source))


# ------------------------------------------------------------- tails


class StreamTailer:
    """Tail one O_APPEND JSONL sidecar: :meth:`poll` returns the
    records appended since the last poll. Rotation-aware — an inode
    change or a truncation (size < position) reopens from byte zero,
    so a log-rotated or restarted writer is picked up without
    restarting the watcher. Torn trailing lines (a writer mid-append)
    stay buffered until their newline lands; garbage lines are
    skipped like every other obs reader."""

    __slots__ = ("path", "_fh", "_ino", "_pos", "_buf")

    def __init__(self, path: str):
        self.path = str(path)
        self._fh = None
        self._ino = None
        self._pos = 0
        self._buf = b""

    def _close(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
        self._fh = None
        self._ino = None
        self._pos = 0
        self._buf = b""

    def poll(self) -> List[dict]:
        try:
            st = os.stat(self.path)
        except OSError:
            # not created yet (or rotated away mid-poll): wait for it
            self._close()
            return []
        if self._fh is None or st.st_ino != self._ino \
                or st.st_size < self._pos:
            self._close()
            try:
                self._fh = open(self.path, "rb")
            except OSError:
                return []
            self._ino = os.fstat(self._fh.fileno()).st_ino
        out: List[dict] = []
        try:
            self._fh.seek(self._pos)
            data = self._fh.read()
        except (OSError, ValueError):
            self._close()
            return []
        self._pos += len(data)
        self._buf += data
        lines = self._buf.split(b"\n")
        self._buf = lines.pop()  # torn tail waits for its newline
        for line in lines:
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

    def close(self) -> None:
        self._close()


class MultiTailer:
    """Several sidecars as one feed (a multi-process soak's
    per-process streams): each :meth:`poll` batch is merged by record
    timestamp across files — the same stable rule ``load_streams``
    applies to whole files, at poll-batch granularity."""

    __slots__ = ("tailers",)

    def __init__(self, paths: Iterable[str]):
        self.tailers = [StreamTailer(p) for p in paths]

    def poll(self) -> List[dict]:
        out: List[dict] = []
        for t in self.tailers:
            out.extend(t.poll())
        if len(self.tailers) > 1:
            out.sort(key=lambda e: e.get("ts_us") or 0)
        return out

    def close(self) -> None:
        for t in self.tailers:
            t.close()
