"""The central telemetry collector: the ingest half of the fleet
telemetry plane (a copy of ``cause_tpu.obs.collector``).

One :class:`CollectorServer` accepts N :class:`~cause_tpu_torch.obs.ship
.ShipExporter` uplinks (either package's: the frames are the same) and
turns the fleet's per-process obs streams into ONE live signal surface:

- **watermark dedup** — every origin is a (host, pid, stream-epoch)
  triple with a monotone record seq assigned exporter-side; the
  collector acks the highest contiguous seq accepted and skips
  anything at or below it, so lost-ack resends, chaos-duplicated
  frames and reconnect overlaps can never double a record. A seq GAP
  is accepted only when the frame's cumulative evidenced-drop count
  accounts for it exactly (the exporter drops OLDEST, so dropped seqs
  are always the contiguous front of the unsent range); an
  unexplained gap (a reordered frame in flight) is stashed briefly
  and healed when the missing frame lands — out-of-watermark-order
  persistence never happens;
- **clock folding** — exporters sample their offset against THIS
  process on every hello/ping (``xtrace.clock_sample`` on the reply
  stamp); those ``xtrace.clock`` records ship like any other, so the
  fold's journey skew machinery corrects every origin's journey hops
  onto one reference clock — journeys reconstruct from the collector
  feed ALONE;
- **durable segments** — accepted frames append to a
  :class:`~cause_tpu_torch.serve.wal.WriteAheadLog` (rotated, CRC-trailed,
  ``python -m cause_tpu_torch.serve scrub``-able), with retention by
  age/size (:meth:`retain`) — the collector is a sidecar archive,
  not an unbounded disk leak;
- **one fleet-wide LiveFold** — every accepted record feeds a
  :class:`~cause_tpu_torch.obs.live.LiveMonitor`; ``obs watch --collector``
  and the Prometheus endpoint render every host's serve/net/lag/
  journey axes from the live socket feed, with per-origin (host, pid)
  labels whose cardinality is bounded by the origin LRU.

Telemetry is best-effort: a misbehaving uplink costs a closed
connection and evidence, never backpressure into a producer's hot
path. Stdlib + this package's host modules only, nothing of torch.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import OrderedDict, deque
from typing import Deque, Dict, List, Optional, Tuple

from .. import sync
from ..collections import shared as s
from ..net import transport
from ..net.transport import FrameStream
from ..serve import wal as _wal
from . import core
from . import xtrace
from .live import LiveMonitor

__all__ = ["CollectorServer"]

# frames parked per origin waiting for an in-flight reordered
# predecessor; past this the gap is accepted as unexplained loss
# (evidence, not a wedge)
_STASH_MAX = 16
_DEFAULT_ORIGIN_LRU = 64


class _Origin:
    """One remote stream's fold-side state: the dedup watermark, the
    drop accounting, the reorder stash, and the last-seen serve/net
    gauges that become this origin's Prometheus labels."""

    __slots__ = ("host", "pid", "epoch", "watermark", "dropped_seen",
                 "missed", "dup_records", "accepted", "stash",
                 "last_us", "gauges")

    def __init__(self, host: str, pid: int, epoch: int):
        self.host = host
        self.pid = pid
        self.epoch = epoch
        self.watermark = 0
        self.dropped_seen = 0
        self.missed = 0          # seqs lost to evidenced drops
        self.dup_records = 0     # records skipped by the watermark
        self.accepted = 0
        self.stash: Dict[int, dict] = {}  # base seq -> parked frame
        self.last_us = 0
        self.gauges: Dict[str, float] = {}

    def key(self) -> Tuple[str, int, int]:
        return (self.host, self.pid, self.epoch)

    def label(self) -> str:
        return f"{self.host}:{self.pid}"


class _Conn:
    __slots__ = ("fs", "peer", "origin")

    def __init__(self, fs: FrameStream, peer: str):
        self.fs = fs
        self.peer = peer
        self.origin: Optional[_Origin] = None


class CollectorServer:
    """See the module docstring. ``start()`` spawns the accept loop;
    each uplink gets a handler thread. ``port=0`` binds ephemeral
    (read ``.port`` back). ``dir=None`` keeps records in memory only
    (tests, short smokes); give a directory for the rotated-segment
    archive."""

    def __init__(self, dir: Optional[str] = None,  # noqa: A002
                 host: str = "127.0.0.1", port: int = 0,
                 idle_timeout_s: float = transport.DEFAULT_IDLE_TIMEOUT_S,
                 rotate_bytes: int = 4 * 1024 * 1024,
                 retain_bytes: Optional[int] = None,
                 retain_s: Optional[float] = None,
                 origin_lru: int = _DEFAULT_ORIGIN_LRU,
                 rules: Optional[List] = None,
                 site: str = "obs.collector"):
        self.dir = dir
        self.idle_timeout_s = float(idle_timeout_s)
        self.retain_bytes = retain_bytes
        self.retain_s = retain_s
        self.origin_lru = int(origin_lru)
        self.site = str(site)
        self.wal: Optional[_wal.WriteAheadLog] = None
        if dir:
            os.makedirs(dir, exist_ok=True)
            self.wal = _wal.WriteAheadLog(dir,
                                          rotate_bytes=rotate_bytes)
        self.monitor = LiveMonitor(rules=rules, source="collector")
        # the full accepted stream in arrival order — the soak/smoke
        # gates' comparison surface (the WAL holds the durable copy)
        self.records: Deque[dict] = deque()
        self._origins: "OrderedDict[Tuple[str, int, int], _Origin]" = \
            OrderedDict()
        self._lock = threading.RLock()   # origins + records + wal
        self._conns: List[_Conn] = []
        self._conns_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._sock = socket.create_server((host, int(port)))
        self._sock.settimeout(0.25)  # accept-loop poll granularity
        self.host = host
        self.port = self._sock.getsockname()[1]
        self.stats = {
            "connections": 0, "frames": 0, "accepted_records": 0,
            "dup_records": 0, "missed_records": 0, "stashed_frames": 0,
            "unexplained_gaps": 0, "heartbeats": 0, "hellos": 0,
            "idle_closes": 0, "bad_frames": 0, "evicted_origins": 0,
        }
        self._stats_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    def _bump(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    # ----------------------------------------------------- lifecycle

    def start(self) -> "CollectorServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="ship-accept", daemon=True)
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:  # pragma: no cover
            pass
        with self._conns_lock:
            for conn in self._conns:
                conn.fs.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None
        for t in self._threads:
            t.join(timeout=2.0)
        self._threads = []
        # after the joins nothing appends; close() blocks on its
        # final fsync, so it must not ride the ingest lock
        if self.wal is not None:
            self.wal.close()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, addr = self._sock.accept()
            except TimeoutError:
                continue
            except OSError:
                return  # listener closed (stop())
            try:
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:  # pragma: no cover
                pass
            sock.settimeout(self.idle_timeout_s)
            fs = FrameStream(sock, site=self.site)
            conn = _Conn(fs, peer=f"{addr[0]}:{addr[1]}")
            with self._conns_lock:
                self._conns.append(conn)
                self._bump("connections")
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name=f"ship-conn-{conn.peer}",
                                 daemon=True)
            self._threads = [x for x in self._threads if x.is_alive()]
            with self._conns_lock:
                self._conns = [c_ for c_ in self._conns
                               if not c_.fs.closed]
            self._threads.append(t)
            t.start()

    # ------------------------------------------------------- handler

    def _handle(self, conn: _Conn) -> None:
        fs = conn.fs
        try:
            while not self._stop.is_set():
                try:
                    frame = transport.recv_msg(
                        fs, timeout_s=self.idle_timeout_s)
                except s.CausalError as e:
                    if "read-timeout" in e.info.get("causes", ()):
                        self._bump("idle_closes")
                    return
                except OSError:
                    return
                op = frame.get("op") if isinstance(frame, dict) \
                    else None
                self._bump("frames")
                try:
                    if op == "hello":
                        reply = self._welcome(conn, frame)
                    elif op == "obs":
                        reply = self._ingest(conn, frame)
                    elif op == "ping":
                        reply = self._pong(conn, frame)
                    elif op == "snap":
                        reply = {"op": "snap",
                                 "snapshot": self.snapshot()}
                    elif op == "bye":
                        return
                    else:
                        self._bump("bad_frames")
                        reply = {"op": "nack", "reason": "bad-frame"}
                    if reply is not None:
                        sync.send_frame(fs, reply)
                except (s.CausalError, OSError):
                    # a peer that died mid-reply: telemetry is
                    # best-effort — the exporter's reconnect ladder
                    # owns what's next
                    return
        finally:
            fs.close()

    def _welcome(self, conn: _Conn, frame: dict) -> dict:
        host = str(frame.get("host") or conn.peer)
        pid = int(frame.get("pid") or 0)
        epoch = int(frame.get("epoch") or 0)
        with self._lock:
            org = self._origin((host, pid, epoch))
        conn.origin = org
        self._bump("hellos")
        if core.enabled():
            core.counter("ship.hellos").inc()
            core.event("ship.hello", origin=org.label(), epoch=epoch,
                       watermark=org.watermark, peer=conn.peer)
        reply = {"op": "welcome", "watermark": org.watermark}
        if core.enabled():
            # wall-clock stamp for the exporter's NTP-style offset
            # sample — the clock edge every origin's journey
            # correction hangs off (obs-off replies stay bare)
            reply.update(xtrace.reply_stamp())
        return reply

    def _pong(self, conn: _Conn, frame: dict) -> dict:
        self._bump("heartbeats")
        reply = {"op": "pong", "seq": int(frame.get("seq") or 0)}
        if core.enabled():
            reply.update(xtrace.reply_stamp())
        return reply

    def _origin(self, key: Tuple[str, int, int]) -> _Origin:
        """The LRU registry row for one (host, pid, epoch) — created
        on first touch, refreshed on every touch, evicted
        least-recently-active beyond ``origin_lru`` (which is what
        bounds the Prometheus label cardinality). Called under
        ``_lock``."""
        org = self._origins.get(key)
        if org is None:
            org = _Origin(*key)
            self._origins[key] = org
        self._origins.move_to_end(key)
        while len(self._origins) > self.origin_lru:
            self._origins.popitem(last=False)
            self._bump("evicted_origins")
        return org

    # -------------------------------------------------------- ingest

    def _ingest(self, conn: _Conn, frame: dict) -> dict:
        org = conn.origin
        if org is None:
            self._bump("bad_frames")
            return {"op": "nack", "reason": "no-hello"}
        recs = frame.get("records")
        base = int(frame.get("base") or 0)
        dropped = int(frame.get("dropped") or 0)
        if not isinstance(recs, list) or base <= 0:
            self._bump("bad_frames")
            return {"op": "nack", "reason": "bad-frame"}
        with self._lock:
            self._origin(org.key())  # LRU touch
            self._apply(org, base, recs, dropped)
            self._drain_stash(org)
            wm = org.watermark
        return {"op": "ack", "seq": wm}

    def _apply(self, org: _Origin, base: int, recs: List[dict],
               dropped: int) -> None:
        """One obs frame against the origin's watermark (under
        ``_lock``): skip the dup prefix, accept the fresh suffix,
        admit an evidenced-drop gap exactly, stash an unexplained
        one."""
        n = len(recs)
        nxt = org.watermark + 1
        if n == 0 or base + n - 1 <= org.watermark:
            # pure wire duplicate (chaos dup / lost-ack resend)
            org.dup_records += n
            self._bump("dup_records", n)
            return
        if base > nxt:
            gap = base - nxt
            drop_delta = dropped - org.dropped_seen
            if gap > drop_delta:
                # more missing than the exporter evidenced: an
                # in-flight reordered frame — park this one; the
                # missing predecessor (or a resend) heals it
                if len(org.stash) < _STASH_MAX:
                    org.stash[base] = {"base": base, "records": recs,
                                       "dropped": dropped}
                    self._bump("stashed_frames")
                    return
                # stash exhausted: accept the gap as unexplained loss
                # rather than wedge the stream (loud, counted)
                self._bump("unexplained_gaps")
            org.missed += gap
            self._bump("missed_records", gap)
        skip = max(0, nxt - base)
        if skip:
            org.dup_records += skip
            self._bump("dup_records", skip)
        fresh = recs[skip:]
        org.watermark = base + n - 1
        org.dropped_seen = max(org.dropped_seen, dropped)
        org.last_us = time.time_ns() // 1000
        org.accepted += len(fresh)
        self._bump("accepted_records", len(fresh))
        self.records.extend(fresh)
        self.monitor.feed(fresh)
        for rec in fresh:
            if rec.get("ev") == "gauge":
                name = rec.get("name")
                v = rec.get("value")
                if isinstance(name, str) and isinstance(v, (int, float)) \
                        and name.startswith(("serve.", "net.")):
                    org.gauges[name] = float(v)
        if self.wal is not None:
            self.wal.append(f"{org.host}:{org.pid}:{org.epoch}",
                            "obs.ship", fresh, ts_us=org.last_us)
            self.retain()

    def _drain_stash(self, org: _Origin) -> None:
        """Re-offer parked frames (under ``_lock``): after an accept
        moved the watermark, a stashed frame either lands (its gap
        closed), re-stashes (still unexplained), or collapses to a
        pure duplicate and is discarded."""
        while org.stash:
            progressed = False
            for b in sorted(org.stash):
                f = org.stash[b]
                if b + len(f["records"]) - 1 <= org.watermark:
                    org.stash.pop(b)   # superseded by a resend
                    org.dup_records += len(f["records"])
                    self._bump("dup_records", len(f["records"]))
                    progressed = True
                    break
                gap = b - (org.watermark + 1)
                if gap <= 0 or gap <= f["dropped"] - org.dropped_seen:
                    org.stash.pop(b)
                    self._apply(org, b, f["records"], f["dropped"])
                    progressed = True
                    break
            if not progressed:
                return

    # ----------------------------------------------------- retention

    def retain(self) -> dict:
        """Retention by size and age over the segment archive (under
        ``_lock`` via callers; safe to call directly too): while the
        directory exceeds ``retain_bytes`` — or the oldest CLOSED
        segment is older than ``retain_s`` — retire whole segments
        through the WAL's crash-safe GC (manifest-first, scrub finds
        no orphans). The open tail segment is never retired."""
        if self.wal is None:
            return {"retired": 0}
        retired = 0
        while True:
            segs = _wal.list_segments(self.wal.path)
            if len(segs) <= 1:
                break
            no, name = segs[0]
            fp = os.path.join(self.wal.path, name)
            too_big = (self.retain_bytes is not None
                       and self.wal.dir_bytes() > self.retain_bytes)
            too_old = False
            if self.retain_s is not None:
                try:
                    age = time.time() - os.path.getmtime(fp)
                    too_old = age > self.retain_s
                except OSError:
                    pass
            if not (too_big or too_old):
                break
            # the GC watermark that retires exactly this segment: the
            # last record seq it holds (records at or below a
            # watermark are retirable once the caller declares them
            # archived — here, age/size policy IS the declaration)
            last_seq = 0
            for kind, rec in _wal.scan_segment_file(fp):
                if kind == "rec":
                    last_seq = max(last_seq, int(rec.get("seq") or 0))
            if not last_seq:
                break
            got = self.wal.gc(last_seq)
            if not got.get("retired"):
                break
            retired += int(got["retired"])
        return {"retired": retired}

    # ------------------------------------------------------ read side

    def origins(self) -> List[dict]:
        with self._lock:
            now = time.time_ns() // 1000
            return [{
                "host": o.host, "pid": o.pid, "epoch": o.epoch,
                "watermark": o.watermark, "accepted": o.accepted,
                "missed": o.missed, "dup_records": o.dup_records,
                "age_s": (round((now - o.last_us) / 1e6, 3)
                          if o.last_us else None),
                "serve": {k[len("serve."):]: v
                          for k, v in o.gauges.items()
                          if k.startswith("serve.")},
                "net": {k[len("net."):]: v
                        for k, v in o.gauges.items()
                        if k.startswith("net.")},
            } for o in self._origins.values()]

    def snapshot(self, evaluate: bool = True) -> dict:
        """The fleet-wide fold snapshot, augmented with the
        collector's own sections: per-origin rows (the Prometheus
        label source, LRU-bounded) and the ship-plane accounting.
        ``obs watch --collector`` renders exactly this dict."""
        if evaluate:
            self.monitor.evaluate()
        snap = self.monitor.snapshot()
        snap["origins"] = self.origins()
        with self._stats_lock:
            stats = dict(self.stats)
        snap["ship"] = {
            "active": bool(stats["hellos"]),
            "origins": len(snap["origins"]),
            "accepted": stats["accepted_records"],
            "dup_records": stats["dup_records"],
            "missed": stats["missed_records"],
            "unexplained_gaps": stats["unexplained_gaps"],
            "connections": stats["connections"],
        }
        snap["alerts_recent"] = self.monitor.alerts[-5:]
        return snap

    def report(self) -> dict:
        with self._stats_lock:
            stats = dict(self.stats)
        out = {"stats": stats, "origins": self.origins(),
               "records": len(self.records)}
        if self.wal is not None:
            with self._lock:
                out["wal"] = self.wal.wal_report()
        return out
