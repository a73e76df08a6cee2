"""Networked obs shipping: the exporter half of the fleet telemetry
plane (a copy of ``cause_tpu.obs.ship``).

The other obs layers assume all processes append JSONL to one shared
filesystem and the read side merges files post-hoc — an assumption
multi-host serving breaks outright. This module ships the records
instead: a :class:`ShipExporter` rides the bounded subscriber hook (the
SAME hook the live attachment uses), frames obs records over the
transport's CRC framing, and pushes them to a
:class:`~cause_tpu_torch.obs.collector.CollectorServer` so the
fleet-wide signal surface exists WHILE the fleet runs. The frames are
the reference's, so either package's exporter ships to either
package's collector.

Telemetry is best-effort BY CONTRACT — the opposite discipline from
the data plane:

- the hot path is never blocked or slowed: the only hot-path touch is
  the O(1) bounded-subscriber enqueue ``core.record`` already pays;
  everything else (buffering, framing, sockets, backoff sleeps) lives
  on one daemon pump thread;
- on overflow it drops OLDEST with an honest, evidenced count (the
  ``obs.dropped.ship`` gauge + ``ship.drop`` events + ``stats``),
  never NACK-parks like data — a wedged collector must cost bounded
  memory and zero admission latency;
- a healed partition ships exactly the missed suffix: records get
  per-(pid, stream-epoch) sequence numbers at enqueue, the collector
  acks a per-origin watermark, and every (re)connect's welcome
  carries that watermark back so the exporter trims what already
  landed and resends only the unacked tail (the collector's watermark
  dedup absorbs any overlap a lost ack forces).

Chaos: the ``ship`` family (partition / drop / dup / reorder) fires
ONLY inside this layer — at ``<site>.connect`` on the dial and
``<site>.send`` around each frame — so a ship-chaos soak can gate on
a bit-identical data plane while the telemetry link burns.

Obs-off invariance: :func:`attach_exporter` returns None when obs is
disabled (``core.subscribe`` returns None — zero sockets, zero
threads, zero state), so the whole shipping layer inherits the
standing contract.

Stdlib + this package's host modules only, nothing of torch: the pump
thread never touches the card (a serving process's ticking thread alone
runs the device).
"""

from __future__ import annotations

import os
import socket
import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

from .. import chaos as _chaos
from .. import sync
from ..collections import shared as s
from ..net.transport import Backoff, FrameStream, recv_msg
from . import core
from . import xtrace

__all__ = ["ShipExporter", "attach_exporter", "SHIP_PROTO"]

SHIP_PROTO = 1
# unacked-record buffer bound: at ~200 B/record this is ~13 MB of
# worst-case partition backlog per process — small enough to never
# matter, deep enough to ride out minutes of collector downtime at
# steady-state record rates
DEFAULT_BUFFER_RECORDS = 65536
DEFAULT_BATCH_RECORDS = 256
DEFAULT_SUB_MAXLEN = 8192


def _now_us() -> int:
    return time.time_ns() // 1000


class ShipExporter:
    """One process's telemetry uplink (see the module docstring).
    Construct via :func:`attach_exporter` — it owns the obs-off gate.
    All socket/buffer work happens on the daemon pump thread;
    :meth:`close` flushes best-effort and detaches."""

    def __init__(self, sub, host: str, port: int,
                 buffer_records: int = DEFAULT_BUFFER_RECORDS,
                 batch_records: int = DEFAULT_BATCH_RECORDS,
                 flush_s: float = 0.05,
                 heartbeat_s: float = 2.0,
                 connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 5.0,
                 backoff: Optional[Backoff] = None,
                 site: str = "obs.ship",
                 epoch: Optional[int] = None,
                 start: bool = True):
        self.sub = sub
        self.host = str(host)
        self.port = int(port)
        self.site = str(site)
        self.buffer_records = int(buffer_records)
        self.batch_records = int(batch_records)
        self.flush_s = float(flush_s)
        self.heartbeat_s = float(heartbeat_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.read_timeout_s = float(read_timeout_s)
        self.backoff = backoff or Backoff(seed=os.getpid())
        self.origin_host = socket.gethostname()
        self.pid = os.getpid()
        # the stream epoch: one per exporter incarnation, so a
        # restarted process (same pid recycled or not) never collides
        # with its predecessor's watermark at the collector
        self.epoch = int(epoch) if epoch is not None else _now_us()
        # unacked suffix: (seq, record) in seq order; drops and ack
        # trims both pop from the LEFT, so the deque stays contiguous
        self._buf: Deque[Tuple[int, dict]] = deque()
        self._next_seq = 1
        self._held: Deque[dict] = deque()  # reorder-chaos holdbacks
        self.fs: Optional[FrameStream] = None
        self.connected = False
        self._next_dial = 0.0
        self._last_io = 0.0
        self._hb_seq = 0
        self._down_since: Optional[float] = None
        self.stats = {
            "connects": 0, "reconnects": 0, "disconnects": 0,
            "dial_failures": 0, "sent_frames": 0, "sent_records": 0,
            "acked_seq": 0, "resumed_skipped": 0, "dropped_records": 0,
            "heartbeats": 0, "clock_samples": 0, "unshipped": 0,
        }
        self._dropped_gauged = -1
        # pump() is the only socket/buffer toucher, but it runs from
        # the daemon thread AND from flush()/close() callers — one
        # cycle at a time or two windows interleave on the socket
        self._pump_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if core.enabled():
            core.event("ship.attach", host=self.origin_host,
                       pid=self.pid, epoch=self.epoch,
                       collector=f"{self.host}:{self.port}")
        if start:
            self.start()

    # ------------------------------------------------------ lifecycle

    def start(self) -> "ShipExporter":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="obs-ship", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.flush_s):
            try:
                self.pump()
            except Exception:  # noqa: BLE001 - telemetry never raises
                with self._pump_lock:
                    self._disconnect_locked("pump-error")

    def close(self, flush_timeout_s: float = 2.0) -> None:
        """Stop the pump, flush the unacked tail best-effort (bounded
        by ``flush_timeout_s`` — telemetry must never stall a
        shutdown), send bye, detach the subscriber. Whatever could not
        ship is counted honestly in ``stats["unshipped"]``."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5.0)
            self._thread = None
        deadline = time.monotonic() + float(flush_timeout_s)
        while time.monotonic() < deadline:
            unacked = None
            try:
                unacked = self.pump()["unacked"]
            except Exception:  # noqa: BLE001 - telemetry never raises
                with self._pump_lock:
                    self._disconnect_locked("close-pump-error")
            if unacked == 0 and self.sub is not None \
                    and not len(self.sub.queue):
                break
            time.sleep(0.02)
        with self._pump_lock:
            self._close_locked()
        core.unsubscribe(self.sub)

    def _close_locked(self) -> None:
        self._ingest_locked()
        self.stats["unshipped"] = len(self._buf)
        if self.fs is not None:
            try:
                sync.send_frame(self.fs, {"op": "bye"})
            except (s.CausalError, OSError):
                pass
            try:
                self.fs.close()
            except OSError:
                pass
            self.fs = None
        self.connected = False

    # --------------------------------------------------------- intake

    def _ingest_locked(self) -> int:
        """Drain the bounded subscriber into the unacked buffer,
        assigning per-(pid, epoch) seqs; overflow drops OLDEST with
        evidence. Returns records ingested."""
        if self.sub is None:
            return 0
        drained = self.sub.drain()
        for rec in drained:
            self._buf.append((self._next_seq, rec))
            self._next_seq += 1
        over = len(self._buf) - self.buffer_records
        if over > 0:
            for _ in range(over):
                self._buf.popleft()
            self.stats["dropped_records"] += over
            if core.enabled():
                core.event("ship.drop", dropped=over,
                           total=self._total_dropped_locked(),
                           buffered=len(self._buf))
        self._gauge_drops_locked()
        return len(drained)

    def _total_dropped_locked(self) -> int:
        return self.stats["dropped_records"] + int(self.sub.dropped)

    def total_dropped(self) -> int:
        """Every record this exporter evidenced as lost before the
        wire: subscriber-queue drops (a stalled pump) plus buffer
        drops (a long partition). The collector's per-origin gap
        accounting must equal exactly this."""
        with self._pump_lock:
            return self._total_dropped_locked()

    def _gauge_drops_locked(self) -> None:
        total = self._total_dropped_locked()
        if total != self._dropped_gauged and core.enabled():
            self._dropped_gauged = total
            core.gauge("obs.dropped.ship").set(total)

    # ----------------------------------------------------------- wire

    def _dial_locked(self) -> None:
        if _chaos.enabled() and _chaos.ship_partition(self.site):
            raise s.CausalError(
                "ship: chaos-injected telemetry partition",
                {"causes": {"ship-unreachable"},
                 "site": self.site})
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self.read_timeout_s)
        self.fs = FrameStream(sock, site=self.site)

    def _connect_locked(self) -> None:
        try:
            self._dial_locked()
            t0 = _now_us()
            sync.send_frame(self.fs, {
                "op": "hello", "kind": "ship", "proto": SHIP_PROTO,
                "host": self.origin_host, "pid": self.pid,
                "epoch": self.epoch, "next_seq": self._next_seq,
            })
            welcome = recv_msg(self.fs, self.read_timeout_s)
            t1 = _now_us()
        except (s.CausalError, OSError) as e:
            self.stats["dial_failures"] += 1
            self._schedule_redial_locked()
            if core.enabled():
                why = (sorted(e.info.get("causes", ()))
                       if isinstance(e, s.CausalError) else ["os-error"])
                core.event("ship.dial_failed", why=why,
                           next_dial_ms=round(
                               (self._next_dial - time.monotonic())
                               * 1000.0, 1))
            return
        if welcome.get("op") != "welcome":
            self.stats["dial_failures"] += 1
            self._schedule_redial_locked()
            try:
                self.fs.close()
            except OSError:
                pass
            self.fs = None
            return
        # the hello RTT doubles as a clock sample against the
        # collector — the xtrace.clock record it mints SHIPS like any
        # other record, so the collector's fold corrects every
        # origin's hop timestamps onto one reference clock (journey's
        # skew machinery, fed over the wire instead of merged files)
        if xtrace.clock_sample(welcome, t0, t1,
                               via="ship-hello") is not None:
            self.stats["clock_samples"] += 1
        wm = int(welcome.get("watermark") or 0)
        skipped = 0
        while self._buf and self._buf[0][0] <= wm:
            self._buf.popleft()
            skipped += 1
        self.stats["resumed_skipped"] += skipped
        self.stats["acked_seq"] = max(self.stats["acked_seq"], wm)
        self.connected = True
        self._last_io = time.monotonic()
        self.backoff.reset()
        self.stats["connects"] += 1
        first = self.stats["connects"] == 1
        if not first:
            self.stats["reconnects"] += 1
        if core.enabled():
            if first:
                core.event("ship.connect", watermark=wm,
                           resumed_skipped=skipped)
            else:
                mttr_ms = (round((time.monotonic() - self._down_since)
                                 * 1000.0, 1)
                           if self._down_since is not None else None)
                core.event("ship.reconnect", watermark=wm,
                           resumed_skipped=skipped, mttr_ms=mttr_ms)
        self._down_since = None

    def _schedule_redial_locked(self) -> None:
        if self._down_since is None:
            self._down_since = time.monotonic()
        self._next_dial = time.monotonic() \
            + self.backoff.next_ms() / 1000.0

    def _disconnect_locked(self, why: str) -> None:
        if self.fs is not None:
            try:
                self.fs.close()
            except OSError:
                pass
            self.fs = None
        if self.connected:
            self.connected = False
            self.stats["disconnects"] += 1
            self._held.clear()  # holdbacks die with their connection
            if core.enabled():
                core.event("ship.disconnect", why=why,
                           unacked=len(self._buf))
        self._schedule_redial_locked()

    def _send_locked(self, frame: dict) -> None:
        """One frame through the ship-family chaos seam: ``drop``
        vanishes it silently, ``reorder`` holds it back until the next
        send overtakes it, ``dup`` puts it on the wire twice. Raises
        on real socket errors (the caller disconnects)."""
        dup = False
        if _chaos.enabled():
            if _chaos.ship_drop(self.site):
                self.stats["sent_frames"] += 1  # "sent", locally
                return
            if _chaos.ship_reorder(self.site):
                self._held.append(frame)
                return
            dup = _chaos.ship_dup(self.site)
        try:
            sync.send_frame(self.fs, frame)
            if dup:
                sync.send_frame(self.fs, frame)
            while self._held:
                # deliver holdbacks AFTER the overtaking frame — the
                # collector's out-of-order stash heals the swap
                sync.send_frame(self.fs, self._held.popleft())
        except OSError as e:
            raise s.CausalError(
                "ship: send failed", {"causes": {"ship-reset"}}) from e
        self.stats["sent_frames"] += 1
        self._last_io = time.monotonic()

    # ----------------------------------------------------------- pump

    def pump(self) -> dict:
        """One pump cycle (the thread's body; callable directly in
        tests): ingest → maybe dial → ship the unacked window → drain
        acks → heartbeat. Returns a small progress dict."""
        with self._pump_lock:
            return self._pump_locked()

    def _pump_locked(self) -> dict:
        self._ingest_locked()
        now = time.monotonic()
        if not self.connected:
            if now >= self._next_dial:
                self._connect_locked()
            return {"connected": self.connected,
                    "unacked": len(self._buf)}
        sent = 0
        try:
            if self._buf:
                sent = self._ship_window_locked()
            elif self._held:
                # a reorder holdback with no follow-up traffic: flush
                # it now (delayed, not lost)
                while self._held:
                    sync.send_frame(self.fs, self._held.popleft())
                self._last_io = time.monotonic()
            if not self._buf \
                    and now - self._last_io >= self.heartbeat_s:
                self._heartbeat_locked()
        except (s.CausalError, OSError) as e:
            why = (",".join(sorted(e.info.get("causes", ())))
                   if isinstance(e, s.CausalError) else "os-error")
            self._disconnect_locked(why)
        self._gauge_drops_locked()
        return {"connected": self.connected, "sent_frames": sent,
                "unacked": len(self._buf)}

    def _ship_window_locked(self) -> int:
        """Frame and send the whole unacked suffix (pipelined — the
        reorder fault needs two frames in flight to mean anything),
        then drain one ack per frame. A lost frame shows as acks
        stopping short; the stranded suffix stays buffered and the
        next cycle resends it (the collector dup-skips overlap)."""
        entries = list(self._buf)
        frames = 0
        for i in range(0, len(entries), self.batch_records):
            chunk = entries[i:i + self.batch_records]
            self._send_locked({
                "op": "obs", "base": chunk[0][0],
                "dropped": self._total_dropped_locked(),
                "records": [rec for _seq, rec in chunk],
            })
            frames += 1
        if self._held:
            # the window ended on a holdback with nothing left to
            # overtake it — flush now (delayed one frame, not lost)
            try:
                while self._held:
                    sync.send_frame(self.fs, self._held.popleft())
            except OSError as e:
                raise s.CausalError(
                    "ship: send failed",
                    {"causes": {"ship-reset"}}) from e
        self.stats["sent_records"] += len(entries)
        last_seq = entries[-1][0]
        progressed = False
        # ack budget > frames: a chaos-duplicated frame gets acked
        # TWICE, and stale acks from a previous partially-drained
        # window may still sit in the socket. The first ``frames``
        # reads are owed and wait the full timeout; past that the
        # drain turns opportunistic (50 ms) so extras clear without
        # stalling the pump
        got = 0
        for _ in range(frames * 2 + 4):
            try:
                reply = recv_msg(
                    self.fs,
                    self.read_timeout_s if got < frames else 0.05)
            except s.CausalError:
                if got < frames and not progressed:
                    raise  # nothing landed: a dead/blackholed link
                break      # partial progress: resend the rest later
            got += 1
            if reply.get("op") != "ack":
                continue
            ack = int(reply.get("seq") or 0)
            if ack > self.stats["acked_seq"]:
                self.stats["acked_seq"] = ack
                progressed = True
            while self._buf and self._buf[0][0] <= ack:
                self._buf.popleft()
            if ack >= last_seq:
                break
        self._last_io = time.monotonic()
        return frames

    def _heartbeat_locked(self) -> None:
        self._hb_seq += 1
        t0 = _now_us()
        self._send_locked({"op": "ping", "seq": self._hb_seq})
        reply = recv_msg(self.fs, self.read_timeout_s)
        t1 = _now_us()
        self.stats["heartbeats"] += 1
        if reply.get("op") == "pong" and xtrace.clock_sample(
                reply, t0, t1, via="ship-ping") is not None:
            self.stats["clock_samples"] += 1
        self._last_io = time.monotonic()

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Pump until the unacked buffer drains (or the deadline).
        Test/smoke helper — production callers just close()."""
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            st = self.pump()
            if st["unacked"] == 0 and not len(self.sub.queue):
                return True
            time.sleep(0.02)
        return False


def attach_exporter(host: str, port: int,
                    maxlen: int = DEFAULT_SUB_MAXLEN,
                    **kw) -> Optional[ShipExporter]:
    """Attach a telemetry uplink to this process's obs sink. Returns
    None when obs is disabled — the obs-off contract is zero sockets,
    zero threads, zero subscriber state (``core.subscribe`` is the
    gate, exactly like ``live.attach``)."""
    sub = core.subscribe(maxlen)
    if sub is None:
        return None
    return ShipExporter(sub, host, port, **kw)


def parse_endpoint(raw: str) -> Optional[Tuple[str, int]]:
    """``"host:port"`` from the ``CAUSE_TPU_OBS_SHIP`` knob (bare
    ``":port"`` means loopback). None on anything unparseable — a
    typo'd endpoint must not take the service down; the exporter
    simply is not wired and the local sidecar still has everything."""
    raw = (raw or "").strip()
    if not raw:
        return None
    host, sep, port = raw.rpartition(":")
    if not sep:
        return None
    try:
        return (host or "127.0.0.1", int(port))
    except ValueError:
        return None
