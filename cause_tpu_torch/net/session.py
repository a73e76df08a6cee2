"""Resumable client replication sessions: the producer side of the
replication transport (a copy of ``cause_tpu.net.session``, without the
``net.*`` events, gauges and trace contexts, which come back with the
telemetry port; frames are byte-identical to the reference's obs-off
frames).

A :class:`NetClient` is the thin front-end a real fleet runs millions
of: it mints per-site op batches locally, queues them in a BOUNDED
outbound buffer, and ships them to a :class:`~cause_tpu_torch.net.server
.ReplicationServer` over a long-lived framed connection — designed so
that every network failure degrades to *queued outbound deltas*,
never a wedge or an exception on the caller's loop:

- **reconnect/backoff** — a dead peer (reset, blackhole'd reply, read
  deadline, refused dial) marks the session disconnected and arms the
  seeded-jitter exponential backoff ladder; ``pump()`` keeps
  returning immediately (queuing locally) until the next dial is due;
- **resumable watermarks** — every (re)connect negotiates
  ``hello``/``welcome``: the server answers with its per-(tenant,
  site) lamport watermarks, and the client drops queued ops at or
  below them — so a partition heals by shipping EXACTLY the missed
  suffix (ops admitted before the link died are never re-sent, ops
  the server never saw all are). Anything that still overlaps (an ack
  lost in flight) is suppressed op-exactly by the server's watermark
  filter;
- **backpressure honored** — a ``nack`` with ``retry_after_ms`` parks
  the whole session until the hint elapses (one NACK histogram
  bucket per reason), so server overload propagates to the producer
  instead of turning into a hot retry loop;
- **bounded outbound** — ``queue_ops`` refuses past
  ``max_pending_ops`` (the ``client-overflow`` shed rung), the client-side twin of the server's shed
  ladder: a partitioned producer's memory is a declared policy too;
- **heartbeats** — an idle connected session pings inside the
  server's idle deadline.

Protocol is strictly request-response per frame (send one ``delta``,
read replies until the matching seq — stale re-acks from wire
-duplicated frames are drained and counted), which keeps the client a
single-threaded state machine the soak can drive from one thread per
client.

Stdlib + sync/serde only (nothing of torch).
"""

from __future__ import annotations

import time
import zlib
from typing import Dict, List, Optional, Tuple

from .. import chaos as _chaos
from .. import serde
from .. import sync
from ..collections import shared as s
from . import transport
from .transport import Backoff, FrameStream

__all__ = ["NetClient"]

# how many stale (lower-seq) replies to drain while waiting for the
# matching one before declaring the connection desynced
_STALE_REPLY_MAX = 64


class NetClient:
    """See the module docstring. Single-threaded: call :meth:`pump`
    from one driving loop (it never raises for network reasons and
    never blocks past the read deadline)."""

    def __init__(self, host: str, port: int, uuids,
                 client_id: str = "",
                 max_pending_ops: int = 4096,
                 backoff: Optional[Backoff] = None,
                 read_timeout_s: float = 5.0,
                 heartbeat_s: float = 2.0,
                 connect_timeout_s: float = 2.0,
                 site: str = "net.client"):
        self.host = host
        self.port = int(port)
        self.uuids = [str(u) for u in uuids]
        self.client_id = str(client_id) or f"client-{port}"
        self.max_pending_ops = int(max_pending_ops)
        self.read_timeout_s = float(read_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.site = str(site)
        self.backoff = backoff or Backoff(
            seed=zlib.crc32(self.client_id.encode()))
        # (uuid, site) -> ordered op triples [(id, cause, value)]
        self._pending: Dict[Tuple[str, str], List[tuple]] = {}
        self._pending_ops = 0
        self._server_wm: Dict[str, Dict[str, list]] = {}
        self._fs: Optional[FrameStream] = None
        self._seq = 0
        self._not_before = 0.0     # NACK backpressure (monotonic)
        self._next_dial = 0.0      # backoff gate (monotonic)
        self._down_since: Optional[float] = None
        self._last_io = 0.0
        self._last_hb = 0.0
        self.partition_mttr_s: List[float] = []
        self.stats = {
            "connects": 0, "reconnects": 0, "dial_failures": 0,
            "sent_frames": 0, "acked_ops": 0, "dup_acked_ops": 0,
            "resumed_skipped_ops": 0,
            "stale_replies": 0, "heartbeats": 0, "shed_ops": 0,
            "nacks": {}, "backoff_hist": {}, "disconnects": 0,
        }

    # ------------------------------------------------------- produce

    @property
    def outbound_depth(self) -> int:
        return self._pending_ops

    @property
    def connected(self) -> bool:
        return self._fs is not None and not self._fs.closed

    def queue_ops(self, uuid: str, site: str, triples) -> bool:
        """Queue one site's op batch for shipment. Bounded: past
        ``max_pending_ops`` the offer is REFUSED with an evidenced
        ``net.shed`` — during a long partition the producer's memory
        is a declared policy, not an accident. Refused ops were never
        queued (the caller may retry after the link heals)."""
        triples = list(triples)
        if not triples:
            return True
        if self._pending_ops + len(triples) > self.max_pending_ops:
            self.stats["shed_ops"] += len(triples)
            return False
        key = (str(uuid), str(site))
        self._pending.setdefault(key, []).extend(triples)
        self._pending_ops += len(triples)
        return True

    # ------------------------------------------------------ plumbing

    def _now(self) -> float:
        return time.monotonic()

    def _disconnect(self, reason: str) -> None:
        if self._fs is not None:
            self._fs.close()
            self._fs = None
        now = self._now()
        if self._down_since is None:
            self._down_since = now
        delay_ms = self.backoff.next_ms()
        self._next_dial = now + delay_ms / 1000.0
        # pow2-bucketed backoff histogram (the soak's ledger evidence)
        bucket = 1
        while bucket < delay_ms:
            bucket *= 2
        key = f"<{bucket}ms"
        self.stats["backoff_hist"][key] = \
            self.stats["backoff_hist"].get(key, 0) + 1
        self.stats["disconnects"] += 1

    def _connect(self) -> None:
        """Dial + hello/welcome + watermark resume. Raises CausalError
        on failure (the pump catches and schedules the backoff)."""
        fs = transport.dial(self.host, self.port, site=self.site,
                            connect_timeout_s=self.connect_timeout_s,
                            read_timeout_s=self.read_timeout_s)
        transport.send_msg(fs, {"op": "hello",
                                "client": self.client_id,
                                "uuids": self.uuids})
        welcome = transport.recv_msg(fs,
                                     timeout_s=self.read_timeout_s)
        if not (isinstance(welcome, dict)
                and welcome.get("op") == "welcome"
                and isinstance(welcome.get("wm"), dict)):
            fs.close()
            raise s.CausalError(
                "net: malformed welcome",
                {"causes": {"bad-frame"}, "expected": "welcome"})
        self._fs = fs
        self._server_wm = {
            str(u): {str(st): [int(h[0]), int(h[1])]
                     for st, h in (w or {}).items()}
            for u, w in welcome["wm"].items()}
        self._seq = 0  # seq is per-connection (the server's _Conn)
        reconnect = self.stats["connects"] > 0
        self.stats["connects"] += 1
        if reconnect:
            self.stats["reconnects"] += 1
        now = self._now()
        self._last_io = now
        self._last_hb = now  # heartbeat cadence starts at connect
        if self._down_since is not None:
            self.partition_mttr_s.append(now - self._down_since)
            self._down_since = None
        self.backoff.reset()
        # resume: drop queued ops the server already admitted — the
        # missed suffix is what remains, and ONLY that ships
        self._resume_filter()

    def _resume_filter(self) -> int:
        skipped = 0
        for (uuid, site_id), ops in list(self._pending.items()):
            wm = (self._server_wm.get(uuid) or {}).get(site_id)
            if not wm:
                continue
            h = (int(wm[0]), int(wm[1]))
            fresh = [t for t in ops
                     if (int(t[0][0]), int(t[0][2])) > h]
            dropped = len(ops) - len(fresh)
            if dropped:
                skipped += dropped
                self._pending_ops -= dropped
                if fresh:
                    self._pending[(uuid, site_id)] = fresh
                else:
                    del self._pending[(uuid, site_id)]
        if skipped:
            self.stats["resumed_skipped_ops"] += skipped
        return skipped

    def _recv_matching(self, seq: int) -> dict:
        """Read replies until the one matching ``seq`` (draining and
        counting stale re-acks from wire-duplicated frames)."""
        for _ in range(_STALE_REPLY_MAX):
            reply = transport.recv_msg(self._fs,
                                       timeout_s=self.read_timeout_s)
            if not isinstance(reply, dict):
                break
            if int(reply.get("seq") or 0) == seq:
                return reply
            self.stats["stale_replies"] += 1
        raise s.CausalError(
            "net: reply stream desynced",
            {"causes": {"bad-frame"}, "expected": f"seq {seq}"})

    # ----------------------------------------------------------- pump

    def pump(self, max_batches: Optional[int] = None) -> dict:
        """Drive the session one step: (re)connect when due, ship up
        to ``max_batches`` pending per-site batches (each one framed,
        CRC-tagged, acked synchronously), heartbeat when idle. Network
        failure of ANY kind degrades to the queued state + backoff —
        this method never raises for network reasons and never blocks
        longer than one read deadline."""
        now = self._now()
        if not self.connected:
            if now < self._next_dial:
                return self.status()
            try:
                self._connect()
            except (s.CausalError, OSError) as e:
                self.stats["dial_failures"] += 1
                reason = "net-unreachable"
                if isinstance(e, s.CausalError):
                    reason = next(iter(e.info.get(
                        "causes", ("net-unreachable",))))
                self._disconnect(reason)
                return self.status()
        sent = 0
        try:
            if now >= self._not_before:  # honoring a NACK's retry hint
                for (uuid, site_id) in list(self._pending):
                    if max_batches is not None and sent >= max_batches:
                        break
                    if not self._ship(uuid, site_id):
                        break  # NACK parked the session
                    sent += 1
            if (self.connected
                    and self._now() - self._last_hb >= self.heartbeat_s):
                # unconditional keepalive cadence (busy, idle, or
                # NACK-parked): the absence:net.heartbeat live rule
                # reads this evidence, and a long retry_after_ms hint
                # must not let the server idle-close a healthy,
                # merely-backpressured session
                self._heartbeat()
        except (s.CausalError, OSError) as e:
            reason = "io-error"
            if isinstance(e, s.CausalError):
                reason = next(iter(e.info.get("causes", ("io-error",))))
            self._disconnect(reason)
        return self.status()

    def _ship(self, uuid: str, site_id: str) -> bool:
        """Frame + send + await ack for one (tenant, site) batch.
        Returns False when a NACK parked the session (retry later);
        raises CausalError on transport failure (pump handles)."""
        ops = self._pending.get((uuid, site_id))
        if not ops:
            return True
        enc = serde.encode_node_items(
            {t[0]: (t[1], t[2]) for t in ops})
        crc = sync.payload_checksum(enc)
        if _chaos.enabled():
            # the payload chaos seam, post-CRC — exactly where a real
            # link corrupts (the server's validate boundary detects).
            # Site scoped per client so a committed plan can target
            # one client's stream deterministically; a bare
            # "net.delta" spec still matches via the prefix rule
            enc = _chaos.mangle_items(enc,
                                      f"net.delta.{self.client_id}")
        self._seq += 1
        seq = self._seq
        frame = {"op": "delta", "seq": seq, "uuid": uuid,
                 "site": site_id, "nodes": enc, "crc": crc}
        self.stats["sent_frames"] += 1
        if not transport.send_msg(self._fs, frame):
            # blackhole: the frame "went out" but never arrives; the
            # matching-reply read below times out and the session
            # reconnects — behave exactly like a real silent drop
            pass
        self._last_io = self._now()
        reply = self._recv_matching(seq)
        op = reply.get("op")
        if op == "ack":
            self._pending_ops -= len(ops)
            self._pending.pop((uuid, site_id), None)
            self.stats["acked_ops"] += int(reply.get("admitted") or 0)
            # ops the server suppressed as re-delivery (a lost ack's
            # resend): cleared from pending too, accounted separately
            # so minted == acked + dup_acked + resumed_skipped holds.
            # (No client-side watermark bookkeeping here: _server_wm
            # is rebuilt wholesale from the next welcome, which is
            # its only reader's input — the server owns the horizon.)
            self.stats["dup_acked_ops"] += int(reply.get("dup") or 0)
            return True
        if op == "nack":
            reason = str(reply.get("reason") or "nack")
            self.stats["nacks"][reason] = \
                self.stats["nacks"].get(reason, 0) + 1
            retry_ms = reply.get("retry_after_ms")
            retry_s = (float(retry_ms) / 1000.0
                       if isinstance(retry_ms, (int, float))
                       else _no_hint_retry_s(reason))
            self._not_before = self._now() + retry_s
            return False
        raise s.CausalError(
            "net: unexpected reply",
            {"causes": {"bad-frame"}, "got": str(op)})

    def _heartbeat(self) -> None:
        self._seq += 1
        transport.send_msg(self._fs, {"op": "ping", "seq": self._seq})
        reply = self._recv_matching(self._seq)
        if reply.get("op") != "pong":
            raise s.CausalError(
                "net: unexpected heartbeat reply",
                {"causes": {"bad-frame"}, "got": str(reply.get("op"))})
        self._last_io = self._now()
        self._last_hb = self._last_io
        self.stats["heartbeats"] += 1

    def flush(self, timeout_s: float = 30.0,
              poll_s: float = 0.01) -> bool:
        """Pump until the outbound queue is empty (True) or the
        deadline passes (False) — the soak's end-of-run drain."""
        deadline = self._now() + float(timeout_s)
        while self._pending_ops and self._now() < deadline:
            self.pump()
            if self._pending_ops:
                time.sleep(poll_s)
        return self._pending_ops == 0

    def close(self) -> None:
        if self.connected:
            try:
                transport.send_msg(self._fs, {"op": "bye"})
            except (s.CausalError, OSError):
                pass
            self._fs.close()
        self._fs = None

    def status(self) -> dict:
        return {"connected": self.connected,
                "outbound_ops": self._pending_ops,
                "connects": self.stats["connects"],
                "reconnects": self.stats["reconnects"],
                "acked_ops": self.stats["acked_ops"],
                "nacks": dict(self.stats["nacks"])}


def _no_hint_retry_s(reason: str) -> float:
    """A NACK without a hint still parks the session briefly — a hot
    retry loop against an overloaded server is the exact failure mode
    the hint exists to prevent. Poison rejects retry sooner (wire
    corruption is transient; the payload at source is clean)."""
    if reason in ("payload-invalid", "payload-checksum"):
        return 0.01
    return 0.1
