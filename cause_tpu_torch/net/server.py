"""The serve-side acceptor: inbound replication frames → admission.

A copy of ``cause_tpu.net.server``. Its replies are the reference's:
byte for byte with telemetry off, and with it on they carry the same
clock stamps.

One :class:`ReplicationServer` fronts a :class:`~cause_tpu_torch.serve
.service.SyncService` (or anything exposing its ``queue``/``tenants``
surface): it accepts long-lived client connections and turns each
inbound ``delta`` frame into one ``Admission.offer`` call, so the
WHOLE admission refusal ladder speaks wire protocol:

- a shed with ``retry_after_ms`` becomes a ``nack`` frame carrying the
  hint — backpressure propagates to the SENDER instead of ballooning
  the queue (the client honors it before re-offering);
- a poison payload NACKs through the offender machinery
  (``sync.note_reject`` → quarantine ladder), and a clean validated
  frame resets the consecutive-reject counter exactly like a sync
  round does (``sync.note_clean`` — wire corruption is transient);
- **idempotent re-delivery is suppressed by the lamport watermark**:
  the server keeps one ``{site: [ts, tx]}`` watermark per tenant —
  seeded from the write-ahead journal (the durable authority for
  everything ever wire-admitted) and advanced on each admission — and
  filters re-delivered ops below it before they reach the queue, so a
  client resending after a lost ack can never double-journal an op
  (``net.dup_ops`` evidence, exact counts);
- **wire-duplicate frames are detected and re-acked**: each connection
  carries a client sequence number; ``seq == last`` re-sends the
  stored reply (at-least-once delivery), ``seq < last`` rejects as
  out-of-order (``net.ooo_frame``) — a chaos-duplicated or reordered
  frame is evidence, never double work;
- a connection silent past the idle deadline closes server-side
  (``net.idle_close``) — heartbeat ``ping`` frames keep a
  healthy-but-quiet client alive and emit the ``net.heartbeat``
  events the default ``absence:net.heartbeat`` live rule watches.

Crash safety: the watermark registry is derived state — a restarted
server reseeds it from the journal the restored service already
replayed, so a crash between admission and ack is healed by the
client's resend landing entirely below the reseeded watermark.

Deferral caveat: the ``defer`` rung parks offers UNADMITTED server
-side and promotes them outside the wire protocol's view, so a
promotion racing a client resend could double-journal (idempotent at
merge, but it would skew the duplicate evidence). Net-facing queues
should disable cold-tenant deferral (``defer_frac=1.0`` — the net
soak's configuration); a ``defer`` outcome still NACKs with the hint.

Stdlib + sync/serde only, nothing of torch (admission is host work —
the accelerator never sees a socket: a connection thread only offers to
the queue, and the service's ticking thread alone runs the device).
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, List, Optional

from .. import obs
from .. import sync
from ..collections import shared as s
from ..obs import xtrace
from . import transport
from .transport import FrameStream

__all__ = ["ReplicationServer"]

_NACK_DEFAULT_RETRY_MS = 250.0


class _Conn:
    __slots__ = ("fs", "peer", "last_seq", "last_reply", "uuids")

    def __init__(self, fs: FrameStream, peer: str):
        self.fs = fs
        self.peer = peer
        self.last_seq = 0
        self.last_reply: Optional[dict] = None
        self.uuids: List[str] = []


class ReplicationServer:
    """See the module docstring. ``start()`` spawns the accept loop;
    every connection gets its own handler thread (admission itself is
    thread-safe — the queue's lock is the serialization point).
    ``port=0`` binds an ephemeral port (read it back from ``.port``)."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 idle_timeout_s: float = transport.DEFAULT_IDLE_TIMEOUT_S,
                 site: str = "net.server"):
        self.service = service
        self.queue = service.queue
        self.idle_timeout_s = float(idle_timeout_s)
        self.site = str(site)
        # per-tenant {site: [ts, tx]} watermarks. RLock: _admit holds
        # it across filter -> offer -> advance (one atomic admission
        # step per frame), and _watermark re-enters it for lazy
        # seeding. A welcome racing an in-flight admission therefore
        # waits for the advance — the returned watermark can never
        # understate what the journal already holds, which is the
        # "a lost ack can never double-journal" guarantee.
        self._wm: Dict[str, Dict[str, List[int]]] = {}
        self._wm_lock = threading.RLock()
        self._wm_seeded = False
        self._conns: List[_Conn] = []
        self._conns_lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._sock = socket.create_server((host, int(port)))
        self._sock.settimeout(0.25)  # accept-loop poll granularity
        self.host = host
        self.port = self._sock.getsockname()[1]
        self.stats = {
            "connections": 0, "frames": 0, "acks": 0, "nacks": 0,
            "admitted_ops": 0, "dup_frames": 0, "dup_ops_suppressed": 0,
            "ooo_frames": 0, "idle_closes": 0, "heartbeats": 0,
            "poison_nacks": 0,
        }
        self._stats_lock = threading.Lock()
        self._accept_thread: Optional[threading.Thread] = None

    def _bump(self, key: str, n: int = 1) -> None:
        """Every stats increment funnels through this lock: handler
        threads race on the counters and the net soak gates EXACT
        counts, so a lost ``+= 1`` (read-modify-write interleave) is
        a test failure, not noise. ``_bump`` takes no other lock, so
        callers may hold ``_wm_lock``/``_conns_lock`` freely."""
        with self._stats_lock:
            self.stats[key] += n

    # ---------------------------------------------------- watermarks

    def _seed_watermarks_locked(self) -> None:
        """Seed EVERY tenant's per-site lamport watermark in ONE pass
        over the write-ahead journal — the durable authority for every
        op ever wire-admitted (the restored service replayed it; the
        running service journaled it before acking). One pass, not one
        per tenant: the first hello after a crash-restore is exactly
        when a per-tenant scan under the lock would freeze admission.
        Sites absent from the journal resolve to "send everything";
        their overlap, if any, is suppressed op-by-op by the same
        watermark filter. Tenants registered later start empty — they
        have no wire history by construction. Called under _wm_lock.

        The journal is duck-typed on the ``iter_from`` contract: the
        single-file ``IngestJournal`` and the segmented
        ``WriteAheadLog`` both seed here unchanged (the WAL's scan
        spans every live segment in seq order). Segments retired by
        post-checkpoint GC held only ops every tenant has applied AND
        checkpointed, so a watermark seeded from the surviving suffix
        can be conservative (lower) but never wrong: a client that
        re-ships ops from the retired range lands merges that are
        idempotent no-ops on state the packs already carry — the
        fail-safe direction, same as a site with no journal history
        at all."""
        journal = getattr(self.queue, "journal", None)
        tenants = getattr(self.service, "tenants", {})
        if journal is not None:
            for e in journal.iter_from(0):
                uuid = str(e.get("uuid"))
                if uuid not in tenants:
                    continue
                wm = self._wm.setdefault(uuid, {})
                for it in (e.get("items") or ()):
                    try:
                        ts, site_id, tx = it[0]
                    except (TypeError, ValueError, IndexError):
                        continue
                    cur = wm.get(site_id)
                    if cur is None or (int(ts), int(tx)) > (cur[0],
                                                            cur[1]):
                        wm[site_id] = [int(ts), int(tx)]
        self._wm_seeded = True

    def _watermark(self, uuid: str) -> Optional[Dict[str, List[int]]]:
        tenants = getattr(self.service, "tenants", {})
        if uuid not in tenants:
            return None
        with self._wm_lock:
            if not self._wm_seeded:
                self._seed_watermarks_locked()
            wm = self._wm.get(uuid)
            if wm is None:
                wm = {}
                self._wm[uuid] = wm
            return wm

    # ----------------------------------------------------- lifecycle

    def start(self) -> "ReplicationServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="net-accept", daemon=True)
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
                n_open = sum(1 for c_ in self._conns
                             if not c_.fs.closed)
            if obs.enabled():
                obs.gauge("net.connections").set(n_open)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 name=f"net-conn-{conn.peer}",
                                 daemon=True)
            # prune finished handlers (and their closed conns) so a
            # long-lived server's bookkeeping stays O(open
            # connections), not O(connections ever)
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
                    causes = e.info.get("causes", ())
                    if "read-timeout" in causes:
                        # a connection with no frames for the whole
                        # idle deadline is dead weight — heartbeats
                        # keep a healthy client well inside it
                        self._bump("idle_closes")
                        if obs.enabled():
                            obs.counter("net.idle_closes").inc()
                            obs.event("net.idle_close", peer=conn.peer,
                                      idle_s=self.idle_timeout_s)
                    return
                except OSError:
                    return
                op = frame.get("op") if isinstance(frame, dict) else None
                self._bump("frames")
                try:
                    if op == "hello":
                        reply = self._welcome(conn, frame)
                    elif op == "ping":
                        reply = self._pong(conn, frame)
                    elif op == "delta":
                        reply = self._admit(conn, frame)
                    elif op == "bye":
                        return
                    else:
                        # anything else — unknown op, or a frame that
                        # is not even a dict (json.loads can yield any
                        # JSON type) — is protocol garbage: nack it,
                        # never crash the handler at the trust boundary
                        seq = (frame.get("seq", 0)
                               if isinstance(frame, dict) else 0)
                        reply = {"op": "nack", "seq": seq,
                                 "reason": "bad-frame"}
                    if reply is not None:
                        transport.send_msg(fs, reply)
                except s.CausalError:
                    # injected reset on OUR send, or a peer that died
                    # mid-reply: either way this connection is done —
                    # the client's reconnect ladder owns what's next
                    return
        finally:
            fs.close()
            with self._conns_lock:
                n_open = sum(1 for c_ in self._conns
                             if not c_.fs.closed)
            if obs.enabled():
                obs.gauge("net.connections").set(n_open)

    def _welcome(self, conn: _Conn, frame: dict) -> dict:
        uuids = frame.get("uuids")
        uuids = [str(u) for u in uuids] if isinstance(uuids, list) else []
        conn.uuids = uuids
        wm = {}
        unknown = []
        for uuid in uuids:
            w = self._watermark(uuid)
            if w is None:
                unknown.append(uuid)
            else:
                wm[uuid] = {site: list(h) for site, h in w.items()}
        if obs.enabled():
            # net.hello, NOT net.connect: the server answers a hello
            # on every RE-connect too, so counting it as a connect
            # would inflate the client-side connect/reconnect
            # arithmetic the evidence gates read from a shared stream
            obs.counter("net.hellos").inc()
            obs.event("net.hello", peer=conn.peer,
                      client=str(frame.get("client") or ""),
                      tenants=len(wm), unknown=len(unknown))
        reply = {"op": "welcome", "wm": wm, "unknown": unknown}
        if obs.enabled():
            # wall-clock stamp for the client's NTP-style offset
            # estimate (xtrace.clock_sample); obs-off replies stay
            # byte-identical
            reply.update(xtrace.reply_stamp())
        return reply

    def _seq_guard(self, conn: _Conn, seq: int) -> Optional[dict]:
        """The per-connection at-least-once guard, shared by pings
        and deltas (one seq space): a repeated seq is a WIRE
        DUPLICATE — counted, the stored reply re-sent, nothing
        re-done; an older seq is out-of-order — rejected. None means
        the frame is fresh."""
        if seq == conn.last_seq and conn.last_reply is not None:
            self._bump("dup_frames")
            if obs.enabled():
                obs.counter("net.dup_frames").inc()
                obs.event("net.dup_frame", seq=seq, peer=conn.peer)
            return dict(conn.last_reply)
        if seq <= conn.last_seq:
            self._bump("ooo_frames")
            if obs.enabled():
                obs.counter("net.ooo_frames").inc()
                obs.event("net.ooo_frame", seq=seq,
                          last_seq=conn.last_seq, peer=conn.peer)
            return {"op": "nack", "seq": seq, "reason": "out-of-order"}
        return None

    def _pong(self, conn: _Conn, frame: dict) -> dict:
        seq = int(frame.get("seq") or 0)
        guarded = self._seq_guard(conn, seq)
        if guarded is not None:
            return guarded
        self._bump("heartbeats")
        if obs.enabled():
            obs.counter("net.heartbeats").inc()
            obs.event("net.heartbeat", peer=conn.peer, side="server")
        reply = {"op": "pong", "seq": seq}
        if obs.enabled():
            # heartbeat = recurring clock-offset sample (see _welcome)
            reply.update(xtrace.reply_stamp())
        conn.last_seq = seq
        conn.last_reply = dict(reply)
        return reply

    def _nack(self, seq: int, reason: str,
              retry_after_ms: Optional[float] = None,
              uuid: str = "", site: str = "") -> dict:
        self._bump("nacks")
        reply = {"op": "nack", "seq": seq, "reason": reason}
        if retry_after_ms is not None:
            reply["retry_after_ms"] = retry_after_ms
        if obs.enabled():
            obs.counter("net.nacks").inc()
            fields = {"seq": seq, "reason": reason, "uuid": uuid,
                      "site": site}
            if retry_after_ms is not None:
                fields["retry_after_ms"] = retry_after_ms
            obs.event("net.nack", **fields)
        return reply

    def _admit(self, conn: _Conn, frame: dict) -> dict:
        seq = int(frame.get("seq") or 0)
        guarded = self._seq_guard(conn, seq)
        if guarded is not None:
            return guarded
        uuid = str(frame.get("uuid") or "")
        site = str(frame.get("site") or "")
        items = frame.get("nodes")
        conn.last_seq = seq

        def finish(reply: dict) -> dict:
            conn.last_reply = dict(reply)
            return reply

        # --- the trust boundary (validate BEFORE the watermark filter
        # reads ids out of the payload)
        try:
            sync.validate_node_items(items)
            crc = frame.get("crc")
            if crc is not None \
                    and sync.payload_checksum(items) != crc:
                raise s.CausalError(
                    "sync payload rejected",
                    {"causes": {"payload-checksum"},
                     "why": "checksum mismatch"})
            if any(it[0][1] != site for it in items):
                # the protocol ships per-site batches; a frame whose
                # ops claim another site is tampered, not mis-routed
                raise s.CausalError(
                    "sync payload rejected",
                    {"causes": {"payload-invalid"},
                     "why": "op site != frame site"})
        except s.CausalError as e:
            why = next(iter(e.info.get("causes", ("payload-invalid",))))
            self._bump("poison_nacks")
            sync.note_reject(site, uuid=uuid, why=why)
            return finish(self._nack(seq, why, uuid=uuid, site=site))
        # --- trace continuation: an obs-on client attached
        # wire contexts; continue each chain with a "recv" hop and
        # hand the trace ids to admission so journal/tick/wave hops
        # stay linked. Garbage ctx degrades to an untraced frame —
        # never an exception on the admission path. Runs AFTER the
        # validate boundary: a poison frame earns no hops.
        traces: List[str] = []
        if obs.enabled():
            raw_ctx = frame.get("ctx")
            if isinstance(raw_ctx, list):
                for c in raw_ctx[:16]:
                    tr, parent = xtrace.continue_from(c)
                    if not tr:
                        continue
                    xtrace.hop("recv", tr, parent=parent,
                               peer=conn.peer, seq=seq, uuid=uuid,
                               site=site)
                    ids = c.get("ids")
                    if isinstance(ids, list):
                        # bind this batch's op ids server-side so the
                        # lag tracer's converged/apply hops and the
                        # op.lag trace field can join (suppressed ids
                        # bind too — harmless, they never re-apply)
                        xtrace.bind_ops(
                            tr, [tuple(i) for i in ids[:64]
                                 if isinstance(i, list)
                                 and len(i) == 3])
                    traces.append(tr)
        # --- idempotent re-delivery: the lamport watermark filter.
        # Filter -> offer -> advance runs ATOMICALLY under the
        # watermark lock: a client that reconnects while an old
        # handler thread sits between the journal append and the
        # advance must not be handed a stale welcome watermark and
        # re-ship ops the journal already holds (double-journaled —
        # idempotent at merge, but it would corrupt the duplicate
        # evidence and the oracle's entry count). Lock order is
        # _wm_lock -> queue lock; nothing takes them in reverse.
        with self._wm_lock:
            wm = self._watermark(uuid)
            if wm is None:
                return finish(self._nack(seq, "unknown-tenant",
                                         uuid=uuid, site=site))
            horizon = wm.get(site)
            h = (horizon[0], horizon[1]) if horizon else (-1, -1)
            kept = [it for it in items
                    if (int(it[0][0]), int(it[0][2])) > h]
            suppressed = len(items) - len(kept)
            if suppressed:
                self._bump("dup_ops_suppressed", suppressed)
                if obs.enabled():
                    obs.counter("net.dup_suppressed").inc(suppressed)
                    obs.event("net.dup_ops", ops=suppressed,
                              uuid=uuid, site=site, seq=seq)
            if not kept:
                sync.note_clean(site)
                self._bump("acks")
                return finish({"op": "ack", "seq": seq, "admitted": 0,
                               "dup": suppressed})
            adm = self.queue.offer(uuid, site, kept,
                                   traces=traces or None)
            if adm.admitted:
                last = kept[-1][0]
                wm[site] = [int(last[0]), int(last[2])]
        if adm.admitted:
            sync.note_clean(site)
            self._bump("acks")
            self._bump("admitted_ops", len(kept))
            if obs.enabled():
                obs.counter("net.admitted_ops").inc(len(kept))
            return finish({"op": "ack", "seq": seq,
                           "admitted": len(kept), "dup": suppressed})
        # a refusal at any rung becomes a wire NACK carrying the
        # backpressure hint — overload flows back to the sender
        retry = adm.retry_after_ms
        if retry is None and adm.rung in ("reject", "defer"):
            retry = _NACK_DEFAULT_RETRY_MS
        return finish(self._nack(seq, adm.reason or adm.rung,
                                 retry_after_ms=retry,
                                 uuid=uuid, site=site))
