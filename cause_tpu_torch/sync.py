"""Anti-entropy sync: converge replicas over any byte stream.

The reference's distributed story is "the CRDT is the protocol" — any
transport that moves immutable nodes between sites converges
(reference: README.md:5), with actual p2p sync transports left as a
roadmap wish (README.md:237-238). This package ships one (a copy of
``cause_tpu.sync``): version-vector delta sync at the collection level.

The yarn cache (per-site, time-sorted node lists — shared.cljc:64-65)
IS a version vector: ``{site: newest ts}``. A sync round is then

1. exchange version vectors (one small frame each way);
2. send the nodes the peer hasn't seen (everything in each yarn above
   the peer's entry — per-site suffixes, straight off the yarn cache);
3. apply the received delta as a merge (all the append-only /
   cause-must-exist / uuid guards come from the normal merge path, so
   a malicious or corrupt delta is rejected exactly like a bad
   ``insert``).

Deltas assume the per-site prefix property (a replica holding a site's
node at ts T holds all of that site's nodes below T), which this
protocol itself preserves — anything else (e.g. a weft-truncated past)
fails cause-must-exist and triggers the full-bag fallback frame.

Frames are length-prefixed JSON (serde's tagged encoding), so the same
session runs over sockets, pipes, files, or an in-memory loopback —
and the payloads are exactly the "bag of nodes" the reference
checkpoints (README.md:19).

On the device weaver (``weaver="torch"``) every applied delta is one
union and one full reweave (``merge_many``), so each side of a round
runs the B1, B2 and B3 kernels once. The telemetry the reference
records along the way (sync events, cost model, convergence lag,
distributed traces) comes with the telemetry port.
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from typing import Dict, Optional, Tuple

from . import chaos as _chaos
from . import serde
from .collections import shared as s

__all__ = [
    "version_vector",
    "delta_nodes",
    "shadow",
    "apply_delta",
    "payload_checksum",
    "validate_node_items",
    "is_quarantined",
    "any_quarantined",
    "quarantined",
    "note_reject",
    "note_clean",
    "readmit",
    "quarantine_reset",
    "send_frame",
    "recv_frame",
    "exchange_frame",
    "sync_stream",
    "sync_pair",
    "sync_base_pair",
]

_HDR = struct.Struct("!I")
MAX_FRAME = 1 << 28  # 256 MB: fail loudly on a corrupt length prefix
# how long a completed receive waits for our own send to drain before
# declaring the peer wedged (generous: full-bag frames on slow uplinks
# legitimately take minutes)
SEND_DRAIN_TIMEOUT = 600.0
# consecutive rejected payloads from one peer before it is quarantined
# out of delta exchanges (and device waves) until a clean validated
# full-bag resync re-admits it
QUARANTINE_AFTER = 3


def version_vector(handle) -> Dict[str, list]:
    """{site: [ts, tx_index] of the newest node} off the yarn cache.
    The tx index matters: ids are (ts, site, tx) and one transaction
    mints same-ts runs, so a ts-only vector would hide a peer stuck
    mid-run (same ts, lower tx) and silently never heal it."""
    return {
        site: [yarn[-1][0][0], yarn[-1][0][2]]
        for site, yarn in handle.ct.yarns.items()
        if yarn
    }


def delta_nodes(handle, peer_vv: Dict[str, list]) -> dict:
    """The nodes the peer hasn't seen: each yarn's suffix above the
    peer's version-vector entry (binary search per yarn — yarns are
    time-sorted; entries compare as (ts, tx))."""
    out = {}
    for site, yarn in handle.ct.yarns.items():
        h = peer_vv.get(site)
        horizon = (int(h[0]), int(h[1])) if h else (-1, -1)
        if not yarn or (yarn[-1][0][0], yarn[-1][0][2]) <= horizon:
            continue
        lo, hi = 0, len(yarn)
        while lo < hi:
            mid = (lo + hi) // 2
            if (yarn[mid][0][0], yarn[mid][0][2]) <= horizon:
                lo = mid + 1
            else:
                hi = mid
        for nid, cause, value in yarn[lo:]:
            out[nid] = (cause, value)
    return out


def shadow(handle, nodes: dict):
    """A same-type handle carrying exactly ``nodes`` — the merge-ready
    container for a received delta. Not a valid standalone tree (causes
    may point outside); only feed it to ``handle.merge``, which unions
    and validates against the receiver."""
    return type(handle)(handle.ct.evolve(nodes=dict(nodes)))


def apply_delta(handle, nodes: dict):
    """Merge a received delta into ``handle`` (no-op for an empty
    delta). Raises CausalError exactly like a local merge would on
    append-only conflicts, uuid mismatch, or missing causes.

    Path choice matters on the default pure weaver: ``merge`` replays
    the delta incrementally (O(delta x doc) — right for anti-entropy's
    steady state of small deltas into large docs), while ``merge_many``
    does one union + one full reweave (O(doc^2) pure, but the fast
    path under the device weaver and for bulk deltas). Small deltas on
    the pure backend take the incremental path; everything else takes
    the one-pass union (on ``weaver="torch"``, a device reweave)."""
    if not nodes:
        return handle
    sh = shadow(handle, nodes)
    incremental = (handle.ct.weaver == "pure"
                   and len(nodes) * 8 < len(handle.ct.nodes))
    return handle.merge(sh) if incremental else handle.merge_many([sh])


# ---------------------------------------------- validate-before-apply
#
# A sync payload crosses a trust boundary (a socket, a pipe, a
# chaos-mangled loopback). Before this layer existed, a corrupted or
# truncated payload either raised a bare TypeError deep inside the
# weave (decode succeeded, the merge choked on a malformed id) or —
# worse — merged cleanly and poisoned the document. Every ingest now
# validates STRUCTURE (triple shape, id types, canonical sort order,
# duplicate ids) and, on framed transports, a CRC32 checksum, and a
# failing payload is REJECTED at the boundary with a ``sync.reject``
# event: the document is untouched and the round degrades to the
# full-bag resync it already knew how to run.


def payload_checksum(encoded_items: list) -> int:
    """CRC32 over the canonical JSON of an encoded node-items payload
    (``serde.encode_node_items`` output) — the integrity tag delta and
    full frames carry as ``crc``."""
    blob = json.dumps(encoded_items, separators=(",", ":"),
                      allow_nan=False).encode()
    return zlib.crc32(blob) & 0xFFFFFFFF


def _valid_id(enc) -> bool:
    return (isinstance(enc, (list, tuple)) and len(enc) == 3
            and isinstance(enc[0], int) and not isinstance(enc[0], bool)
            and isinstance(enc[1], str) and enc[1] != ""
            and isinstance(enc[2], int) and not isinstance(enc[2], bool)
            and enc[0] >= 0 and enc[2] >= 0)


def validate_node_items(data) -> None:
    """Structural validation of an encoded node-items payload, raising
    ``CausalError`` (causes ``{"payload-invalid"}``) on the first
    violation. Checks per item: ``[id, cause, value]`` triple shape,
    id = ``[ts >= 0, nonempty site str, tx >= 0]``, id-shaped causes
    well-formed; payload-wide: ids strictly increasing (the canonical
    ``encode_node_items`` sort — a reordered payload was tampered
    with) and therefore unique (a duplicated id ditto)."""

    def bad(why: str, index: Optional[int] = None):
        info = {"causes": {"payload-invalid"}, "why": why}
        if index is not None:
            info["index"] = index
        return s.CausalError("sync payload rejected", info)

    if not isinstance(data, list):
        raise bad("payload is not a list")
    prev = None
    for i, item in enumerate(data):
        if not isinstance(item, (list, tuple)) or len(item) != 3:
            raise bad("node triple malformed", i)
        enc_id, enc_cause, _value = item
        if not _valid_id(enc_id):
            raise bad("node id malformed", i)
        # a cause is an id (positional list) or a tagged value (map
        # keys); a LIST-shaped cause must be id-shaped — anything else
        # would decode into garbage the weave chokes on later
        if isinstance(enc_cause, (list, tuple)) and not _valid_id(
                enc_cause):
            raise bad("cause id malformed", i)
        key = (enc_id[0], enc_id[1], enc_id[2])
        if prev is not None and key <= prev:
            raise bad("ids out of canonical order (reordered or "
                      "duplicated payload)", i)
        prev = key


def checked_decode(frame_nodes, crc: Optional[int] = None) -> dict:
    """Validate-then-decode one payload: structure first, checksum (if
    the frame carried one) second, ``serde.decode_node_items`` last.
    Raises ``CausalError`` with ``payload-invalid`` / ``payload-
    checksum`` causes instead of letting a poisoned payload reach the
    merge."""
    validate_node_items(frame_nodes)
    if crc is not None and payload_checksum(frame_nodes) != crc:
        raise s.CausalError(
            "sync payload rejected",
            {"causes": {"payload-checksum"},
             "why": "checksum mismatch"},
        )
    try:
        return serde.decode_node_items(frame_nodes)
    except Exception:  # noqa: BLE001 - decode of validated shape
        raise s.CausalError(
            "sync payload rejected",
            {"causes": {"payload-invalid"}, "why": "undecodable"},
        ) from None


def _is_payload_reject(e: s.CausalError) -> bool:
    return bool({"payload-invalid", "payload-checksum"}
                & set(e.info.get("causes", ())))


# ------------------------------------------------ replica quarantine
#
# Repeat offenders: a peer whose payloads keep failing validation is
# either corrupt or hostile; after QUARANTINE_AFTER consecutive
# rejects it is quarantined — delta exchanges skip it (straight to
# the validated full-bag resync) and merge_wave routes its pairs to
# the fully-validating host merge instead of the device kernel. A
# clean full-bag resync re-admits it (``sync.readmit``). The registry
# is process-wide, keyed by the peer replica's site id.

_Q_LOCK = threading.Lock()
_REJECTS: Dict[str, int] = {}   # peer site id -> consecutive rejects
_QUARANTINED: set = set()


def note_reject(peer: str, uuid: str = "", why: str = "") -> int:
    """Record one rejected payload from ``peer``; quarantines it at
    QUARANTINE_AFTER consecutive rejects. Returns the consecutive
    count. ``uuid`` and ``why`` name the document and the reject for
    the telemetry port (the reference's ``sync.reject`` event)."""
    peer = str(peer or "")
    if not peer:
        return 1
    with _Q_LOCK:
        n = _REJECTS.get(peer, 0) + 1
        _REJECTS[peer] = n
        if n >= QUARANTINE_AFTER:
            _QUARANTINED.add(peer)
    return n


def note_clean(peer: str) -> None:
    """A validated payload from ``peer`` landed: the consecutive
    -reject counter resets (quarantine itself only lifts via
    :func:`readmit`). Public: a server's ingest boundary resets
    offenders exactly like a sync round does (a wire corruption is
    transient; only CONSECUTIVE rejects quarantine)."""
    peer = str(peer or "")
    if not peer:
        return
    with _Q_LOCK:
        _REJECTS.pop(peer, None)


def readmit(peer: str, uuid: str = "") -> bool:
    """Lift ``peer``'s quarantine after a clean validated full-bag
    resync; returns whether it was quarantined. A full bag from a peer
    that is NOT quarantined changes nothing — in particular it does not
    reset the consecutive-reject count, or a repeat offender whose
    every reject heals over a full bag could never cross the
    threshold."""
    peer = str(peer or "")
    with _Q_LOCK:
        was = peer in _QUARANTINED
        if was:
            _QUARANTINED.discard(peer)
            _REJECTS.pop(peer, None)
    return was


def is_quarantined(peer) -> bool:
    with _Q_LOCK:
        return str(peer or "") in _QUARANTINED


def any_quarantined() -> bool:
    """Cheap wave-path guard: True iff any replica is quarantined
    (merge_wave checks per-pair only past this)."""
    return bool(_QUARANTINED)


def quarantined() -> frozenset:
    with _Q_LOCK:
        return frozenset(_QUARANTINED)


def quarantine_reset() -> None:
    """Drop all quarantine/offender state (tests)."""
    with _Q_LOCK:
        _REJECTS.clear()
        _QUARANTINED.clear()


def send_frame(stream, obj: dict) -> None:
    payload = json.dumps(obj, allow_nan=False).encode()
    stream.write(_HDR.pack(len(payload)) + payload)
    stream.flush()


def _read_exact(stream, n: int) -> bytes:
    """Accumulate exactly ``n`` bytes. Raw sockets and unbuffered pipes
    may legally return short reads; only an empty read means EOF. A
    stream whose deadline expires (a socket with a timeout set, or the
    net transport's ``FrameStream``) raises the protocol's uniform
    ``read-timeout`` CausalError instead of leaking ``TimeoutError`` —
    the caller treats both as "this peer is dead, degrade/reconnect"."""
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = stream.read(n - got)
        except TimeoutError:
            # socket.timeout is TimeoutError since 3.10: a silent peer
            # on a deadline-armed stream is a protocol outcome, not a
            # crash — reject uniformly so every caller's except
            # CausalError ladder (full-bag retry, transport reconnect)
            # handles it
            raise s.CausalError(
                "sync read deadline exceeded",
                {"causes": {"read-timeout"}},
            ) from None
        if not chunk:
            raise s.CausalError("sync stream closed mid-frame",
                                {"causes": {"eof"}})
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _arm_deadline(stream, timeout_s: Optional[float]) -> None:
    """Arm a read deadline on a stream that supports one (sockets and
    the net transport's ``FrameStream`` expose ``settimeout``; plain
    buffered file objects don't — for those, set the timeout on the
    underlying socket BEFORE ``makefile()`` and ``_read_exact`` maps
    the raised ``TimeoutError`` to the uniform reject)."""
    if timeout_s is None:
        return
    settimeout = getattr(stream, "settimeout", None)
    if settimeout is not None:
        settimeout(float(timeout_s))


def recv_frame(stream, timeout_s: Optional[float] = None) -> dict:
    _arm_deadline(stream, timeout_s)
    (n,) = _HDR.unpack(_read_exact(stream, _HDR.size))
    if n > MAX_FRAME:
        raise s.CausalError("sync frame too large",
                            {"causes": {"frame-overflow"}, "size": n})
    return json.loads(_read_exact(stream, n))


def exchange_frame(stream, obj: dict,
                   read_timeout_s: Optional[float] = None) -> dict:
    """Send ``obj`` and receive the peer's frame CONCURRENTLY. Both
    sync endpoints are symmetric (each sends, then expects the peer's
    frame of the same kind); writing a large frame before reading
    would deadlock once the two frames exceed the transport buffers,
    so the write happens on a helper thread while this thread reads."""
    err = []

    def _send():
        try:
            send_frame(stream, obj)
        except Exception as e:  # noqa: BLE001 - surfaced below
            err.append(e)

    t = threading.Thread(target=_send, daemon=True)
    t.start()
    try:
        got = recv_frame(stream, timeout_s=read_timeout_s)
        # bounded even on success: a peer that answered and then
        # stopped draining would otherwise hang this join forever. The
        # bound is generous (SEND_DRAIN_TIMEOUT) because a slow uplink
        # legitimately takes minutes for a full-bag frame — only a
        # genuinely wedged peer should trip it.
        t.join(timeout=SEND_DRAIN_TIMEOUT)
        if t.is_alive():
            raise s.CausalError(
                "sync peer stopped draining mid-frame",
                {"causes": {"send-stalled"}},
            )
    except BaseException:
        # The receive failed (bad frame, uuid mismatch, EOF). The
        # writer may be blocked on a transport buffer the peer will
        # never drain; it's a daemon thread, so give it a short grace
        # period and surface the receive error either way.
        t.join(timeout=1.0)
        raise
    if err:
        if isinstance(err[0], TimeoutError):
            # the armed deadline is socket-wide, so a peer that stops
            # DRAINING can time out our send thread too — map it to
            # the same uniform CausalError family the read path uses,
            # or the caller's except-CausalError degrade ladder would
            # miss it and crash on a bare TimeoutError
            raise s.CausalError(
                "sync peer stopped draining mid-frame",
                {"causes": {"send-stalled"}},
            ) from err[0]
        raise err[0]
    return got


def sync_stream(handle, stream, read_timeout_s: Optional[float] = None):
    """One symmetric anti-entropy round over a duplex byte stream (a
    socket ``makefile('rwb')``, a pipe pair, ...). Both ends call this;
    returns the converged handle.

    Round: exchange hello {uuid, type, vv} (uuid and type must match)
    / exchange deltas / merge. If either side flags that a delta was
    inapplicable (non-prefix history, e.g. a weft), fall back to
    exchanging the full bag of nodes. Every exchange is concurrent
    send+recv (``exchange_frame``) so arbitrarily large frames cannot
    deadlock the symmetric protocol.

    ``read_timeout_s`` is the transport's read deadline: a
    peer that connects and then goes silent used to wedge the reader
    forever on the first blocking receive — with a deadline armed, the
    round rejects with the uniform ``read-timeout`` CausalError
    instead. The deadline is armed through the stream's ``settimeout``
    when it has one (sockets, the net transport's ``FrameStream``);
    buffered ``makefile()`` streams should arm the timeout on the
    underlying socket instead — either way the raised ``TimeoutError``
    maps to the same reject (tests/test_sync.py pins both spellings).
    """
    ct = handle.ct
    _arm_deadline(stream, read_timeout_s)
    hello = exchange_frame(stream, {
        "op": "hello", "uuid": ct.uuid, "type": ct.type,
        # sender identity for the offender/quarantine registry (an
        # old peer without it just gets no quarantine bookkeeping)
        "site": ct.site_id,
        "vv": version_vector(handle),
    })

    def frame_field(frame, op, key):
        # a malformed frame is protocol corruption, not a crash: wrong
        # op, wrong JSON shape, or missing fields all reject uniformly
        if not isinstance(frame, dict) or frame.get("op") != op:
            raise s.CausalError(
                "sync protocol error",
                {"causes": {"bad-frame"}, "expected": op},
            )
        try:
            return frame[key]
        except (KeyError, TypeError):
            raise s.CausalError(
                "sync protocol error",
                {"causes": {"bad-frame"}, "expected": op,
                 "missing": key},
            ) from None

    def nodes_frame(op, nodes_map, mangle_site):
        """An outbound node-carrying frame: canonical encoding, CRC
        computed over the TRUE payload, then the chaos transport
        mangle (after the CRC, exactly where a real link corrupts) —
        so every injected payload fault is detectable."""
        enc = serde.encode_node_items(nodes_map)
        frame = {"op": op, "nodes": enc, "crc": payload_checksum(enc)}
        if _chaos.enabled():
            frame["nodes"] = _chaos.mangle_items(enc, mangle_site)
        return frame

    if (frame_field(hello, "hello", "uuid") != ct.uuid
            or frame_field(hello, "hello", "type") != ct.type):
        raise s.CausalError(
            "Causal UUID missmatch. Merge not allowed.",
            {"causes": {"uuid-missmatch"},
             "uuids": [ct.uuid, hello.get("uuid")]},
        )
    peer_site = hello.get("site")
    peer_site = peer_site if isinstance(peer_site, str) else ""
    peer_vv = frame_field(hello, "hello", "vv")
    if not (isinstance(peer_vv, dict) and all(
            isinstance(site, str)
            and isinstance(h, (list, tuple)) and len(h) == 2
            and all(isinstance(x, int) and not isinstance(x, bool)
                    for x in h)
            for site, h in peer_vv.items())):
        raise s.CausalError(
            "sync protocol error",
            {"causes": {"bad-frame"}, "expected": "hello",
             "missing": "vv"},
        )
    delta = exchange_frame(
        stream,
        nodes_frame("delta", delta_nodes(handle, peer_vv),
                    "sync.delta"),
    )
    ok = True
    reason = None
    if peer_site and is_quarantined(peer_site):
        # quarantined peer: its deltas are not trusted — go straight
        # to the validated full-bag resync, which is also its one
        # road back in (readmission below)
        ok = False
        reason = "quarantined"
        merged = handle
    else:
        try:
            merged = apply_delta(
                handle,
                checked_decode(frame_field(delta, "delta", "nodes"),
                               delta.get("crc")))
            note_clean(peer_site)
        except s.CausalError as e:
            if _is_payload_reject(e):
                # the validate-before-apply boundary: the poisoned
                # payload never reached the merge; the document is
                # untouched and the round heals over the full bag
                ok = False
                reason = "payload-reject"
                merged = handle
                note_reject(peer_site, uuid=ct.uuid,
                            why=next(iter(
                                e.info.get("causes", ("payload",)))))
            elif "cause-must-exist" in e.info.get("causes", ()):
                ok = False
                merged = handle
            else:
                raise
    # prefix-gap / reject fallback: ask for (and offer) the full bag
    peer_state = exchange_frame(stream, {"op": "done" if ok else "resync"})
    if (not isinstance(peer_state, dict)
            or peer_state.get("op") not in ("done", "resync")):
        raise s.CausalError(
            "sync protocol error",
            {"causes": {"bad-frame"}, "expected": "done|resync"},
        )
    if peer_state.get("op") == "resync" or not ok:
        full = exchange_frame(
            stream, nodes_frame("full", dict(ct.nodes), "sync.full"))
        try:
            merged = apply_delta(
                merged,
                checked_decode(frame_field(full, "full", "nodes"),
                               full.get("crc")))
        except s.CausalError as e:
            if _is_payload_reject(e):
                # a poisoned FULL bag cannot heal this round: reject
                # at the boundary (document untouched) and surface it
                # — the next round retries the resync
                note_reject(peer_site, uuid=ct.uuid,
                            why=next(iter(
                                e.info.get("causes", ("payload",)))))
            raise
        # a clean validated full bag re-admits a quarantined peer —
        # but ONLY on the dedicated resync road (a round that STARTED
        # quarantined): the full bag healing the very round whose
        # rejects caused the quarantine must not instantly undo it,
        # or quarantine would never outlive one protocol round
        if peer_site and reason == "quarantined":
            readmit(peer_site, uuid=ct.uuid)
    return merged


def sync_pair(a, b) -> Tuple[object, object]:
    """In-memory anti-entropy between two handles (the loopback twin of
    ``sync_stream`` — same vv/delta/full-bag-fallback path, no
    framing)."""
    va, vb = version_vector(a), version_vector(b)

    def full_bag(dst, src, reason):
        out = apply_delta(dst, dict(src.ct.nodes))
        # the in-memory full bag comes straight off the live peer
        # handle (already merge-validated state): it is the
        # quarantine's validated exit ramp — but only on the
        # dedicated resync road (reason "quarantined"), never the
        # same-round heal of the reject that caused the quarantine
        if reason == "quarantined":
            readmit(src.ct.site_id, uuid=dst.ct.uuid)
        return out

    def one_way(dst, src, dst_vv):
        peer = src.ct.site_id
        if is_quarantined(peer):
            return full_bag(dst, src, "quarantined")
        nodes = delta_nodes(src, dst_vv)
        if _chaos.enabled() and nodes:
            # the loopback's transport seam: round-trip the delta
            # through the wire encoding so payload faults (and the
            # validate-before-apply boundary) exercise exactly like a
            # framed stream — chaos-off loopbacks never pay this
            enc = serde.encode_node_items(nodes)
            crc = payload_checksum(enc)
            mangled = _chaos.mangle_items(enc, "sync.delta")
            try:
                nodes = checked_decode(mangled, crc)
                note_clean(peer)
            except s.CausalError as e:
                if not _is_payload_reject(e):
                    raise
                note_reject(peer, uuid=dst.ct.uuid,
                            why=next(iter(
                                e.info.get("causes", ("payload",)))))
                return full_bag(dst, src, "payload-reject")
        try:
            return apply_delta(dst, nodes)
        except s.CausalError as e:
            if "cause-must-exist" not in e.info.get("causes", ()):
                raise
            # non-prefix history (weft, gapped replica): full bag
            return full_bag(dst, src, "cause-must-exist")

    return one_way(a, b, va), one_way(b, a, vb)


def sync_base_pair(a, b) -> Tuple[object, object]:
    """Anti-entropy between two replicas of one CausalBase: sync every
    shared collection pairwise, copy collections the peer lacks, union
    the history logs, and fast-forward the shared clock. Site ids and
    undo/redo cursors stay per-replica (undo inverts only the local
    site's transactions, base/core.cljc:354-369, so remote cursors are
    meaningless here).

    Replicas must fork AFTER the base's root collection exists: two
    sides that each ran their first transaction independently minted
    different root collections, which cannot converge (raised as a
    CausalError, same stance as the uuid merge guard)."""
    ca, cb_ = a.cb, b.cb
    if ca.uuid != cb_.uuid:
        raise s.CausalError(
            "Causal UUID missmatch. Merge not allowed.",
            {"causes": {"uuid-missmatch"}, "uuids": [ca.uuid, cb_.uuid]},
        )
    if (ca.root_uuid and cb_.root_uuid
            and ca.root_uuid != cb_.root_uuid):
        raise s.CausalError(
            "Replicas created their root collections independently.",
            {"causes": {"root-missmatch"},
             "roots": [ca.root_uuid, cb_.root_uuid]},
        )
    root_uuid = ca.root_uuid or cb_.root_uuid

    cols_a = dict(ca.collections)
    cols_b = dict(cb_.collections)
    for uuid in set(cols_a) | set(cols_b):
        ha, hb = cols_a.get(uuid), cols_b.get(uuid)
        if ha is not None and hb is not None:
            ha2, hb2 = sync_pair(ha, hb)
            cols_a[uuid], cols_b[uuid] = ha2, hb2
        elif ha is None:
            cols_a[uuid] = hb
        else:
            cols_b[uuid] = ha

    history = sorted(
        {(tuple(nid), uuid) for nid, uuid in ca.history}
        | {(tuple(nid), uuid) for nid, uuid in cb_.history}
    )
    ts = max(ca.lamport_ts, cb_.lamport_ts)
    base_cls = type(a)
    a2 = base_cls(ca.evolve(collections=cols_a, history=list(history),
                            lamport_ts=ts, root_uuid=root_uuid))
    b2 = base_cls(cb_.evolve(collections=cols_b, history=list(history),
                             lamport_ts=ts, root_uuid=root_uuid))
    return a2, b2
