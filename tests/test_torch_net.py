"""The port's replication transport, client and server against the JAX
package's.

Mirrors ``tests/test_net.py``: each scenario runs in both packages
(``test_torch_serve.both``) over real loopback sockets, with the same
documents, site ids and minted ops, and returns what it observed —
replies, acked/admitted/suppressed counts, journal ids and the
materialized document; the port's record must equal the reference's.
Also mirrors the ``FrameStream`` halves of ``tests/test_sync.py:279``
(``test_sync_stream_read_deadline_on_silent_peer``) and ``:316``
(``test_sync_stream_deadline_does_not_break_healthy_rounds``), and
crosses the packages on the wire: a port ``NetClient`` replicating into
a reference ``ReplicationServer`` and the reverse, to equal documents.

Cases of ``tests/test_net.py`` that read telemetry events keep their
event-free half under the reference's name; their event half
(``net.*`` and ``sync.reject``) is a second case, ``<name>_obs``, which
runs the same scenario with telemetry on in both packages and holds the
port's stream equal to the reference's (``test_torch_serve.twin_events``,
as multisets: the server's connection threads write beside the
client). The live-fold and dashboard cases
(``test_live_fold_net_section_and_flap_rule``,
``test_net_default_rules_inert_without_net_activity``,
``test_net_heartbeat_absence_fires_on_active_transport``,
``test_watch_renders_net_line_and_prometheus``) are mirrored whole, and
so are the wire cases of ``tests/test_xtrace.py`` (a batch's journey
across the wire, a client without trace contexts, a server without
clock stamps), each as twins and then across the packages.
"""

import socket
import sys
import threading
import time

import pytest

from test_torch_serve import (PORT, REF, _fresh_state, base, both,  # noqa: F401
                              edn, obs_twin, site, twin_events)


def _service(P, root, max_ops=256, d_max=16, n_tenants=1):
    """One SyncService and its tenants, deferral disabled (the server's
    caveat for net-facing queues), each tenant a fresh document."""
    q = P.IngestQueue(max_ops=max_ops, defer_frac=1.0,
                      journal=P.IngestJournal(str(root / "wal.jsonl")))
    svc = P.SyncService(q, checkpoint_dir=str(root), d_max=d_max)
    uuids, pairs = [], {}
    for i in range(n_tenants):
        b = base(P, 12, uuid=f"net-{i:08d}")
        a = P.CausalList(b.ct.evolve(site_id=site("A", i))).conj(f"A{i}")
        r = P.CausalList(b.ct.evolve(site_id=site("B", i))).conj(f"B{i}")
        uuid = svc.add_tenant(a, r)
        uuids.append(uuid)
        pairs[uuid] = (a, r)
    return svc, uuids, pairs


def _mint(P, st, n, start_ts=1000, cause=None):
    """``n`` chained ops on one site (a thin producer's yarn)."""
    out = []
    last = cause if cause is not None else P.root_id
    ts = start_ts
    for _ in range(n):
        ts += 1
        nid = (ts, st, 0)
        out.append((nid, last, f"op{ts}"))
        last = nid
    return out


# a heartbeat interval no scenario reaches: a heartbeat fires on wall
# time (the first reference tick compiles for seconds), so a scenario
# whose stream is compared across the packages keeps heartbeats out
_NO_HEARTBEAT = 3600.0


def _journal_entries(P, path):
    jr = P.IngestJournal(path)
    entries = sorted(jr.iter_from(0), key=lambda e: int(e["seq"]))
    jr.close()
    return entries


def _apply(P, h, nodes):
    """The oracle's replay: the full-bag spelling, which records no
    ``sync.delta_apply``, in both packages."""
    return P.sync.apply_delta(h, nodes, _count_as_delta=False)


def _pure_oracle(P, pairs, path):
    """The fault-free single-process oracle: each tenant's pure pair
    merge plus a pure replay of the whole write-ahead journal."""
    out = {}
    for uuid, (a, b) in pairs.items():
        pa = P.CausalList(a.ct.evolve(weaver="pure", lanes=None))
        pb = P.CausalList(b.ct.evolve(weaver="pure", lanes=None))
        out[uuid] = pa.merge(pb)
    for e in _journal_entries(P, path):
        nodes = P.serde.decode_node_items(e["items"])
        out[str(e["uuid"])] = _apply(P, out[str(e["uuid"])], nodes)
    return out


def _journal_ids(P, path):
    return [tuple(it[0]) for e in _journal_entries(P, path)
            for it in e["items"]]


def _pump_until_empty(cl, limit_s=5.0, nap=0.002):
    deadline = time.monotonic() + limit_s
    while cl.outbound_depth and time.monotonic() < deadline:
        cl.pump()
        time.sleep(nap)


_STABLE = ("connects", "reconnects", "acked_ops", "sent_frames",
           "resumed_skipped_ops", "nacks", "shed_ops", "dup_acks")


def _client_stats(cl):
    return {k: cl.stats[k] for k in _STABLE if k in cl.stats}


# ------------------------------------------------------------ transport


def test_frame_stream_roundtrip_and_eof():
    def scen(P):
        fa, fb = P.loopback_pair()
        P.transport.send_msg(fa, {"op": "ping", "seq": 7})
        got = P.transport.recv_msg(fb, timeout_s=2.0)
        assert got == {"op": "ping", "seq": 7}
        fa.close()
        with pytest.raises(P.CausalError) as ei:
            P.transport.recv_msg(fb, timeout_s=2.0)
        assert "eof" in ei.value.info["causes"]
        fb.close()
        return got, sorted(ei.value.info["causes"])

    both(scen)


def test_frame_stream_read_deadline():
    def scen(P):
        fa, fb = P.loopback_pair()
        t0 = time.monotonic()
        with pytest.raises(P.CausalError) as ei:
            P.transport.recv_msg(fb, timeout_s=0.2)
        assert "read-timeout" in ei.value.info["causes"]
        assert time.monotonic() - t0 < 2.0
        fa.close()
        fb.close()
        return sorted(ei.value.info["causes"])

    both(scen)


def test_backoff_seeded_deterministic_and_capped():
    def scen(P):
        b1 = P.Backoff(base_ms=50, cap_ms=400, seed=7)
        b2 = P.Backoff(base_ms=50, cap_ms=400, seed=7)
        seq1 = [b1.next_ms() for _ in range(6)]
        seq2 = [b2.next_ms() for _ in range(6)]
        assert seq1 == seq2
        other = P.Backoff(base_ms=50, cap_ms=400, seed=8).next_ms()
        assert other != seq1[0]
        for i, d in enumerate(seq1):
            raw = min(400.0, 50.0 * 2 ** i)
            assert raw * 0.5 <= d < raw
        b1.reset()
        assert b1.attempt == 0
        after = b1.next_ms()
        assert 25.0 <= after < 50.0
        return seq1, other, after

    both(scen)


def test_dial_unreachable_is_uniform_causal_error():
    def scen(P):
        with pytest.raises(P.CausalError) as ei:
            P.transport.dial("127.0.0.1", 1, connect_timeout_s=0.5)
        assert "net-unreachable" in ei.value.info["causes"]
        return sorted(ei.value.info["causes"])

    both(scen)


def test_chaos_net_hooks_off_invariance():
    def scen(P):
        ch = P.chaos
        assert not ch.enabled()
        got = (ch.net_partition("net.client"), ch.net_reset("net.client"),
               ch.net_latency_ms("net.client"),
               ch.net_blackhole("net.client"), ch.net_dup("net.client"))
        assert got == (False, False, 0.0, False, False)
        assert ch.injected() == []
        return got

    both(scen)


def test_chaos_net_partition_schedule_is_seeded_exact():
    def scen(P):
        P.chaos.configure(plan={"seed": 3, "faults": [
            {"family": "net", "mode": "partition", "site": "net.client",
             "at": [1, 2]}]})
        for _ in range(2):
            with pytest.raises(P.CausalError) as ei:
                P.transport.dial("127.0.0.1", 1, connect_timeout_s=0.2)
            assert ei.value.info.get("injected") is True
        with pytest.raises(P.CausalError) as ei:
            P.transport.dial("127.0.0.1", 1, connect_timeout_s=0.2)
        assert "injected" not in ei.value.info
        nets = [r for r in P.chaos.injected() if r["family"] == "net"]
        assert len(nets) == 2
        return [(r["mode"], r["site"]) for r in nets]

    both(scen)


# ----------------------------------------------------------- end to end


def test_end_to_end_replication_and_oracle_identity(tmp_path):
    def scen(P, root):
        svc, (uuid,), pairs = _service(P, root)
        srv = P.ReplicationServer(svc).start()
        try:
            cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                             client_id="e2e", read_timeout_s=2.0)
            st_id = site("N", 1)
            assert cl.queue_ops(uuid, st_id, _mint(P, st_id, 5))
            st = cl.pump()
            assert st["connected"] and st["outbound_ops"] == 0, st
            assert st["acked_ops"] == 5
            svc.tick()
            doc = svc.materialize(uuid)
            oracle = _pure_oracle(P, pairs, svc.queue.journal.path)[uuid]
            assert dict(doc.ct.nodes) == dict(oracle.ct.nodes)
            assert edn(P, doc) == edn(P, oracle)
            assert srv.stats["admitted_ops"] == 5
            assert srv.stats["dup_ops_suppressed"] == 0
            cl.close()
            return (edn(P, doc), svc.converged_digest(uuid),
                    _client_stats(cl), srv.stats["admitted_ops"])
        finally:
            srv.stop()

    both(scen, tmp_path)


def test_reconnect_resume_ships_exactly_the_missed_suffix(tmp_path):
    def scen(P, root):
        svc, (uuid,), pairs = _service(P, root)
        srv = P.ReplicationServer(svc).start()
        try:
            st_id = site("N", 2)
            all_ops = _mint(P, st_id, 8)
            cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                             client_id="r1", read_timeout_s=2.0,
                             backoff=P.Backoff(base_ms=1, cap_ms=5,
                                               seed=1))
            assert cl.queue_ops(uuid, st_id, all_ops[:5])
            cl.pump()
            assert cl.stats["acked_ops"] == 5
            cl._fs.sock.close()
            assert cl.queue_ops(uuid, st_id, all_ops[5:])
            st = cl.pump()
            assert not st["connected"]
            assert st["outbound_ops"] == 3
            _pump_until_empty(cl)
            assert cl.outbound_depth == 0
            assert cl.stats["reconnects"] == 1
            assert cl.stats["acked_ops"] == 8
            assert srv.stats["admitted_ops"] == 8
            assert srv.stats["dup_ops_suppressed"] == 0
            assert srv.stats["dup_frames"] == 0
            jids = _journal_ids(P, svc.queue.journal.path)
            assert len(jids) == len(set(jids)) == 8
            cl.close()
            cl2 = P.NetClient("127.0.0.1", srv.port, [uuid],
                              client_id="r2", read_timeout_s=2.0)
            assert cl2.queue_ops(uuid, st_id, all_ops)
            st = cl2.pump()
            assert st["outbound_ops"] == 0
            assert cl2.stats["resumed_skipped_ops"] == 8
            assert cl2.stats["sent_frames"] == 0
            assert srv.stats["admitted_ops"] == 8
            cl2.close()
            svc.tick()
            doc = svc.materialize(uuid)
            oracle = _pure_oracle(P, pairs, svc.queue.journal.path)[uuid]
            assert dict(doc.ct.nodes) == dict(oracle.ct.nodes)
            assert edn(P, doc) == edn(P, oracle)
            return (edn(P, doc), jids, _client_stats(cl),
                    _client_stats(cl2))
        finally:
            srv.stop()

    both(scen, tmp_path)


def _scen_watermark(P, root):
    svc, (uuid,), _pairs = _service(P, root)
    srv = P.ReplicationServer(svc).start()
    try:
        st_id = site("N", 3)
        ops = _mint(P, st_id, 4)
        enc = P.serde.encode_node_items(
            {t[0]: (t[1], t[2]) for t in ops})
        crc = P.sync.payload_checksum(enc)
        fs = P.transport.dial("127.0.0.1", srv.port)
        P.transport.send_msg(fs, {"op": "hello", "client": "raw",
                                  "uuids": [uuid]})
        w = P.transport.recv_msg(fs, timeout_s=2.0)
        assert w["op"] == "welcome" and w["wm"][uuid] == {}
        frame = {"op": "delta", "seq": 1, "uuid": uuid,
                 "site": st_id, "nodes": enc, "crc": crc}
        replies = [w]
        P.transport.send_msg(fs, frame)
        replies.append(P.transport.recv_msg(fs, timeout_s=2.0))
        assert replies[-1] == {"op": "ack", "seq": 1, "admitted": 4,
                               "dup": 0}
        frame2 = dict(frame, seq=2)
        P.transport.send_msg(fs, frame2)
        replies.append(P.transport.recv_msg(fs, timeout_s=2.0))
        assert replies[-1] == {"op": "ack", "seq": 2, "admitted": 0,
                               "dup": 4}
        assert srv.stats["dup_ops_suppressed"] == 4
        P.transport.send_msg(fs, frame2)
        replies.append(P.transport.recv_msg(fs, timeout_s=2.0))
        assert replies[-1] == replies[-2]
        assert srv.stats["dup_frames"] == 1
        P.transport.send_msg(fs, dict(frame, seq=1))
        replies.append(P.transport.recv_msg(fs, timeout_s=2.0))
        assert replies[-1] == {"op": "nack", "seq": 1,
                               "reason": "out-of-order"}
        assert srv.stats["ooo_frames"] == 1
        jids = _journal_ids(P, svc.queue.journal.path)
        assert len(jids) == len(set(jids)) == 4
        fs.close()
        return replies, jids
    finally:
        srv.stop()


def test_watermark_suppresses_redelivery_and_wire_dups(tmp_path):
    both(_scen_watermark, tmp_path)


def _scen_nack(P, root):
    svc, (uuid,), _pairs = _service(P, root, max_ops=4)
    srv = P.ReplicationServer(svc).start()
    try:
        cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                         client_id="bp", read_timeout_s=2.0,
                         heartbeat_s=_NO_HEARTBEAT)
        s1, s2 = site("N", 4), site("N", 5)
        assert cl.queue_ops(uuid, s1, _mint(P, s1, 3, start_ts=2000))
        assert cl.queue_ops(uuid, s2, _mint(P, s2, 3, start_ts=3000))
        cl.pump()
        assert cl.stats["acked_ops"] == 3
        assert cl.stats["nacks"] == {"capacity": 1}
        assert cl.outbound_depth == 3
        frames_before = cl.stats["sent_frames"]
        cl.pump()
        assert cl.stats["sent_frames"] == frames_before
        svc.tick()
        _pump_until_empty(cl, nap=0.01)
        assert cl.outbound_depth == 0
        assert srv.stats["admitted_ops"] == 6
        cl.close()
        return dict(cl.stats["nacks"]), srv.stats["admitted_ops"]
    finally:
        srv.stop()


def test_nack_backpressure_is_honored(tmp_path):
    both(_scen_nack, tmp_path)


def _scen_poison(P, root):
    P.chaos.configure(plan={"seed": 5, "faults": [
        {"family": "payload", "site": "net.delta", "mode": "reorder",
         "at": [1]}]})
    svc, (uuid,), pairs = _service(P, root)
    srv = P.ReplicationServer(svc).start()
    try:
        cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                         client_id="poi", read_timeout_s=2.0,
                         heartbeat_s=_NO_HEARTBEAT)
        st_id = site("N", 6)
        assert cl.queue_ops(uuid, st_id, _mint(P, st_id, 3))
        cl.pump()
        assert srv.stats["poison_nacks"] == 1
        assert sum(cl.stats["nacks"].values()) == 1
        assert not P.sync.is_quarantined(st_id)
        _pump_until_empty(cl, nap=0.01)
        assert cl.outbound_depth == 0
        svc.tick()
        doc = svc.materialize(uuid)
        oracle = _pure_oracle(P, pairs, svc.queue.journal.path)[uuid]
        assert dict(doc.ct.nodes) == dict(oracle.ct.nodes)
        cl.close()
        return dict(cl.stats["nacks"]), edn(P, doc)
    finally:
        srv.stop()


def test_poison_payload_nacks_through_offender_ladder(tmp_path):
    both(_scen_poison, tmp_path)


def test_blackhole_degrades_to_reconnect_and_resume(tmp_path):
    def scen(P, root):
        P.chaos.configure(plan={"seed": 9, "faults": [
            {"family": "net", "mode": "blackhole", "site": "net.client",
             "at": [2]}]})
        svc, (uuid,), _pairs = _service(P, root)
        srv = P.ReplicationServer(svc).start()
        try:
            cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                             client_id="bh", read_timeout_s=0.3,
                             backoff=P.Backoff(base_ms=1, cap_ms=5,
                                               seed=2))
            st_id = site("N", 7)
            assert cl.queue_ops(uuid, st_id, _mint(P, st_id, 4))
            cl.pump()
            assert not cl.connected
            assert cl.outbound_depth == 4
            _pump_until_empty(cl)
            assert cl.outbound_depth == 0
            assert cl.stats["reconnects"] == 1
            assert srv.stats["admitted_ops"] == 4
            assert srv.stats["dup_ops_suppressed"] == 0
            jids = _journal_ids(P, svc.queue.journal.path)
            assert len(jids) == len(set(jids)) == 4
            cl.close()
            return jids, cl.stats["reconnects"]
        finally:
            srv.stop()

    both(scen, tmp_path)


def _scen_shed(P):
    cl = P.NetClient("127.0.0.1", 1, ["u"], client_id="shed",
                     max_pending_ops=5)
    st_id = site("N", 8)
    assert cl.queue_ops("u", st_id, _mint(P, st_id, 4))
    assert not cl.queue_ops("u", st_id,
                            _mint(P, st_id, 3, start_ts=5000))
    assert cl.outbound_depth == 4
    assert cl.stats["shed_ops"] == 3
    return cl.outbound_depth, cl.stats["shed_ops"]


def test_client_outbound_queue_is_bounded_with_shed_evidence():
    both(_scen_shed)


def _scen_idle(P, root):
    svc, (uuid,), _pairs = _service(P, root)
    srv = P.ReplicationServer(svc, idle_timeout_s=0.2).start()
    try:
        fs = P.transport.dial("127.0.0.1", srv.port)
        P.transport.send_msg(fs, {"op": "hello", "client": "quiet",
                                  "uuids": [uuid]})
        P.transport.recv_msg(fs, timeout_s=2.0)
        deadline = time.monotonic() + 5.0
        while not srv.stats["idle_closes"] \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.stats["idle_closes"] == 1
        fs.close()
        return srv.stats["idle_closes"]
    finally:
        srv.stop()


def test_idle_connection_closes_with_evidence(tmp_path):
    both(_scen_idle, tmp_path)


def _scen_heartbeat(P, root):
    svc, (uuid,), _pairs = _service(P, root)
    srv = P.ReplicationServer(svc, idle_timeout_s=1.0).start()
    try:
        cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                         client_id="hb", read_timeout_s=2.0,
                         heartbeat_s=0.05)
        cl.pump()
        deadline = time.monotonic() + 5.0
        while cl.stats["heartbeats"] < 2 \
                and time.monotonic() < deadline:
            cl.pump()
            time.sleep(0.06)
        assert cl.stats["heartbeats"] >= 2
        assert cl.connected
        assert srv.stats["heartbeats"] >= 2
        cl.close()
        return cl.connected, srv.stats["idle_closes"]
    finally:
        srv.stop()


def test_heartbeat_keeps_session_alive_and_evidenced(tmp_path):
    both(_scen_heartbeat, tmp_path)


def test_net_layer_obs_off_emits_nothing(tmp_path):
    def scen(P, root):
        svc, (uuid,), _pairs = _service(P, root)
        srv = P.ReplicationServer(svc).start()
        try:
            cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                             client_id="off", read_timeout_s=2.0)
            st_id = site("N", 9)
            assert cl.queue_ops(uuid, st_id, _mint(P, st_id, 3))
            cl.pump()
            assert cl.stats["acked_ops"] == 3
            cl.close()
            return _client_stats(cl)
        finally:
            srv.stop()

    both(scen, tmp_path)
    from cause_tpu import obs as j_obs

    assert j_obs.events() == []


def test_server_stats_increments_are_lock_safe():
    srv = PORT.ReplicationServer.__new__(PORT.ReplicationServer)
    srv.stats = {"frames": 0}
    srv._stats_lock = threading.Lock()
    n_threads, n_bumps = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(n_bumps):
                srv._bump("frames")
        threads = [threading.Thread(target=hammer)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        sys.setswitchinterval(old)
    assert srv.stats["frames"] == n_threads * n_bumps


# -------------------------------------- FrameStream under sync_stream


def test_sync_stream_read_deadline_on_silent_peer():
    """``tests/test_sync.py:279``, its FrameStream half: sync_stream
    arms the read deadline through the stream's settimeout, and a
    silent peer rejects inside it in both packages."""
    def scen(P):
        h = P.c.clist("x")
        s1, s2 = socket.socketpair()
        t0 = time.monotonic()
        with pytest.raises(P.CausalError) as ei:
            P.sync.sync_stream(h, P.transport.FrameStream(s1),
                               read_timeout_s=0.3)
        assert "read-timeout" in ei.value.info["causes"]
        assert time.monotonic() - t0 < 5.0
        s1.close()
        s2.close()
        return sorted(ei.value.info["causes"])

    both(scen)


def test_sync_stream_deadline_does_not_break_healthy_rounds():
    """``tests/test_sync.py:316``: a generous deadline over FrameStream
    changes nothing — both ends converge as without one."""
    def scen(P):
        b = P.CausalList(P.c.clist(*"shared").ct.evolve(
            site_id=site("BASE")))
        a = P.CausalList(b.ct.evolve(site_id=site("A"))).extend(["A1"])
        r = P.CausalList(b.ct.evolve(site_id=site("B"))).extend(["B1"])
        s1, s2 = socket.socketpair()
        out = {}

        def side(name, handle, sock):
            with sock:
                out[name] = P.sync.sync_stream(
                    handle, P.transport.FrameStream(sock),
                    read_timeout_s=30.0)

        t1 = threading.Thread(target=side, args=("a", a, s1))
        t2 = threading.Thread(target=side, args=("b", r, s2))
        t1.start()
        t2.start()
        t1.join(15)
        t2.join(15)
        assert out["a"].get_nodes() == out["b"].get_nodes()
        assert edn(P, out["a"]) == edn(P, out["b"])
        return edn(P, out["a"])

    both(scen)


# -------------------------------------------------------- cross-package


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_cross_package_replication(tmp_path, client_pkg, server_pkg):
    """A port ``NetClient`` replicating into a reference
    ``ReplicationServer`` (fronting a reference service), and the
    reverse: the frames are byte-compatible, the ops land once, and the
    served document equals the pure oracle and the document the same
    exchange gives within one package."""
    pk = {"ref": REF, "port": PORT}
    C, S = pk[client_pkg], pk[server_pkg]
    svc, (uuid,), pairs = _service(S, tmp_path)
    srv = S.ReplicationServer(svc).start()
    try:
        cl = C.NetClient("127.0.0.1", srv.port, [uuid], client_id="x",
                         read_timeout_s=2.0,
                         backoff=C.Backoff(base_ms=1, cap_ms=5, seed=3))
        s1, s2 = site("N", 10), site("N", 11)
        ops1 = _mint(C, s1, 6)
        assert cl.queue_ops(uuid, s1, ops1[:4])
        assert cl.queue_ops(uuid, s2, _mint(C, s2, 3, start_ts=4000))
        cl.pump()
        assert cl.stats["acked_ops"] == 7
        # drop the link, queue the rest: the resume ships the suffix
        cl._fs.sock.close()
        assert cl.queue_ops(uuid, s1, ops1)
        cl.pump()
        _pump_until_empty(cl)
        assert cl.outbound_depth == 0
        assert cl.stats["acked_ops"] == 9
        assert srv.stats["admitted_ops"] == 9
        jids = _journal_ids(S, svc.queue.journal.path)
        assert len(jids) == len(set(jids)) == 9
        svc.tick()
        doc = svc.materialize(uuid)
        oracle = _pure_oracle(S, pairs, svc.queue.journal.path)[uuid]
        assert dict(doc.ct.nodes) == dict(oracle.ct.nodes)
        got = edn(S, doc)
        assert got == edn(S, oracle)
        assert sum(1 for v in got if str(v).startswith("op")) == 9
        cl.close()
    finally:
        srv.stop()


# ------------------------------------------- the net layer's telemetry
#
# The ``_obs`` halves: the scenario above with telemetry on in both
# packages (``obs_twin``), the streams equal as multisets (a server's
# connection threads write beside its client) and the reference test's
# own event assertions on the port's stream.


def _unstamped(record):
    """A scenario's record without the clock stamps an obs-on server
    puts on its welcome and pong replies."""
    if isinstance(record, dict):
        return {k: _unstamped(v) for k, v in record.items()
                if k not in ("ts_us", "pid")}
    if isinstance(record, (list, tuple)):
        return [_unstamped(v) for v in record]
    return record


def _events(streams, name):
    return twin_events(streams, name, ordered=False)


def test_watermark_suppresses_redelivery_and_wire_dups_obs(tmp_path,
                                                            obs_twin):
    both(lambda P, root: _unstamped(_scen_watermark(P, root)), tmp_path)
    assert len(_events(obs_twin, "net.dup_ops")) == 1
    assert len(_events(obs_twin, "net.dup_frame")) == 1
    assert len(_events(obs_twin, "net.ooo_frame")) == 1


def test_nack_backpressure_is_honored_obs(tmp_path, obs_twin):
    both(_scen_nack, tmp_path)
    nacks = _events(obs_twin, "net.nack")
    assert len(nacks) == 1
    assert nacks[0]["fields"]["reason"] == "capacity"


def test_poison_payload_nacks_through_offender_ladder_obs(tmp_path,
                                                          obs_twin):
    both(_scen_poison, tmp_path)
    assert len(_events(obs_twin, "sync.reject")) == 1


def test_client_outbound_queue_is_bounded_with_shed_evidence_obs(obs_twin):
    both(_scen_shed)
    sheds = _events(obs_twin, "net.shed")
    assert len(sheds) == 1
    f = sheds[0]["fields"]
    assert f["rung"] == "client-overflow" and f["ops"] == 3


def test_idle_connection_closes_with_evidence_obs(tmp_path, obs_twin):
    both(_scen_idle, tmp_path)
    assert len(_events(obs_twin, "net.idle_close")) == 1


def test_heartbeat_keeps_session_alive_and_evidenced_obs(tmp_path,
                                                         obs_twin):
    both(_scen_heartbeat, tmp_path)
    hb = _events(obs_twin, "net.heartbeat")
    assert {"client", "server"} <= {e["fields"].get("side") for e in hb}


# --------------------------------------------- live rules and the watch


def _ev(name, ts_us, **fields):
    return {"ev": "event", "name": name, "ts_us": ts_us,
            "fields": fields}


def test_live_fold_net_section_and_flap_rule():
    def scen(P):
        fold = P.obs.live.LiveFold()
        t0 = 1_000_000_000
        fold.feed(_ev("net.connect", t0, side="client"))
        for i in range(7):
            fold.feed(_ev("net.reconnect", t0 + (i + 1) * 1_000_000))
        fold.feed(_ev("net.nack", t0 + 2_000_000, reason="capacity"))
        fold.feed(_ev("net.dup_ops", t0 + 3_000_000, ops=4))
        fold.feed({"ev": "gauge", "name": "net.outbound_depth",
                   "value": 12, "ts_us": t0 + 3_000_000})
        snap = fold.snapshot(now_us=t0 + 8_000_000)
        net = snap["net"]
        assert net["active"] is True
        assert net["connects"] == 1 and net["reconnects"] == 7
        assert net["reconnects_per_min"] == 7.0
        assert net["nacks"] == 1 and net["dup_ops_suppressed"] == 4
        assert net["outbound_depth"] == 12
        rule = P.obs.live.parse_rule("reconnects_per_min>6")
        fired = rule.check(snap)
        assert fired["value"] == 7.0
        assert rule.check(snap) is None
        return net, fired

    both(scen)


def test_net_default_rules_inert_without_net_activity():
    def scen(P):
        live = P.obs.live
        specs = set(live.DEFAULT_RULE_SPECS)
        assert "absence:net.heartbeat:120" in specs
        assert "reconnects_per_min>6" in specs
        monitor = live.LiveMonitor()
        t0 = 1_000_000_000
        monitor.feed([_ev("wave.digest", t0, agreed=True, pairs=1,
                          valid=1, distinct=1, uuid="u", source="wave",
                          wave=1, staleness={"0": 1}),
                      _ev("wave.digest", t0 + 300_000_000, agreed=True,
                          pairs=1, valid=1, distinct=1, uuid="u",
                          source="wave", wave=2, staleness={"0": 1})])
        fired = monitor.evaluate(now_us=t0 + 300_000_000)
        assert not [a for a in fired
                    if "net" in a["rule"] or "reconnects" in a["rule"]]
        return sorted(specs), fired

    both(scen)


def test_net_heartbeat_absence_fires_on_active_transport():
    def scen(P):
        monitor = P.obs.live.LiveMonitor(
            rules=["absence:net.heartbeat:120"])
        t0 = 1_000_000_000
        monitor.feed([_ev("net.connect", t0, side="client"),
                      _ev("serve.tick", t0 + 200_000_000, ops=0)])
        fired = monitor.evaluate(now_us=t0 + 200_000_000)
        assert len(fired) == 1 and fired[0]["event"] == "net.heartbeat"
        return fired

    both(scen)


def test_watch_renders_net_line_and_prometheus():
    def scen(P):
        from importlib import import_module

        watch = import_module(f"{P.obs.__name__}.watch")
        monitor = P.obs.live.LiveMonitor()
        t0 = 1_000_000_000
        monitor.feed([_ev("net.connect", t0),
                      _ev("net.reconnect", t0 + 1_000_000),
                      _ev("net.heartbeat", t0 + 1_500_000, side="client"),
                      {"ev": "gauge", "name": "net.outbound_depth",
                       "value": 3, "ts_us": t0 + 1_500_000}])
        snap = monitor.snapshot(now_us=t0 + 2_000_000)
        block = watch.render(snap, [], ["x.jsonl"])
        assert "net: " in block and "1 re" in block
        prom = watch.prometheus_text(snap)
        assert "cause_tpu_live_net_reconnects_total 1" in prom
        assert "cause_tpu_live_net_outbound_depth 3" in prom
        return block, prom

    both(scen)


# ------------------------------------------ trace contexts on the wire
#
# ``tests/test_xtrace.py``'s wire cases: a NetClient's batch carries its
# trace across the wire, and a peer without contexts or clock stamps
# still replicates. Twins with telemetry on, then across the packages.


def _xtrace_service(P, root):
    svc, (uuid,), _pairs = _service(P, root, max_ops=4096)
    return svc, uuid


def _hop_names(j):
    return [h["hop"] for h in j["hops"]]


def _journey(P, events, trace):
    from importlib import import_module

    journey = import_module(f"{P.obs.__name__}.journey")
    fold = journey.JourneyFold(retain_all=True)
    fold.feed_many(events)
    return fold.journey(trace)


def _scen_wire_journey(P, root):
    svc, uuid = _xtrace_service(P, root)
    srv = P.ReplicationServer(svc).start()
    try:
        cl = P.NetClient("127.0.0.1", srv.port, [uuid], client_id="jny",
                         read_timeout_s=2.0)
        st_id = site("N", 12)
        ops = _mint(P, st_id, 4)
        assert cl.queue_ops(uuid, st_id, ops)
        st = cl.pump()
        assert st["acked_ops"] == 4, st
        svc.tick()
        cl.close()
    finally:
        srv.stop()
    evs = P.obs.events()
    mints = [e for e in evs if e.get("name") == "xtrace.hop"
             and e["fields"]["hop"] == "mint"
             and e["fields"].get("client") == "jny"]
    assert len(mints) == 1
    tr = mints[0]["fields"]["trace"]
    j = _journey(P, evs, tr)
    assert j is not None
    names = _hop_names(j)
    for need in ("mint", "send", "recv", "admit", "journal", "tick",
                 "wave"):
        assert need in names, (need, names)
    assert names.index("mint") < names.index("send") \
        < names.index("recv") < names.index("admit")
    assert j["orphans"] == 0
    assert P.obs.xtrace.trace_of(tuple(ops[0][0])) == tr
    clocks = [e for e in evs if e.get("name") == "xtrace.clock"]
    assert clocks and clocks[0]["fields"]["via"] == "hello"
    return names, j["orphans"], clocks[0]["fields"]["via"]


def test_wire_journey_end_to_end(tmp_path, obs_twin):
    both(_scen_wire_journey, tmp_path)
    assert _events(obs_twin, "xtrace.hop")


def _old_client_frames(P, port, uuid, st_id, ops):
    """A context-less client driven by hand: hello, one delta, its ack."""
    fs = P.transport.dial("127.0.0.1", port, connect_timeout_s=2.0,
                          read_timeout_s=2.0)
    P.transport.send_msg(fs, {"op": "hello", "client": "old",
                              "uuids": [uuid]})
    welcome = P.transport.recv_msg(fs, timeout_s=2.0)
    items = P.serde.encode_node_items(
        {nid: (parent, val) for nid, parent, val in ops})
    P.transport.send_msg(fs, {"op": "delta", "seq": 1, "uuid": uuid,
                              "site": st_id, "nodes": items,
                              "crc": P.sync.payload_checksum(items)})
    ack = P.transport.recv_msg(fs, timeout_s=2.0)
    fs.close()
    return welcome, ack


def _scen_old_client(P, root):
    svc, uuid = _xtrace_service(P, root)
    srv = P.ReplicationServer(svc).start()
    try:
        st_id = site("N", 13)
        welcome, ack = _old_client_frames(P, srv.port, uuid, st_id,
                                          _mint(P, st_id, 3))
        assert welcome["op"] == "welcome"
        assert isinstance(welcome.get("ts_us"), int)
        assert ack["op"] == "ack" and ack["admitted"] == 3, ack
    finally:
        srv.stop()
    recv = [e for e in P.obs.events() if e.get("name") == "xtrace.hop"
            and e["fields"]["hop"] == "recv"]
    assert recv == []
    return _unstamped(welcome), ack


def test_old_client_new_server_ctxless_frames(tmp_path, obs_twin):
    both(_scen_old_client, tmp_path)


def _old_server(uuid, got):
    """A server of the context-less protocol on a thread: its welcome
    carries no clock stamp and it ignores a frame's ``ctx``. Returns
    the listening port and the thread."""
    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(1)
    lsock.settimeout(10.0)

    def serve():
        from cause_tpu_torch.net import transport

        try:
            conn, _peer = lsock.accept()
            fs = transport.FrameStream(conn, site="net.server")
            got["hello"] = transport.recv_msg(fs, timeout_s=5.0)
            transport.send_msg(fs, {"op": "welcome", "wm": {uuid: {}},
                                    "unknown": []})
            frame = transport.recv_msg(fs, timeout_s=5.0)
            got["delta"] = frame
            transport.send_msg(fs, {"op": "ack", "seq": frame.get("seq"),
                                    "admitted": len(frame.get("nodes"))})
            fs.close()
        finally:
            lsock.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return lsock.getsockname()[1], t


def _scen_new_client(P):
    uuid = "tenant-old"
    got = {}
    port, t = _old_server(uuid, got)
    try:
        cl = P.NetClient("127.0.0.1", port, [uuid], client_id="new",
                         read_timeout_s=2.0)
        st_id = site("N", 14)
        assert cl.queue_ops(uuid, st_id, _mint(P, st_id, 2))
        st = cl.pump()
        assert st["connected"] and st["acked_ops"] == 2, st
        cl.close()
    finally:
        t.join(timeout=10)
    assert not t.is_alive()
    assert isinstance(got["delta"].get("ctx"), list)
    evs = P.obs.events()
    assert [e for e in evs if e.get("name") == "xtrace.clock"] == []
    assert [e for e in evs if e.get("name") == "xtrace.hop"
            and e["fields"]["hop"] == "send"] != []
    return (got["hello"], len(got["delta"]["ctx"]),
            sorted(got["delta"]["ctx"][0]))


def test_new_client_old_server_no_stamp_no_ctx_choke(obs_twin):
    both(_scen_new_client)


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_cross_package_wire_journey(tmp_path, client_pkg, server_pkg):
    """A ``NetClient`` of one package with telemetry on, replicating
    into the other package's obs-on server: the client's ``mint`` and
    ``send`` hops and the server's ``recv`` through ``wave`` form one
    journey over the two packages' streams, with no orphan hop, and
    the server binds the batch's op ids to the client's trace. (Both
    packages number spans per process; the server's counter starts
    high, as another process's pid would keep them apart.)"""
    pk = {"ref": REF, "port": PORT}
    C, S = pk[client_pkg], pk[server_pkg]
    C.obs.configure(enabled=True)
    S.obs.configure(enabled=True)
    S.obs.xtrace._SPAN_N = 1 << 20
    svc, uuid = _xtrace_service(S, tmp_path)
    srv = S.ReplicationServer(svc).start()
    try:
        cl = C.NetClient("127.0.0.1", srv.port, [uuid], client_id="x",
                         read_timeout_s=2.0)
        st_id = site("N", 15)
        ops = _mint(C, st_id, 4)
        assert cl.queue_ops(uuid, st_id, ops)
        assert cl.pump()["acked_ops"] == 4
        svc.tick()
        cl.close()
    finally:
        srv.stop()
    client_evs, server_evs = C.obs.events(), S.obs.events()
    (mint,) = [e for e in client_evs if e.get("name") == "xtrace.hop"
               and e["fields"]["hop"] == "mint"]
    tr = mint["fields"]["trace"]
    j = _journey(C, client_evs + server_evs, tr)
    names = _hop_names(j)
    for need in ("mint", "send", "recv", "admit", "journal", "tick",
                 "wave"):
        assert need in names, (need, names)
    assert j["orphans"] == 0
    assert S.obs.xtrace.trace_of(tuple(ops[0][0])) == tr
    clocks = [e for e in client_evs if e.get("name") == "xtrace.clock"]
    assert clocks and clocks[0]["fields"]["via"] == "hello"


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "ref"), ("ref", "port")])
def test_cross_package_ctxless_peers(tmp_path, client_pkg, server_pkg):
    """``tests/test_xtrace.py:243`` and ``:278`` across the packages: a
    client with telemetry off (frames without contexts) into the other
    package's obs-on server admits with no ``recv`` hop, and an obs-on
    client into the other package's obs-off server (a welcome without
    a clock stamp; the context ignored) replicates with no clock
    sample."""
    pk = {"ref": REF, "port": PORT}
    C, S = pk[client_pkg], pk[server_pkg]
    for n, (c_on, s_on) in enumerate(((False, True), (True, False))):
        C.obs.reset()
        S.obs.reset()
        C.obs.configure(enabled=c_on)
        S.obs.configure(enabled=s_on)
        root = tmp_path / str(n)
        root.mkdir()
        svc, uuid = _xtrace_service(S, root)
        srv = S.ReplicationServer(svc).start()
        try:
            cl = C.NetClient("127.0.0.1", srv.port, [uuid],
                             client_id="x", read_timeout_s=2.0)
            st_id = site("N", 16 + n)
            assert cl.queue_ops(uuid, st_id, _mint(C, st_id, 3))
            st = cl.pump()
            assert st["connected"] and st["acked_ops"] == 3, st
            cl.close()
        finally:
            srv.stop()
        c_hops, s_hops = ([e["fields"]["hop"] for e in P.obs.events()
                           if e.get("name") == "xtrace.hop"]
                          for P in (C, S))
        clocks = [e for e in C.obs.events()
                  if e.get("name") == "xtrace.clock"]
        assert srv.stats["admitted_ops"] == 3
        if c_on:
            assert "send" in c_hops and s_hops == [] and clocks == []
        else:
            assert c_hops == [] and "recv" not in s_hops
    C.obs.configure(enabled=False)
    S.obs.configure(enabled=False)


def test_obs_off_pin_byte_identity(monkeypatch, capsys):
    """``tests/test_xtrace.py:111`` against the port: with telemetry off,
    the port's client, server and journals, run through the reference's
    pin scenario (``scripts/obs_off_pin.py``, its byte-recording proxy
    and its stub service), put on the wire and on disk exactly the bytes
    of the committed capture (``measurements/obs_off_pin_r19.json``): no
    trace context, no clock stamp, no trace field."""
    import importlib.util
    import os

    from cause_tpu_torch import chaos as t_chaos
    from cause_tpu_torch import obs as t_obs
    from cause_tpu_torch.serve import ingest as t_ingest
    from cause_tpu_torch.serve import wal as t_wal

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(repo, "scripts"))
    spec = importlib.util.spec_from_file_location(
        "obs_off_pin_port", os.path.join(repo, "scripts", "obs_off_pin.py"))
    pin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pin)
    for name, value in (("obs", t_obs), ("chaos", t_chaos),
                        ("root_id", PORT.root_id),
                        ("NetClient", PORT.NetClient),
                        ("ReplicationServer", PORT.ReplicationServer),
                        ("IngestJournal", t_ingest.IngestJournal),
                        ("IngestQueue", t_ingest.IngestQueue),
                        ("WriteAheadLog", t_wal.WriteAheadLog)):
        monkeypatch.setattr(pin, name, value)
    assert pin.check(os.path.join(repo, pin.PIN_PATH_DEFAULT)) == 0
    assert "clean" in capsys.readouterr().out
