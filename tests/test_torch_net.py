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

The telemetry halves (``net.*`` and ``sync.reject`` events) and the
telemetry-only cases (``test_live_fold_net_section_and_flap_rule``,
``test_net_default_rules_inert_without_net_activity``,
``test_net_heartbeat_absence_fires_on_active_transport``,
``test_watch_renders_net_line_and_prometheus``) wait for the telemetry
port (ROADMAP A.13).
"""

import socket
import sys
import threading
import time

import pytest

from test_torch_serve import (PORT, REF, _fresh_state, base, both,  # noqa: F401
                              edn, site)


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


def _journal_entries(P, path):
    jr = P.IngestJournal(path)
    entries = sorted(jr.iter_from(0), key=lambda e: int(e["seq"]))
    jr.close()
    return entries


def _apply(P, h, nodes):
    if P is REF:
        return P.sync.apply_delta(h, nodes, _count_as_delta=False)
    return P.sync.apply_delta(h, nodes)


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


def test_watermark_suppresses_redelivery_and_wire_dups(tmp_path):
    def scen(P, root):
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

    both(scen, tmp_path)


def test_nack_backpressure_is_honored(tmp_path):
    def scen(P, root):
        svc, (uuid,), _pairs = _service(P, root, max_ops=4)
        srv = P.ReplicationServer(svc).start()
        try:
            cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                             client_id="bp", read_timeout_s=2.0)
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

    both(scen, tmp_path)


def test_poison_payload_nacks_through_offender_ladder(tmp_path):
    def scen(P, root):
        P.chaos.configure(plan={"seed": 5, "faults": [
            {"family": "payload", "site": "net.delta", "mode": "reorder",
             "at": [1]}]})
        svc, (uuid,), pairs = _service(P, root)
        srv = P.ReplicationServer(svc).start()
        try:
            cl = P.NetClient("127.0.0.1", srv.port, [uuid],
                             client_id="poi", read_timeout_s=2.0)
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

    both(scen, tmp_path)


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


def test_client_outbound_queue_is_bounded_with_shed_evidence():
    def scen(P):
        cl = P.NetClient("127.0.0.1", 1, ["u"], client_id="shed",
                         max_pending_ops=5)
        st_id = site("N", 8)
        assert cl.queue_ops("u", st_id, _mint(P, st_id, 4))
        assert not cl.queue_ops("u", st_id,
                                _mint(P, st_id, 3, start_ts=5000))
        assert cl.outbound_depth == 4
        assert cl.stats["shed_ops"] == 3
        return cl.outbound_depth, cl.stats["shed_ops"]

    both(scen)


def test_idle_connection_closes_with_evidence(tmp_path):
    def scen(P, root):
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

    both(scen, tmp_path)


def test_heartbeat_keeps_session_alive_and_evidenced(tmp_path):
    def scen(P, root):
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

    both(scen, tmp_path)


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
