"""The port's telemetry uplink and collector against the JAX package's.

Mirrors all 16 cases of ``tests/test_ship.py``: each scenario runs as
twins, once in each package (``REF``: ``cause_tpu``; ``PORT``:
``cause_tpu_torch``), with telemetry on where the reference case has
it. A scenario keeps the reference test's assertions and returns what
it observed (stats, acks, per-origin rows without their ages,
delivered records); the port's record must equal the reference's, and
so must the two event streams after ``test_torch_obs.normalize`` and
:func:`canon`. Records are compared as multisets: the collector's
handler threads and the exporter write into one stream, so the order
of two records from two threads is not fixed.

What the port changes on purpose, pinned here: its Prometheus text
adds the ship plane's accounting (``cause_tpu_live_ship_*``) to a
collector's snapshot and is otherwise the reference's; the ledger's
chip platform is ``gpu``; and where the reference checks that
``CAUSE_TPU_OBS_SHIP`` is a registered switch (the port has no switch
registry), the mirror checks that the port's ``SyncService`` reads it.

Beyond the mirrors: a ``SyncService`` under ``CAUSE_TPU_OBS_SHIP``
ships every record it emits to a collector and ``close()`` flushes the
uplink (both packages), and the two packages on one wire: a port
exporter into a reference collector and the reverse, with exact
accounting.

Every socket wait here has its own deadline (``_drain``, the
subprocess timeouts, the frame reads), so a hung case fails.
"""

import json
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from cause_tpu import chaos as j_chaos
from cause_tpu import obs as j_obs
from cause_tpu import sync as j_sync
from cause_tpu.net import transport as j_transport
from cause_tpu.obs import collector as j_collector
from cause_tpu.obs import core as j_core
from cause_tpu.obs import ledger as j_ledger
from cause_tpu.obs import live as j_live
from cause_tpu.obs import ship as j_ship
from cause_tpu.obs import watch as j_watch
from cause_tpu.obs import xtrace as j_xtrace

import cause_tpu_torch as ct
from cause_tpu_torch import chaos as t_chaos
from cause_tpu_torch import obs as t_obs
from cause_tpu_torch import sync as t_sync
from cause_tpu_torch.net import transport as t_transport
from cause_tpu_torch.obs import collector as t_collector
from cause_tpu_torch.obs import core as t_core
from cause_tpu_torch.obs import ledger as t_ledger
from cause_tpu_torch.obs import live as t_live
from cause_tpu_torch.obs import ship as t_ship
from cause_tpu_torch.obs import watch as t_watch
from cause_tpu_torch.obs import xtrace as t_xtrace

from test_torch_obs import comparable, normalize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name, mod, obs, core, live, xtrace, ship, watch, collector,
         chaos, sync, transport, ledger, chip):
    return SimpleNamespace(
        name=name, mod=mod, obs=obs, core=core, live=live, xtrace=xtrace,
        ship=ship, watch=watch, CollectorServer=collector.CollectorServer,
        chaos=chaos, sync=sync, Backoff=transport.Backoff,
        FrameStream=transport.FrameStream, recv_msg=transport.recv_msg,
        ledger=ledger, chip=chip)


REF = _pkg("ref", "cause_tpu", j_obs, j_core, j_live, j_xtrace, j_ship,
           j_watch, j_collector, j_chaos, j_sync, j_transport, j_ledger,
           "tpu")
PORT = _pkg("port", "cause_tpu_torch", t_obs, t_core, t_live, t_xtrace,
            t_ship, t_watch, t_collector, t_chaos, t_sync, t_transport,
            t_ledger, "gpu")
PKGS = {"ref": REF, "port": PORT}

_ENV = ("CAUSE_TPU_OBS", "CAUSE_TPU_OBS_OUT", "CAUSE_TPU_OBS_SHIP",
        "CAUSE_TPU_CHAOS", "CAUSE_TPU_LEDGER")


def fresh(P):
    P.chaos.configure(reset=True)
    P.obs.reset()


@pytest.fixture(autouse=True)
def _fresh_obs(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    for P in (REF, PORT):
        fresh(P)
    yield
    for P in (REF, PORT):
        fresh(P)


# fields that differ between two runs of one scenario: ephemeral ports
_RUN_FIELDS = ("peer", "collector")


def canon(events):
    """A stream as a sorted multiset of normalized records, the run's
    ephemeral ports and scenario directories left out."""
    out = []
    for rec in normalize(events):
        for key in ("fields", "attrs"):
            for k in _RUN_FIELDS:
                rec.get(key, {}).pop(k, None)
        out.append(json.dumps(rec, sort_keys=True).replace("/port/", "/"))
    return sorted(s.replace("/ref/", "/") for s in out)


def twin(scen, tmp_path=None):
    """Run ``scen`` in the reference and then in the port; the records
    they return, and their event streams (:func:`canon`), must be
    equal. Returns the port's record."""
    out, streams = {}, {}
    for P in (REF, PORT):
        fresh(P)
        if tmp_path is None:
            out[P.name] = scen(P)
        else:
            root = tmp_path / P.name
            root.mkdir(parents=True, exist_ok=True)
            out[P.name] = scen(P, root)
        streams[P.name] = P.obs.events()
        fresh(P)
    assert out["port"] == out["ref"]
    same_streams(streams["port"], streams["ref"])
    return out["port"]


def same_streams(port, ref):
    """The two streams as :func:`canon` multisets; on a difference, the
    records only one side holds."""
    a, b = canon(port), canon(ref)
    if a != b:
        only_port = [r for r in a if r not in b]
        only_ref = [r for r in b if r not in a]
        raise AssertionError(f"streams differ ({len(a)} / {len(b)} "
                             f"records); only the port's: "
                             f"{only_port[:3]}; only the reference's: "
                             f"{only_ref[:3]}")


def _exporter(P, port, **kw):
    kw.setdefault("flush_s", 0.01)
    kw.setdefault("heartbeat_s", 30.0)
    kw.setdefault("backoff", P.Backoff(base_ms=5, cap_ms=50, seed=7))
    return P.ship.attach_exporter("127.0.0.1", port, start=False, **kw)


def _drain(exp, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = exp.pump()
        if st["connected"] and st["unacked"] == 0 \
                and not len(exp.sub.queue):
            return True
        time.sleep(0.005)
    return False


def _origins(srv):
    """The collector's origin rows without their wall-clock ages and
    stream epochs (an exporter's start time)."""
    return [{k: v for k, v in o.items() if k not in ("age_s", "epoch")}
            for o in srv.origins()]


# ------------------------------------------------------- obs-off gate


def test_obs_off_attach_is_none_and_stateless():
    def scen(P):
        assert not P.obs.enabled()
        assert P.ship.attach_exporter("127.0.0.1", 1) is None
        assert P.core.subscribe() is None
        return True

    twin(scen)


def test_parse_endpoint():
    def scen(P):
        assert P.ship.parse_endpoint("host7:9419") == ("host7", 9419)
        assert P.ship.parse_endpoint(":9419") == ("127.0.0.1", 9419)
        assert P.ship.parse_endpoint(" 10.0.0.2:77 ") == ("10.0.0.2", 77)
        bad = ("", "garbage", "host:", "host:nan", None)
        assert [P.ship.parse_endpoint(b) for b in bad] == [None] * 5
        return [P.ship.parse_endpoint(r)
                for r in ("host7:9419", ":9419", " 10.0.0.2:77 ")]

    twin(scen)


# ------------------------------------------------- loopback delivery


def test_loopback_delivery_exact_accounting(tmp_path):
    def scen(P, root):
        P.obs.configure(enabled=True, out=str(root / "o.jsonl"))
        srv = P.CollectorServer().start()
        try:
            exp = _exporter(P, srv.port)
            for i in range(40):
                P.core.event("t.ev", i=i)
            assert _drain(exp)
            org = srv.origins()
            assert len(org) == 1 and org[0]["pid"] == os.getpid()
            assert org[0]["missed"] == 0 and org[0]["dup_records"] == 0
            assert org[0]["accepted"] == exp.stats["acked_seq"]
            assert org[0]["watermark"] == exp.stats["acked_seq"]
            seen = [r for r in srv.records if r.get("name") == "t.ev"]
            assert [r["fields"]["i"] for r in seen] == list(range(40))
            assert exp.stats["clock_samples"] >= 1
            assert any(r.get("name") == "xtrace.clock"
                       for r in srv.records)
            exp.close()
            return _origins(srv), exp.stats, [r["fields"]["i"]
                                              for r in seen]
        finally:
            srv.stop()

    twin(scen, tmp_path)


def test_watermark_resume_ships_only_missed_suffix(tmp_path):
    def scen(P, root):
        P.obs.configure(enabled=True, out=str(root / "o.jsonl"))
        srv = P.CollectorServer().start()
        try:
            exp = _exporter(P, srv.port)
            for i in range(10):
                P.core.event("a.ev", i=i)
            assert _drain(exp)
            wm = exp.stats["acked_seq"]
            with exp._pump_lock:
                exp._disconnect_locked("test-sever")
            for i in range(10):
                P.core.event("b.ev", i=i)
            assert _drain(exp)
            org = srv.origins()[0]
            assert org["dup_records"] == 0 and org["missed"] == 0
            assert org["watermark"] == exp.stats["acked_seq"] > wm
            assert [r["fields"]["i"] for r in srv.records
                    if r.get("name") == "b.ev"] == list(range(10))
            assert exp.stats["reconnects"] == 1
            exp.close()
            return _origins(srv), exp.stats, wm
        finally:
            srv.stop()

    twin(scen, tmp_path)


def test_drop_oldest_evidence_and_collector_gap_accounting(tmp_path):
    def scen(P, root):
        P.obs.configure(enabled=True, out=str(root / "o.jsonl"))
        srv = P.CollectorServer().start()
        try:
            exp = _exporter(P, srv.port, buffer_records=8)
            with exp._pump_lock:
                for i in range(30):
                    P.core.event("d.ev", i=i)
                exp._ingest_locked()
            dropped = exp.total_dropped()
            assert dropped > 0
            assert exp.stats["dropped_records"] == dropped
            assert _drain(exp)
            final = exp.stats["dropped_records"]
            org = srv.origins()[0]
            assert org["missed"] == final >= dropped
            assert org["accepted"] == exp.stats["acked_seq"] - final
            assert org["dup_records"] == 0
            exp.close()
            return _origins(srv), exp.stats, dropped
        finally:
            srv.stop()

    twin(scen, tmp_path)


# --------------------------------------- wire protocol, driven by hand


def _dial(P, port, site="test.uplink"):
    sock = socket.create_connection(("127.0.0.1", port), timeout=2.0)
    sock.settimeout(5.0)
    return P.FrameStream(sock, site=site)


def _hello(P, fs, pid=999, epoch=1, next_seq=1):
    P.sync.send_frame(fs, {"op": "hello", "kind": "ship", "proto": 1,
                           "host": "testhost", "pid": pid,
                           "epoch": epoch, "next_seq": next_seq})
    return P.recv_msg(fs, 5.0)


def _obs_frame(P, fs, base, n, dropped=0, tag="w"):
    P.sync.send_frame(fs, {
        "op": "obs", "base": base, "dropped": dropped,
        "records": [{"ev": "event", "name": f"{tag}.{base + k}",
                     "pid": 999, "ts_us": 1, "fields": {}}
                    for k in range(n)]})
    return P.recv_msg(fs, 5.0)


def test_collector_dedup_overlap_and_full_dup():
    def scen(P):
        srv = P.CollectorServer().start()
        try:
            fs = _dial(P, srv.port)
            w = _hello(P, fs)
            assert w["op"] == "welcome" and w["watermark"] == 0
            acks = [_obs_frame(P, fs, 1, 4)["seq"],
                    _obs_frame(P, fs, 1, 4)["seq"],
                    _obs_frame(P, fs, 3, 4)["seq"]]
            assert acks == [4, 4, 6]
            org = srv.origins()[0]
            assert org["accepted"] == 6
            assert org["dup_records"] == 4 + 2
            assert org["missed"] == 0
            fs.close()
            return w, acks, _origins(srv), [r["name"] for r in srv.records]
        finally:
            srv.stop()

    twin(scen)


def test_collector_evidenced_gap_vs_stash_heal():
    def scen(P):
        srv = P.CollectorServer().start()
        try:
            fs = _dial(P, srv.port)
            _hello(P, fs)
            acks = [_obs_frame(P, fs, 1, 2)["seq"],
                    _obs_frame(P, fs, 5, 2, dropped=2)["seq"]]
            org = srv.origins()[0]
            assert org["missed"] == 2 and org["accepted"] == 4
            acks.append(_obs_frame(P, fs, 9, 2, dropped=2)["seq"])
            assert srv.stats["stashed_frames"] == 1
            acks.append(_obs_frame(P, fs, 7, 2, dropped=2)["seq"])
            assert acks == [2, 6, 6, 10]
            org = srv.origins()[0]
            assert org["accepted"] == 8 and org["missed"] == 2
            assert srv.stats["unexplained_gaps"] == 0
            fs.close()
            return acks, _origins(srv), [r["name"] for r in srv.records]
        finally:
            srv.stop()

    twin(scen)


def test_collector_epoch_restart_is_a_fresh_stream():
    def scen(P):
        srv = P.CollectorServer().start()
        try:
            fs = _dial(P, srv.port)
            _hello(P, fs, epoch=1)
            assert _obs_frame(P, fs, 1, 3)["seq"] == 3
            fs.close()
            fs = _dial(P, srv.port)
            w = _hello(P, fs, epoch=2)
            assert w["watermark"] == 0
            assert _obs_frame(P, fs, 1, 3)["seq"] == 3
            assert len(srv.origins()) == 2
            fs.close()
            return w, _origins(srv)
        finally:
            srv.stop()

    twin(scen)


# ----------------------------------------------------- chaos absorbed


def _chaos_plan(**modes):
    return {"seed": 77, "faults": [
        {"family": "ship", "mode": m, "site": "obs.ship", **spec}
        for m, spec in modes.items()]}


def test_chaos_drop_dup_reorder_absorbed_exactly(tmp_path):
    def scen(P, root):
        P.obs.configure(enabled=True, out=str(root / "o.jsonl"))
        P.chaos.configure(plan=_chaos_plan(
            drop={"at": [2]}, dup={"at": [4]}, reorder={"at": [5]}),
            enabled=True)
        srv = P.CollectorServer().start()
        try:
            exp = _exporter(P, srv.port, batch_records=4)
            for r in range(12):
                P.core.event("c.ev", i=r)
                exp.pump()
            assert _drain(exp)
            org = srv.origins()[0]
            assert org["missed"] == 0
            assert org["accepted"] == exp.stats["acked_seq"]
            assert exp.total_dropped() == 0
            assert srv.stats["dup_records"] > 0
            seen = [r["fields"]["i"] for r in srv.records
                    if r.get("name") == "c.ev"]
            assert seen == list(range(12))
            exp.close()
            # resends after a late ack vary with the host's load: the
            # record holds what the faults cannot change
            return ([(o["accepted"], o["missed"], o["watermark"])
                     for o in srv.origins()], exp.stats["acked_seq"],
                    seen, [{k: v for k, v in f.items() if k != "ts_us"}
                           for f in P.chaos.injected()])
        finally:
            srv.stop()

    twin(scen, tmp_path)


def test_chaos_partition_heals_with_backoff(tmp_path):
    def scen(P, root):
        P.obs.configure(enabled=True, out=str(root / "o.jsonl"))
        P.chaos.configure(plan=_chaos_plan(partition={"at": [1, 2]}),
                          enabled=True)
        srv = P.CollectorServer().start()
        try:
            exp = _exporter(P, srv.port)
            P.core.event("p.ev", i=0)
            assert _drain(exp)
            assert exp.stats["dial_failures"] == 2
            assert exp.stats["connects"] == 1
            assert srv.origins()[0]["accepted"] == exp.stats["acked_seq"]
            exp.close()
            return _origins(srv), exp.stats
        finally:
            srv.stop()

    twin(scen, tmp_path)


# --------------------------------- the obs.dropped gauge and its alert


def test_subscriber_saturation_gauges_and_alerts_once(tmp_path):
    def scen(P, root):
        P.obs.configure(enabled=True, out=str(root / "o.jsonl"))
        att = P.live.attach(maxlen=4)
        try:
            for i in range(64):
                P.core.event("sat.ev", i=i)
            att.poll()
            alerts = [a for a in att.monitor.alerts
                      if a["rule"].startswith("obs_dropped")]
            assert len(alerts) == 1, att.monitor.alerts
            snap = att.monitor.snapshot()
            assert snap["obs"]["dropped"] > 0
            for i in range(64):
                P.core.event("sat2.ev", i=i)
            att.poll()
            again = [a for a in att.monitor.alerts
                     if a["rule"].startswith("obs_dropped")]
            assert len(again) == 1
            return snap["obs"], len(again)
        finally:
            att.close()

    twin(scen, tmp_path)


# ------------------------- the origin LRU bounds Prometheus label sets


def _ship_lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("cause_tpu_live_ship_",
                              "# TYPE cause_tpu_live_ship_"))]


def test_origin_lru_bounds_prometheus_label_cardinality():
    def scen(P):
        srv = P.CollectorServer(origin_lru=3).start()
        try:
            for pid in range(10):
                fs = _dial(P, srv.port)
                _hello(P, fs, pid=pid, epoch=1)
                P.sync.send_frame(fs, {
                    "op": "obs", "base": 1, "dropped": 0,
                    "records": [{"ev": "gauge", "name": "serve.depth",
                                 "pid": pid, "value": float(pid)}]})
                P.recv_msg(fs, 5.0)
                fs.close()
            assert srv.stats["evicted_origins"] == 7
            snap = srv.snapshot()
            assert len(snap["origins"]) == 3
            text = P.watch.prometheus_text(snap)
            labeled = [ln for ln in text.splitlines()
                       if ln.startswith("cause_tpu_origin_serve_depth{")]
            assert len(labeled) == 3, text
            assert all('host="testhost"' in ln for ln in labeled)
            ship = _ship_lines(text)
            if P is PORT:
                # the port's own family: the collector's accounting
                assert "cause_tpu_live_ship_origins 3" in ship
                assert "cause_tpu_live_ship_accepted_total 10" in ship
                assert "cause_tpu_live_ship_missed_total 0" in ship
            else:
                assert ship == []
            rest = [ln for ln in text.splitlines() if ln not in ship]
            return rest, sorted(labeled)
        finally:
            srv.stop()

    twin(scen)


# ------------------------------------------------- watch --collector


def _cli(P, *argv, env=None):
    return subprocess.run(
        [sys.executable, "-m", f"{P.mod}.obs", *argv],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})})


def test_watch_collector_once_renders_fleet(tmp_path):
    def scen(P, root):
        P.obs.configure(enabled=True, out=str(root / "o.jsonl"))
        srv = P.CollectorServer().start()
        try:
            exp = _exporter(P, srv.port)
            P.core.event("w.ev", i=1)
            assert _drain(exp)
            out = _cli(P, "watch", "--collector",
                       f"127.0.0.1:{srv.port}", "--once")
            assert out.returncode == 0, out.stderr
            assert "ship:" in out.stdout and "origin(s)" in out.stdout
            assert "wm" in out.stdout
            outj = _cli(P, "watch", "--collector",
                        f"127.0.0.1:{srv.port}", "--once", "--json")
            snap = json.loads(outj.stdout)["snapshot"]
            assert snap["ship"]["active"] and snap["origins"]
            exp.close()
        finally:
            srv.stop()
        bad = _cli(P, "watch", "--once")
        assert bad.returncode == 2
        lines = [ln.split(":")[0].strip() for ln in out.stdout.splitlines()]
        return lines, snap["ship"], bad.returncode

    twin(scen, tmp_path)


# ----------------------------- journey --file and the bare 16-hex trace


def test_journey_cli_disambiguates_trace_vs_file(tmp_path):
    def scen(P, root):
        P.obs.configure(enabled=True, out=str(root / "j.jsonl"))
        tr = P.xtrace.new_trace()
        P.xtrace.hop("mint", tr, parent="")
        P.xtrace.hop("send", tr)
        P.obs.flush()
        P.obs.configure(enabled=False)
        stream = str(root / "j.jsonl")
        out = _cli(P, "journey", tr, "--file", stream)
        assert out.returncode == 0, out.stderr
        assert tr in out.stdout
        out2 = _cli(P, "journey", stream)
        assert out2.returncode == 0, out2.stderr
        out3 = _cli(P, "journey", "0123456789abcdef", "--file", stream)
        assert "0123456789abcdef" in (out3.stdout + out3.stderr)
        # the hop lines without their timings
        hops = [ln.split()[-3:] for ln in out.stdout.splitlines()
                if ln.lstrip().startswith("+")]
        return hops, out2.returncode, out3.returncode

    twin(scen, tmp_path)


# ------------------------------------------- the chip-pending matrix


def test_ledger_pending_matrix(tmp_path, monkeypatch):
    """The chip platform claims a partition: ``tpu`` in the reference,
    ``gpu`` in the port."""
    def scen(P, root):
        path = str(root / "ledger.jsonl")
        monkeypatch.setenv("CAUSE_TPU_LEDGER", path)
        base = {"metric": "m", "value": 1.0, "kernel": "wave",
                "config": "c1", "smoke": True}
        P.ledger.ingest_record(dict(base, platform="cpu"), source="s")
        P.ledger.ingest_record(dict(base, platform=P.chip), source="s")
        P.ledger.ingest_record(dict(base, platform="cpu", config="c2"),
                               source="s")
        m = P.ledger.pending(path=path)
        assert m["partitions"] == 2 and m["claimed"] == 1
        assert len(m["pending"]) == 1
        assert m["pending"][0]["config"] == "c2"
        out = _cli(P, "ledger", "--pending",
                   env={"CAUSE_TPU_LEDGER": path})
        assert out.returncode == 0, out.stderr
        assert "pending" in out.stdout
        return m

    twin(scen, tmp_path)


# ------------------------------------------------- the service's knob


def _service(P, root):
    """A service on the CPU (``test_torch_serve``'s twin packages)."""
    from test_torch_serve import REF as SREF, PORT as SPORT

    S = SREF if P is REF else SPORT
    q = S.IngestQueue(max_ops=256,
                      journal=S.IngestJournal(str(root / "wal.jsonl")))
    return S, S.SyncService(q, checkpoint_dir=str(root / "ckpt"),
                            d_max=16)


def test_service_knob_is_read(tmp_path, monkeypatch):
    """The reference pins ``CAUSE_TPU_OBS_SHIP`` in its switch registry;
    the port has none, so the mirror holds what the knob does in both:
    with telemetry on, a parseable endpoint arms the service's uplink,
    an unparseable one is ignored, and telemetry off arms nothing."""
    before = ct.default_device()
    ct.use_device("cpu")

    def scen(P, root):
        got = []
        for i, (obs_on, raw) in enumerate(((True, "127.0.0.1:1"),
                                           (True, "garbage"),
                                           (False, "127.0.0.1:1"))):
            monkeypatch.setenv("CAUSE_TPU_OBS_SHIP", raw)
            P.obs.configure(enabled=obs_on)
            sub = root / str(i)
            sub.mkdir()
            _S, svc = _service(P, sub)
            exp = svc._ship
            got.append(None if exp is None
                       else (exp.host, exp.port, exp.site))
            svc.close()
            assert svc._ship is None
            P.obs.configure(enabled=False)
            P.obs.reset()
        monkeypatch.delenv("CAUSE_TPU_OBS_SHIP")
        return got

    try:
        got = twin(scen, tmp_path)
    finally:
        ct.use_device(before)
    assert got == [("127.0.0.1", 1, "obs.ship"), None, None]


def test_service_uplink_ships_every_record_and_close_flushes(tmp_path,
                                                              monkeypatch):
    """A ``SyncService`` under ``CAUSE_TPU_OBS_SHIP`` ships every record
    it emits from its construction on (the uplink's ``ship.attach``
    first) to the collector, and ``close()`` flushes the uplink: the
    collector holds exactly the records the sidecar holds from
    ``ship.attach`` to the last shipped one, with nothing missed,
    dropped or left unshipped (the reference has no such test). The
    collector runs in this process, so its own ``ship.hello`` ships
    too; the lag SLO is out of reach and both controllers hold still,
    as ``test_torch_serve.obs_twin`` holds them."""
    from cause_tpu.serve import controller as j_controller
    from cause_tpu_torch.serve import controller as t_controller
    from test_torch_serve import base, delta_items, pair

    monkeypatch.setenv("CAUSE_TPU_LAG_SLO_MS", "1e9")
    for mod in (j_controller, t_controller):
        monkeypatch.setattr(mod.BatchController, "update",
                            lambda self, snapshot: self.t_batch_ms)
    before = ct.default_device()
    ct.use_device("cpu")

    def scen(P, root):
        srv = P.CollectorServer().start()
        try:
            monkeypatch.setenv("CAUSE_TPU_OBS_SHIP",
                               f"127.0.0.1:{srv.port}")
            P.obs.configure(enabled=True, out=str(root / "o.jsonl"))
            S, svc = _service(P, root)
            exp = svc._ship
            assert exp is not None
            # the uplink's thread is on its own clock: let it connect
            # before the traffic, and keep its heartbeats (a timer)
            # out of the twin streams
            exp.heartbeat_s = 1e9
            deadline = time.monotonic() + 10.0
            while not exp.connected and time.monotonic() < deadline:
                time.sleep(0.01)
            assert exp.connected
            a, b = pair(S, base(S, 12))
            uuid = svc.add_tenant(a, b)
            a2 = a.conj("x1").conj("x2")
            adm = svc.queue.offer(uuid, a2.ct.site_id,
                                  delta_items(S, a2, a))
            assert adm.admitted
            svc.tick()
            P.obs.flush()
            svc.close()
            monkeypatch.delenv("CAUSE_TPU_OBS_SHIP")
            assert exp.stats["unshipped"] == 0
            assert exp.total_dropped() == 0
            (org,) = srv.origins()
            assert org["missed"] == 0 and org["dup_records"] == 0
            assert org["accepted"] == org["watermark"] \
                == exp.stats["acked_seq"] == exp._next_seq - 1
            P.obs.flush()
            with open(root / "o.jsonl") as f:
                side = [json.loads(ln) for ln in f if ln.strip()]
            shipped = [json.dumps(r, sort_keys=True) for r in srv.records]
            keys = [json.dumps(r, sort_keys=True) for r in side]
            start = next(i for i, r in enumerate(side)
                         if r.get("name") == "ship.attach")
            end = len(keys) - 1 - keys[::-1].index(shipped[-1])
            assert sorted(shipped) == sorted(keys[start:end + 1])
            names = {r.get("name") for r in comparable(srv.records)}
            for want in ("ship.attach", "xtrace.clock", "serve.tick",
                         "wave.digest"):
                assert want in names, want
            return org["accepted"] > 0, sorted(n for n in names if n)
        finally:
            srv.stop()

    try:
        twin(scen, tmp_path)
    finally:
        ct.use_device(before)


# ------------------------------------------------ across the packages


@pytest.mark.parametrize("exp_pkg,col_pkg", [("port", "ref"),
                                             ("ref", "port")])
def test_cross_package_uplink_exact_accounting(tmp_path, exp_pkg, col_pkg):
    """A port exporter shipping into a reference collector, and the
    reverse: the frames are the same protocol, every record lands once,
    in order, and a severed link resumes with the missed suffix only."""
    E, C = PKGS[exp_pkg], PKGS[col_pkg]
    E.obs.configure(enabled=True, out=str(tmp_path / "o.jsonl"))
    C.obs.configure(enabled=True)  # its replies carry clock stamps
    srv = C.CollectorServer().start()
    try:
        exp = _exporter(E, srv.port)
        for i in range(30):
            E.core.event("x.ev", i=i)
        assert _drain(exp)
        with exp._pump_lock:
            exp._disconnect_locked("test-sever")
        for i in range(30, 50):
            E.core.event("x.ev", i=i)
        assert _drain(exp)
        (org,) = srv.origins()
        assert org["missed"] == 0 and org["dup_records"] == 0
        assert org["accepted"] == org["watermark"] \
            == exp.stats["acked_seq"] == exp._next_seq - 1
        assert exp.stats["reconnects"] == 1
        assert [r["fields"]["i"] for r in srv.records
                if r.get("name") == "x.ev"] == list(range(50))
        assert exp.stats["clock_samples"] >= 2
        exp.close()
        assert exp.stats["unshipped"] == 0
        snap = srv.snapshot()
        assert snap["ship"]["accepted"] == org["accepted"]
    finally:
        srv.stop()
