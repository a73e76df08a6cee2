"""The port's ``watch`` dashboard, its Prometheus endpoint and the
journey fold's cross-process cases against the JAX package's.

Mirrors the dashboard cases that waited for the ``watch`` port:
``tests/test_live.py:424`` (the multi-stream tailer), ``:465``,
``:479``, ``:501`` and ``:512`` (``watch --once``, its JSON and rules,
the rendered sections, the ``/metrics`` endpoint), ``test_serve.py:755``
(the ``serve:`` line), ``test_wal.py:570`` (the disk families) and
``test_xtrace.py:389``, ``:485`` and ``:514`` (skew-corrected journeys
and their CLI, the live fold's journey section). Each runs in both
packages over the same inputs; what it renders, exports or folds must
be equal, the CLI's output too (the port's CLI is
``python -m cause_tpu_torch.obs``).
"""

import json
import os
import subprocess
import sys
import urllib.request

import pytest

from test_torch_costmodel_lag import (JAX, PORT, _fresh,  # noqa: F401
                                      wave_digest, window_event)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R9_STREAM = os.path.join(REPO, "measurements", "obs_lag_r9.jsonl")


def watch(P):
    from importlib import import_module

    return import_module(f"{P.obs.__name__}.watch")


def both(fn):
    """``fn(P)`` in both packages; their records must be equal."""
    ref, port = fn(JAX), fn(PORT)
    assert port == ref
    return port


def _cli(P, *argv):
    return subprocess.run(
        [sys.executable, "-m", P.obs.__name__, *argv],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})


def _write_lines(path, events, mode="a"):
    with open(path, mode) as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


# ------------------------------------------------- tailing + watch


def test_multi_stream_tail_with_rotation(tmp_path):
    def scen(P):
        root = tmp_path / P.obs.__name__
        root.mkdir()
        a, b = str(root / "a.jsonl"), str(root / "b.jsonl")
        tail = P.live.MultiTailer([a, b])
        seen = [tail.poll()]
        assert seen[-1] == []
        _write_lines(a, [wave_digest(ts_us=10, uuid="d1")], mode="w")
        _write_lines(b, [wave_digest(ts_us=5, uuid="d2")], mode="w")
        seen.append(tail.poll())
        assert [e["ts_us"] for e in seen[-1]] == [5, 10]
        with open(a, "a") as f:
            f.write('{"ev": "event", "na')
        seen.append(tail.poll())
        assert seen[-1] == []
        with open(a, "a") as f:
            f.write('me": "wave.digest", "ts_us": 20}\n')
        seen.append(tail.poll())
        assert len(seen[-1]) == 1 and seen[-1][0]["ts_us"] == 20
        os.remove(a)
        _write_lines(a, [wave_digest(ts_us=30, uuid="d1")], mode="w")
        seen.append(tail.poll())
        assert len(seen[-1]) == 1 and seen[-1][0]["ts_us"] == 30
        _write_lines(b, [wave_digest(ts_us=35, uuid="d2"),
                         wave_digest(ts_us=36, uuid="d2")])
        seen.append(tail.poll())
        assert [e["ts_us"] for e in seen[-1]] == [35, 36]
        _write_lines(b, [wave_digest(ts_us=40, uuid="d2")], mode="w")
        seen.append(tail.poll())
        assert len(seen[-1]) == 1 and seen[-1][0]["ts_us"] == 40
        tail.close()
        return seen

    both(scen)


def test_watch_once_renders_committed_stream():
    def scen(P):
        res = _cli(P, "watch", R9_STREAM, "--once")
        assert res.returncode == 0, res.stderr
        assert "live telemetry" in res.stdout
        assert "64 replicas" in res.stdout
        assert "SLO 100 ms" in res.stdout
        assert "alerts:" in res.stdout
        assert "absence:wave.digest" not in res.stdout
        assert "burn>2" in res.stdout
        return res.stdout

    both(scen)


def test_watch_once_json_and_custom_rules(tmp_path):
    def scen(P):
        stream = str(tmp_path / f"{P.obs.__name__}.jsonl")
        _write_lines(stream, [wave_digest(ts_us=1_000_000),
                              window_event(P, ts_us=2_000_000)], mode="w")
        res = _cli(P, "watch", stream, "--once", "--json", "--rules",
                   "p99>0.001")
        assert res.returncode == 0, res.stderr
        doc = json.loads(res.stdout)
        assert doc["snapshot"]["fleet"]["waves"] == 1
        assert len(doc["alerts"]) == 1
        assert doc["alerts"][0]["rule"] == "p99>0.001"
        healthy = _cli(P, "watch", stream, "--once", "--json")
        assert json.loads(healthy.stdout)["alerts"] == []
        bad_rule = _cli(P, "watch", stream, "--once", "--rules",
                        "garbage")
        assert bad_rule.returncode == 2
        missing = _cli(P, "watch", str(tmp_path / "nope.jsonl"), "--once")
        assert missing.returncode == 2
        snap = doc["snapshot"]
        return ({k: snap[k] for k in ("fleet", "lag", "sync")},
                [a["rule"] for a in doc["alerts"]],
                bad_rule.returncode, missing.returncode)

    both(scen)


def _r9_snapshot(P):
    events = P.perfetto.load_jsonl(R9_STREAM)
    mon = P.live.LiveMonitor()
    mon.feed(events)
    return mon, mon.snapshot(now_us=mon.fold.last_ts_us)


def test_watch_render_sections():
    def scen(P):
        mon, snap = _r9_snapshot(P)
        text = watch(P).render(snap, mon.alerts, [R9_STREAM])
        for needle in ("fleet:", "lag:", "sync:", "cost:", "ages:",
                       "alerts:"):
            assert needle in text, text
        return text

    both(scen)


def test_prometheus_endpoint_smoke():
    def scen(P):
        _mon, snap = _r9_snapshot(P)
        w = watch(P)
        text = w.prometheus_text(snap)
        assert "cause_tpu_live_ops_converged 16" in text
        assert "cause_tpu_live_waves_total 8" in text
        assert "# TYPE cause_tpu_live_lag_p99_ms gauge" in text
        server, port = w.serve_metrics(0, lambda: snap)
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10
            ).read().decode()
            assert body == text
            doc = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/", timeout=10).read())
            assert doc["lag"]["ops_converged"] == 16
        finally:
            server.shutdown()
            server.server_close()
        return text, doc["lag"]

    both(scen)


# ---------------------------------------- the serve and disk families


def test_watch_renders_serve_line():
    def scen(P):
        mon = P.live.LiveMonitor(source="t")
        mon.feed([
            {"ev": "event", "name": "serve.tick", "ts_us": 1_000_000,
             "fields": {"ops": 2}},
            {"ev": "gauge", "name": "serve.queue_depth",
             "ts_us": 1_000_000, "value": 5},
        ])
        w = watch(P)
        text = w.render(mon.snapshot(now_us=2_000_000), [], ["x"])
        assert "serve: 1 tick(s)" in text
        assert "queue depth 5" in text
        prom = w.prometheus_text(mon.snapshot(now_us=2_000_000))
        assert "cause_tpu_live_serve_queue_depth 5" in prom
        return text, prom

    both(scen)


def test_prometheus_exports_disk_metrics():
    """The reference's families are all the port's; the port adds the
    ship plane's (``tests/test_torch_ship.py``)."""
    def scen(P):
        names = [m[0] for m in watch(P)._PROM_METRICS]
        for want in ("cause_tpu_live_serve_disk_faults_total",
                     "cause_tpu_live_serve_journal_torn_total",
                     "cause_tpu_live_serve_wal_segments",
                     "cause_tpu_live_serve_wal_bytes"):
            assert want in names
        return [n for n in names if not n.startswith("cause_tpu_live_ship_")]

    both(scen)
    ship = [m[0] for m in watch(PORT)._PROM_METRICS
            if m[0].startswith("cause_tpu_live_ship_")]
    assert ship and not [m for m in watch(JAX)._PROM_METRICS
                         if m[0].startswith("cause_tpu_live_ship_")]


# ------------------------------------ journeys: clock skew, live fold


def _rec(pid, ts_us, name, **fields):
    return {"ev": "event", "name": name, "ts_us": ts_us, "pid": pid,
            "tid": 1, "parent": "", "platform": "cpu",
            "fields": fields}


def _hop_names(j):
    return [h["hop"] for h in j["hops"]]


def test_journey_corrects_cross_host_clock_skew(tmp_path):
    """Two processes' streams with the client clock 5 s ahead: the
    fold's offset correction restores causal order, counts an orphan,
    and the ``journey`` CLI over the two files agrees."""
    tr = "ab" * 8
    client, server = 111, 222
    stream_client = [
        _rec(client, 10_000_000, "xtrace.clock", remote_pid=server,
             offset_us=-5_000_000.0, rtt_us=800, via="hello"),
        _rec(client, 10_000_000, "xtrace.hop", trace=tr, span="c.1",
             parent="", hop="mint"),
        _rec(client, 10_001_000, "xtrace.hop", trace=tr, span="c.2",
             parent="c.1", hop="send"),
    ]
    stream_server = [
        _rec(server, 5_002_000, "xtrace.hop", trace=tr, span="s.1",
             parent="c.2", hop="recv"),
        _rec(server, 5_003_000, "xtrace.hop", trace=tr, span="s.2",
             parent="s.1", hop="admit"),
        _rec(server, 5_004_500, "xtrace.hop", trace=tr, span="s.3",
             parent="s.2", hop="converged"),
    ]
    pa, pb = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    pa.write_text("".join(json.dumps(r) + "\n" for r in stream_client))
    pb.write_text("".join(json.dumps(r) + "\n" for r in stream_server))

    def scen(P):
        fold = P.journey.JourneyFold(retain_all=True)
        fold.feed_many(stream_client + stream_server)
        offsets, ref = fold.offsets()
        assert ref == server
        assert offsets[client] == -5_000_000.0 and offsets[server] == 0.0
        j = fold.journey(tr)
        assert _hop_names(j) == ["mint", "send", "recv", "admit",
                                 "converged"]
        assert all(h["dt_ms"] >= 0 for h in j["hops"])
        assert j["orphans"] == 0 and j["complete"]
        assert j["total_ms"] == pytest.approx(4.5, abs=0.01)
        assert j["edges"]["send→recv"] == pytest.approx(1.0, abs=0.01)
        fold.feed(_rec(server, 5_005_000, "xtrace.hop", trace=tr,
                       span="s.9", parent="GONE", hop="shed"))
        j2 = fold.journey(tr)
        assert j2["orphans"] == 1
        res = _cli(P, "journey", tr, str(pa), str(pb))
        assert res.returncode == 0, res.stderr
        assert "5 hop(s) across 2 process(es)" in res.stdout
        rep = P.journey.journey_report(stream_client + stream_server)
        assert rep["complete"] == 1 and rep["orphan_hops"] == 0
        assert rep["clock"]["ref_pid"] == server
        return j, j2["orphans"], res.stdout, rep

    both(scen)


def test_live_fold_journey_section_and_prometheus():
    tr = "cd" * 8
    stream = [
        _rec(7, 1_000_000, "xtrace.hop", trace=tr, span="a.1",
             parent="", hop="mint"),
        _rec(7, 1_250_000, "xtrace.hop", trace=tr, span="a.2",
             parent="a.1", hop="converged"),
    ]

    def scen(P):
        lf = P.live.LiveFold()
        for r in stream:
            lf.feed(r)
        snap = lf.snapshot()
        jy = snap["journey"]
        assert jy["active"] and jy["traces"] == 1 and jy["complete"] == 1
        assert jy["worst_trace"] == tr
        assert jy["total_p99_ms"] == pytest.approx(250.0, rel=0.5)
        w = watch(P)
        out = w.render(snap, alerts=[], paths=["x"])
        assert "journeys:" in out and tr in out
        prom = w.prometheus_text(snap)
        assert "cause_tpu_live_journey_traces_total 1" in prom
        assert "cause_tpu_live_journey_complete_total 1" in prom
        lines = [ln for ln in out.splitlines() if "journeys:" in ln]
        return jy, lines, [ln for ln in prom.splitlines()
                           if "journey" in ln]

    both(scen)


def test_live_fold_inside_slo_journeys_fold_without_exemplar():
    tr = "ef" * 8

    def scen(P):
        lf = P.live.LiveFold()
        lf.feed(_rec(7, 1_000_000, "xtrace.hop", trace=tr, span="a.1",
                     parent="", hop="mint"))
        lf.feed(_rec(7, 1_002_000, "xtrace.hop", trace=tr, span="a.2",
                     parent="a.1", hop="converged"))
        jy = lf.snapshot()["journey"]
        assert jy["complete"] == 1 and jy["worst_trace"] is None
        assert lf.journeys.journey(tr) is None
        assert jy["total_p50_ms"] == pytest.approx(2.0, rel=0.5)
        return jy

    both(scen)
