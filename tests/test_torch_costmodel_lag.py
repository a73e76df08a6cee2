"""The port's cost model, lag tracer, journeys, ledger and live fold
against the JAX package's.

Mirrors ``tests/test_costmodel.py``, ``test_lag.py``, ``test_ledger.py``,
``test_live.py`` (its ``watch`` dashboard and Prometheus endpoint cases
are in ``tests/test_torch_watch.py``) and the in-process cases of
``test_xtrace.py`` (its wire cases are in ``tests/test_torch_net.py``,
its journey across a restore in ``tests/test_torch_serve.py`` and its
cross-process journey cases in ``tests/test_torch_watch.py``). Host-side cases run against BOTH packages (the
``P`` fixture); the fleet cases build ``weaver="jax"`` fleets in the
reference and ``weaver="torch"`` fleets in the port, whose device paths
run on the CPU through the kernels' plain versions.

The acceptance property of the read side: both packages' folds
(``LagReducer``, ``FleetReducer``, ``CostReducer``, the counter
reducer and ``LiveFold``) over the committed streams under
``measurements/`` give BYTE-identical reports
(``test_folds_are_byte_identical_across_packages``).

What the port changes on purpose, each pinned here: the dispatch floor
is the H100's (``costmodel.DISPATCH_FLOOR_MS`` IS
``serve.controller.DISPATCH_FLOOR_MS``, no TPU range); the gap report's
headline platform and the ledger's wall-time gate are ``gpu``; the
ledger's default file is the port's own and its deterministic gate
compares kernel launches; the reference's ``backfill`` of its TPU
artifacts is not copied.
"""

import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import pytest

import cause_tpu as c
from cause_tpu import obs as j_obs
from cause_tpu import sync as j_sync
from cause_tpu.collections import clist as j_clist
from cause_tpu.obs import costmodel as j_cm
from cause_tpu.obs import fleet as j_fleet
from cause_tpu.obs import journey as j_journey
from cause_tpu.obs import lag as j_lag
from cause_tpu.obs import ledger as j_ledger
from cause_tpu.obs import live as j_live
from cause_tpu.obs import perfetto as j_perfetto
from cause_tpu.obs import semantic as j_sem
from cause_tpu.obs import xtrace as j_xtrace
from cause_tpu.parallel import merge_wave as j_merge_wave
from cause_tpu.parallel.session import FleetSession as JSession
from cause_tpu.parallel.tree import merge_tree as j_merge_tree

import cause_tpu_torch as ct
from cause_tpu_torch import obs as t_obs
from cause_tpu_torch import sync as t_sync
from cause_tpu_torch.collections import clist as t_clist
from cause_tpu_torch.obs import costmodel as t_cm
from cause_tpu_torch.obs import fleet as t_fleet
from cause_tpu_torch.obs import journey as t_journey
from cause_tpu_torch.obs import lag as t_lag
from cause_tpu_torch.obs import ledger as t_ledger
from cause_tpu_torch.obs import live as t_live
from cause_tpu_torch.obs import perfetto as t_perfetto
from cause_tpu_torch.obs import semantic as t_sem
from cause_tpu_torch.obs import xtrace as t_xtrace
from cause_tpu_torch.parallel.session import FleetSession as TSession
from cause_tpu_torch.parallel.tree import merge_tree as t_merge_tree
from cause_tpu_torch.serve import controller as t_controller

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = ["obs_lag_r9.jsonl", "obs_live_r10.jsonl", "obs_tree_r8.jsonl",
           "obs_sweep_r7.jsonl", "obs_chaos_r11.jsonl",
           "obs_serve_batched_r18.jsonl", "obs_net_r19.jsonl"]

JAX = SimpleNamespace(
    pkg=c, obs=j_obs, cm=j_cm, fleet=j_fleet, journey=j_journey,
    lag=j_lag, ledger=j_ledger, live=j_live, perfetto=j_perfetto,
    sem=j_sem, xtrace=j_xtrace, sync=j_sync, clist=j_clist,
    weaver="jax", merge_wave=j_merge_wave, Session=JSession,
    merge_tree=j_merge_tree)
PORT = SimpleNamespace(
    pkg=ct, obs=t_obs, cm=t_cm, fleet=t_fleet, journey=t_journey,
    lag=t_lag, ledger=t_ledger, live=t_live, perfetto=t_perfetto,
    sem=t_sem, xtrace=t_xtrace, sync=t_sync, clist=t_clist,
    weaver="torch", merge_wave=ct.merge_wave, Session=TSession,
    merge_tree=t_merge_tree)


def reset_all():
    for p in (JAX, PORT):
        p.obs.reset()
        p.sem.reset()
        p.cm.reset()
        p.lag.reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("CAUSE_TPU_OBS", "CAUSE_TPU_OBS_OUT", "CAUSE_TPU_OBS_RING",
              "CAUSE_TPU_LEDGER", "CAUSE_TPU_LAG_SLO_MS", "BENCH_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    before = ct.default_device()
    ct.use_device("cpu")
    reset_all()
    yield
    reset_all()
    ct.use_device(before)


@pytest.fixture(params=["jax", "torch"])
def P(request):
    return JAX if request.param == "jax" else PORT


def j(x):
    return json.dumps(x, sort_keys=True)


def fleet_base(P, n=20):
    base = P.clist.CausalList(P.clist.weave(
        P.pkg.clist(weaver=P.weaver).extend(["w"] * n).ct))
    base.ct.lanes.segments()
    return base


def replica_pair(P, base, edits_a=("A",), edits_b=("B",)):
    a = P.clist.CausalList(base.ct.evolve(site_id=P.pkg.new_site_id()))
    b = P.clist.CausalList(base.ct.evolve(site_id=P.pkg.new_site_id()))
    for v in edits_a:
        a = a.conj(v)
    for v in edits_b:
        b = b.conj(v)
    return a, b


def events(P, name=None):
    evs = [e for e in P.obs.events() if e.get("ev") == "event"]
    return [e["fields"] for e in evs if name is None or e["name"] == name]


def window_event(P, pid=1, epoch=0, pending=0, converged=2, breach=0,
                 slo=100.0, ts_us=1000, lag_us=4000):
    """A minimal but schema-complete lag.window record (the reference
    test's helper)."""
    h = P.lag.LagHistogram()
    for _ in range(converged):
        h.record_us(lag_us)
    return {"ev": "event", "name": "lag.window", "pid": pid,
            "ts_us": ts_us,
            "fields": {"uuid": "u", "source": "wave", "epoch": epoch,
                       "woven": converged, "converged": converged,
                       "pending": pending, "slo_ms": slo,
                       "slo_breach": breach,
                       "converged_total": converged,
                       "breach_total": breach,
                       "hist_woven": h.to_fields(),
                       "hist_converged": h.to_fields(),
                       "window": {"n": max(1, converged),
                                  "p50_ms": lag_us / 1000.0,
                                  "p95_ms": lag_us / 1000.0,
                                  "p99_ms": lag_us / 1000.0,
                                  "breach_frac": (breach
                                                  / max(1, converged)),
                                  "burn_rate": round(
                                      (breach / max(1, converged))
                                      / 0.01, 2)}}}


def wave_digest(ts_us=1000, uuid="u", agreed=True, pairs=2):
    return {"ev": "event", "name": "wave.digest", "pid": 1,
            "ts_us": ts_us,
            "fields": {"uuid": uuid, "source": "wave", "wave": 1,
                       "pairs": pairs, "valid": pairs, "distinct": 1,
                       "agreed": agreed, "staleness": {"0": pairs}}}


# ------------------------------------------- folds across packages


def _stream(name):
    path = os.path.join(REPO, "measurements", name)
    evs = j_perfetto.load_jsonl(path)
    assert evs, path
    assert j(t_perfetto.load_jsonl(path)) == j(evs)
    return evs


FOLDS = {
    "lag": lambda P, evs: P.lag.lag_summary(evs),
    "lag_reducer": lambda P, evs: _feed(P.lag.LagReducer(), evs).report(),
    "fleet": lambda P, evs: P.fleet.fleet_report(evs),
    "fleet_reducer": lambda P, evs: _feed(P.fleet.FleetReducer(),
                                          evs).report(),
    "cost": lambda P, evs: P.cm.costmodel_digest(evs),
    "cost_reducer": lambda P, evs: _feed(P.cm.CostReducer(), evs).digest(),
    "counters": lambda P, evs: P.perfetto.merged_final_counters(evs),
    "live": lambda P, evs: _live(P, evs),
    "journey": lambda P, evs: P.journey.journey_report(evs),
    "journey_live": lambda P, evs: _feed(P.journey.JourneyFold(),
                                         evs).summary(),
    "gap": lambda P, evs: _gap(P, evs),
}


def _feed(reducer, evs):
    for e in evs:
        reducer.feed(e)
    return reducer


def _live(P, evs):
    fold = P.live.LiveFold()
    fold.feed_many(evs)
    snap = fold.snapshot(now_us=fold.last_ts_us)
    return {k: snap[k] for k in sorted(snap) if k not in ("ts_us",)}


def _gap(P, evs):
    rep = P.cm.gap_report([], events=evs, floor_ms=10.0)
    rep.pop("floor_range_ms", None)
    return rep


@pytest.mark.parametrize("fold", sorted(FOLDS))
@pytest.mark.parametrize("stream", STREAMS)
def test_folds_are_byte_identical_across_packages(stream, fold):
    evs = _stream(stream)
    assert j(FOLDS[fold](PORT, evs)) == j(FOLDS[fold](JAX, evs))


def test_incremental_folds_bit_equal_on_committed_stream(P):
    """``test_live.py``'s acceptance property, in each package."""
    evs = _stream("obs_lag_r9.jsonl")
    lr = _feed(P.lag.LagReducer(), evs)
    fr = _feed(P.fleet.FleetReducer(), evs)
    cr = _feed(P.cm.CostReducer(), evs)
    ctr = _feed(P.perfetto.CountersReducer(), evs)
    assert j(lr.report()) == j(P.lag.lag_summary(evs))
    assert j(fr.report()) == j(P.fleet.fleet_report(evs))
    assert j(cr.digest()) == j(P.cm.costmodel_digest(evs))
    assert j(ctr.totals()) == j(P.perfetto.merged_final_counters(evs))
    fold = P.live.LiveFold()
    fold.feed_many(evs)
    snap = fold.snapshot(now_us=fold.last_ts_us)
    assert j(snap["lag"]) == j(P.lag.lag_summary(evs))


def test_cli_reports_equal_the_folds(tmp_path):
    """``python -m cause_tpu_torch.obs lag|fleet|gap`` print the port's
    folds, which equal the reference's."""
    path = os.path.join(REPO, "measurements", "obs_lag_r9.jsonl")
    evs = _stream("obs_lag_r9.jsonl")
    for sub, want in (("lag", j_lag.lag_summary(evs)),
                      ("fleet", j_fleet.fleet_report(evs))):
        r = subprocess.run(
            [sys.executable, "-m", "cause_tpu_torch.obs", sub, path,
             "--json"], capture_output=True, text=True, cwd=REPO)
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout) == json.loads(j(want))
    led = str(tmp_path / "led.jsonl")
    r = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.obs", "gap", "--obs",
         path, "--ledger", led, "--json"],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr
    rep = json.loads(r.stdout)
    assert rep["floor_ms"] == t_controller.DISPATCH_FLOOR_MS
    assert rep["headline"] is None and "floor_range_ms" not in rep


# ---------------------------------------------------------- costmodel


def test_floor_is_the_h100_constant():
    assert t_cm.DISPATCH_FLOOR_MS is t_controller.DISPATCH_FLOOR_MS
    assert t_cm.DISPATCH_FLOOR_MS == 28.58
    assert not hasattr(t_cm, "DISPATCH_FLOOR_RANGE_MS")
    assert "DISPATCH_FLOOR_RANGE_MS" not in t_cm.__all__


def test_merge_wave_emits_wave_cost(P):
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P))
    P.merge_wave([(a, b)] * 4)
    (f,) = events(P, "wave.cost")
    assert f["source"] == "wave" and f["pairs"] == 4
    assert f["dispatches"] == 2 and f["programs"] == 2
    assert f["lanes"] > 0 and 0 < f["tokens"] <= f["token_budget"]
    assert f["floor_ms"] == P.cm.DISPATCH_FLOOR_MS
    assert f["floor_budget_ms"] == round(P.cm.DISPATCH_FLOOR_MS * 2, 3)
    assert f["semantic"]["agreed"] is True
    assert f["full_bag"] == 0 and f["delta_ops"] == 0
    snap = P.obs.counters_snapshot()["counters"]
    assert snap["costmodel.waves"] == 1 and snap["costmodel.dispatches"] == 2
    gauges = {e["name"] for e in P.obs.events() if e.get("ev") == "gauge"}
    assert {"costmodel.dispatches.wave", "costmodel.tokens.wave"} <= gauges


def test_degenerate_wave_records_zero_dispatches(P):
    P.obs.configure(enabled=True)
    base = P.pkg.cmap().append(P.pkg.K("t"), "x")
    cm = type(base)
    a = cm(base.ct.evolve(site_id=P.pkg.new_site_id())).append(
        P.pkg.K("t"), "a")
    b = cm(base.ct.evolve(site_id=P.pkg.new_site_id())).append(
        P.pkg.K("u"), "b")
    P.merge_wave([(a, b)])
    (f,) = events(P, "wave.cost")
    assert f["dispatches"] == 0 and f["programs"] == 0
    assert f["full_bag"] == 1 and f["lanes"] == 0


def test_session_waves_join_delta_ops(P):
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P))
    sess = P.Session([(a, b)] * 4)
    sess.wave()
    sess.update([(a.conj("x"), b.conj("y"))] * 4)
    sess.wave()
    first, second = events(P, "wave.cost")
    assert first["source"] == "session" and first["path"] == "full"
    assert first["full_bag"] == 1 and first["delta_ops"] == 0
    assert first["dispatches"] == 2
    assert second["path"] == "delta" and second["delta_ops"] == 8
    assert second["full_bag"] == 0 and second["dispatches"] == 2
    assert second["semantic"]["agreed"] is True
    snap = P.obs.counters_snapshot()["counters"]
    assert snap["costmodel.dispatches.session"] == 5  # + the splice
    assert snap["session.delta_update"] == 1


def test_sync_delta_ops_flow_into_next_wave_cost(P):
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P))
    a2, b2 = P.sync.sync_pair(a, b)
    synced = sum(f["nodes"] for f in events(P, "sync.delta_apply"))
    assert synced > 0
    P.merge_wave([(a2, b2)])
    assert events(P, "wave.cost")[-1]["delta_ops"] == synced
    P.merge_wave([(a2, b2)])
    assert events(P, "wave.cost")[-1]["delta_ops"] == 0


def test_dispatch_count_leaves_out_b1_reweaves(P):
    """``sync.apply_delta``'s ``B = 1`` reweave through ``merge_many``
    is not a counted dispatch, in either package (``wave.cost`` parity;
    the port's ``kernels.launches`` still count its launches)."""
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P))
    P.sync.sync_pair(a, b)
    assert P.obs.counters_snapshot()["counters"].get(
        "costmodel.dispatches", 0) == 0


def test_cost_vs_divergence_verdicts(P):
    flat = [{"delta_ops": d, "wall_ms": 1000.0 + i, "lanes": 20480}
            for i, d in enumerate((10, 100, 400, 800))]
    assert P.cm.cost_vs_divergence(flat)["verdict"] == "O(doc)"
    prop = [{"delta_ops": d, "wall_ms": 5.0 + 2.0 * d, "lanes": 20480}
            for d in (10, 100, 400, 800)]
    got = P.cm.cost_vs_divergence(prop)
    assert got["verdict"] == "O(delta)"
    assert got["slope_ms_per_op"] == pytest.approx(2.0, rel=1e-3)
    floor = [{"delta_ops": d, "wall_ms": 70.0 + 0.05 * d, "lanes": 20480}
             for d in (0, 100, 200, 400)]
    assert P.cm.cost_vs_divergence(floor)["verdict"] == "O(doc)"
    for pts in ([], [{"delta_ops": 5, "wall_ms": 9.0}],
                [{"delta_ops": 5, "wall_ms": 9.0},
                 {"delta_ops": 5, "wall_ms": 11.0}]):
        assert P.cm.cost_vs_divergence(pts)["verdict"] \
            == "insufficient-data"


def test_costmodel_digest_and_ledger_row_extension(P, tmp_path):
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P))
    P.merge_wave([(a, b)] * 2)
    stream = tmp_path / "waves.jsonl"
    P.obs.export_jsonl(str(stream))
    digest = P.cm.costmodel_digest(P.obs.events())
    assert digest["waves"] == 1 and digest["dispatches"] == 2
    led = str(tmp_path / "ledger.jsonl")
    row = P.ledger.ingest_record(
        {"platform": "cpu", "metric": "m", "value": None,
         "kernel": "v5", "config": "t"},
        source="t", obs_jsonl=str(stream), path=led, kind="soak")
    assert row["cost"]["waves"] == 1
    assert row["cost"]["dispatches"] == digest["dispatches"]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    row2 = P.ledger.ingest_record(
        {"platform": "cpu", "metric": "m", "value": None},
        source="t2", obs_jsonl=str(empty), path=led, kind="soak")
    assert "cost" not in row2


def _row(platform, value_ms=40.0, single=45.0, source="run.log"):
    return {"schema": 1, "kind": "bench", "source": source,
            "platform": platform, "fallback": False, "smoke": False,
            "kernel": "v5", "config": "default",
            "metric": "p50 batched merge+weave", "value_ms": value_ms,
            "single_dispatch_ms": single, "quarantined": False}


def test_gap_report_headline_is_the_card():
    """The port cites its ``gpu`` row; a ``tpu`` or ``cpu`` row is
    shown per platform but never as the port's headline."""
    rows = [_row("gpu", 40.0), _row("tpu", 30.0), _row("cpu", 900.0)]
    rep = t_cm.gap_report(rows, events=[])
    assert rep["headline"]["platform"] == "gpu"
    assert rep["headline"]["value_ms"] == 40.0
    assert rep["floor_ms"] == t_cm.DISPATCH_FLOOR_MS
    assert set(rep["platforms"]) == {"gpu", "tpu", "cpu"}
    only_cpu = t_cm.gap_report([_row("cpu", 900.0)], events=[])
    assert "no gpu row" in only_cpu["headline"]["note"]
    text = t_cm.render_gap(rep)
    assert "dispatch floor 28.58 ms" in text
    # the reference keeps its own headline platform
    assert j_cm.gap_report(rows, events=[])["headline"]["platform"] \
        == "tpu"


def test_gap_report_decomposition_matches_reference_on_streams():
    """With an explicit floor and no ledger, both packages decompose a
    stream identically (paths, stages, tree levels, verdicts)."""
    evs = _stream("obs_tree_r8.jsonl") + _stream("obs_sweep_r7.jsonl")
    assert j(_gap(PORT, evs)) == j(_gap(JAX, evs))


# ---------------------------------------------------------------- lag


def test_histogram_records_and_quantiles(P):
    h = P.lag.LagHistogram()
    for us in (100, 200, 400, 800, 1600, 3200, 6400, 12800):
        h.record_us(us)
    assert h.count == 8 and h.min_us == 100 and h.max_us == 12800
    assert 0.1 <= h.quantile_ms(0.5) <= 3.2
    assert h.quantile_ms(1.0) == 12.8
    assert h.mean_ms() == round(sum(
        (100, 200, 400, 800, 1600, 3200, 6400, 12800)) / 8 / 1000, 4)


def test_histogram_merge_and_fields_roundtrip(P):
    H = P.lag.LagHistogram
    h1, h2 = H(), H()
    for us in (50, 500, 5000):
        h1.record_us(us)
    for us in (10, 100000):
        h2.record_us(us)
    merged = H.from_fields(h1.to_fields()).merge(H.from_fields(
        h2.to_fields()))
    ref = H()
    for us in (50, 500, 5000, 10, 100000):
        ref.record_us(us)
    assert merged.count == 5 and merged.buckets == ref.buckets
    assert merged.within_us(1 << 30) == 5


def test_session_rounds_resolve_ops(P):
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P))
    sess = P.Session([(a, b)] * 4)
    sess.wave()
    assert P.lag.pending_ops() == 0
    a2, b2 = a.conj("x"), b.conj("y")
    assert P.lag.pending_ops(a.ct.uuid) == 2
    sess.update([(a2, b2)] * 4)
    sess.wave()
    assert P.lag.pending_ops() == 0
    conv = [f for f in events(P, "op.lag") if f["phase"] == "converged"]
    assert {f["site"] for f in conv} >= {a.ct.site_id, b.ct.site_id}
    wins = events(P, "lag.window")
    assert wins[-1]["converged_total"] == len(conv)
    assert wins[-1]["slo_ms"] == P.lag.SLO_DEFAULT_MS
    gauges = {e["name"] for e in P.obs.events() if e.get("ev") == "gauge"}
    assert {"lag.p50_ms", "lag.p95_ms", "lag.p99_ms"} <= gauges


def test_disagreeing_wave_defers_convergence(P):
    P.obs.configure(enabled=True)
    base = fleet_base(P)
    a, b = replica_pair(P, base)
    a2, b2 = replica_pair(P, base, edits_a=("C",), edits_b=("D",))
    P.merge_wave([(a, b), (a2, b2)])
    assert all(f["phase"] == "woven" for f in events(P, "op.lag"))
    before = P.lag.pending_ops(a.ct.uuid)
    assert before > 0
    P.merge_wave([(a, b)] * 2)
    conv = [f for f in events(P, "op.lag") if f["phase"] == "converged"]
    assert len(conv) == before and P.lag.pending_ops(a.ct.uuid) == 0


def test_sync_apply_lag_per_replica_and_ingest_stamp(P):
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P))
    P.sync.sync_pair(a, b)
    reps = events(P, "lag.replica")
    assert {f["replica"] for f in reps} == {a.ct.site_id, b.ct.site_id}
    foreign = ((a.ct.lamport_ts + 7, P.pkg.new_site_id(), 0),
               list(a.ct.nodes)[0], "F")
    before = P.lag.pending_ops(a.ct.uuid)
    merged = P.sync.apply_delta(a, {foreign[0]: foreign[1:]})
    assert P.lag.pending_ops(a.ct.uuid) == before + 1
    P.merge_wave([(merged, merged)] * 2)
    assert P.lag.pending_ops(a.ct.uuid) == 0


def test_tree_resolution(P):
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P, 40), edits_a=("A0", "A1"),
                        edits_b=("B0",))
    assert P.lag.pending_ops(a.ct.uuid) > 0
    P.merge_tree([a, b] * 4)
    assert P.lag.pending_ops(a.ct.uuid) == 0
    wins = events(P, "lag.window")
    assert wins[-1]["source"] == "tree" and wins[-1]["converged"] > 0
    assert wins[0]["level"] == 0 and wins[0]["converged_total"] == 0


def test_doc_registry_is_lru_bounded(P, monkeypatch):
    P.obs.configure(enabled=True)
    monkeypatch.setattr(P.lag, "_DOC_MAX", 8)
    for i in range(20):
        P.lag.op_created(f"doc{i}", [(1, "s", 0)])
    assert len(P.lag._DOCS) == 8
    assert "doc0" not in P.lag._DOCS and "doc19" in P.lag._DOCS


def test_slo_env_and_set_slo(P, monkeypatch):
    monkeypatch.setenv("CAUSE_TPU_LAG_SLO_MS", "25")
    P.lag.reset()
    assert P.lag.slo_ms() == 25.0
    P.lag.set_slo(1.0)
    assert P.lag.slo_ms() == 1.0
    P.lag.set_slo(None)
    assert P.lag.slo_ms() == 25.0


def test_lag_summary_render_and_fleet_section(P):
    P.obs.configure(enabled=True)
    a, b = replica_pair(P, fleet_base(P))
    sess = P.Session([(a, b)] * 4)
    sess.wave()
    sess.update([(a.conj("x"), b.conj("y"))] * 4)
    sess.wave()
    P.obs.flush()
    rep = P.lag.lag_summary(P.obs.events())
    assert rep["ops_converged"] >= 2 and rep["pending"] == 0
    assert "converged" in P.lag.render(rep)
    assert P.fleet.fleet_report(P.obs.events())["lag"]["ops_converged"] \
        == rep["ops_converged"]


# --------------------------------------------------------------- ledger


def test_default_ledger_is_the_ports_own(monkeypatch):
    path = t_ledger.default_path()
    assert path.endswith(os.path.join("measurements_torch", "ledger.jsonl"))
    assert path != j_ledger.default_path()
    monkeypatch.setenv("CAUSE_TPU_LEDGER", "/x/led.jsonl")
    assert t_ledger.default_path() == "/x/led.jsonl"
    assert not hasattr(t_ledger, "backfill")


def test_normalize_bench_wrapper_and_fallbacks(P):
    wrap = {"n": 1, "cmd": "x", "rc": 0, "parsed": {
        "platform": "cpu-fallback", "metric": "m", "value": 12.0}}
    row = P.ledger.normalize_bench(wrap, source="w")
    assert row["platform"] == "cpu-fallback" and row["quarantined"]
    null = P.ledger.normalize_bench({"n": 2, "cmd": "x", "rc": 1,
                                     "parsed": None})
    assert null["platform"] == "none" and null["quarantined"]
    live_row = P.ledger.normalize_bench({"platform": "gpu", "metric": "m",
                                         "value": 3.0})
    assert not live_row["quarantined"]


def _chk(P, rows):
    return P.ledger.check(rows=rows)


def test_check_never_compares_across_platforms(P):
    rows = [_row("cpu", 10.0, source="a"), _row("gpu", 100.0, source="b")]
    assert _chk(P, rows)["ok"]


def test_wall_time_gates_only_on_the_cards_rows():
    slow_gpu = [_row("gpu", 10.0, source="a"), _row("gpu", 20.0, source="b")]
    v = t_ledger.check(rows=slow_gpu)
    assert not v["ok"] and v["regressions"][0]["kind"] == "wall_time"
    slow_tpu = [_row("tpu", 10.0, source="a"), _row("tpu", 20.0, source="b")]
    assert t_ledger.check(rows=slow_tpu)["ok"]
    slow_cpu = [_row("cpu", 10.0, source="a"), _row("cpu", 20.0, source="b")]
    assert t_ledger.check(rows=slow_cpu)["ok"]
    m = t_ledger.pending(rows=slow_tpu)
    assert m["claimed"] == 0 and len(m["pending"]) == 1
    assert t_ledger.pending(rows=slow_gpu)["claimed"] == 1


def test_launch_cost_is_a_deterministic_gate():
    a = dict(_row("cpu", source="a"), devprof={"launches": 8})
    b = dict(_row("cpu", source="b"), devprof={"launches": 9})
    v = t_ledger.check(rows=[a, b])
    assert not v["ok"] and v["regressions"][0]["metric"] == "launches"
    same = dict(b, devprof={"launches": 8})
    assert t_ledger.check(rows=[a, same])["ok"]


def test_counter_regression_is_deterministic_gate(P):
    a = dict(_row("cpu", source="a"), counters={"program_cache.miss": 2})
    b = dict(_row("cpu", source="b"), counters={"program_cache.miss": 3})
    v = _chk(P, [a, b])
    assert not v["ok"] and v["regressions"][0]["kind"] == "counters"


def test_ingest_with_devprof_digest_and_cli_check(tmp_path):
    """A port stream's ``devprof.program`` launch costs land in the
    row; ``ledger --check`` exits 1 on a regression."""
    side = tmp_path / "side.jsonl"
    side.write_text("\n".join(json.dumps(e) for e in (
        {"ev": "event", "name": "devprof.program", "pid": 1,
         "fields": {"pipeline": "v5", "cost": {"launches": 8}}},
        {"ev": "counters", "pid": 1, "counters": {"wave.pairs": 4},
         "gauges": {}})) + "\n")
    led = str(tmp_path / "led.jsonl")
    row = t_ledger.ingest_record({"platform": "gpu", "metric": "m",
                                  "value": 5.0}, source="r1",
                                 obs_jsonl=str(side), path=led)
    assert row["devprof"] == {"launches": 8, "programs": 1}
    assert row["counters"] == {"wave.pairs": 4}
    t_ledger.ingest_record({"platform": "gpu", "metric": "m",
                            "value": 50.0}, source="r2", path=led)
    r = subprocess.run([sys.executable, "-m", "cause_tpu_torch.obs",
                        "ledger", "--ledger", led, "--check"],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 1, r.stderr
    assert json.loads(r.stdout)["regressions"][0]["kind"] == "wall_time"


# ----------------------------------------------------------------- live


def test_obs_off_attach_is_none_and_records_nothing(P, tmp_path):
    out = str(tmp_path / "never.jsonl")
    P.obs.configure(enabled=False, out=out)
    assert P.obs.subscribe() is None and P.live.attach() is None
    mon = P.live.LiveMonitor(rules=["pending>0"])
    mon.feed([window_event(P, pending=3)])
    assert len(mon.evaluate()) == 1
    assert P.obs.events() == [] and not os.path.exists(out)


def test_subscriber_receives_and_is_bounded(P):
    P.obs.configure(enabled=True)
    sub = P.obs.subscribe()
    P.obs.event("wave.digest", uuid="u", agreed=True)
    with P.obs.span("x"):
        pass
    assert [e["ev"] for e in sub.drain()] == ["event", "span"]
    P.obs.unsubscribe(sub)
    P.obs.event("wave.digest", uuid="u")
    assert sub.drain() == []
    small = P.obs.subscribe(maxlen=4)
    for i in range(10):
        P.obs.event("e", i=i)
    assert [e["fields"]["i"] for e in small.drain()] == [6, 7, 8, 9]
    assert small.dropped == 6


def test_threshold_rule_fires_once_per_excursion(P):
    mon = P.live.LiveMonitor(rules=["pending>2"])
    mon.feed([window_event(P, pending=5)])
    assert len(mon.evaluate()) == 1
    assert mon.evaluate() == []
    mon.feed([window_event(P, pending=0, ts_us=2000)])
    assert mon.evaluate() == []
    mon.feed([window_event(P, pending=9, ts_us=3000)])
    fired = mon.evaluate()
    assert len(fired) == 1 and fired[0]["value"] == 9
    assert len(mon.alerts) == 2


def test_burn_and_absence_rules(P):
    mon = P.live.LiveMonitor(rules=["burn>2"])
    mon.feed([window_event(P, converged=4, breach=2)])
    fired = mon.evaluate()
    assert fired[0]["path"] == "lag.slo.burn_rate"
    assert fired[0]["value"] == 50.0
    ab = P.live.LiveMonitor(rules=["absence:wave.digest:120"])
    assert ab.evaluate() == []
    t0 = 1_000_000_000
    ab.feed([wave_digest(ts_us=t0)])
    assert ab.evaluate(now_us=t0 + 60_000_000) == []
    assert len(ab.evaluate(now_us=t0 + 200_000_000)) == 1


def test_alert_emits_record_and_fires_callbacks(P, tmp_path):
    out = str(tmp_path / "events.jsonl")
    P.obs.configure(enabled=True, out=out)
    hits = []
    mon = P.live.LiveMonitor(rules=["pending>0"], on_alert=[hits.append])
    mon.feed([window_event(P, pending=1)])
    mon.evaluate()
    assert len(hits) == 1 and hits[0]["rule"] == "pending>0"
    recorded = [e for e in P.obs.load_jsonl(out)
                if e.get("name") == "live.alert"]
    assert len(recorded) == 1


def test_default_rules_and_parse_errors(P):
    assert [r.spec for r in P.live.default_rules()] == list(
        P.live.DEFAULT_RULE_SPECS)
    assert P.live.DEFAULT_RULE_SPECS == j_live.DEFAULT_RULE_SPECS
    for bad in ("not a rule", "absence:wave.digest", "pending>lots"):
        with pytest.raises(ValueError):
            P.live.parse_rule(bad)


def test_live_snapshot_record(P, tmp_path):
    out = str(tmp_path / "events.jsonl")
    P.obs.configure(enabled=True, out=out)
    mon = P.live.LiveMonitor()
    mon.feed([wave_digest(), window_event(P)])
    snap = mon.emit_snapshot()
    assert snap["fleet"]["waves"] == 1
    (rec,) = [e for e in P.obs.load_jsonl(out)
              if e.get("name") == "live.snapshot"]
    assert rec["fields"]["verdict"] == "OK"


def test_attach_folds_own_stream_and_sees_reset(P):
    P.obs.configure(enabled=True)
    att = P.live.attach(rules=["divergence>0"])
    P.obs.event("wave.digest", uuid="u", source="wave", wave=1, pairs=2,
                valid=2, distinct=1, agreed=True, staleness={"0": 2})
    P.obs.counter("sync.full_bag").inc(3)
    snap = att.poll()
    assert snap["fleet"]["waves"] == 1 and snap["sync"]["full_bag"] == 3
    assert snap["records"] == 1
    P.obs.reset()
    assert att.closed
    att.close()


def test_concurrent_evaluate_fires_once(P):
    mon = P.live.LiveMonitor(rules=["pending>0"])
    mon.feed([window_event(P, pending=7)])
    snap = mon.snapshot()
    barrier = threading.Barrier(2)

    def run():
        barrier.wait()
        for _ in range(50):
            mon.evaluate(snap=snap)

    ts = [threading.Thread(target=run) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(mon.alerts) == 1


def test_attach_survives_fold_of_own_emissions(P):
    P.obs.configure(enabled=True)
    att = P.live.attach(rules=["pending>0"])
    P.obs.event("lag.window", **window_event(P, pending=2)["fields"])
    s1 = att.poll(emit_snapshot=True)
    s2 = att.poll(emit_snapshot=True)
    assert s1["alerts_total"] == 1 and s2["alerts_total"] == 1
    assert s2["records"] > s1["records"]
    att.close()


# --------------------------------------------------------------- xtrace


def test_xtrace_apis_inert_when_off(P):
    assert P.xtrace.new_trace() is None
    assert P.xtrace.hop("mint", "abc") is None
    P.xtrace.bind_ops("abc", [(1, "s", 0)])
    assert P.xtrace.traces_of([(1, "s", 0)]) == []


def test_hop_chain_and_bind_ops(P):
    P.obs.configure(enabled=True)
    tr = P.xtrace.new_trace()
    s1 = P.xtrace.hop("mint", tr, parent="")
    s2 = P.xtrace.hop("admit", tr)
    hops = events(P, "xtrace.hop")
    assert [h["hop"] for h in hops] == ["mint", "admit"]
    assert hops[1]["parent"] == s1 and P.xtrace.last_span(tr) == s2
    P.xtrace.bind_ops(tr, [(1, "s", 0)])
    P.xtrace.bind_ops("other", [(1, "s", 0)])  # first binding wins
    assert P.xtrace.traces_of([(1, "s", 0)]) == [tr]


def test_obs_reset_delegates_to_lag_and_xtrace(P):
    P.obs.configure(enabled=True)
    P.lag.op_created("u", [(1, "s", 0)])
    tr = P.xtrace.new_trace()
    P.xtrace.bind_ops(tr, [(1, "s", 0)])
    P.obs.reset()
    P.obs.configure(enabled=True)
    assert P.lag.pending_ops() == 0
    assert P.xtrace.traces_of([(1, "s", 0)]) == []


def test_journey_fold_reads_the_ports_serve_stream(tmp_path):
    """The port's own funnel-minted journeys fold in both packages'
    ``JourneyFold`` to the same section."""
    t_obs.configure(enabled=True)
    a, b = replica_pair(PORT, fleet_base(PORT))
    sess = TSession([(a, b)] * 2)
    sess.wave()
    sess.update([(a.conj("x"), b.conj("y"))] * 2)
    sess.wave()
    evs = t_obs.events()
    assert [e for e in evs if e.get("name") == "xtrace.hop"]
    assert j(j_journey.journey_report(evs)) == j(
        t_journey.journey_report(evs))
