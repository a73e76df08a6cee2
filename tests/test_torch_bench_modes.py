"""The modes of the port's north-star benchmark (``cause_tpu_torch.bench``)
and its handle-level benchmark (``cause_tpu_torch.api_bench``) against
the reference's ``bench.py`` and ``scripts/api_bench.py``, on the CPU at
smoke size.

The divergence sweep agrees at every level, lands its ledger rows and
per-path gap verdicts, and its full-width digests equal the reference's
``jaxwd.batched_weave_digest`` on the same marshal
(``tests/test_delta_weave.py::test_bench_divergence_sweep_smoke`` for
the port); the tree is bit-identical to its fold in ``tree_rounds(n)``
rounds; the lag mode resolves every op, with the live monitor's row;
telemetry on and off give the same artifact keys. ``api_bench`` prints
the reference's keys in every mode, and its wave's digests equal the
reference's ``merge_wave`` over twin handles.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

import cause_tpu as c
import cause_tpu_torch as ct
from cause_tpu.parallel import tree as ref_tree
from cause_tpu.weaver import jaxwd
from cause_tpu_torch import api_bench, bench, benchgen as tb, obs
from cause_tpu_torch.obs import costmodel, devprof, ledger, semantic
from cause_tpu_torch.parallel import tree
from cause_tpu_torch.weaver import torchwd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the wave fleet of the api_bench cases: pairs, base, divergence a side
WAVE = ("8", "300", "40")


def clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "CAUSE_TPU_"))}
    env.update(extra)
    return env


def run_bench(tmp_path, **extra):
    """``python -m cause_tpu_torch.bench`` forced onto the CPU at smoke
    size with ``extra`` variables; returns (process, last line, ledger
    rows)."""
    led = str(tmp_path / "ledger.jsonl")
    env = clean_env(BENCH_FORCE_CPU="1", BENCH_SMOKE="1",
                    CAUSE_TPU_LEDGER=led, **extra)
    out = subprocess.run([sys.executable, "-m", "cause_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return (out, json.loads(out.stdout.strip().splitlines()[-1]),
            ledger.load(led))


@pytest.fixture
def obs_on(monkeypatch, tmp_path):
    """Telemetry on in this process with a tmp sidecar and ledger, the
    bench variables cleared; every obs layer and the package default
    device reset afterwards."""
    for k in list(os.environ):
        if k.startswith(("BENCH_", "CAUSE_TPU_")):
            monkeypatch.delenv(k)
    sidecar = str(tmp_path / "obs.jsonl")
    monkeypatch.setenv("CAUSE_TPU_OBS", "1")
    monkeypatch.setenv("CAUSE_TPU_OBS_OUT", sidecar)
    monkeypatch.setenv("CAUSE_TPU_LEDGER", str(tmp_path / "ledger.jsonl"))
    layers = (obs, semantic, costmodel, devprof)
    for m in layers:
        m.reset()
    before = ct.default_device()
    yield monkeypatch, sidecar
    ct.use_device(before)
    for m in layers:
        m.reset()


def test_sweep_agrees_and_equals_the_reference(obs_on, capsys):
    """``BENCH_DIV_SWEEP=4,40``: every level's digests agree, one sweep
    row a level and path in the ledger, a gap verdict a path, and each
    level's full-width digests equal the reference's on its marshal."""
    monkeypatch, sidecar = obs_on
    monkeypatch.setenv("BENCH_FORCE_CPU", "1")
    monkeypatch.setenv("BENCH_SMOKE", "1")
    monkeypatch.setenv("BENCH_DIV_SWEEP", "4,40")
    marshals, digests = [], []
    real_inputs = tb.delta_sweep_inputs
    real_full = torchwd.batched_weave_digest

    def inputs(*a, **kw):
        marshals.append(real_inputs(*a, **kw))
        return marshals[-1]

    def full(*a, **kw):
        out = real_full(*a, **kw)
        digests.append((kw["u_max"], out[2].numpy().view(np.uint32)))
        return out

    monkeypatch.setattr(tb, "delta_sweep_inputs", inputs)
    monkeypatch.setattr(torchwd, "batched_weave_digest", full)
    assert bench.main() == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["digest_agreed"] is True and rec["card"] is None
    assert [lv["level_ops"] for lv in rec["levels"]] == [4, 40]
    assert all(lv["digest_agreed"] for lv in rec["levels"])
    rows = ledger.load(os.environ["CAUSE_TPU_LEDGER"])
    assert sorted(r["config"] for r in rows) == [
        "div4-delta", "div4-full", "div40-delta", "div40-full"]
    assert all(r["kind"] == "sweep" and r["platform"] == "cpu-forced"
               for r in rows)
    rep = costmodel.gap_report([], obs.load_jsonl(sidecar))
    assert set(rep["cost_vs_divergence_by_path"]) == {"delta", "full"}
    assert os.path.exists(sidecar + ".perfetto.json")
    # the full arm: a warm dispatch, the timed singles and bursts; its
    # first call a level holds the digests the gate compared
    per_level = len(digests) // len(marshals)
    for i, sw in enumerate(marshals):
        u_max, got = digests[i * per_level]
        want = jaxwd.batched_weave_digest(
            *(jnp.asarray(sw["full"][k]) for k in tb.LANE_KEYS5),
            u_max=u_max, k_max=u_max)[2]
        np.testing.assert_array_equal(got, np.asarray(want))


def test_tree_is_bit_identical_in_tree_rounds(tmp_path):
    """``BENCH_TREE=8``: root and fold bit-identical, ``tree_rounds(8)``
    rounds (the reference's count), a tree and a fold row."""
    sidecar = str(tmp_path / "obs.jsonl")
    _out, rec, rows = run_bench(tmp_path, BENCH_TREE="8",
                                CAUSE_TPU_OBS="1",
                                CAUSE_TPU_OBS_OUT=sidecar)
    assert rec["bit_identical"] is True
    (fleet,) = rec["fleets"]
    assert fleet["bit_identical"] and fleet["replicas"] == 8
    assert fleet["rounds"] == fleet["rounds_expected"] == \
        tree.tree_rounds(8) == ref_tree.tree_rounds(8)
    assert fleet["paths"][0] == "full"
    assert len(fleet["tree_reps_ms"]) == 3 and fleet["fold_ms"] > 0
    assert sorted(r["config"] for r in rows) == ["n8-fold", "n8-tree"]
    assert all(r["kind"] == "tree" and r["bit_identical"] for r in rows)


def test_lag_and_live_resolve_every_op(tmp_path):
    """``BENCH_LAG=8 BENCH_LIVE=1``: no op pending, ops converged, a lag
    and a live row."""
    sidecar = str(tmp_path / "obs.jsonl")
    _out, rec, rows = run_bench(tmp_path, BENCH_LAG="8", BENCH_LIVE="1",
                                CAUSE_TPU_OBS="1",
                                CAUSE_TPU_OBS_OUT=sidecar)
    (fleet,) = rec["fleets"]
    assert fleet["pending"] == 0 and fleet["ops_converged"] > 0
    assert fleet["rounds"] == 4 and fleet["live"]["snapshots"] >= 4
    kinds = {r["kind"]: r for r in rows if r["kind"] in ("lag", "live")}
    assert kinds["lag"]["config"] == "n8-lag"
    assert kinds["live"]["config"] == "n8-live"
    assert kinds["lag"]["value_ms"] == fleet["p99_ms"]


@pytest.mark.parametrize("mode", ["BENCH_DIV_SWEEP", "BENCH_TREE",
                                  "BENCH_LAG"])
def test_modes_refuse_without_telemetry(obs_on, mode):
    """The reference's ``_require_obs``: each mode refuses, before any
    marshal, without telemetry."""
    monkeypatch, _sidecar = obs_on
    monkeypatch.delenv("CAUSE_TPU_OBS")
    obs.reset()
    monkeypatch.setenv("BENCH_SMOKE", "1")
    monkeypatch.setenv(mode, "8")
    with pytest.raises(SystemExit, match="requires CAUSE_TPU_OBS=1"):
        bench.measure("cpu")


def test_obs_on_and_off_give_the_same_keys(tmp_path):
    """The headline with telemetry off writes no ledger; on, the same
    artifact keys, a Perfetto trace beside the sidecar and one bench row
    in the ledger."""
    off_dir, on_dir = tmp_path / "off", tmp_path / "on"
    off_dir.mkdir()
    on_dir.mkdir()
    _o, off, off_rows = run_bench(off_dir)
    sidecar = str(on_dir / "obs.jsonl")
    _o, on, on_rows = run_bench(on_dir, CAUSE_TPU_OBS="1",
                                CAUSE_TPU_OBS_OUT=sidecar)
    assert set(on) == set(off)
    assert off_rows == [] and not (off_dir / "ledger.jsonl").exists()
    assert os.path.exists(sidecar + ".perfetto.json")
    (row,) = on_rows
    assert row["kind"] == "bench" and row["platform"] == "cpu-forced"
    assert row["value_ms"] == on["value"] and not row["quarantined"]
    # a wave.cost a warm or timed single; a dispatch a wave, bursts too
    assert row["cost"]["waves"] == 1 + on["reps"]
    assert row["counters"]["costmodel.dispatches"] == 1 + on["reps"] + (
        on["burst_reps"] * on["waves_per_burst"])


def api_lines(cmd, env):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return [json.loads(x) for x in out.stdout.strip().splitlines()]


@pytest.mark.parametrize("mode", [
    ["--wave", WAVE[0], "--n-base", WAVE[1], "--n-div", WAVE[2], "--lazy"],
    ["--maps", "4", "--n-keys", "8", "--n-edits", "4"],
    ["--n-base", "400", "--n-div", "40"],
], ids=["wave", "maps", "merge"])
def test_api_bench_prints_the_references_keys(mode):
    """Each ``--cpu`` mode of both scripts at the same tiny size: the
    same lines with the same keys (the reference's ``jax`` weaver named
    ``torch``), the same metrics and the same counts."""
    got = api_lines([sys.executable, "-m", "cause_tpu_torch.api_bench",
                     "--cpu", *mode], clean_env())
    want = api_lines([sys.executable, "scripts/api_bench.py", "--cpu",
                      *mode], clean_env(JAX_PLATFORMS="cpu"))
    assert [set(g) for g in got] == [set(w) for w in want]
    for g, w in zip(got, want):
        assert g["metric"] == w["metric"].replace("jax", "torch")
        for k in ("pairs", "nodes_per_tree", "u_max", "overflow_rows",
                  "fallback_pairs", "capacity"):
            assert g.get(k) == w.get(k), k
        if "weaver" in g:
            assert g["weaver"] == w["weaver"].replace("jax", "torch")
        if "platform" in g:
            assert g["platform"] == w["platform"] == "cpu"


def test_api_bench_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would succeed on it")
    out = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.api_bench", "--wave", "2",
         "--n-base", "30", "--n-div", "8"],
        capture_output=True, text=True, timeout=300, env=clean_env(),
        cwd=ROOT)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr


def ref_wave_fleet(B, n_base, n_div):
    """``scripts/api_bench.py``'s wave mint in the reference package."""
    from cause_tpu.collections import clist as c_list
    from cause_tpu.collections.clist import CausalList
    from cause_tpu.ids import new_site_id
    from cause_tpu.weaver import lanecache

    ct_ = c.clist(weaver="pure", lazy=True).extend(["x"] * n_base).ct
    ct_ = c_list.weave(ct_)
    base = CausalList(ct_.evolve(
        weaver="jax", lanes=lanecache.build_view(ct_.nodes, ct_.uuid)))
    pairs = []
    for p in range(B):
        def replica(tag):
            r = CausalList(base.ct.evolve(site_id=new_site_id()))
            vals = [f"{tag}{p}.{i}" for i in range(n_div)]
            for start in range(0, n_div, 8):
                r = r.extend(vals[start:start + 8])
                r = r.append(r.tail_id(), c.hide)
            return r

        pairs.append((replica("a"), replica("b")))
    return pairs


def test_api_wave_digests_equal_the_reference(capsys):
    """The ``--wave`` measurements over a fleet minted from the same
    seeded ids in both packages: the whole wave's digests equal the
    reference's ``merge_wave`` over the twin fleet, with no pair off the
    device, and every ``merged(i)`` checked equals the twin's."""
    from cause_tpu.parallel import merge_wave as ref_merge_wave

    B, n_base, n_div = (int(x) for x in WAVE)
    c.ids._rng.seed(16)
    ct.ids._rng.seed(16)
    try:
        pairs = api_bench.wave_fleet(B, n_base, n_div, lazy=True)
        twins = ref_wave_fleet(B, n_base, n_div)
    finally:
        c.ids._rng.seed()
        ct.ids._rng.seed()
    before = ct.default_device()
    ct.use_device("cpu")
    try:
        res = api_bench.wave_measure(pairs, ct.default_device(),
                                     n_base + n_div + 1, reps=1, burst=2)
    finally:
        ct.use_device(before)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [ln["metric"].split(" ")[0] for ln in lines] == [
        "device-resident", "merge"]
    want = ref_merge_wave(twins)
    assert res.fallback == want.fallback == []
    np.testing.assert_array_equal(res.digest, want.digest)
    for i in (0, B - 1):
        got_i, want_i = res.merged(i), want.merged(i)
        assert [n[0] for n in got_i.ct.weave] == [
            n[0] for n in want_i.ct.weave]
        assert list(got_i) == list(want_i)
