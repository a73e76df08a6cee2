"""The port's device telemetry (``obs.devprof``) and stage ladder
(``obs.stages``) on CPU tensors.

Mirrors ``tests/test_devprof.py``. The reference prices compiled XLA
programs; the port has none, so its counterparts are pinned instead:
the ``devprof.program`` event once per dispatch identity with the
dispatch's kernel launches, the ``devprof.compile`` span around the
kernel library's first build, the CUDA-allocator memory gauges (which
record nothing on the CPU and never touch CUDA there), and the arena
footprint (copied). The stage ladder runs ``torchw5``'s ``stage=``
prefixes, whose per-row checksums equal ``jaxw5``'s stage checksums on
the same inputs (float32 sums in a different order: ``rtol=1e-6``); the
FULL stage is the whole kernel.

Every new entry point defaults to CUDA and raises without a card; the
no-card cases live in ``tests/test_torch_hygiene.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as tbench
from cause_tpu_torch import kernels
from cause_tpu_torch import obs
from cause_tpu_torch.obs import costmodel, devprof, semantic, stages
from cause_tpu_torch.weaver import torchw5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("CAUSE_TPU_OBS", "CAUSE_TPU_OBS_OUT", "CAUSE_TPU_OBS_RING",
              "BENCH_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    before = ct.default_device()
    ct.use_device("cpu")
    obs.reset()
    semantic.reset()
    costmodel.reset()
    devprof.reset()
    yield
    obs.reset()
    semantic.reset()
    costmodel.reset()
    devprof.reset()
    ct.use_device(before)


def programs():
    return [e["fields"] for e in obs.events()
            if e.get("name") == "devprof.program"]


def small_v5(B=2, n_base=30, n_div=6, cap=64):
    batch = tbench.batched_pair_lanes(B, n_base, n_div, cap, hide_every=3)
    v5 = tbench.batched_v5_inputs(batch, cap)
    return v5, tbench.v5_token_budget(v5)


# ------------------------------------------------------------ obs off


def test_disabled_devprof_records_nothing_and_wraps_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA touched with obs off")

    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    fn = lambda: 1  # noqa: E731
    assert devprof.profiled(fn, "cuda", pipeline="v5") is fn
    assert devprof.sample_device_memory("wave") == {}
    assert devprof.arena_footprint(object(), "x") == {}
    assert obs.events() == [] and devprof._SEEN == {}


# ------------------------------------------------------------ programs


def test_program_event_once_per_identity_with_launch_delta():
    obs.configure(enabled=True)

    def dispatch():
        kernels.launches["sort"] += 6
        kernels.launches["fphase"] += 1
        return 7

    ident = dict(site="wave", pipeline="v5", B=4, N=128, u_max=128,
                 k_max=128)
    before = dict(kernels.launches)
    try:
        for _ in range(3):
            assert devprof.profiled(dispatch, "cpu", **ident)() == 7
        assert devprof.profiled(dispatch, "cpu",
                                **dict(ident, site="tree"))() == 7
        devprof.profiled(dispatch, "cpu", **dict(ident, B=8))()
    finally:
        kernels.launches.update(before)
    evs = programs()
    assert len(evs) == 2  # site is not identity; B is
    f = evs[0]
    assert f["launches"] == {"sort": 6, "fphase": 1}
    assert f["cost"] == {"launches": 7}
    assert f["library"] == kernels.source_hash()
    assert f["bench_kernel"] == "" and f["pipeline"] == "v5"
    assert "memory" not in f  # no card, no allocator read
    assert "flops" not in f["cost"]  # what the card cannot give is absent


def test_program_identity_carries_bench_kernel(monkeypatch):
    obs.configure(enabled=True)
    monkeypatch.setenv("BENCH_KERNEL", "v5f")
    devprof.profiled(lambda: None, "cpu", pipeline="v5f", B=1)()
    monkeypatch.setenv("BENCH_KERNEL", "v5")
    devprof.profiled(lambda: None, "cpu", pipeline="v5f", B=1)()
    assert [f["bench_kernel"] for f in programs()] == ["v5f", "v5"]


def test_waves_emit_one_program_per_dispatch_identity():
    """``merge_wave`` twice over the same shapes: one event; a session
    over the same pairs adds its full and delta identities."""
    obs.configure(enabled=True)
    base = ct.CausalList(ct.clist(weaver="torch").ct.evolve(
        site_id="sBASE00000000")).extend(["w"] * 30)
    pairs = [(ct.CausalList(base.ct.evolve(site_id=f"sA{i}0000000000"))
              .conj("a"),
              ct.CausalList(base.ct.evolve(site_id=f"sB{i}0000000000"))
              .conj("b")) for i in range(2)]
    ct.merge_wave(pairs)
    ct.merge_wave(pairs)
    assert [f["site"] for f in programs()] == ["wave"]
    sess = ct.FleetSession(pairs)
    sess.wave()
    for rnd in range(3):
        pairs = [(a.conj(f"x{rnd}"), b.conj(f"y{rnd}")) for a, b in pairs]
        sess.update(pairs)
        sess.wave()
    got = [(f["site"], f["pipeline"]) for f in programs()]
    assert got[0] == ("wave", "v5") and ("session", "delta") in got
    idents = [tuple(sorted((k, v) for k, v in f.items()
                           if k not in ("site", "launches", "cost")))
              for f in programs()]
    assert len(set(idents)) == len(idents)  # never twice an identity
    assert all(f["launches"] == {} for f in programs())  # plain on CPU


def test_library_build_runs_under_the_compile_span(monkeypatch):
    """The first build/load of the kernel library: one
    ``devprof.compile`` span naming the library hash."""
    obs.configure(enabled=True)
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "build_all",
                        lambda: {n: n for n in kernels.SOURCES})
    monkeypatch.setattr(kernels, "load", lambda p: f"lib:{p}")
    assert kernels.library("sort") == "lib:sort"
    assert kernels.library("fphase") == "lib:fphase"
    spans = [e for e in obs.events() if e.get("name") == "devprof.compile"]
    assert len(spans) == 1
    assert spans[0]["attrs"] == {"kernels": 6,
                                 "library": kernels.source_hash()}


# -------------------------------------------------------------- memory


def test_memory_sample_on_cpu_records_nothing(monkeypatch):
    obs.configure(enabled=True)

    def boom(*a, **k):
        raise AssertionError("CUDA touched for a CPU path")

    monkeypatch.setattr(torch.cuda, "memory_stats", boom)
    monkeypatch.setattr(torch.cuda, "memory_allocated", boom)
    assert devprof.sample_device_memory("wave", "cpu") == {}
    assert obs.events() == []


def test_memory_sample_streams_allocator_gauges(monkeypatch, tmp_path):
    """On a CUDA device the sampler gauges the allocator's bytes in
    use, reserved and live blocks under ``devprof.<key>.<site>``
    (allocator stubbed: the CPU has none)."""
    obs.configure(enabled=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats",
                        lambda d: {"active.all.current": 5})
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 4096)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 8192)
    got = devprof.sample_device_memory("waveX")
    assert got == {"device_bytes_in_use": 4096,
                   "device_bytes_reserved": 8192, "live_blocks": 5}
    gauges = {e["name"]: e["value"] for e in obs.events()
              if e.get("ev") == "gauge"}
    assert gauges["devprof.device_bytes_in_use.waveX"] == 4096
    path = str(tmp_path / "trace.json")
    obs.export_perfetto(path, events=obs.events())
    tracks = {t["name"] for t in json.load(open(path))["traceEvents"]
              if t["ph"] == "C"}
    assert "devprof.live_blocks.waveX" in tracks


def test_arena_footprint_on_a_real_lane_view():
    from cause_tpu_torch.weaver import lanecache

    obs.configure(enabled=True)
    lst = ct.clist("a", "b")
    for ch in "cdefgh":
        lst = lst.conj(ch)
    view = lanecache.view_for(lst.ct)
    out = devprof.arena_footprint(view.arena, site="test")
    assert out["arena_bytes"] > 0
    assert out["arena_lanes"] == view.arena.committed_n
    assert "devprof.arena_bytes.test" in {
        e["name"] for e in obs.events() if e.get("ev") == "gauge"}


# ------------------------------------------------------- stage ladder


@pytest.fixture(scope="module")
def ladder_inputs():
    return small_v5()


@pytest.mark.parametrize("stage", ["A", "B", "C", "D", "E"])
def test_stage_checksums_match_the_reference(stage, ladder_inputs):
    import jax
    import jax.numpy as jnp

    from cause_tpu.benchgen import LANE_KEYS5 as J_KEYS
    from cause_tpu.weaver.jaxw5 import merge_weave_kernel_v5

    v5, u = ladder_inputs
    want = np.asarray(jax.vmap(lambda *xs: merge_weave_kernel_v5(
        *xs, u_max=u, k_max=u, stage=stage))(
        *(jnp.asarray(v5[k]) for k in J_KEYS)))
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    got = torchw5.batched_merge_weave_v5(
        *(lanes[k] for k in tbench.LANE_KEYS5), u_max=u, k_max=u,
        device="cpu", stage=stage)
    assert got.shape == (v5["hi"].shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_full_stage_is_the_kernel_and_bad_stage_raises(ladder_inputs):
    v5, u = ladder_inputs
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    args = [lanes[k] for k in tbench.LANE_KEYS5]
    full = torchw5.batched_merge_weave_v5(*args, u_max=u, k_max=u,
                                          device="cpu", stage=None)
    plain = torchw5.batched_merge_weave_v5(*args, u_max=u, k_max=u,
                                           device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(full, plain))
    with pytest.raises(ValueError):
        torchw5.batched_merge_weave_v5(*args, u_max=u, k_max=u,
                                       device="cpu", stage="F")


def test_stage_ladder_runs_through_obs_spans(capsys):
    obs.configure(enabled=True)
    results = stages.run_v5_stage_ladder(reps=1, shape=(2, 30, 6, 64),
                                         device="cpu")
    out = capsys.readouterr().out
    assert "platform=cpu" in out and "prefix->FULL" in out
    assert [r["stage"] for r in results] == ["A", "B", "C", "D", "E",
                                             "FULL"]
    evs = obs.events()
    prefix = [e for e in evs if e.get("name") == "stages.prefix"]
    assert [e["fields"]["stage"] for e in prefix] == [
        "A", "B", "C", "D", "E", "FULL"]
    assert all(e["platform"] == "cpu" for e in prefix)
    spans = {e["name"] for e in evs if e.get("ev") == "span"}
    assert {"stages.marshal", "stages.warm", "stages.rep"} <= spans


def test_timed_median_on_given_inputs(ladder_inputs):
    """The ladder over a caller's own batch (the smoke passes its
    north-star batch): every stage timed, deltas add up to FULL."""
    res = stages.run_v5_stage_ladder(reps=2, inputs=ladder_inputs,
                                     device="cpu", echo=lambda s: None)
    assert sum(r["delta_ms"] for r in res) == pytest.approx(
        res[-1]["p50_ms"])
    out, p50, samples = stages.timed_median("x", lambda: 3, reps=3,
                                            device="cpu")
    assert out == 3 and len(samples) == 3 and p50 >= 0


def test_stage_ladder_times_beside_in_turns(ladder_inputs):
    """A program ``beside`` FULL is timed in turns with it, a call of
    each a rep: FULL's dict holds its p50 and every sample, and the
    reps' spans alternate between the two programs."""
    obs.configure(enabled=True)
    seen = []

    def beside(*lanes):
        seen.append(len(lanes))
        return lanes[0]

    res = stages.run_v5_stage_ladder(reps=3, inputs=ladder_inputs,
                                     device="cpu", echo=lambda s: None,
                                     beside=beside)
    full = res[-1]
    assert full["stage"] == "FULL" and len(full["beside_ms"]) == 3
    assert full["beside_p50_ms"] == pytest.approx(
        float(np.median(full["beside_ms"])))
    assert all("beside_ms" not in r for r in res[:-1])
    assert seen == [len(tbench.LANE_KEYS5)] * 4  # a warm-up, 3 reps
    reps = [e["attrs"]["program"] for e in obs.events()
            if e.get("ev") == "span" and e.get("name") == "stages.rep"
            and e["attrs"]["program"] in ("stages.prefix.FULL",
                                          "stages.beside")]
    assert reps == ["stages.prefix.FULL", "stages.beside"] * 3


def test_stages_cli(tmp_path):
    side = str(tmp_path / "st.jsonl")
    r = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.obs", "stages", "--shape",
         "2,30,6,64", "--reps", "1", "--device", "cpu", "--obs-out", side],
        capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "prefix->FULL" in r.stdout
    recs = [json.loads(ln) for ln in open(side)]
    assert [x["fields"]["stage"] for x in recs
            if x.get("name") == "stages.prefix"] == [
        "A", "B", "C", "D", "E", "FULL"]
    bad = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.obs", "stages", "--shape",
         "2,30"], capture_output=True, text=True, cwd=REPO)
    assert bad.returncode == 2
