"""The port's north-star benchmark (``cause_tpu_torch.bench``) and its burst
timer (``benchgen.time_dispatch``) against the reference's ``bench.py``
and ``cause_tpu.benchgen.time_dispatch``, on the CPU at smoke size.

The headline's final checksum and ladder rung equal the reference's
``merge_wave_scalar`` on the same batch (the v5 family's exact int32
avalanche digest; v4's float32 sum at ``rtol=1e-6``, another summation
order); its artifact has the reference's keys plus ``card``; the
subprocess contract of ``tests/test_bench_contract.py`` holds under
``BENCH_FORCE_CPU=1``, and without it and without a card the benchmark
fails with one parseable line and a non-zero exit instead of falling
back to the CPU. The modes are in ``test_torch_bench_modes.py``.
"""

import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import jax.numpy as jnp

import bench as ref_bench
import cause_tpu_torch as ct
from cause_tpu import benchgen as jb
from cause_tpu_torch import bench, benchgen as tb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = (8, 800, 100, 1024)  # pairs, base, divergence, capacity


@pytest.fixture
def smoke_env(monkeypatch):
    """A clean bench environment at smoke size, the package default
    device restored afterwards (``measure`` sets it)."""
    for k in list(os.environ):
        if k.startswith(("BENCH_", "CAUSE_TPU_")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_SMOKE", "1")
    before = ct.default_device()
    yield monkeypatch
    ct.use_device(before)


def recording(monkeypatch, mod):
    """Wrap ``mod.merge_wave_scalar``: every call's ``(k_max, kernel)``,
    lanes as numpy and output as numpy, in order."""
    calls = []
    real = mod.merge_wave_scalar

    def rec(*args, **kw):
        out = real(*args, **kw)
        calls.append((kw["k_max"], kw["kernel"],
                      [np.asarray(a) for a in args], np.asarray(out)))
        return out

    monkeypatch.setattr(mod, "merge_wave_scalar", rec)
    return calls


def run_cli(extra_env, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "CAUSE_TPU_"))}
    env.update(extra_env)
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "cause_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=ROOT)
    return out, time.monotonic() - t0


@pytest.mark.parametrize("kernel", ["", "v5f", "v4"])
def test_headline_checksum_and_rung_equal_the_reference(smoke_env, kernel):
    """The headline's last wave and its rung against the reference's
    ``merge_wave_scalar`` on the same smoke batch, at the rung the
    reference's own ladder picks (v5 at the sampled token budget, or the
    forced kernel's budget). v5f's digest equals v5's exactly."""
    if kernel:
        smoke_env.setenv("BENCH_KERNEL", kernel)
    calls = recording(smoke_env, tb)
    out = bench.measure("cpu")
    k_max, got_kernel, lanes, last = calls[-1]
    assert out["kernel"] == got_kernel == (kernel or "v5")
    # one warm wave, the timed singles, the bursts: one call each
    assert len(calls) == 1 + out["reps"] + (
        out["burst_reps"] * out["waves_per_burst"])
    assert all(c[:2] == (k_max, got_kernel) for c in calls)
    assert all(np.array_equal(c[3], last) for c in calls)

    batch = jb.batched_pair_lanes(*SMOKE, hide_every=8)
    v5batch = jb.batched_v5_inputs(batch, SMOKE[3])
    want_k = (jb.pair_run_budget(batch) if kernel == "v4"
              else jb.v5_token_budget(v5batch))
    assert k_max == want_k
    # the lanes the port dispatched are the reference's batch
    keys = jb.LANE_KEYS4 if kernel == "v4" else jb.LANE_KEYS5
    src = batch if kernel == "v4" else v5batch
    for k, a in zip(keys, lanes):
        np.testing.assert_array_equal(a, src[k])
    ref_kernel = "v4" if kernel == "v4" else "v5"
    want = np.asarray(jb.merge_wave_scalar(
        *(jnp.asarray(src[k]) for k in keys), k_max=want_k,
        kernel=ref_kernel, u_max=want_k if ref_kernel == "v5" else 0))
    assert int(last[1]) == int(want[1]) == 0
    if ref_kernel == "v5":
        assert int(last[0]) == int(want[0])
    else:
        np.testing.assert_allclose(float(last[0]), float(want[0]),
                                   rtol=1e-6)


def test_artifact_keys_are_the_references_plus_card(smoke_env):
    """The in-process artifact of both benchmarks at smoke size on the CPU:
    the same keys, but ``card`` (None off the card), the same metric,
    kernel, config and repetition counts."""
    got = bench.measure("cpu")
    want = ref_bench.measure("cpu")
    assert set(got) - {"card"} == set(want)
    assert got["card"] is None
    for k in ("metric", "unit", "waves_per_burst", "reps", "burst_reps",
              "kernel", "config", "vs_baseline", "vs_target", "target_ms",
              "schema_version"):
        assert got[k] == want[k], k
    assert got["platform"] == "cpu-forced" and want["platform"] == "cpu"
    assert got["value"] > 0 and got["single_dispatch_ms"] > 0


def test_smoke_contract_cpu_forced():
    """``tests/test_bench_contract.py``'s smoke contract and repetition
    fields: exit 0 within 120 s, one parseable last line."""
    out, wall = run_cli({"BENCH_FORCE_CPU": "1", "BENCH_SMOKE": "1"})
    assert out.returncode == 0, out.stderr[-1500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "vs_target",
                "target_ms", "platform", "kernel", "config", "card"):
        assert key in rec, (key, rec)
    assert rec["value"] and rec["value"] > 0
    assert rec["unit"] == "ms"
    assert rec["platform"] == "cpu-forced"
    assert "smoke size" in rec["metric"]
    assert rec["vs_baseline"] == rec["vs_target"] == 0.0
    assert rec["target_ms"] == 100.0
    assert rec["reps"] >= 3 and rec["burst_reps"] >= 1
    assert rec["config"] == "default" and rec["card"] is None
    assert wall < 120, f"the smoke run took {wall:.0f} s"


def test_no_card_fails_without_falling_back():
    """Without ``BENCH_FORCE_CPU`` and without a card: a non-zero exit,
    one parseable failure line with the reference's failure keys whose
    error names CUDA, and no CPU result anywhere."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would succeed on it")
    out, _ = run_cli({"BENCH_SMOKE": "1"})
    assert out.returncode != 0
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline",
                        "platform", "schema_version", "fallback", "error"}
    assert rec["value"] is None and rec["platform"] == "none"
    assert "CUDA" in rec["error"]
    assert "cpu-fallback" not in out.stdout + out.stderr
    assert "cpu-forced" not in out.stdout
    assert len(out.stdout.strip().splitlines()) == 1


def test_bad_mode_variable_fails_with_one_line():
    out, _ = run_cli({"BENCH_FORCE_CPU": "1", "BENCH_SMOKE": "1",
                      "BENCH_DIV_SWEEP": "3"})
    assert out.returncode != 0
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["value"] is None and "even" in rec["error"]


def test_marshal_precedes_the_device_claim():
    """``tests/test_bench_contract.py::test_marshal_precedes_backend_claim``
    for the port: in every mode of ``measure`` the host marshal comes
    before ``_claim_device`` (the one place that touches CUDA:
    ``resolve_device`` and ``torch.cuda.init``), and the headline's
    upload (``lanes_from_numpy``) after it."""
    src = "\n".join(
        line for line in inspect.getsource(bench.measure).splitlines()
        if not line.lstrip().startswith("#"))
    claims = [i for i in range(len(src))
              if src.startswith("_claim_device(", i)]
    assert len(claims) == 4  # sweep, tree, lag, headline
    marshals = ("delta_sweep_inputs(", "tree_fleet_handles(",
                "tree_fleet_handles(", "batched_pair_lanes(")
    prev = 0
    for at, marshal in zip(claims, marshals):
        assert marshal in src[prev:at], (marshal, src[prev:at][-300:])
        prev = at
    headline = src.index("batched_pair_lanes(")
    assert headline < claims[-1] < src.index("lanes_from_numpy(")
    assert "torch.cuda" not in src[:claims[0]]
    claim_src = inspect.getsource(bench._claim_device)
    assert "torch.cuda.init()" in claim_src
    assert "resolve_device(platform)" in claim_src


def test_ladder_climbs_as_the_reference(smoke_env):
    """A token budget too small for any row: both benchmarks overflow v5 at
    the budget and at twice it and settle on v4 at the run budget,
    trying the same rungs in the same order."""
    smoke_env.setattr(jb, "v5_token_budget", lambda *a, **k: 8)
    smoke_env.setattr(tb, "v5_token_budget", lambda *a, **k: 8)
    got_calls = recording(smoke_env, tb)
    want_calls = recording(smoke_env, jb)
    got = bench.measure("cpu")
    want = ref_bench.measure("cpu")

    def rungs(calls):
        return list(dict.fromkeys(c[:2] for c in calls))

    assert rungs(got_calls) == rungs(want_calls)
    budget = jb.pair_run_budget(jb.batched_pair_lanes(*SMOKE, hide_every=8))
    assert rungs(got_calls) == [(8, "v5"), (16, "v5"), (budget, "v4")]
    assert got["kernel"] == want["kernel"] == "v4"
    np.testing.assert_allclose(float(got_calls[-1][3][0]),
                               float(want_calls[-1][3][0]), rtol=1e-6)


def test_unknown_kernel_raises_as_the_reference(smoke_env):
    smoke_env.setenv("BENCH_KERNEL", "v9")
    with pytest.raises(SystemExit) as got:
        bench.measure("cpu")
    with pytest.raises(SystemExit) as want:
        ref_bench.measure("cpu")
    assert str(got.value) == str(want.value)
    assert "'v9'" in str(got.value) and "'v5f'" in str(got.value)


class FakeWave:
    """A dispatch's output that logs its wait (the port's ``.cpu()``,
    the reference's ``np.asarray``)."""

    def __init__(self, log):
        self.log = log

    def cpu(self):
        self.log.append("wait")
        return self

    def __array__(self, dtype=None, copy=None):
        self.log.append("wait")
        return np.zeros(2, np.int32)


@pytest.mark.parametrize("single_ms, burst_reps", [(5.0, 3), (2000.0, 1)])
@pytest.mark.parametrize("pkg", [tb, jb], ids=["port", "reference"])
def test_time_dispatch_contract(monkeypatch, pkg, single_ms, burst_reps):
    """``reps`` singles, each waited for and bracketed by ``begin``/
    ``end`` outside its time; then ``reps`` bursts under a second a
    single (one above), unbracketed, each waited for once at its end,
    timed as its mean wave; identical in both packages."""
    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0] / 1000.0)
    log = []

    def dispatch():
        clock[0] += single_ms
        log.append("dispatch")
        return FakeWave(log)

    singles, bursts = pkg.time_dispatch(
        dispatch, 3, 4, begin=lambda: log.append("begin"),
        end=lambda: log.append("end"))
    assert singles == pytest.approx([single_ms] * 3)
    assert bursts == pytest.approx([single_ms] * burst_reps)
    one = ["begin", "dispatch", "wait", "end"]
    burst = ["dispatch"] * 4 + ["wait"]
    assert log == one * 3 + burst * burst_reps
