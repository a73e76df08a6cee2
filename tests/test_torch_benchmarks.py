"""The port's benchmark CLI (``cause_tpu_torch.benchmarks``) against the
JAX package's (``cause_tpu.benchmarks``), on the CPU.

The host configs run at tiny sizes on both host backends (native is
skipped without a toolchain, as the reference skips it). The device
configs run under ``use_device("cpu")``: config 5's timed step returns
the same ``[checksum, overflowed]`` as the reference's
``merge_wave_scalar`` on the same ``benchgen`` batch — the v5 digest
integer for integer, v1-v4's float32 sum at ``rtol=1e-6`` (another
summation order, as ``tests/test_torch_ladder.py`` holds it) — and
config 6 converges its map fleet on both routes with no pair falling
back. The records carry the reference's keys and metrics, with the
``jax-*`` weaver names read ``torch-*``, and ``--profile`` writes a
torch.profiler trace.
"""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

import cause_tpu_torch as ct
from cause_tpu import benchgen as jb
from cause_tpu import benchmarks as ref
from cause_tpu_torch import benchgen as tb
from cause_tpu_torch import benchmarks, native

TINY5 = dict(n_replicas=2, n_base=24, n_div=8, cap=64, reps=1)
TINY6 = dict(n_pairs=3, n_keys=4, edits=3, reps=1)


@pytest.fixture
def on_cpu():
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def host_records(mod, weaver):
    return [
        mod.config1_append_only(weaver, n=40, reps=1),
        mod.config1_bulk_extend(weaver, n=40, reps=1),
        mod.config2_concurrent_hide(weaver, n_per_site=10, reps=1),
        mod.config3_map_undo_redo(weaver, n_keys=4, overwrites=2, reps=1),
        mod.config4_rich_text_base(weaver, paragraphs=2, para_len=8,
                                   reps=1),
    ]


@pytest.mark.parametrize("weaver", ["pure", "native"])
def test_host_configs_run(weaver):
    if weaver == "native" and not native.available():
        pytest.skip("native toolchain unavailable")
    for r in host_records(benchmarks, weaver):
        assert r["value"] > 0 and r["unit"] and r["weaver"] == weaver


def test_host_records_match_the_reference():
    """Same keys, configs, metrics (node counts included) and units as
    the reference's records on the same inputs."""
    for got, want in zip(host_records(benchmarks, "pure"),
                         host_records(ref, "pure")):
        assert set(got) == set(want)
        for k in ("config", "metric", "weaver", "unit"):
            assert got[k] == want[k], k


def test_lazy_row_picks_native_else_the_torch_weaver(on_cpu, monkeypatch):
    r = benchmarks.config1_append_lazy(n=40, reps=1)
    assert r["weaver"] == ("lazy+native" if native.available()
                           else "lazy+torch")
    monkeypatch.setattr(native, "available", lambda: False)
    r = benchmarks.config1_append_lazy(n=40, reps=1)
    assert r["weaver"] == "lazy+torch" and r["value"] > 0
    assert r["metric"] == "lazy conj x40 + one render"


def _reference_scalar(kernel, k_max):
    """The reference's ``merge_wave_scalar`` on config 5's tiny batch,
    with the budgets config 5 derives."""
    batch = jb.batched_pair_lanes(2, 24, 8, 64, hide_every=8)
    u_max = 0
    if kernel == "v5":
        batch = dict(batch, **jb.batched_v5_inputs(batch, 64))
        keys = jb.LANE_KEYS5
        u_max = k_max = jb.v5_token_budget(batch)
    else:
        keys = jb.LANE_KEYS4 if (kernel == "v4" and k_max != 0) \
            else jb.LANE_KEYS
        if k_max is None:
            k_max = jb.pair_run_budget(batch)
    return np.asarray(jb.merge_wave_scalar(
        *[jnp.asarray(batch[k]) for k in keys], k_max=k_max,
        kernel=kernel, u_max=u_max))


@pytest.mark.parametrize("kernel,k_max,weaver", [
    ("v5", None, "torch-v5"), ("v4", None, "torch-v4"),
    ("v4", 0, "torch-v1")])
def test_config5_step_equals_the_reference(on_cpu, monkeypatch, kernel,
                                           k_max, weaver):
    outs = []
    real = tb.merge_wave_scalar

    def record(*args, **kw):
        out = real(*args, **kw)
        outs.append(out.clone())
        return out

    monkeypatch.setattr(tb, "merge_wave_scalar", record)
    r = benchmarks.config5_batched_merge(kernel=kernel, k_max=k_max,
                                         **TINY5)
    assert r["unit"] == "ms" and r["value"] > 0 and r["weaver"] == weaver
    assert len(outs) == 2  # the warm step and one timed rep
    want = _reference_scalar(kernel, k_max)
    for out in outs:
        got = out.numpy()
        assert got.shape == want.shape
        if kernel == "v5":
            assert got.dtype == want.dtype == np.int32
            assert np.array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6)
            if want.ndim:
                assert got[1] == want[1] == 0


@pytest.mark.parametrize("kernel", ["v5", "v4"])
def test_config6_runs_on_both_routes(on_cpu, kernel):
    r = benchmarks.config6_map_fleet(kernel=kernel, **TINY6)
    assert r["unit"] == "ms" and r["value"] > 0
    assert r["weaver"] == f"torch-{kernel}"
    assert r["metric"] == "map fleet wave, 3 pairs x ~12 nodes"


def test_device_records_match_the_reference(on_cpu):
    """Config 5's and config 6's records carry the reference's keys and
    metrics; the weaver reads ``torch-*`` where the reference's reads
    ``jax-*``."""
    pairs = [
        (benchmarks.config5_batched_merge(**TINY5),
         ref.config5_batched_merge(**TINY5)),
        (benchmarks.config5_batched_merge(k_max=0, **TINY5),
         ref.config5_batched_merge(k_max=0, **TINY5)),
        (benchmarks.config6_map_fleet(**TINY6),
         ref.config6_map_fleet(**TINY6)),
    ]
    for got, want in pairs:
        assert set(got) == set(want)
        assert got["weaver"] == want["weaver"].replace("jax-", "torch-")
        for k in ("config", "metric", "unit"):
            assert got[k] == want[k], k


def test_profile_writes_a_trace(on_cpu, tmp_path):
    d = tmp_path / "prof"
    benchmarks.config5_batched_merge(kernel="v5", profile_dir=str(d),
                                     **TINY5)
    benchmarks.config6_map_fleet(profile_dir=str(d), **TINY6)
    assert sorted(os.listdir(d)) == ["config5.json", "config6-v5.json"]
    with open(d / "config5.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_main_prints_one_json_record_a_line(capsys):
    benchmarks.main(["-c", "3", "-w", "pure"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    r = json.loads(lines[0])
    assert set(r) == {"config", "metric", "weaver", "value", "unit"}
    assert r["config"] == 3 and r["weaver"] == "pure" and r["value"] > 0


def test_main_runs_config1_rows_and_the_native_skip(capsys, monkeypatch,
                                                    on_cpu):
    """Config 1 prints a conj and a bulk row per backend, then the lazy
    row; without a toolchain, native's rows are the skip record."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setitem(benchmarks.CONFIGS, 1,
                        lambda w: {"config": 1, "weaver": w})
    monkeypatch.setattr(benchmarks, "config1_bulk_extend",
                        lambda w: {"config": 1, "weaver": w, "bulk": 1})
    monkeypatch.setattr(benchmarks, "config1_append_lazy",
                        lambda: {"config": 1, "weaver": "lazy+torch"})
    benchmarks.main(["-c", "1"])
    rows = [json.loads(x) for x in
            capsys.readouterr().out.strip().splitlines()]
    assert rows == [
        {"config": 1, "weaver": "pure"},
        {"config": 1, "weaver": "pure", "bulk": 1},
        {"config": 1, "weaver": "native",
         "skipped": "native toolchain unavailable"},
        {"config": 1, "weaver": "lazy+torch"},
    ]
