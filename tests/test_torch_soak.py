"""The port's differential soak (``cause_tpu_torch.soak``) against the
reference's ``scripts/soak.py``.

- Every soup kind passes its own pure-oracle checks on the CPU, at four
  seeds each (the seeds of its kind: ``ROUNDS[seed % 6]``).
- Every soup kind, at two seeds each, produces what the reference's
  round produces on the same seed: with both packages' site-id minting
  seeded alike, the two build the same documents, and every rendered
  document (``causal_to_edn``, ``cb_to_edn``), merged map weave, wave
  digest and single-row v5/v5f output is equal, in order.
- A device result corrupted on its way to the checks makes the round
  raise: the soak does see a fault.
- The CLI: a clean timed run exits 0 with ``soak finished``; a failing
  round prints ``SOAK FAILURE seed=...`` and exits 1; ``--slo-ms``
  without ``--obs-out`` is refused as the reference refuses it; without
  a card and without ``--cpu`` it exits non-zero with one line.
- The chaos plan of ``tests/test_chaos.py:761-776`` in both packages in
  this process: equal ordered injection logs (family, site, mode and
  the spec's invocation counter) and equal ``injected``, ``detected``,
  ``recovery.restores``, ``divergence_incidents``, ``quarantined_final``
  and ``converged_bit_identical``; only ``mttr_ms`` and wall times may
  differ.
"""

import argparse
import importlib.util
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from cause_tpu import cbase as j_cbase
from cause_tpu import chaos as j_chaos
from cause_tpu import ids as j_ids
from cause_tpu import obs as j_obs
from cause_tpu import sync as j_sync
from cause_tpu.obs import costmodel as j_cm
from cause_tpu.obs import lag as j_lag
from cause_tpu.obs import semantic as j_sem
from cause_tpu.parallel import session as j_session
from cause_tpu.weaver import jaxw5, jaxw5f
from cause_tpu.weaver import mapw as j_mapw

import cause_tpu as jc
import cause_tpu_torch as ct
from cause_tpu_torch import cbase as t_cbase
from cause_tpu_torch import chaos as t_chaos
from cause_tpu_torch import ids as t_ids
from cause_tpu_torch import obs as t_obs
from cause_tpu_torch import soak
from cause_tpu_torch import sync as t_sync
from cause_tpu_torch.obs import costmodel as t_cm
from cause_tpu_torch.obs import devprof as t_devprof
from cause_tpu_torch.obs import lag as t_lag
from cause_tpu_torch.obs import semantic as t_sem
from cause_tpu_torch.parallel import session as t_session
from cause_tpu_torch.weaver import mapw as t_mapw
from cause_tpu_torch.weaver import torchw5, torchw5f

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = {
    "seed": 11, "replicas": 8, "rounds": 4, "doc": 30,
    "faults": [
        {"family": "payload", "site": "sync.delta",
         "mode": "corrupt", "at": [3]},
        {"family": "payload", "site": "sync.delta",
         "mode": "truncate", "at": [20]},
        {"family": "dispatch", "site": "session", "mode": "raise",
         "at": [2]},
        {"family": "dispatch", "site": "session",
         "mode": "exhaust", "at": [3]},
        {"family": "crash", "site": "session", "at": [2]},
        {"family": "stall", "site": "session", "ms": 120,
         "at": [4]},
    ],
}
ENV_DROP = ("CAUSE_TPU_", "BENCH_")


def reset_all():
    for obs, sem, cm, lag, chaos, sync in (
            (j_obs, j_sem, j_cm, j_lag, j_chaos, j_sync),
            (t_obs, t_sem, t_cm, t_lag, t_chaos, t_sync)):
        obs.configure(enabled=False, out="")
        obs.reset()
        sem.reset()
        cm.reset()
        lag.reset()
        chaos.reset()
        sync.quarantine_reset()
    t_devprof.reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both packages' telemetry and chaos engines start disarmed, the
    port on the CPU; nothing is left behind."""
    for k in list(os.environ):
        if k.startswith(ENV_DROP):
            monkeypatch.delenv(k)
    before = ct.default_device()
    ct.use_device("cpu")
    reset_all()
    yield
    reset_all()
    ct.use_device(before)


def ref_soak():
    """``scripts/soak.py`` as a module (it sets JAX to the CPU, which the
    test session already is)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_soak", os.path.join(ROOT, "scripts", "soak.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return mod


def run_cli(args, code=None, timeout=300):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(ENV_DROP)}
    cmd = ([sys.executable, "-c", code] if code else
           [sys.executable, "-m", "cause_tpu_torch.soak"]) + list(args)
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT,
                          stdin=subprocess.DEVNULL)


@pytest.mark.parametrize("rep", range(4))
@pytest.mark.parametrize("kind", [k.__name__ for k in soak.ROUNDS])
def test_every_soup_kind_passes_on_the_cpu(kind, rep):
    i = [k.__name__ for k in soak.ROUNDS].index(kind)
    seed = i + 6 * rep
    assert soak.ROUNDS[seed % len(soak.ROUNDS)].__name__ == kind
    soak.ROUNDS[i](random.Random(seed))


def _host(x):
    """A result as a comparable host value: its elements and dtype."""
    a = np.asarray(x.cpu() if hasattr(x, "cpu") else x)
    return a.tolist(), str(a.dtype)


def _recorded_round(monkeypatch, mod, pkg, ids, cbase, mapw, session,
                    kernels, kind, seed):
    """``mod.ROUNDS[kind]`` on ``random.Random(seed)`` with the package's
    site-id minting seeded from ``seed``; returns what the round
    produced, in order. The kernel entries are recorded only in the
    v5f round, which calls them itself (the other rounds reach the
    packages' own, different, internal routes)."""
    log = []

    def record(fn, tag, host=False):
        def recorded(*a, **kw):
            out = fn(*a, **kw)
            outs = out if isinstance(out, tuple) else (out,)
            log.append((tag, [_host(x) for x in outs] if host
                        else repr(out)))
            return out
        return recorded

    monkeypatch.setattr(ids, "_rng", random.Random(10_000 + seed))
    monkeypatch.setattr(pkg, "causal_to_edn",
                        record(pkg.causal_to_edn, "edn"))
    monkeypatch.setattr(cbase, "cb_to_edn", record(cbase.cb_to_edn, "cb"))
    monkeypatch.setattr(mapw, "merged_map_weave",
                        record(mapw.merged_map_weave, "map"))
    monkeypatch.setattr(session.FleetSession, "wave",
                        record(session.FleetSession.wave, "wave", True))
    if mod.ROUNDS[kind].__name__ == "v5f_round":
        for m, name in kernels:
            monkeypatch.setattr(m, name, record(
                getattr(m, name), name.removesuffix("_jit"), True))
    mod.ROUNDS[kind](random.Random(seed))
    return log


@pytest.mark.parametrize("rep", range(2))
@pytest.mark.parametrize("kind", [k.__name__ for k in soak.ROUNDS])
def test_every_soup_kind_equals_the_reference(monkeypatch, kind, rep):
    i = [k.__name__ for k in soak.ROUNDS].index(kind)
    seed = i + 6 * rep
    want = _recorded_round(
        monkeypatch, ref_soak(), jc, j_ids, j_cbase, j_mapw, j_session,
        [(jaxw5, "merge_weave_kernel_v5_jit"),
         (jaxw5f, "merge_weave_kernel_v5f_jit")], i, seed)
    got = _recorded_round(
        monkeypatch, soak, ct, t_ids, t_cbase, t_mapw, t_session,
        [(torchw5, "merge_weave_kernel_v5"),
         (torchw5f, "merge_weave_kernel_v5f")], i, seed)
    assert want, "the round produced nothing to compare"
    assert got == want


def _flip_digest(merge_wave):
    def corrupted(pairs, *a, **kw):
        res = merge_wave(pairs, *a, **kw)
        res.digest = res.digest ^ np.uint32(1)
        return res
    return corrupted


def _flip_rank(kernel):
    def corrupted(*a, **kw):
        rank, vis, conflict, ovf = kernel(*a, **kw)
        return rank ^ 1, vis, conflict, ovf
    return corrupted


@pytest.mark.parametrize("where", ["wave digest", "v5f rank"])
def test_a_corrupted_device_result_fails_its_round(monkeypatch, where):
    from cause_tpu_torch.weaver import torchw5f

    if where == "wave digest":
        monkeypatch.setattr(soak, "merge_wave",
                            _flip_digest(soak.merge_wave))
        kind, seed, msg = soak.wave_round, 1, "session vs wave digest"
    else:
        monkeypatch.setattr(torchw5f, "merge_weave_kernel_v5f",
                            _flip_rank(torchw5f.merge_weave_kernel_v5f))
        kind, seed, msg = soak.v5f_round, 5, "rank"
    with pytest.raises(AssertionError, match=msg):
        kind(random.Random(seed))


def test_cli_clean_run_exits_zero():
    out = run_cli(["--cpu", "--minutes", "0.05"])
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("soak finished: ") and "no failures" in last
    assert int(last.split()[2]) > 0


def test_cli_failure_prints_the_repro_and_exits_one():
    code = ("import sys\n"
            "import cause_tpu_torch.soak as s\n"
            "def broken(rng):\n"
            "    raise AssertionError('planted')\n"
            "s.ROUNDS = (broken,) * 6\n"
            "sys.exit(s.main(sys.argv[1:]))\n")
    out = run_cli(["--cpu", "--minutes", "0.05", "--seed0", "7"], code=code)
    assert out.returncode == 1, out.stdout + out.stderr
    assert ("SOAK FAILURE seed=7 kind=broken: AssertionError: planted"
            in out.stdout)
    assert "soak finished" not in out.stdout


def test_slo_without_obs_out_is_refused_as_in_the_reference(monkeypatch,
                                                            capsys):
    argv = ["--slo-ms", "5"]
    with pytest.raises(SystemExit) as port:
        soak.main(["--cpu"] + argv)
    port_err = capsys.readouterr().err
    ref = ref_soak()
    monkeypatch.setattr(sys, "argv", ["soak.py"] + argv)
    with pytest.raises(SystemExit) as want:
        ref.main()
    ref_err = capsys.readouterr().err
    assert port.value.code == want.value.code == 2
    line = "--slo-ms requires --obs-out"
    assert line in port_err and line in ref_err


def test_no_card_exits_nonzero_with_one_line():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go on it")
    out = run_cli(["--minutes", "0.05"])
    assert out.returncode != 0
    assert out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and "CUDA" in lines[0]


def _chaos_run(mod, obs, chaos, tmp_path, tag, monkeypatch):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(PLAN))
    out = str(tmp_path / f"{tag}.jsonl")
    monkeypatch.setenv("CAUSE_TPU_LEDGER", str(tmp_path / f"{tag}.led"))
    obs.configure(enabled=True, out=out)
    args = argparse.Namespace(chaos=str(plan), obs_out=out, minutes=0.0,
                              seed0=0, slo_ms=None)
    rc = mod.chaos_soak(args)
    log = [{k: v for k, v in f.items() if k != "ts_us"}
           for f in chaos.injected()]
    done = [e["fields"] for e in obs.events()
            if e.get("ev") == "event" and e.get("name") == "chaos.done"]
    chaos.reset()
    obs.configure(enabled=False, out="")
    return rc, log, done[-1]


def test_chaos_plan_equals_the_reference(tmp_path, monkeypatch):
    ref = ref_soak()
    j_rc, j_log, j_sum = _chaos_run(ref, j_obs, j_chaos, tmp_path, "jax",
                                    monkeypatch)
    t_rc, t_log, t_sum = _chaos_run(soak, t_obs, t_chaos, tmp_path,
                                    "torch", monkeypatch)
    assert j_rc == t_rc == 0
    assert len(t_log) == 6
    assert t_log == j_log
    for key in ("injected", "injected_total", "detected",
                "divergence_incidents", "quarantined_final",
                "converged_bit_identical"):
        assert t_sum[key] == j_sum[key], key
    assert t_sum["recovery"]["restores"] == j_sum["recovery"]["restores"]
    assert t_sum["converged_bit_identical"] is True
    rows = [json.loads(x) for x in
            (tmp_path / "torch.led").read_text().splitlines()]
    assert [r.get("kind") for r in rows] == ["chaos"]
    assert rows[0]["platform"] == "cpu"
