"""The port's ship smoke (``cause_tpu_torch.ship_smoke``) against the
reference CI's ship step and the reference's producer.

- ``python -m cause_tpu_torch.ship_smoke`` (host only: no ``--cpu``, no
  card) exits 0 from any working directory; its ``ship`` row passes
  CI's asserts (2 producers, 0 orphan hops, missed == the evidenced
  drops, duplicates skipped) and ``ledger --check``.
- One producer run in this process under the committed plan
  (``measurements/ship_plan_r20.json``), against a collector child,
  injects the reference's faults in the reference's order (family,
  site, mode, the call it fired on), and both hand back the same
  accounting.
- The collector and producer children are host work: neither imports
  torch.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from cause_tpu import chaos as j_chaos
from cause_tpu import obs as j_obs

from cause_tpu_torch import chaos as t_chaos
from cause_tpu_torch import obs as t_obs
from cause_tpu_torch import ship_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_DROP = ("CAUSE_TPU_", "BENCH_")
NO_TORCH = ("import sys\n"
            "from cause_tpu_torch import {mod} as m\n"
            "rc = m.main(sys.argv[1:])\n"
            "print('torch imported:', 'torch' in sys.modules, flush=True)\n"
            "sys.exit(rc)\n")


def clean_env(**extra):
    e = {k: v for k, v in os.environ.items() if not k.startswith(ENV_DROP)}
    # one intra-op thread, as in test_torch_serve_soak.py
    e["OMP_NUM_THREADS"] = "1"
    e.update(extra)
    return e


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith(ENV_DROP):
            monkeypatch.delenv(k)
    for obs, chaos in ((j_obs, j_chaos), (t_obs, t_chaos)):
        obs.configure(enabled=False, out="")
        obs.reset()
        chaos.reset()
    yield
    for obs, chaos in ((j_obs, j_chaos), (t_obs, t_chaos)):
        obs.configure(enabled=False, out="")
        obs.reset()
        chaos.reset()


def ref_ship_smoke():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_ship_smoke", os.path.join(ROOT, "scripts",
                                           "ship_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return mod


def test_cli_passes_the_reference_ci_ship_smoke(tmp_path):
    led = str(tmp_path / "ledger.jsonl")
    # from another directory, with a relative --out
    out = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.ship_smoke",
         "--out", "ship_smoke_ci"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        stdin=subprocess.DEVNULL,
        env=clean_env(CAUSE_TPU_LEDGER=led, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.splitlines()[-1].startswith("ship smoke: clean")
    assert os.path.isdir(tmp_path / "ship_smoke_ci.wal")
    rows = [json.loads(x) for x in open(led)]
    (row,) = [r for r in rows if r.get("kind") == "ship"]
    assert row["platform"] == "cpu" and row["card"] is None
    s = row["ship"]
    assert s["producers"] == 2, s
    assert s["orphan_hops"] == 0, s
    assert s["missed"] == s["evidenced_drops"], s
    assert s["dup_skipped"] > 0, s
    check = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.obs", "ledger",
         "--ledger", led, "--check"], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=clean_env(), stdin=subprocess.DEVNULL)
    assert check.returncode == 0, check.stdout + check.stderr


class Collector:
    """The port's collector child (``--role collector``), optionally
    wrapped to report whether torch was imported."""

    def __init__(self, tmp, tag, wrap=False):
        argv = ["--role", "collector", "--obs-out", str(tmp / f"{tag}.c"),
                "--wal-dir", str(tmp / f"{tag}.wal"),
                "--dump", str(tmp / f"{tag}.dump")]
        head = (["-c", NO_TORCH.format(mod="ship_smoke")] if wrap
                else ["-m", "cause_tpu_torch.ship_smoke"])
        self.proc = subprocess.Popen(
            [sys.executable, *head, *argv], cwd=ROOT, env=clean_env(),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.port = json.loads(self.proc.stdout.readline())["port"]

    def stop(self):
        self.proc.stdin.write("stop\n")
        self.proc.stdin.flush()
        out, _ = self.proc.communicate(timeout=60)
        assert self.proc.returncode == 0, out
        return out.strip().splitlines()


def producer_args(port, obs_out):
    return argparse.Namespace(port=port, traces=8, obs_out=obs_out,
                              buffer=65536, filler=0)


def injected(chaos):
    return [{k: v for k, v in r.items() if k != "ts_us"}
            for r in chaos.injected()]


def test_producer_injects_the_reference_s_faults(tmp_path, capsys):
    ref = ref_ship_smoke()
    got = {}
    for tag, mod, chaos in (("j", ref, j_chaos),
                            ("t", ship_smoke, t_chaos)):
        coll = Collector(tmp_path, tag)
        try:
            assert mod.producer_main(producer_args(
                coll.port, str(tmp_path / f"{tag}.p.jsonl"))) == 0
        finally:
            coll.stop()
        hand = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        got[tag] = (injected(chaos), {k: hand[k] for k in (
            "dropped", "buffer_dropped", "reconnects", "dial_failures",
            "unshipped")}, len(hand["traces"]))
    assert got["t"] == got["j"]
    modes = [(r["mode"], r["seq"]) for r in got["t"][0]]
    assert modes[:2] == [("partition", 1), ("partition", 2)]
    assert ("drop", 2) in modes
    assert got["t"][1]["dial_failures"] == 2


def test_collector_and_producer_children_are_host_only(tmp_path):
    coll = Collector(tmp_path, "h", wrap=True)
    prod = subprocess.run(
        [sys.executable, "-c", NO_TORCH.format(mod="ship_smoke"),
         "--role", "producer", "--port", str(coll.port), "--traces", "2",
         "--obs-out", str(tmp_path / "h.p.jsonl")],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=clean_env(), stdin=subprocess.DEVNULL)
    lines = coll.stop()
    assert prod.returncode == 0, prod.stdout + prod.stderr
    assert prod.stdout.strip().splitlines()[-1] == "torch imported: False"
    assert lines[-1] == "torch imported: False"
    summary = json.loads(lines[-2])
    hand = json.loads(prod.stdout.strip().splitlines()[-2])
    (origin,) = summary["origins"]
    assert origin["watermark"] == hand["acked"] > 0
