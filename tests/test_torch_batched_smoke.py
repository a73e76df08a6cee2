"""The port's batched-serve smoke (``cause_tpu_torch.batched_smoke``)
against the reference's ``scripts/batched_smoke.py``, and the obs-off
byte pin (``cause_tpu_torch.obs_off_pin``) against the committed capture.

- ``main(["--cpu", ...])`` passes its gates and lands one ``serve`` row
  whose ``serve`` extra (tenants, buckets, wave dispatches, fallbacks,
  batch rows, digest bit-identity) equals the one the reference's
  ``main`` lands in the same process, and which ``ledger --check``
  passes.
- ``one_tick`` hands back both arms' digests, equal tenant by tenant,
  and the batched tick's record: 2 buckets, 2 dispatches.
- Without a card and without ``--cpu`` the CLI exits non-zero with one
  line.
- ``python -m cause_tpu_torch.obs_off_pin --check`` exits 0 against
  ``measurements/obs_off_pin_r19.json`` from any working directory; a
  fresh capture checks clean against itself; one changed byte of the
  pin makes ``--check`` exit 1 naming the section.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from cause_tpu import obs as j_obs

import cause_tpu_torch as ct
from cause_tpu_torch import batched_smoke, obs_off_pin
from cause_tpu_torch import obs as t_obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_DROP = ("CAUSE_TPU_", "BENCH_")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith(ENV_DROP):
            monkeypatch.delenv(k)
    before = ct.default_device()
    ct.use_device("cpu")
    for obs in (j_obs, t_obs):
        obs.configure(enabled=False, out="")
        obs.reset()
    yield
    for obs in (j_obs, t_obs):
        obs.configure(enabled=False, out="")
        obs.reset()
    ct.use_device(before)


def ref_batched_smoke():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_batched_smoke", os.path.join(ROOT, "scripts",
                                              "batched_smoke.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return mod


def run(module, args, env=None, cwd=ROOT):
    e = {k: v for k, v in os.environ.items() if not k.startswith(ENV_DROP)}
    # one intra-op thread, as in test_torch_serve_soak.py
    e["OMP_NUM_THREADS"] = "1"
    e.update(env or {})
    return subprocess.run([sys.executable, "-m", module] + list(args),
                          capture_output=True, text=True, timeout=300,
                          env=e, cwd=cwd, stdin=subprocess.DEVNULL)


def test_main_lands_the_reference_s_serve_row(tmp_path, monkeypatch,
                                              capsys):
    t_led, j_led = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    monkeypatch.setenv("CAUSE_TPU_LEDGER", str(t_led))
    assert batched_smoke.main(["--cpu", "--tenants", "12", "--obs-out",
                               str(tmp_path / "t_obs.jsonl")]) == 0
    assert "12 tenants, 2 buckets, 2 dispatch(es) in one tick" in \
        capsys.readouterr().out
    monkeypatch.setenv("CAUSE_TPU_LEDGER", str(j_led))
    monkeypatch.setattr(sys, "argv", ["batched_smoke.py", "--tenants",
                                      "12", "--obs-out",
                                      str(tmp_path / "j_obs.jsonl")])
    assert ref_batched_smoke().main() == 0
    (got,) = [json.loads(x) for x in open(t_led)]
    (want,) = [json.loads(x) for x in open(j_led)]
    assert got["kind"] == want["kind"] == "serve"
    assert got["serve"] == want["serve"]
    assert got["serve"]["wave_dispatches"] == got["serve"]["buckets"] == 2
    assert got["platform"] == "cpu" and got["card"] is None
    for k in ("metric", "value_ms", "config", "smoke", "kernel"):
        assert got[k] == want[k], k
    check = run("cause_tpu_torch.obs", ["ledger", "--ledger", str(t_led),
                                        "--check"])
    assert check.returncode == 0, check.stdout + check.stderr


def test_one_tick_returns_both_arms(tmp_path):
    t_obs.configure(enabled=True, out=str(tmp_path / "obs.jsonl"))
    dig_b, dig_u, out, tenants = batched_smoke.one_tick(str(tmp_path), 6)
    assert len(tenants) == 6 and set(dig_b) == set(dig_u) == {
        t["uuid"] for t in tenants}
    assert dig_b == dig_u
    assert out["tenants"] == 6
    assert out["buckets"] == out["wave_dispatches"] == 2


def test_no_card_exits_nonzero_with_one_line(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go on it")
    out = run("cause_tpu_torch.batched_smoke",
              ["--obs-out", str(tmp_path / "o.jsonl")])
    assert out.returncode != 0
    assert out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("batched_smoke: ") \
        and "CUDA" in lines[0]


def test_obs_off_pin_checks_clean_from_any_directory(tmp_path):
    e = {"PYTHONPATH": ROOT}
    out = run("cause_tpu_torch.obs_off_pin", ["--check"], env=e,
              cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout + out.stderr
    assert "obs-off pin: clean" in out.stdout
    assert os.path.samefile(obs_off_pin.PIN_PATH_DEFAULT, os.path.join(
        ROOT, "measurements", "obs_off_pin_r19.json"))


def test_obs_off_pin_capture_round_trips_and_catches_a_byte(tmp_path,
                                                            capsys):
    cap = tmp_path / "cap.json"
    assert obs_off_pin.main(["--out", str(cap)]) == 0
    assert obs_off_pin.main(["--check", str(cap)]) == 0
    pin = json.loads(cap.read_text())
    with open(obs_off_pin.PIN_PATH_DEFAULT) as f:
        committed = json.load(f)
    assert pin["wire"] == committed["wire"]
    assert pin["journal"] == committed["journal"]
    seg = pin["journal"]["wal_segment"]
    pin["journal"]["wal_segment"] = seg[:-2] + (
        "00" if seg[-2:] != "00" else "01")
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(pin))
    capsys.readouterr()
    assert obs_off_pin.main(["--check", str(bad)]) == 1
    out = capsys.readouterr().out
    assert "BYTES CHANGED — journal.wal_segment" in out
    assert "wire." not in out.splitlines()[0]
