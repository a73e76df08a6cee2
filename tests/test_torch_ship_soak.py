"""The port's ship soak (``cause_tpu_torch.ship_soak``) against the
reference's ``scripts/ship_soak.py``.

- ``_soak_plan(seed)`` is the reference's, and ``_mk_tenant(seed)``
  builds the reference's documents (every site id pinned from the
  seed, so digests compare across processes and packages).
- The data plane at a few waves with ``--cpu``, telemetry ``off`` and
  ``partitioned``: equal digests and admissions, 0 connects and drops
  with evidence under the partition, and the digest equal to the
  reference's data plane at the same seed and waves.
- The fleet phase at 2 rounds passes its gates (exact per-origin
  accounting, no duplicate accepted, every journey complete from the
  collector alone, the WAL archive equal to the accepted count).
- The ``overhead`` data plane at a few waves ships (its own
  ``acked_seq > 0`` assert) and hands back both walls; its 1% gate is
  a timing gate, held by phase 19 of ``chip_smoke.py`` on the card.
- Without a card and without ``--cpu`` the CLI exits non-zero with one
  line, before any child starts.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import pytest

import cause_tpu as jc
from cause_tpu import obs as j_obs

import cause_tpu_torch as ct
from cause_tpu_torch import obs as t_obs
from cause_tpu_torch import ship_soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_DROP = ("CAUSE_TPU_", "BENCH_")
WAVES = "6"


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


@pytest.fixture(scope="module")
def ref():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_ship_soak", os.path.join(ROOT, "scripts", "ship_soak.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return mod


def doc_view(pkg, h):
    return (pkg.causal_to_edn(h), dict(h.ct.nodes),
            [n[0] for n in h.get_weave()], h.ct.site_id)


@pytest.mark.parametrize("seed", [0, 20, 77])
def test_soak_plan_is_the_reference_s(ref, seed):
    assert ship_soak._soak_plan(seed) == ref._soak_plan(seed)


@pytest.mark.parametrize("seed", [3, 20])
def test_mk_tenant_builds_the_reference_s_documents(ref, seed):
    got, want = ship_soak._mk_tenant(seed), ref._mk_tenant(seed)
    for g, w in zip(got, want):
        assert g.ct.weaver == "torch"
        assert doc_view(ct, g) == doc_view(jc, w)


def dataplane(tmp, mode, script=None, extra=()):
    """One ``--role dataplane`` child: the port's with ``--cpu``, or the
    reference's (``script``). Returns its handoff."""
    head = ([script] if script else
            ["-m", "cause_tpu_torch.ship_soak", "--cpu"])
    out = subprocess.run(
        [sys.executable, *head, "--role", "dataplane", "--seed", "20",
         "--waves", WAVES, "--ship-mode", mode,
         "--obs-out", str(tmp / f"{mode}.{bool(script)}.jsonl"), *extra],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=clean_env(JAX_PLATFORMS="cpu"), stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_dataplane_digest_holds_under_partition_and_is_the_reference_s(
        tmp_path):
    off = dataplane(tmp_path, "off")
    part = dataplane(tmp_path, "partitioned")
    assert off["digest"] == part["digest"]
    assert off["admitted"] == part["admitted"] > 0
    assert part["connects"] == 0 and part["dropped"] > 0
    assert off["connects"] == off["dropped"] == 0
    want = dataplane(tmp_path, "off",
                     script=os.path.join(ROOT, "scripts", "ship_soak.py"))
    assert off["digest"] == want["digest"]
    assert off["admitted"] == want["admitted"]


def test_fleet_phase_passes_its_gates(tmp_path, capsys):
    args = argparse.Namespace(seed=20, rounds=2, traces=4)
    fleet = ship_soak._fleet_phase(args, str(tmp_path / "soak"))
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "ship soak: fleet phase clean")
    assert fleet["journeys"] == 3 * 2 * 4
    assert fleet["clock_edges"] >= 1
    hands = fleet["handoffs"]
    assert len(hands) == 3 and hands[2]["dropped"] > 0
    stats = fleet["summary"]["stats"]
    assert stats["missed_records"] == sum(h["dropped"] for h in hands)
    with open(str(tmp_path / "soak") + ".plan.json") as f:
        assert json.load(f) == ship_soak._soak_plan(20)


def test_overhead_dataplane_ships(tmp_path):
    coll = ship_soak._spawn("collector", obs_out=tmp_path / "c.jsonl",
                            wal_dir=tmp_path / "wal",
                            dump=tmp_path / "dump.jsonl")
    try:
        port = json.loads(coll.stdout.readline())["port"]
        oh = dataplane(tmp_path, "overhead", extra=("--port", str(port)))
        coll.stdin.write("stop\n")
        coll.stdin.flush()
        co, _ = coll.communicate(timeout=60)
    finally:
        ship_soak._reap(coll)
    assert coll.returncode == 0
    assert oh["median_base_ms"] > 0 and oh["median_ship_ms"] > 0
    assert oh["overhead_pct_median"] is not None
    (origin,) = json.loads(co.strip().splitlines()[-1])["origins"]
    assert origin["accepted"] > 0


def test_no_card_exits_nonzero_with_one_line(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go on it")
    out = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.ship_soak",
         "--out", str(tmp_path / "s")], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=clean_env(), stdin=subprocess.DEVNULL)
    assert out.returncode != 0
    assert out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and "CUDA" in lines[0] \
        and lines[0].startswith("ship_soak: ")
    assert not os.path.exists(tmp_path / "s.plan.json")
