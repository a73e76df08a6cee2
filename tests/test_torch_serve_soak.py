"""The port's serve soak (``cause_tpu_torch.serve_soak``) against the
reference's ``scripts/serve_soak.py``.

- ``_zipf_weights`` is the reference's.
- A ``Generator`` driven by hand (``_mint_and_offer`` 40 times, seed 12,
  no thread) into each package's ``IngestQueue`` over a
  ``WriteAheadLog``, with both packages' site-id minting seeded alike
  and the clock pinned, writes byte-identical journal segments and
  makes the same admissions and refusals.
- ``_journal_oracle`` over one WAL directory gives equal documents
  (``causal_to_edn``, node bags, weave ids) in both packages; a
  bit-rotted record comes back from each package's chaos log.
- The lifted calibration round (``_calib_round``) makes the reference's
  offers (the reference's own closure, rebuilt around the reference's
  service) and gives equal converged documents.
- The CLI with ``--cpu`` at the flags of the reference CI's serve smoke
  passes that step's checks, ``obs watch --once`` and ``ledger
  --check``; ``--batched off --gate-dispatch`` exits 8; a materialized
  tenant corrupted in process makes ``main`` return 4; without a card
  and without ``--cpu`` the CLI exits non-zero with one line.

The disk arm's CLI run is in ``test_torch_serve_soak_disk.py``.
"""

import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
import types

import pytest

import cause_tpu as jc
from cause_tpu import chaos as j_chaos
from cause_tpu import ids as j_ids
from cause_tpu import obs as j_obs
from cause_tpu import serve as j_serve
from cause_tpu import sync as j_sync
from cause_tpu.obs import lag as j_lag

import cause_tpu_torch as ct
from cause_tpu_torch import chaos as t_chaos
from cause_tpu_torch import ids as t_ids
from cause_tpu_torch import obs as t_obs
from cause_tpu_torch import serve as t_serve
from cause_tpu_torch import serve_soak
from cause_tpu_torch import sync as t_sync
from cause_tpu_torch.obs import lag as t_lag

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_DROP = ("CAUSE_TPU_", "BENCH_")
# the flags of the reference CI's serve smoke (.github/workflows/ci.yml)
CI_SERVE = ["--tenants", "4", "--capacity", "4", "--doc", "100",
            "--d-max", "64", "--seconds", "6", "--rate-mult", "0.5",
            "--seed", "12"]
BITROT_PLAN = {"seed": 15, "faults": [
    {"family": "disk", "site": "serve.wal", "mode": "bitrot",
     "at": [10]}]}


def reset_all():
    for obs, lag, chaos, sync in ((j_obs, j_lag, j_chaos, j_sync),
                                  (t_obs, t_lag, t_chaos, t_sync)):
        obs.configure(enabled=False, out="")
        obs.reset()
        lag.reset()
        chaos.reset()
        sync.quarantine_reset()


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


def ref_serve_soak():
    """``scripts/serve_soak.py`` as a module (it sets JAX to the CPU,
    which the test session already is)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_serve_soak", os.path.join(ROOT, "scripts",
                                           "serve_soak.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return mod


def ref_calib_round(ref, svc, tenants, rng, weights):
    """The reference's calibration closure (``main``'s ``_calib_round``
    and the ``_flush`` it calls), rebuilt from its own code around the
    given service, tenants, draws and weights."""
    code = {c.co_name: c for c in ref.main.__code__.co_consts
            if isinstance(c, types.CodeType)}
    env = {"queue": svc.queue, "svc": svc, "rng": rng,
           "tenants": tenants, "calib_weights": weights}

    def bind(name):
        c = code[name]
        cells = tuple(types.CellType(env[v]) for v in c.co_freevars)
        return types.FunctionType(c, ref.__dict__, name, None, cells)

    env["_flush"] = bind("_flush")
    return bind("_calib_round")


@pytest.fixture(scope="module")
def ref():
    return ref_serve_soak()


def twin_fleet(monkeypatch, mod, ids, n, doc, seed=18):
    """``mod._mk_fleet(n, doc)`` with the package's site-id minting
    seeded from ``seed``: both packages build the same documents."""
    monkeypatch.setattr(ids, "_rng", random.Random(seed))
    return mod._mk_fleet(n, doc)


def seg_bytes(wal_dir):
    out = {}
    for name in sorted(os.listdir(wal_dir)):
        with open(os.path.join(wal_dir, name), "rb") as f:
            out[name] = f.read()
    return out


def doc_view(pkg, h):
    """A document as comparable host values: its EDN, node bag and
    weave ids."""
    return (pkg.causal_to_edn(h), dict(h.ct.nodes),
            [n[0] for n in h.get_weave()])


@pytest.mark.parametrize("n,alpha", [(1, 1.2), (4, 1.2), (32, 1.2),
                                     (7, 0.8)])
def test_zipf_weights_are_the_reference_s(ref, n, alpha):
    assert serve_soak._zipf_weights(n, alpha) == ref._zipf_weights(n,
                                                                   alpha)


def generated_wal(monkeypatch, mod, pkg_ids, serve, chaos, wal_dir,
                  plan=None):
    """``_mint_and_offer`` 40 times (seed 12) over a fleet of 3 tenants
    into a queue of 48 ops on a WAL at ``wal_dir``, with ``plan`` armed
    on ``chaos``. Returns the fleet, the generator's counters and the
    queue's stats."""
    pairs = twin_fleet(monkeypatch, mod, pkg_ids, 3, 30)
    tenants = [mod._Tenant(str(a.ct.uuid), a, b) for a, b in pairs]
    wal = serve.WriteAheadLog(wal_dir)
    queue = serve.IngestQueue(max_ops=48, journal=wal)
    gen = mod.Generator({"queue": queue}, tenants, 1.0, 12)
    if plan is not None:
        chaos.configure(plan=plan)
    for _ in range(40):
        gen._mint_and_offer()
    wal.close()
    stats = {k: v for k, v in queue.stats.items() if k != "wait_ms"}
    return pairs, (gen.offered, gen.admitted, gen.refused,
                   [t.minted_ops for t in tenants]), stats


@pytest.fixture
def pinned_clock(monkeypatch):
    """Every admission's timestamp one fixed value, so that journal
    bytes compare across packages."""
    monkeypatch.setattr(time, "time_ns", lambda: 1_700_000_000_000_000)


def test_generator_writes_the_reference_s_journal_bytes(
        monkeypatch, tmp_path, ref, pinned_clock):
    _, want, want_stats = generated_wal(monkeypatch, ref, j_ids, j_serve,
                                        j_chaos, str(tmp_path / "j"))
    _, got, got_stats = generated_wal(monkeypatch, serve_soak, t_ids,
                                      t_serve, t_chaos,
                                      str(tmp_path / "t"))
    assert got == want
    assert got_stats == want_stats
    assert want[2] > 0, "the queue refused nothing: no shed exercised"
    j, t = seg_bytes(tmp_path / "j"), seg_bytes(tmp_path / "t")
    assert j and t == j


def test_journal_oracle_equals_the_reference_s_with_bitrot(
        monkeypatch, tmp_path, ref, pinned_clock):
    j_pairs, want, _ = generated_wal(monkeypatch, ref, j_ids, j_serve,
                                     j_chaos, str(tmp_path / "j"),
                                     BITROT_PLAN)
    t_pairs, got, _ = generated_wal(monkeypatch, serve_soak, t_ids,
                                    t_serve, t_chaos, str(tmp_path / "t"),
                                    BITROT_PLAN)
    assert got == want
    # the same byte flipped in the same record, logged by both engines
    assert seg_bytes(tmp_path / "t") == seg_bytes(tmp_path / "j")
    rot = [r for r in t_chaos.injected() if r.get("mode") == "bitrot"]
    assert len(rot) == 1 and rot == [
        r for r in j_chaos.injected() if r.get("mode") == "bitrot"]

    wal_dir = str(tmp_path / "t")
    t_init = {str(a.ct.uuid): (a, b) for a, b in t_pairs}
    j_init = {str(a.ct.uuid): (a, b) for a, b in j_pairs}
    assert list(t_init) == list(j_init)
    got_docs, got_n = serve_soak._journal_oracle(t_init, wal_dir, None)
    want_docs, want_n = ref._journal_oracle(j_init, wal_dir, None)
    assert got_n == want_n == got[1]  # every admitted batch, rot included
    for u in t_init:
        assert doc_view(ct, got_docs[u]) == doc_view(jc, want_docs[u])
        assert serve_soak._doc_equal(got_docs[u], got_docs[u])
    # the rotted record's intact copy came from the chaos log: without
    # it the durable walk holds one record fewer
    t_chaos.reset()
    assert len(serve_soak._wal_entries(wal_dir, None)) == got_n - 1


def soak_service(serve, root, capacity=2):
    wal = serve.WriteAheadLog(os.path.join(root, "wal"))
    queue = serve.IngestQueue(max_ops=256, journal=wal)
    return serve.SyncService(
        queue, residency=serve.ResidencyManager(capacity=capacity),
        checkpoint_dir=os.path.join(root, "ckpt"), d_max=16,
        watchdog_s=None, batched=True)


def calibrated(monkeypatch, mod, pkg_ids, serve, root, rounds):
    """A service of 3 tenants (capacity 2) run through ``rounds``
    calibration rounds of the serve soak's draws (seed 12). Returns the
    service, its tenants' uuids and each round's admitted offers."""
    pairs = twin_fleet(monkeypatch, mod, pkg_ids, 3, 30)
    svc = soak_service(serve, root)
    tenants = []
    for a, b in pairs:
        tenants.append(mod._Tenant(svc.add_tenant(a, b), a, b))
    rng = random.Random(12 ^ 0x5EED)
    weights = mod._zipf_weights(len(tenants), 1.2)
    if mod is serve_soak:
        def step(k):
            return mod._calib_round(svc, tenants, rng, weights, k)
    else:
        step = ref_calib_round(mod, svc, tenants, rng, weights)
    admitted = [step(k) for k in range(rounds)]
    assert not (svc.queue.depth or svc.queue.deferred)
    return svc, [t.uuid for t in tenants], admitted


def test_calibration_round_makes_the_reference_s_offers(
        monkeypatch, tmp_path, ref, pinned_clock):
    j_svc, j_uuids, want = calibrated(monkeypatch, ref, j_ids, j_serve,
                                      str(tmp_path / "j"), 2)
    t_svc, t_uuids, got = calibrated(monkeypatch, serve_soak, t_ids,
                                     t_serve, str(tmp_path / "t"), 2)
    assert got == want and sum(got) > 0
    assert t_uuids == j_uuids
    j_svc.queue.journal.close()
    t_svc.queue.journal.close()
    assert seg_bytes(tmp_path / "t" / "wal") == seg_bytes(
        tmp_path / "j" / "wal")
    for u in t_uuids:
        assert doc_view(ct, t_svc.materialize(u)) == doc_view(
            jc, j_svc.materialize(u))


def run_cli(args, env=None, timeout=300, module="cause_tpu_torch.serve_soak"):
    e = {k: v for k, v in os.environ.items() if not k.startswith(ENV_DROP)}
    # one intra-op thread: the plain versions at these sizes gain
    # nothing from more, and the suite's other workers keep their cores
    e["OMP_NUM_THREADS"] = "1"
    e.update(env or {})
    return subprocess.run([sys.executable, "-m", module] + list(args),
                          capture_output=True, text=True, timeout=timeout,
                          env=e, cwd=ROOT, stdin=subprocess.DEVNULL)


def test_cli_passes_the_reference_ci_serve_smoke(tmp_path):
    led = str(tmp_path / "ledger.jsonl")
    obs_out = str(tmp_path / "obs_serve.jsonl")
    out = run_cli(["--cpu"] + CI_SERVE + ["--obs-out", obs_out],
                  env={"CAUSE_TPU_LEDGER": led})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "serve soak: clean" in out.stdout.splitlines()[-1]
    watch = run_cli(["watch", obs_out, "--once"],
                    module="cause_tpu_torch.obs")
    assert watch.returncode == 0, watch.stderr
    assert "serve: " in watch.stdout
    rows = [json.loads(x) for x in open(led)]
    (row,) = [r for r in rows if r.get("kind") == "serve"]
    assert row["platform"] == "cpu" and row["card"] is None
    s = row["serve"]
    assert s["sheds"] == 0, s
    assert s["crashes"] == 0, s
    assert s["restore_bit_identical"] is True, s
    assert s["p99_ms"] is not None \
        and math.isfinite(s["p99_ms"]) and s["p99_ms"] > 0, s
    assert s["max_depth"] <= s["max_ops"], s
    evs = t_obs.load_jsonl(obs_out)
    names = {e.get("name") for e in evs if e.get("ev") == "event"}
    assert "serve.tick" in names and "serve.drain" in names, (
        sorted(n for n in names if n.startswith("serve.")))
    assert not [e for e in evs if e.get("ev") == "event"
                and e.get("name") == "serve.shed"]
    check = run_cli(["ledger", "--ledger", led, "--check"],
                    module="cause_tpu_torch.obs")
    assert check.returncode == 0, check.stdout + check.stderr


SHORT = ["--tenants", "3", "--capacity", "3", "--doc", "30", "--d-max",
         "64", "--seconds", "1", "--calib-ticks", "1", "--seed", "3"]


def test_unbatched_run_fails_the_dispatch_gate(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setenv("CAUSE_TPU_LEDGER", str(tmp_path / "led.jsonl"))
    rc = serve_soak.main(["--cpu"] + SHORT + [
        "--batched", "off", "--gate-dispatch",
        "--obs-out", str(tmp_path / "obs.jsonl")])
    assert rc == serve_soak.EXIT_DISPATCH == 8
    assert "DISPATCH COLLAPSE GATE FAILED (batched=False" in \
        capsys.readouterr().out
    assert not os.path.exists(tmp_path / "led.jsonl")


def test_a_corrupted_tenant_fails_the_convergence_gate(tmp_path,
                                                       monkeypatch,
                                                       capsys):
    real = t_serve.SyncService.materialize
    hit = []

    def corrupted(self, uuid):
        h = real(self, uuid)
        if not hit:
            hit.append(uuid)
            h = h.conj("planted")
        return h

    monkeypatch.setattr(t_serve.SyncService, "materialize", corrupted)
    monkeypatch.setenv("CAUSE_TPU_LEDGER", str(tmp_path / "led.jsonl"))
    rc = serve_soak.main(["--cpu"] + SHORT + [
        "--obs-out", str(tmp_path / "obs.jsonl")])
    assert rc == serve_soak.EXIT_CONVERGENCE == 4
    out = capsys.readouterr().out
    assert f"CONVERGENCE GATE FAILED (restore_ok=True, mismatched=" \
           f"['{hit[0]}'])" in out


def test_no_card_exits_nonzero_with_one_line(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go on it")
    out = run_cli(CI_SERVE + ["--obs-out", str(tmp_path / "o.jsonl")])
    assert out.returncode != 0
    assert out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and "CUDA" in lines[0] \
        and lines[0].startswith("serve_soak: ")
    assert not os.path.exists(tmp_path / "o.jsonl")
