"""The port's wire chaos soak (``cause_tpu_torch.net_soak``) against the
reference's ``scripts/net_soak.py`` and the reference CI's net step.

- ``_mk_tenants`` with both packages' site-id minting seeded alike
  builds the same documents (uuids, EDN, node bags, weave ids).
- ``ClientDriver._mint_batch`` makes the reference's draws for a seed
  (its thread never started: the constructor dials nothing).
- ``_journal_oracle`` over one journal file gives equal documents in
  both packages.
- The CLI with ``--cpu`` at the reference CI's flags passes that step's
  Python block, ``obs watch --once`` and ``ledger --check``. The run
  adds ``--tick-every 0.3``: at the default 0.03 s the plan's crash
  (tick 10) can land as client 2 sends a planned duplicate on the
  connection the crash is closing, and the exact-duplicate gate then
  exits 5 (ROADMAP C.6, in both packages).
- ``--proc-clients 2`` (``journey_smoke``'s client half in two child
  interpreters) at a short window exits 0 with the journey row.
- A materialized tenant corrupted in process makes ``main`` return 4.
- Without a card and without ``--cpu`` the CLI exits non-zero with one
  line.
- C.6, pinned in both packages: a planned duplicate sent on a
  connection the server has closed is injected (the chaos log has it)
  but never reaches a server, so no ``dup_frames`` evidence can match
  it.
"""

import importlib.util
import json
import os
import random
import subprocess
import sys
import threading

import pytest

import cause_tpu as jc
from cause_tpu import chaos as j_chaos
from cause_tpu import ids as j_ids
from cause_tpu import net as j_net
from cause_tpu import obs as j_obs
from cause_tpu import serve as j_serve
from cause_tpu import sync as j_sync

import cause_tpu_torch as ct
from cause_tpu_torch import chaos as t_chaos
from cause_tpu_torch import ids as t_ids
from cause_tpu_torch import net as t_net
from cause_tpu_torch import net_soak
from cause_tpu_torch import obs as t_obs
from cause_tpu_torch import serde as t_serde
from cause_tpu_torch import serve as t_serve
from cause_tpu_torch import sync as t_sync

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_DROP = ("CAUSE_TPU_", "BENCH_")
PLAN = os.path.join(ROOT, "measurements", "net_plan_r13.json")
# the reference CI's net-smoke flags (.github/workflows/ci.yml)
CI_NET = ["--seconds", "8", "--seed", "13", "--chaos", PLAN]


def reset_all():
    for obs, chaos, sync in ((j_obs, j_chaos, j_sync),
                             (t_obs, t_chaos, t_sync)):
        obs.configure(enabled=False, out="")
        obs.reset()
        chaos.reset()
        sync.quarantine_reset()


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in list(os.environ):
        if k.startswith(ENV_DROP):
            monkeypatch.delenv(k)
    before = ct.default_device()
    ct.use_device("cpu")
    reset_all()
    yield
    reset_all()
    ct.use_device(before)


@pytest.fixture(scope="module")
def ref():
    """``scripts/net_soak.py`` as a module (it sets JAX to the CPU,
    which the test session already is)."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_net_soak", os.path.join(ROOT, "scripts", "net_soak.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return mod


class KeyedService:
    """The one call ``_mk_tenants`` makes of a service."""

    def add_tenant(self, a, b):
        return str(a.ct.uuid)


def twin_tenants(monkeypatch, mod, ids, n, doc, seed=13):
    monkeypatch.setattr(ids, "_rng", random.Random(seed))
    return mod._mk_tenants(KeyedService(), n, doc)


def doc_view(pkg, h):
    return (pkg.causal_to_edn(h), dict(h.ct.nodes),
            [n[0] for n in h.get_weave()])


@pytest.mark.parametrize("n,doc", [(2, 5), (3, 40)])
def test_mk_tenants_builds_the_reference_s_documents(monkeypatch, ref, n,
                                                     doc):
    want_u, want = twin_tenants(monkeypatch, ref, j_ids, n, doc)
    got_u, got = twin_tenants(monkeypatch, net_soak, t_ids, n, doc)
    assert got_u == want_u and len(set(got_u)) == n
    for u in got_u:
        for g, w in zip(got[u], want[u]):
            assert g.ct.weaver == "torch"
            assert doc_view(ct, g) == doc_view(jc, w)
            assert g.ct.site_id == w.ct.site_id


@pytest.mark.parametrize("seed,idx", [(13, 0), (13, 2), (7, 5)])
def test_client_driver_makes_the_reference_s_draws(monkeypatch, ref, seed,
                                                   idx):
    out = {}
    for mod, ids in ((ref, j_ids), (net_soak, t_ids)):
        monkeypatch.setattr(ids, "_rng", random.Random(seed))
        d = mod.ClientDriver(idx, 1, "tenant", seed, 0.1,
                             threading.Event())
        batches = [d._mint_batch() for _ in range(30)]
        assert not d.is_alive() and d.client.outbound_depth == 0
        out[mod] = (d.site, batches, d.minted, d.minted_ids,
                    d.client.site, d.client.client_id)
    assert out[net_soak] == out[ref]
    assert out[ref][2] == len(out[ref][3]) > 30


def test_journal_oracle_equals_the_reference_s(monkeypatch, tmp_path,
                                               ref):
    j_u, j_pairs = twin_tenants(monkeypatch, ref, j_ids, 3, 30)
    t_u, t_pairs = twin_tenants(monkeypatch, net_soak, t_ids, 3, 30)
    assert j_u == t_u
    path = str(tmp_path / "ingest.jsonl")
    jr = t_serve.IngestJournal(path)
    monkeypatch.setattr(t_ids, "_rng", random.Random(5))
    drivers = [net_soak.ClientDriver(i, 1, u, 13, 0.1, threading.Event())
               for i, u in enumerate(t_u)]
    for _ in range(6):
        for d in drivers:
            batch = d._mint_batch()
            items = t_serde.encode_node_items(
                {nid: (cause, v) for nid, cause, v in batch})
            jr.append(d.uuid, d.site, items)
    jr.close()
    got, got_n = net_soak._journal_oracle(t_pairs, path)
    want, want_n = ref._journal_oracle(j_pairs, path)
    assert got_n == want_n == 18
    for u in t_u:
        assert doc_view(ct, got[u]) == doc_view(jc, want[u])
        assert net_soak._doc_equal(got[u], got[u])
        minted = [nid for d in drivers if d.uuid == u
                  for nid in d.minted_ids]
        assert all(nid in got[u].ct.nodes for nid in minted)


def run_cli(args, env=None, module="cause_tpu_torch.net_soak",
            timeout=300):
    e = {k: v for k, v in os.environ.items() if not k.startswith(ENV_DROP)}
    # one intra-op thread, as in test_torch_serve_soak.py
    e["OMP_NUM_THREADS"] = "1"
    e.update(env or {})
    return subprocess.run([sys.executable, "-m", module] + list(args),
                          capture_output=True, text=True, timeout=timeout,
                          env=e, cwd=ROOT, stdin=subprocess.DEVNULL)


def test_cli_passes_the_reference_ci_net_smoke(tmp_path):
    led = str(tmp_path / "ledger.jsonl")
    obs_out = str(tmp_path / "obs_net_ci.jsonl")
    out = run_cli(["--cpu"] + CI_NET + ["--tick-every", "0.3",
                                        "--obs-out", obs_out],
                  env={"CAUSE_TPU_LEDGER": led})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "net soak: clean" in out.stdout.splitlines()[-1]
    watch = run_cli(["watch", obs_out, "--once"],
                    module="cause_tpu_torch.obs")
    assert watch.returncode == 0, watch.stderr
    assert "net: " in watch.stdout

    # the reference CI's Python block, on the port's ledger and stream
    plan = json.load(open(PLAN))

    def planned(mode):
        return sum(len(s.get("at") or ()) for s in plan["faults"]
                   if s["family"] == "net" and s.get("mode") == mode)

    dups, partitions = planned("dup"), planned("partition")
    assert dups >= 1 and partitions >= 1
    rows = [json.loads(x) for x in open(led)]
    (row,) = [r for r in rows if r.get("kind") == "net"]
    assert row["platform"] == "cpu" and row["card"] is None
    n = row["net"]
    assert n["dup_frames"] == dups, (n["dup_frames"], dups)
    assert n["minted_ops"] > 0, n
    assert (n["acked_ops"] + n["dup_acked_ops"]
            + n["resumed_skipped_ops"]) == n["minted_ops"], n
    assert n["minted_ops_missing"] == 0, n
    assert n["client_shed_ops"] == 0, n
    assert n["crashes"] == 1, n
    assert n["reconnects"] >= 1, n
    assert n["dial_failures"] >= partitions, n
    assert n["partition_mttr_mean_ms"] is not None, n
    evs = t_obs.load_jsonl(obs_out)
    names = {e.get("name") for e in evs if e.get("ev") == "event"}
    for need in ("net.connect", "net.reconnect", "net.heartbeat",
                 "net.dup_frame", "sync.reject"):
        assert need in names, (need, sorted(
            x for x in names if str(x).startswith("net.")))
    dup_evs = [e for e in evs if e.get("ev") == "event"
               and e.get("name") == "net.dup_frame"]
    assert len(dup_evs) == dups, (len(dup_evs), dups)
    check = run_cli(["ledger", "--ledger", led, "--check"],
                    module="cause_tpu_torch.obs")
    assert check.returncode == 0, check.stdout + check.stderr


def test_proc_clients_pass_the_journey_gate(tmp_path):
    led = str(tmp_path / "ledger.jsonl")
    obs_out = str(tmp_path / "obs_net_p.jsonl")
    out = run_cli(["--cpu", "--clients", "2", "--doc", "10",
                   "--seconds", "3", "--frame-bench", "20",
                   "--proc-clients", "2", "--obs-out", obs_out],
                  env={"CAUSE_TPU_LEDGER": led})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert any(x.startswith("net soak: journey gate clean")
               for x in out.stdout.splitlines())
    (row,) = [json.loads(x) for x in open(led)]
    j = row["journey"]
    assert j["proc_clients"] == 2 and j["streams"] == 3
    assert j["orphan_hops"] == 0 and j["clock_edges"] >= 2
    assert len(j["proc_traces"]) == 2
    for k in (1, 2):
        assert os.path.exists(f"{obs_out}.p{k}")
    assert row["net"]["minted_ops_missing"] == 0


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
    rc = net_soak.main(["--cpu", "--clients", "2", "--doc", "10",
                        "--seconds", "1", "--frame-bench", "10",
                        "--obs-out", str(tmp_path / "obs.jsonl")])
    assert rc == net_soak.EXIT_CONVERGENCE == 4
    out = capsys.readouterr().out
    assert f"CONVERGENCE GATE FAILED (mismatched=['{hit[0]}']" in out
    assert not os.path.exists(tmp_path / "led.jsonl")


def test_no_card_exits_nonzero_with_one_line(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go on it")
    out = run_cli(CI_NET + ["--obs-out", str(tmp_path / "o.jsonl")])
    assert out.returncode != 0
    assert out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and "CUDA" in lines[0] \
        and lines[0].startswith("net_soak: ")
    assert not os.path.exists(tmp_path / "o.jsonl")


@pytest.mark.parametrize("side", ["reference", "port"])
def test_a_dup_on_a_connection_the_server_closed_goes_unevidenced(side):
    """ROADMAP C.6: the crash protocol stops the server while a client
    still holds its connection; the client's next delta frame, planned
    as a duplicate, goes into the closed socket. The injection is
    logged, the server counts no duplicate, so the soak's exact
    ``dup_frames == planned`` gate cannot hold for it."""
    net, serve, chaos = ((j_net, j_serve, j_chaos) if side == "reference"
                         else (t_net, t_serve, t_chaos))

    class Service:
        queue = serve.IngestQueue(max_ops=64, defer_frac=1.0)
        tenants = {"t": {"applied_seq": 0}}

    srv = net.ReplicationServer(Service()).start()
    cl = net.NetClient("127.0.0.1", srv.port, ["t"], client_id="c",
                       read_timeout_s=0.5, connect_timeout_s=0.5,
                       site="net.cx")
    try:
        root = (0, "0", 0)
        assert cl.queue_ops("t", "s1", [((1, "s1", 0), root, "a")])
        assert cl.pump()["outbound_ops"] == 0 and cl.connected
        chaos.configure(plan={"seed": 1, "faults": [
            {"family": "net", "mode": "dup", "site": "net.cx",
             "at": [1]}]})
        srv.stop()  # the crash protocol's first step
        assert cl.queue_ops("t", "s1", [((2, "s1", 0), (1, "s1", 0), "b")])
        cl.pump()
        assert not cl.connected
        assert [(r["mode"], r["site"]) for r in chaos.injected()] == [
            ("dup", "net.cx")]
        assert srv.stats["dup_frames"] == 0
        assert Service.queue.stats["admitted_ops"] == 1
    finally:
        cl.close()
        srv.stop()
