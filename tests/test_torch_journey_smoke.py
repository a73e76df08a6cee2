"""The port's journey smoke (``cause_tpu_torch.journey_smoke``) against
the reference CI's journey step and the reference's journey fold.

- ``python -m cause_tpu_torch.journey_smoke --cpu`` at the reference
  CI's flags exits 0 (a run that misses by ROADMAP C.7, the clock
  offset's bias on a loaded host, shared with the reference, is run
  again; any other miss fails); ``python -m cause_tpu_torch.obs
  journey --worst 3`` over its two streams prints CI's three lines (0
  orphan hops, the per-hop decomposition, the clock edge); its
  ``journey`` row passes CI's asserts and ``ledger --check``.
- The reference's ``journey_report`` and ``JourneyFold`` over the same
  two streams find the row's trace complete across both pids with 0
  orphan hops and the port's hops in the port's order.
- The client half (``--child``) is host work: run against a server in
  this process, it acks every op and never imports torch.
- Without a card and without ``--cpu`` the CLI exits non-zero with one
  line.
"""

import json
import os
import subprocess
import sys

import pytest

from cause_tpu.obs import journey as j_journey
from cause_tpu.obs import perfetto as j_perfetto

import cause_tpu_torch as ct
from cause_tpu_torch import journey_smoke
from cause_tpu_torch.collections.clist import CausalList
from cause_tpu_torch.ids import new_site_id
from cause_tpu_torch.obs import journey as t_journey
from cause_tpu_torch.obs import perfetto as t_perfetto

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_DROP = ("CAUSE_TPU_", "BENCH_")
# runs a module's main with argv and reports, after it, whether torch
# was ever imported in the process
NO_TORCH = ("import sys\n"
            "from cause_tpu_torch import {mod} as m\n"
            "rc = m.main(sys.argv[1:])\n"
            "print('torch imported:', 'torch' in sys.modules, flush=True)\n"
            "sys.exit(rc)\n")


def run(args, env=None, module="cause_tpu_torch.journey_smoke", code=None,
        timeout=300):
    e = {k: v for k, v in os.environ.items() if not k.startswith(ENV_DROP)}
    # one intra-op thread, as in test_torch_serve_soak.py
    e["OMP_NUM_THREADS"] = "1"
    e.update(env or {})
    head = ["-c", code] if code else ["-m", module]
    return subprocess.run([sys.executable, *head, *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=e, cwd=ROOT, stdin=subprocess.DEVNULL)


def clock_bias_miss(obs_out) -> bool:
    """Whether a failed run is ROADMAP C.7: the client's ``send`` hop
    precedes the server's ``recv`` on the shared wall clock, but the
    edge's median offset estimate exceeds that gap, so the corrected
    journey puts ``send`` after ``recv``."""
    evs = t_perfetto.load_streams([obs_out, obs_out + ".client"])
    offs = sorted(e["fields"]["offset_us"] for e in evs
                  if e.get("name") == "xtrace.clock")
    mint = [e["fields"]["trace"] for e in evs
            if e.get("name") == "xtrace.hop"
            and e["fields"].get("hop") == "mint"
            and e["fields"].get("client")]
    raw = {e["fields"]["hop"]: e["ts_us"] for e in evs
           if e.get("name") == "xtrace.hop"
           and e["fields"].get("trace") == mint[0]}
    gap = raw["recv"] - raw["send"]
    return 0 < gap < offs[len(offs) // 2]


# C.7 can still make the journey gate miss on a loaded host: a run may
# repeat, each miss held to C.7's signature, none to any other
ATTEMPTS = 3


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """One clean CLI run at the reference CI's flags: its streams and
    its ledger."""
    for attempt in range(ATTEMPTS):
        tmp = tmp_path_factory.mktemp("journey")
        led = str(tmp / "ledger.jsonl")
        obs_out = str(tmp / "obs_journey_ci.jsonl")
        out = run(["--cpu", "--obs-out", obs_out],
                  env={"CAUSE_TPU_LEDGER": led})
        if out.returncode == 0:
            break
        assert "names.index" in out.stderr and clock_bias_miss(obs_out), \
            out.stdout[-3000:] + out.stderr[-3000:]
        assert not os.path.exists(led)
    assert out.returncode == 0, f"{ATTEMPTS} runs missed by C.7"
    assert out.stdout.splitlines()[-1].startswith("journey smoke: clean")
    return {"led": led, "obs": obs_out, "client": obs_out + ".client"}


def test_cli_passes_the_reference_ci_journey_smoke(smoke):
    rep = run(["journey", "--worst", "3", smoke["obs"], smoke["client"]],
              module="cause_tpu_torch.obs")
    assert rep.returncode == 0, rep.stderr
    for need in ("0 orphan hop(s)", "per-hop decomposition",
                 "clock (ref pid"):
        assert need in rep.stdout, (need, rep.stdout)
    rows = [json.loads(x) for x in open(smoke["led"])]
    (row,) = [r for r in rows if r.get("kind") == "journey"]
    assert row["platform"] == "cpu" and row["card"] is None
    j = row["journey"]
    assert j["processes"] == 2, j
    assert j["orphan_hops"] == 0, j
    assert j["clock_edges"] >= 1, j
    assert j["total_ms"] is not None and j["total_ms"] > 0, j
    check = run(["ledger", "--ledger", smoke["led"], "--check"],
                module="cause_tpu_torch.obs")
    assert check.returncode == 0, check.stdout + check.stderr


def test_reference_fold_finds_the_same_journey(smoke):
    (row,) = [json.loads(x) for x in open(smoke["led"])]
    tr = row["journey"]["trace"]
    paths = [smoke["obs"], smoke["client"]]
    j_events = j_perfetto.load_streams(paths)
    t_events = t_perfetto.load_streams(paths)
    assert j_events == t_events
    want = j_journey.journey_report(j_events)
    assert want["orphan_hops"] == 0 and want["clock"]["edges"]
    got = t_journey.journey_report(t_events)
    assert got["complete"] == want["complete"]
    assert got["orphan_hops"] == want["orphan_hops"]
    j_fold = j_journey.JourneyFold(retain_all=True)
    j_fold.feed_many(j_events)
    t_fold = t_journey.JourneyFold(retain_all=True)
    t_fold.feed_many(t_events)
    jj, tj = j_fold.journey(tr), t_fold.journey(tr)
    assert jj is not None and jj["complete"] and jj["orphans"] == 0
    assert len(jj["pids"]) == 2
    assert [h["hop"] for h in jj["hops"]] == [h["hop"] for h in tj["hops"]]
    assert jj["total_ms"] == tj["total_ms"] == row["journey"]["total_ms"]


def test_client_half_is_host_only(tmp_path):
    """The ``--child`` half against a server of this process: every op
    acked, a trace handed back, and no torch in its interpreter."""
    from cause_tpu_torch import net, serve

    before = ct.default_device()
    ct.use_device("cpu")
    q = serve.IngestQueue(max_ops=4096, journal=serve.IngestJournal(
        str(tmp_path / "ingest.jsonl")))
    svc = serve.SyncService(q, checkpoint_dir=str(tmp_path / "ckpt"),
                            d_max=64)
    base = ct.clist(weaver="torch").extend(["w"] * 4)
    a = CausalList(base.ct.evolve(site_id=new_site_id())).conj("A")
    b = CausalList(base.ct.evolve(site_id=new_site_id())).conj("B")
    srv = None
    try:
        uuid = svc.add_tenant(a, b)
        srv = net.ReplicationServer(svc).start()
        argv = journey_smoke.child_command(srv.port, uuid, 4,
                                           str(tmp_path / "c.jsonl"))
        out = run(argv[3:], code=NO_TORCH.format(mod="journey_smoke"))
    finally:
        if srv is not None:
            srv.stop()
        svc.close()
        ct.use_device(before)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "torch imported: False"
    hand = json.loads(lines[-2])
    assert hand["trace"] and hand["acked"] == hand["accounted"] == 4
    assert q.stats["admitted_ops"] == 4


def test_no_card_exits_nonzero_with_one_line(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would go on it")
    out = run(["--obs-out", str(tmp_path / "o.jsonl")])
    assert out.returncode != 0
    assert out.stdout == ""
    lines = out.stderr.strip().splitlines()
    assert len(lines) == 1 and "CUDA" in lines[0] \
        and lines[0].startswith("journey_smoke: ")
    assert not os.path.exists(tmp_path / "o.jsonl")
