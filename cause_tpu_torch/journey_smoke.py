"""Journey smoke of the port: distributed tracing across a REAL process
boundary. A port of ``scripts/journey_smoke.py``.

    CAUSE_TPU_LEDGER=ledger.jsonl \\
      python -m cause_tpu_torch.journey_smoke --obs-out obs_journey.jsonl
    python -m cause_tpu_torch.journey_smoke --cpu ...   # plain versions

Two genuinely separate processes on loopback: this process serves one
tenant behind a ``ReplicationServer`` and ticks it on the device; a
child interpreter (``python -m cause_tpu_torch.journey_smoke --child``,
started from the checkout's root) dials in as a ``NetClient``, takes
two heartbeats on the warm session (their clock samples outvote the
hello's, ROADMAP C.7), mints a traced batch, and pushes it over the
wire. The child is host work only: it never claims the device. Each
process writes its OWN obs stream. The gates then run on the MERGED
streams — exactly what an operator has after collecting per-host
sidecars:

- the child's trace reconstructs as ONE journey spanning both pids:
  mint/send client-side, recv/admit/journal/tick/wave server-side,
  in causal order after the hello clock-offset correction, with
  every per-hop delta non-negative;
- the journey is complete — converged terminal, ZERO orphan hops
  (every parent span resolved across the process boundary);
- at least one clock edge was measured (the hello RTT sample rode
  the child's connect);
- a ``--kind journey`` ledger row lands (value = the traced
  journey's mint→converged total) for ``ledger --check`` to vet; its
  ``platform`` is the device's tag (``gpu`` or ``cpu``) and ``card``
  the card's ``name, power.limit`` (null on the CPU).

Exit 0 clean; any gate miss raises (exit 1). Runs on the card unless
``--cpu`` asks for the plain versions on the CPU: without a card and
without ``--cpu`` it exits 2 with one line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import cause_tpu_torch as c
from . import obs, sync
from .collections import clist as c_list
from .collections.clist import CausalList
from .ids import new_site_id
from .obs import ledger
from .obs.journey import JourneyFold, journey_report
from .obs.perfetto import load_streams

CLIENT_ID = "journey-smoke"
# the checkout's root: children are started there as ``python -m``
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mint_ops(site, n):
    out, last, ts = [], c.root_id, 1000
    for _ in range(n):
        ts += 1
        nid = (ts, site, 0)
        out.append((nid, last, f"op{ts}"))
        last = nid
    return out


def child_command(port: int, uuid: str, ops: int, obs_out: str) -> list:
    """The argv of the client half, run from ``ROOT``."""
    return [sys.executable, "-m", "cause_tpu_torch.journey_smoke",
            "--child", "--port", str(port), "--uuid", uuid,
            "--ops", str(ops), "--obs-out", obs_out]


# ------------------------------------------------------ child process


def child_main(args) -> int:
    """The client half: its own interpreter, its own obs stream, its
    own wall clock. Dial, heartbeat twice, mint one traced batch, pump
    to acked, flush, and hand the trace id back on stdout. Host work:
    it never claims or initialises the device."""
    from .net import Backoff, NetClient

    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform("cpu")  # host work: its events never name the card
    client_id = f"{CLIENT_ID}-{os.getpid()}"
    cl = NetClient("127.0.0.1", args.port, [args.uuid],
                   client_id=client_id, read_timeout_s=1.0,
                   heartbeat_s=0.5, connect_timeout_s=0.5,
                   backoff=Backoff(base_ms=20, cap_ms=500,
                                   seed=os.getpid()))
    # two heartbeats on the warm session before the batch: the hello's
    # clock sample also times the server starting a thread for the new
    # connection, which can exceed a delta's send→recv and put the
    # corrected send after the server's recv (ROADMAP C.7); the
    # journey fold takes the median of an edge's samples
    deadline = time.monotonic() + 30.0
    while cl.stats["heartbeats"] < 2 and time.monotonic() < deadline:
        cl.pump()
        time.sleep(0.02)
    site = new_site_id()
    ops = _mint_ops(site, args.ops)
    assert cl.queue_ops(args.uuid, site, ops)
    deadline = time.monotonic() + 30.0
    drained = False
    while time.monotonic() < deadline:
        drained = cl.pump()["outbound_ops"] == 0
        if drained:
            break
        time.sleep(0.02)
    cl.close()
    mints = [e for e in obs.events()
             if e.get("ev") == "event" and e.get("name") == "xtrace.hop"
             and e["fields"].get("hop") == "mint"
             and e["fields"].get("client") == client_id]
    obs.flush()
    # accounted = admitted + dup-suppressed resends + watermark skips
    # (the lost-ack shapes a faulted wire legitimately produces);
    # under a healthy link it degenerates to acked == ops
    print(json.dumps({
        "trace": mints[0]["fields"]["trace"] if mints else None,
        "acked": cl.stats["acked_ops"],
        "accounted": (cl.stats["acked_ops"]
                      + cl.stats["dup_acked_ops"]
                      + cl.stats["resumed_skipped_ops"]),
        "reconnects": cl.stats["reconnects"],
    }), flush=True)
    return 0 if drained and mints else 1


# ----------------------------------------------------- parent process


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--obs-out", default=os.path.join(
        tempfile.gettempdir(), "obs_journey.jsonl"),
        help="server-process obs stream (the client stream lands "
             "beside it at <obs-out>.client)")
    ap.add_argument("--ops", type=int, default=6)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    ap.add_argument("--child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--uuid", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child_main(args)

    from .bench import card_name_power
    from .device import claim_device
    from .net import ReplicationServer
    from .obs.core import platform_of
    from .serve import IngestJournal, IngestQueue, SyncService

    dev = claim_device(args.cpu, "journey_smoke")
    card = card_name_power(dev)
    client_out = args.obs_out + ".client"
    for p in (args.obs_out, client_out):
        if os.path.exists(p):
            os.remove(p)
    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform(dev)
    sync.quarantine_reset()

    state_dir = args.obs_out + ".state"
    os.makedirs(state_dir, exist_ok=True)
    journal_path = os.path.join(state_dir, "ingest.jsonl")
    if os.path.exists(journal_path):
        os.remove(journal_path)
    q = IngestQueue(max_ops=4096, defer_frac=1.0,
                    journal=IngestJournal(journal_path))
    svc = SyncService(q, checkpoint_dir=os.path.join(state_dir, "ckpt"),
                      d_max=64)
    base = CausalList(c_list.weave(
        c.clist(weaver="torch").extend(["w"] * 12).ct))
    base.ct.lanes.segments()
    a = CausalList(base.ct.evolve(site_id=new_site_id())).conj("A")
    b = CausalList(base.ct.evolve(site_id=new_site_id())).conj("B")
    uuid = svc.add_tenant(a, b)
    srv = ReplicationServer(svc).start()
    print(f"journey smoke: serving tenant {uuid} on "
          f"127.0.0.1:{srv.port}; spawning client process", flush=True)

    child = subprocess.Popen(
        child_command(srv.port, uuid, args.ops, client_out),
        cwd=ROOT, stdout=subprocess.PIPE, stdin=subprocess.DEVNULL,
        text=True)
    try:
        deadline = time.monotonic() + 30.0
        while child.poll() is None and time.monotonic() < deadline:
            svc.tick()
            time.sleep(0.01)
        for _ in range(4):  # drain anything acked on the final pump
            svc.tick()
        out, _ = child.communicate(timeout=10.0)
    finally:
        if child.poll() is None:
            child.kill()
        srv.stop()
    assert child.returncode == 0, f"client process failed: {out!r}"
    handoff = json.loads(out.strip().splitlines()[-1])
    tr = handoff["trace"]
    assert tr and handoff["acked"] == args.ops, handoff
    obs.flush()

    # ---- gates: the merged per-process streams tell one story ------
    events = load_streams([args.obs_out, client_out])
    pids = {e.get("pid") for e in events if e.get("ev") == "event"}
    assert len(pids) == 2, f"expected two processes, saw pids {pids}"
    rep = journey_report(events)
    fold = JourneyFold(retain_all=True)
    fold.feed_many(events)
    j = fold.journey(tr)
    assert j is not None, f"trace {tr} absent from the merged streams"
    names = [h["hop"] for h in j["hops"]]
    for need in ("mint", "send", "recv", "admit", "journal", "tick",
                 "wave", "converged"):
        assert need in names, (need, names)
    assert names.index("mint") < names.index("send") \
        < names.index("recv") < names.index("admit") \
        < names.index("journal"), names
    assert all(h["dt_ms"] >= 0 for h in j["hops"]), j["hops"]
    assert len(j["pids"]) == 2, j["pids"]
    assert j["complete"] and j["orphans"] == 0, j
    assert rep["orphan_hops"] == 0, rep
    assert rep["clock"]["edges"], "no clock edge measured on connect"

    row = ledger.ingest_record(
        {
            "platform": platform_of(dev),
            "metric": "journey mint->converged total ms",
            "value": j["total_ms"],
            "kernel": "net",
            "config": f"ops={args.ops} processes=2 smoke=journey",
            "smoke": True,
        },
        source="journey-smoke two-process loopback",
        obs_jsonl=args.obs_out,
        kind="journey",
        extra={"journey": {
            "trace": tr,
            "processes": len(j["pids"]),
            "hops": len(j["hops"]),
            "orphan_hops": rep["orphan_hops"],
            "complete": rep["complete"],
            "clock_edges": len(rep["clock"]["edges"]),
            "total_ms": j["total_ms"],
        }, "card": card},
    )
    print(f"journey smoke: clean — trace {tr} spans {len(j['pids'])} "
          f"processes, {len(j['hops'])} hops in causal order, "
          f"0 orphans, {j['total_ms']:g} ms mint->converged; ledger "
          f"row ({row['platform']}) -> {ledger.default_path()}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
