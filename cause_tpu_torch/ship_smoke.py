"""Ship smoke of the port: fleet telemetry over a REAL process
boundary, under seeded chaos. A port of ``scripts/ship_smoke.py``.

    CAUSE_TPU_LEDGER=ledger.jsonl \\
      python -m cause_tpu_torch.ship_smoke --out /tmp/ship_smoke

Three genuinely separate interpreters on loopback: one collector
child runs a ``CollectorServer`` (WAL-backed); two producer children
each write their OWN obs sidecar, arm the seeded partition plan
(``measurements/ship_plan_r20.json`` of the checkout: first two dials
refused, a couple of frames dropped/duplicated on the wire), attach a
``ShipExporter``, and mint synthetic end-to-end journeys
(mint→send→recv→admit→journal→tick→wave→apply→converged). Producer 2
additionally runs a TINY ship buffer and floods filler events while
the link is still partitioned, forcing honest drop-oldest evidence.
The children are ``python -m cause_tpu_torch.ship_smoke --role
collector|producer``, started from the checkout's root.

The parent (obs OFF — the gates need no local stream) then asserts
the fleet-plane contract from the collector's feed ALONE:

- per-origin accounting is EXACT: ``accepted == acked − dropped`` and
  ``missed == dropped`` for each producer, with the evidenced drop
  count taken from the producer's own handoff;
- zero duplicate accepted records: each producer's collector slice is
  a sub-multiset of that producer's sidecar (wire dups and resends
  were all watermark-skipped);
- every journey reconstructs COMPLETE with ZERO orphan hops from the
  collector stream alone — no sidecar consulted — and at least one
  clock edge rode the ship hello;
- a ``--kind ship`` ledger row lands for ``ledger --check`` to vet.

Host work only: no process of it touches a weaver or the device, so
it runs with or without a card and takes no ``--cpu``; its row's
``platform`` is ``cpu`` (the host) and ``card`` null. Exit 0 clean;
any gate miss raises (exit 1).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import chaos, obs
from .journey_smoke import ROOT
from .obs import ledger

_PLAN = os.path.join(ROOT, "measurements", "ship_plan_r20.json")
_HOPS = ("send", "recv", "admit", "journal", "tick", "wave", "apply",
         "converged")


def _canon(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _role(role: str, *args) -> list:
    """The argv of a ``--role`` child, run from ``ROOT``."""
    return [sys.executable, "-m", "cause_tpu_torch.ship_smoke",
            "--role", role, *args]


# -------------------------------------------------------- collector


def collector_main(args) -> int:
    """The fleet half: its own interpreter, obs ON to its own sidecar
    (so the ship hello carries a clock stamp), a WAL archive dir.
    Prints the bound port, then serves until stdin says stop; dumps
    the accepted stream and a summary for the parent's gates."""
    from .obs.collector import CollectorServer

    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform("cpu")  # host work: its events never name the card
    srv = CollectorServer(dir=args.wal_dir, idle_timeout_s=10.0).start()
    print(json.dumps({"port": srv.port}), flush=True)
    sys.stdin.readline()  # parent says stop
    srv.stop()
    with open(args.dump, "w") as f:
        for rec in srv.records:
            f.write(_canon(rec) + "\n")
    obs.flush()
    print(json.dumps({"stats": srv.stats, "origins": srv.origins()}),
          flush=True)
    return 0


# --------------------------------------------------------- producers


def producer_main(args) -> int:
    """One host of the fleet: own sidecar, seeded chaos plan, one
    exporter. Mints ``--traces`` complete in-process journeys, then
    flushes to acked and hands the accounting back on stdout."""
    from .net import Backoff
    from .obs import ship, xtrace

    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform("cpu")  # host work: its events never name the card
    with open(_PLAN) as f:
        chaos.configure(plan=json.load(f), enabled=True)
    # start=False: the smoke owns the pump, so drop evidence and the
    # partition window are deterministic, not a thread race
    exp = ship.attach_exporter(
        "127.0.0.1", args.port, start=False,
        buffer_records=args.buffer, flush_s=0.02, heartbeat_s=30.0,
        connect_timeout_s=2.0, read_timeout_s=5.0,
        backoff=Backoff(base_ms=20, cap_ms=250, seed=os.getpid()))
    assert exp is not None, "obs is on; attach_exporter gated None"

    if args.filler:
        # flood while the plan still refuses the dial: the tiny
        # buffer drops OLDEST with evidence, journeys stay intact
        # because they are minted only after the link heals
        for i in range(args.filler):
            obs.event("smoke.filler", i=i)
        exp.pump()  # ingest + dial 1 (refused by the plan)
    deadline = time.monotonic() + 30.0
    while not exp.connected and time.monotonic() < deadline:
        exp.pump()
        time.sleep(0.02)
    assert exp.connected, "exporter never healed through the plan"
    # drain the filler backlog to acked BEFORE minting journeys: the
    # journey phase must fit the buffer even with a drop-fault resend
    # window in flight, or overflow eats evidenced-but-real hops
    assert exp.flush(timeout_s=30.0), "filler backlog never drained"

    traces = []
    for _ in range(args.traces):
        tr = xtrace.new_trace()
        xtrace.hop("mint", tr, parent="", smoke="ship")
        for name in _HOPS:
            xtrace.hop(name, tr)
        traces.append(tr)
        exp.pump()
    assert exp.flush(timeout_s=30.0), "unacked tail never drained"
    dropped = exp.total_dropped()
    exp.close()
    obs.flush()
    print(json.dumps({
        "pid": os.getpid(),
        "acked": exp.stats["acked_seq"],
        "dropped": dropped,
        "buffer_dropped": exp.stats["dropped_records"],
        "reconnects": exp.stats["reconnects"],
        "dial_failures": exp.stats["dial_failures"],
        "clock_samples": exp.stats["clock_samples"],
        "unshipped": exp.stats["unshipped"],
        "traces": traces,
    }), flush=True)
    return 0


# ------------------------------------------------------------ parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "ship_smoke"),
        help="scratch prefix (sidecars, WAL dir, dump)")
    ap.add_argument("--traces", type=int, default=8)
    ap.add_argument("--role", choices=("collector", "producer"),
                    default="", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--obs-out", default="", help=argparse.SUPPRESS)
    ap.add_argument("--wal-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--dump", default="", help=argparse.SUPPRESS)
    ap.add_argument("--buffer", type=int, default=65536,
                    help=argparse.SUPPRESS)
    ap.add_argument("--filler", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.role == "collector":
        return collector_main(args)
    if args.role == "producer":
        return producer_main(args)

    from .obs.journey import JourneyFold, journey_report

    out = os.path.abspath(args.out)
    if os.path.isdir(out + ".wal"):
        shutil.rmtree(out + ".wal")
    for p in (out + ".collector.jsonl", out + ".p1.jsonl",
              out + ".p2.jsonl", out + ".dump.jsonl"):
        if os.path.exists(p):
            os.remove(p)

    producers = []
    coll = subprocess.Popen(
        _role("collector", "--obs-out", out + ".collector.jsonl",
              "--wal-dir", out + ".wal", "--dump", out + ".dump.jsonl"),
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True)
    try:
        port = json.loads(coll.stdout.readline())["port"]
        print(f"ship smoke: collector on 127.0.0.1:{port}; spawning "
              f"2 producers under {os.path.basename(_PLAN)}",
              flush=True)
        producers = [
            subprocess.Popen(
                _role("producer", "--port", str(port),
                      "--traces", str(args.traces),
                      "--obs-out", out + f".p{i}.jsonl")
                + (["--buffer", "128", "--filler", "300"]
                   if i == 2 else []),
                cwd=ROOT, stdout=subprocess.PIPE,
                stdin=subprocess.DEVNULL, text=True)
            for i in (1, 2)]
        handoffs = []
        for i, p in enumerate(producers, 1):
            po, _ = p.communicate(timeout=90.0)
            assert p.returncode == 0, f"producer {i} failed: {po!r}"
            handoffs.append(json.loads(po.strip().splitlines()[-1]))
        coll.stdin.write("stop\n")
        coll.stdin.flush()
        co, _ = coll.communicate(timeout=30.0)
    finally:
        for p in producers:
            if p.poll() is None:
                p.kill()
                p.wait()
        if coll.poll() is None:
            coll.kill()
            coll.wait()
    assert coll.returncode == 0, f"collector failed: {co!r}"
    summary = json.loads(co.strip().splitlines()[-1])
    with open(out + ".dump.jsonl") as f:
        collected = [json.loads(ln) for ln in f if ln.strip()]

    # ---- gate 1: per-origin accounting is exact --------------------
    origins = {o["pid"]: o for o in summary["origins"]}
    for h in handoffs:
        o = origins.get(h["pid"])
        assert o is not None, f"producer {h['pid']} never registered"
        assert h["unshipped"] == 0, h
        # subscriber drops never enter seq space; the wire gap is the
        # BUFFER drops exactly — and this smoke keeps the subscriber
        # queue comfortably under its maxlen, so the two coincide
        assert h["dropped"] == h["buffer_dropped"], h
        assert o["watermark"] == h["acked"], (o, h)
        assert o["accepted"] == h["acked"] - h["dropped"], (o, h)
        assert o["missed"] == h["dropped"], (o, h)
    assert handoffs[1]["dropped"] > 0, \
        "producer 2 never overflowed: the drop-evidence path is untested"
    assert sum(h["reconnects"] + h["dial_failures"]
               for h in handoffs) > 0, "the partition plan never fired"

    # ---- gate 2: zero duplicate accepted records -------------------
    for i, h in enumerate(handoffs, 1):
        mine = [r for r in collected if r.get("pid") == h["pid"]]
        assert len(mine) == origins[h["pid"]]["accepted"], (i, len(mine))
        side = {}
        with open(out + f".p{i}.jsonl") as f:
            for ln in f:
                if ln.strip():
                    k = _canon(json.loads(ln))
                    side[k] = side.get(k, 0) + 1
        for r in mine:
            k = _canon(r)
            assert side.get(k, 0) > 0, \
                f"collector holds a record producer {i} never wrote: {k}"
            side[k] -= 1

    # ---- gate 3: journeys from the collector feed ALONE ------------
    rep = journey_report(collected)
    fold = JourneyFold(retain_all=True)
    fold.feed_many(collected)
    want = ("mint",) + _HOPS
    for h in handoffs:
        for tr in h["traces"]:
            j = fold.journey(tr)
            assert j is not None, f"trace {tr} absent from collector"
            names = [x["hop"] for x in j["hops"]]
            for need in want:
                assert need in names, (tr, need, names)
            assert j["complete"] and j["orphans"] == 0, j
    assert rep["orphan_hops"] == 0, rep
    assert rep["clock"]["edges"], "no clock edge rode the ship hello"
    assert summary["stats"]["dup_records"] > 0, \
        "chaos dup/resend traffic never reached the dedup path"

    n_tr = sum(len(h["traces"]) for h in handoffs)
    row = ledger.ingest_record(
        {
            "platform": "cpu",
            "metric": "ship smoke journeys complete",
            "value": n_tr,
            "kernel": "obs",
            "config": f"producers=2 traces={n_tr} smoke=ship",
            "smoke": True,
        },
        source="ship-smoke three-process loopback",
        kind="ship",
        extra={"ship": {
            "producers": len(handoffs),
            "accepted": summary["stats"]["accepted_records"],
            "missed": summary["stats"]["missed_records"],
            "dup_skipped": summary["stats"]["dup_records"],
            "evidenced_drops": sum(h["dropped"] for h in handoffs),
            "orphan_hops": rep["orphan_hops"],
            "clock_edges": len(rep["clock"]["edges"]),
        }, "card": None},
    )
    print(f"ship smoke: clean — {n_tr} journeys complete from the "
          f"collector feed alone, 0 orphans; "
          f"{summary['stats']['accepted_records']} accepted, "
          f"{summary['stats']['missed_records']} missed == "
          f"{sum(h['dropped'] for h in handoffs)} evidenced, "
          f"{summary['stats']['dup_records']} wire dups skipped; "
          f"ledger row ({row['platform']}) -> {ledger.default_path()}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
