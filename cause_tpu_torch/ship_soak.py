"""Ship soak of the port: the fleet telemetry plane, run end to end
under seeded chaos. A port of ``scripts/ship_soak.py``. Three phases,
one verdict:

    CAUSE_TPU_LEDGER=ledger.jsonl \\
      python -m cause_tpu_torch.ship_soak --out /tmp/ship_soak \\
        [--seed 20] [--rounds 10] [--traces 4] [--waves 120] [--cpu]

**Phase 1 — fleet plane under chaos.** A collector child (WAL
archive) plus three producer children on loopback, all armed with one
seeded plan exercising every ship fault mode (a refused first dial,
probabilistic frame drop/dup/reorder); producer 3 runs a tiny ship
buffer and floods filler while partitioned so drop-oldest evidence is
REAL. Gates — all from the collector side:

- the collector stream is the union of the per-host sidecars minus
  EXACTLY the evidenced drops: per origin, ``accepted == acked −
  dropped`` and ``missed == dropped``, with each origin's slice a
  sub-multiset of that producer's own sidecar (zero duplicate
  accepted records, ever — wire dups and resends all watermark-skip);
- every journey reconstructs COMPLETE with ZERO orphan hops from the
  collector feed ALONE, and clock edges rode the ship hellos;
- the WAL archive scrubs clean: every segment record CRC-decodes and
  the archived record count equals the accepted count exactly.

**Phase 2 — data-plane invariance under full telemetry partition.**
The same seeded serve workload runs twice: once with no exporter,
once with an exporter whose every dial the plan refuses (partition
prob 1.0) and a buffer too small for the run. The converged tenant
digest must be BIT-IDENTICAL — a fully partitioned telemetry plane
degrades telemetry (drops with evidence), never data.

**Phase 3 — exporter overhead.** One process measures its steady-
state wave wall twice back to back — baseline rounds with no
exporter, then shipped rounds with a live exporter draining to a real
collector. The median shipped wall must sit within 1% of baseline
(the hot path's only cost is one bounded-queue append).

The children are ``python -m cause_tpu_torch.ship_soak --role
collector|producer|dataplane``, started from the checkout's root. The
collector and the producers are host work and never touch the
device; the data plane (one tenant: mint → offer → tick to drained) is
the only child that claims it, on the card unless ``--cpu`` (which the
parent passes on) asks for the plain versions on the CPU. Without a
card and without ``--cpu`` the command exits 2 with one line.

A clean run lands a ``--kind ship`` row in the port's ledger (value =
exporter overhead %; extra = the full fleet-plane evidence); its
``platform`` is the data plane's device tag (``gpu`` or ``cpu``) and
``card`` the card's ``name, power.limit`` (null on the CPU). Exit 0
clean; any gate miss raises (exit 1).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import subprocess
import sys
import tempfile
import time

from . import chaos, obs
from .journey_smoke import ROOT
from .obs import ledger

_HOPS = ("send", "recv", "admit", "journal", "tick", "wave", "apply",
         "converged")


def _canon(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _soak_plan(seed: int) -> dict:
    """The committed fault schedule: first dial refused (backoff +
    resume-from-watermark exercised on every producer), then a steady
    probabilistic mix of every wire fault mode."""
    return {"seed": int(seed), "faults": [
        {"family": "ship", "mode": "partition", "site": "obs.ship",
         "at": [1]},
        {"family": "ship", "mode": "drop", "site": "obs.ship",
         "prob": 0.08},
        {"family": "ship", "mode": "dup", "site": "obs.ship",
         "prob": 0.08},
        {"family": "ship", "mode": "reorder", "site": "obs.ship",
         "prob": 0.08},
    ]}


# -------------------------------------------------------- collector


def collector_main(args) -> int:
    """Same contract as ship_smoke's collector child, with a WAL
    archive dir the parent scrubs after the run."""
    from .obs.collector import CollectorServer

    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform("cpu")  # host work: its events never name the card
    srv = CollectorServer(dir=args.wal_dir, idle_timeout_s=15.0).start()
    print(json.dumps({"port": srv.port}), flush=True)
    sys.stdin.readline()
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
    """One fleet host: sidecar, seeded plan, one exporter, ``--rounds``
    rounds each minting ``--traces`` complete journeys plus serve/net
    gauge traffic. The pump is driven manually so the drop-evidence
    staging (filler flood while partitioned, journeys only after the
    backlog is acked) is deterministic, exactly like ship_smoke."""
    from .net import Backoff
    from .obs import core, ship, xtrace

    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform("cpu")  # host work: its events never name the card
    with open(args.plan) as f:
        chaos.configure(plan=json.load(f), enabled=True)
    exp = ship.attach_exporter(
        "127.0.0.1", args.port, start=False,
        buffer_records=args.buffer, flush_s=0.02, heartbeat_s=30.0,
        read_timeout_s=5.0,
        backoff=Backoff(base_ms=20, cap_ms=250, seed=os.getpid()))
    assert exp is not None, "obs is on; attach_exporter gated None"

    if args.filler:
        for i in range(args.filler):
            obs.event("soak.filler", i=i)
        exp.pump()  # ingest + dial 1 (refused by the plan)
    deadline = time.monotonic() + 60.0
    while not exp.connected and time.monotonic() < deadline:
        exp.pump()
        time.sleep(0.02)
    assert exp.connected, "exporter never healed through the plan"
    assert exp.flush(timeout_s=60.0), "filler backlog never drained"

    rng = random.Random(args.seed ^ os.getpid())
    traces = []
    for r in range(args.rounds):
        for _ in range(args.traces):
            tr = xtrace.new_trace()
            xtrace.hop("mint", tr, parent="", soak="ship")
            for name in _HOPS:
                xtrace.hop(name, tr)
            traces.append(tr)
        core.gauge("serve.soak_depth").set(rng.randrange(64))
        core.gauge("net.soak_outbound").set(rng.randrange(64))
        exp.pump()
        time.sleep(0.005)
        # every round must end acked: the plan's drop/reorder faults
        # leave resend windows in flight, and the journey records must
        # never meet a full buffer (drop evidence is the FILLER's job)
        assert exp.flush(timeout_s=60.0), f"round {r} never drained"
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
        "injected": len(chaos.injected()),
        "traces": traces,
    }), flush=True)
    return 0


# -------------------------------------------------------- data plane


def _mk_tenant(seed: int):
    import cause_tpu_torch as c
    from .collections import clist as c_list
    from .collections.clist import CausalList

    # every site id pinned from the seed: the bit-identity gate
    # compares digests ACROSS processes, so nothing random (site ids
    # ride inside node ids) may leak into the document
    base = CausalList(c.clist(weaver="torch").ct.evolve(
        site_id="S%012d" % seed))
    fresh = base.extend(["w%d" % j for j in range(24)])
    fresh = CausalList(c_list.weave(fresh.ct))
    fresh.ct.lanes.segments()
    a = CausalList(fresh.ct.evolve(site_id="A%012d" % seed)).conj("A")
    b = CausalList(fresh.ct.evolve(site_id="B%012d" % seed)).conj("B")
    return a, b


def dataplane_main(args) -> int:
    """One seeded serve workload (single tenant, closed loop): mint →
    offer → tick to drained, one wall per round. ``--ship-mode``
    selects the telemetry condition; the DATA path is identical in
    all of them — that is the point. The only child that claims the
    device."""
    from . import serde, sync
    from .device import claim_device
    from .net import Backoff
    from .obs import ship
    from .serve import IngestJournal, IngestQueue, SyncService

    dev = claim_device(args.cpu, "ship_soak")
    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform(dev)

    exp = None
    if args.ship_mode == "partitioned":
        # every dial refused: the uplink NEVER comes up; the tiny
        # buffer guarantees honest drop evidence while the data plane
        # runs to the bit-identical digest
        chaos.configure(plan={"seed": args.seed, "faults": [
            {"family": "ship", "mode": "partition",
             "site": "obs.ship", "prob": 1.0}]}, enabled=True)
        exp = ship.attach_exporter(
            "127.0.0.1", args.port or 9, buffer_records=128,
            flush_s=0.02, connect_timeout_s=0.2,
            backoff=Backoff(base_ms=20, cap_ms=100, seed=1))

    state = args.obs_out + ".state"
    if os.path.isdir(state):
        shutil.rmtree(state)
    os.makedirs(state)
    q = IngestQueue(max_ops=4096,
                    journal=IngestJournal(
                        os.path.join(state, "ingest.jsonl")))
    svc = SyncService(q, checkpoint_dir=os.path.join(state, "ckpt"),
                      d_max=64)
    a, b = _mk_tenant(args.seed)
    uuid = svc.add_tenant(a, b)
    sites = []
    for h in (a, b):
        site = str(h.ct.site_id)
        yarn = h.ct.yarns[site]
        sites.append({"site": site, "last": yarn[-1][0],
                      "ts": int(yarn[-1][0][0])})
    rng = random.Random(args.seed)

    def _round(r):
        t0 = time.perf_counter()
        for st in sites:
            items = {}
            for i in range(rng.randrange(1, 4)):
                st["ts"] += 1
                nid = (st["ts"], st["site"], 0)
                items[nid] = (st["last"], f"r{r}.{i}")
                st["last"] = nid
            enc = serde.encode_node_items(items)
            adm = q.offer(uuid, st["site"], enc,
                          crc=sync.payload_checksum(enc))
            assert adm.admitted, adm
        for _ in range(200):
            if not (q.depth or q.deferred):
                break
            svc.tick()
        return time.perf_counter() - t0

    for r in range(8):       # warm: first waves, kernel loads
        _round(-1 - r)
    walls_base, walls_ship = [], []
    pairs = []
    if args.ship_mode == "overhead":
        # PAIRED alternation, order swapped each pair: the document
        # grows every round, so a sequential base-then-ship design
        # measures doc growth, not the exporter. Interleaving samples
        # both flavors along the SAME size trajectory; the half-round
        # growth bias alternates sign and cancels in the medians. The
        # shipped tail is flushed (untimed) before each base round so
        # pump CPU never leaks across flavors.
        from .obs import core as obs_core
        # flush_s parks the pump thread: every frame ships in the
        # UNTIMED flush between rounds, so the timed delta is the
        # exporter's actual hot-path cost (the bounded-subscriber
        # enqueue) — a concurrent pump plus the collector process
        # would bill their CPU share to the wave wall, which is a
        # property of the host, not the design (the fleet deployment
        # drains on other cores)
        exp = ship.attach_exporter("127.0.0.1", args.port,
                                   flush_s=30.0, heartbeat_s=30.0)
        assert exp is not None
        r = 0
        for k in range(args.waves):
            got = {}
            for flavor in (("ship", "base") if k % 2 == 0
                           else ("base", "ship")):
                if flavor == "ship":
                    if exp.sub.closed:
                        exp.sub = obs_core.subscribe()
                    got["ship"] = _round(r)
                    assert exp.flush(timeout_s=30.0)
                    obs_core.unsubscribe(exp.sub)
                else:
                    got["base"] = _round(r)
                r += 1
            walls_base.append(got["base"])
            walls_ship.append(got["ship"])
            pairs.append(got)
        assert exp.stats["acked_seq"] > 0, \
            "overhead rounds never actually shipped"
    else:
        walls_base = [_round(r) for r in range(args.waves)]
    digest = svc.converged_digest(uuid)
    handoff = {
        "digest": digest,
        "admitted": q.stats["admitted_ops"],
        "median_base_ms": round(
            1000.0 * sorted(walls_base)[len(walls_base) // 2], 4),
        "median_ship_ms": round(
            1000.0 * sorted(walls_ship)[len(walls_ship) // 2], 4)
        if walls_ship else None,
        # the gate statistic: median of per-PAIR relative deltas.
        # Pooled medians compare two independent order statistics and
        # inherit the full run-to-run spread; a pair's rounds are
        # adjacent in time and document size, so the delta cancels
        # growth and drift, and the median rejects the occasional
        # scheduler-stall outlier pair.
        "overhead_pct_median": round(sorted(
            100.0 * (p["ship"] - p["base"]) / p["base"]
            for p in pairs)[len(pairs) // 2], 4)
        if walls_ship else None,
        "dropped": exp.total_dropped() if exp is not None else 0,
        "connects": exp.stats["connects"] if exp is not None else 0,
    }
    if exp is not None:
        exp.close()
    svc.close()
    obs.flush()
    print(json.dumps(handoff), flush=True)
    return 0


# ------------------------------------------------------------ parent


def _spawn(role, cpu=False, **kw):
    """A ``--role`` child started from ``ROOT``; a data plane gets the
    parent's ``--cpu``."""
    argv = [sys.executable, "-m", "cause_tpu_torch.ship_soak",
            "--role", role]
    for k, v in kw.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    if cpu and role == "dataplane":
        argv.append("--cpu")
    return subprocess.Popen(
        argv, cwd=ROOT, stdout=subprocess.PIPE,
        stdin=subprocess.PIPE if role == "collector"
        else subprocess.DEVNULL,
        text=True)


def _reap(*procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def _fleet_phase(args, out) -> dict:
    from .obs.journey import JourneyFold, journey_report
    from .serve import wal as wal_mod

    plan_path = out + ".plan.json"
    with open(plan_path, "w") as f:
        json.dump(_soak_plan(args.seed), f)
    producers = []
    coll = _spawn("collector", obs_out=out + ".collector.jsonl",
                  wal_dir=out + ".wal", dump=out + ".dump.jsonl")
    try:
        port = json.loads(coll.stdout.readline())["port"]
        print(f"ship soak: collector on 127.0.0.1:{port}; 3 producers "
              f"x {args.rounds} rounds under seed {args.seed}",
              flush=True)
        for i in (1, 2, 3):
            kw = dict(port=port, plan=plan_path, seed=args.seed + i,
                      rounds=args.rounds, traces=args.traces,
                      obs_out=out + f".p{i}.jsonl")
            if i == 3:
                kw.update(buffer=128, filler=400)
            producers.append(_spawn("producer", **kw))
        handoffs = []
        for i, p in enumerate(producers, 1):
            po, _ = p.communicate(timeout=300.0)
            assert p.returncode == 0, f"producer {i} failed: {po!r}"
            handoffs.append(json.loads(po.strip().splitlines()[-1]))
        coll.stdin.write("stop\n")
        coll.stdin.flush()
        co, _ = coll.communicate(timeout=60.0)
    finally:
        _reap(*producers, coll)
    assert coll.returncode == 0, f"collector failed: {co!r}"
    summary = json.loads(co.strip().splitlines()[-1])
    with open(out + ".dump.jsonl") as f:
        collected = [json.loads(ln) for ln in f if ln.strip()]

    # gate: per-origin accounting exact — the collector stream IS the
    # union of the sidecars minus exactly the evidenced drops
    origins = {o["pid"]: o for o in summary["origins"]}
    for h in handoffs:
        o = origins.get(h["pid"])
        assert o is not None, f"producer {h['pid']} never registered"
        assert h["unshipped"] == 0, h
        assert h["dropped"] == h["buffer_dropped"], h
        assert o["watermark"] == h["acked"], (o, h)
        assert o["accepted"] == h["acked"] - h["dropped"], (o, h)
        assert o["missed"] == h["dropped"], (o, h)
    assert handoffs[2]["dropped"] > 0, \
        "producer 3 never overflowed: drop evidence untested"
    assert sum(h["injected"] for h in handoffs) > 0, \
        "the seeded plan never fired"

    # gate: zero duplicate accepted records (sub-multiset per origin)
    for i, h in enumerate(handoffs, 1):
        mine = [r for r in collected if r.get("pid") == h["pid"]]
        assert len(mine) == origins[h["pid"]]["accepted"], \
            (i, len(mine), origins[h["pid"]]["accepted"])
        side = {}
        with open(out + f".p{i}.jsonl") as f:
            for ln in f:
                if ln.strip():
                    k = _canon(json.loads(ln))
                    side[k] = side.get(k, 0) + 1
        for r in mine:
            k = _canon(r)
            assert side.get(k, 0) > 0, \
                f"record at collector that producer {i} never wrote"
            side[k] -= 1

    # gate: journeys from the collector feed ALONE
    rep = journey_report(collected)
    fold = JourneyFold(retain_all=True)
    fold.feed_many(collected)
    n_tr = 0
    for h in handoffs:
        for tr in h["traces"]:
            j = fold.journey(tr)
            assert j is not None, f"trace {tr} absent from collector"
            assert j["complete"] and j["orphans"] == 0, j
            n_tr += 1
    assert rep["orphan_hops"] == 0, rep
    assert rep["clock"]["edges"], "no clock edge rode the hellos"

    # gate: the WAL archive scrubs clean and holds the accepted
    # stream exactly (CRC walk over every segment)
    archived = 0
    for _no, name in wal_mod.list_segments(out + ".wal"):
        for kind, rec in wal_mod.scan_segment_file(
                os.path.join(out + ".wal", name)):
            assert kind == "rec", (name, kind, rec)
            archived += len(rec["items"])
    assert archived == summary["stats"]["accepted_records"], \
        (archived, summary["stats"]["accepted_records"])

    print(f"ship soak: fleet phase clean — {n_tr} journeys, "
          f"{summary['stats']['accepted_records']} accepted == "
          f"archived, {summary['stats']['missed_records']} missed == "
          f"{sum(h['dropped'] for h in handoffs)} evidenced, "
          f"{summary['stats']['dup_records']} wire dups skipped, "
          f"{sum(h['injected'] for h in handoffs)} faults injected",
          flush=True)
    return {"summary": summary, "handoffs": handoffs,
            "journeys": n_tr, "clock_edges": len(rep["clock"]["edges"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "ship_soak"))
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--traces", type=int, default=4)
    ap.add_argument("--waves", type=int, default=120,
                    help="data-plane rounds per condition")
    ap.add_argument("--cpu", action="store_true",
                    help="run the data plane's plain versions on the CPU")
    ap.add_argument("--role",
                    choices=("collector", "producer", "dataplane"),
                    default="", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--obs-out", default="", help=argparse.SUPPRESS)
    ap.add_argument("--wal-dir", default="", help=argparse.SUPPRESS)
    ap.add_argument("--dump", default="", help=argparse.SUPPRESS)
    ap.add_argument("--plan", default="", help=argparse.SUPPRESS)
    ap.add_argument("--buffer", type=int, default=65536,
                    help=argparse.SUPPRESS)
    ap.add_argument("--filler", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--ship-mode", default="off",
                    choices=("off", "partitioned", "overhead"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.role == "collector":
        return collector_main(args)
    if args.role == "producer":
        return producer_main(args)
    if args.role == "dataplane":
        return dataplane_main(args)

    from .bench import card_name_power
    from .device import claim_device
    from .obs.core import platform_of

    # the data plane's device, checked before any child starts; this
    # process itself runs no device work
    dev = claim_device(args.cpu, "ship_soak")
    card = card_name_power(dev)
    out = os.path.abspath(args.out)
    if os.path.isdir(out + ".wal"):
        shutil.rmtree(out + ".wal")
    for p in (out + ".dump.jsonl",):
        if os.path.exists(p):
            os.remove(p)

    fleet = _fleet_phase(args, out)

    # ---- phase 2: data plane bit-identical, telemetry partitioned --
    runs = {}
    for mode in ("off", "partitioned"):
        p = _spawn("dataplane", args.cpu, seed=args.seed,
                   waves=args.waves, ship_mode=mode,
                   obs_out=out + f".dp.{mode}.jsonl")
        try:
            po, _ = p.communicate(timeout=600.0)
        finally:
            _reap(p)
        assert p.returncode == 0, f"dataplane {mode} failed: {po!r}"
        runs[mode] = json.loads(po.strip().splitlines()[-1])
    assert runs["off"]["digest"] == runs["partitioned"]["digest"], \
        (runs["off"]["digest"], runs["partitioned"]["digest"])
    assert runs["off"]["admitted"] == runs["partitioned"]["admitted"]
    assert runs["partitioned"]["connects"] == 0, runs["partitioned"]
    assert runs["partitioned"]["dropped"] > 0, runs["partitioned"]
    print(f"ship soak: data plane bit-identical under full telemetry "
          f"partition — digest {runs['off']['digest']}, "
          f"{runs['partitioned']['dropped']} records dropped with "
          f"evidence, 0 connects", flush=True)

    # ---- phase 3: exporter overhead on the steady-state wave wall --
    p = None
    coll = _spawn("collector", obs_out=out + ".oh.collector.jsonl",
                  wal_dir=out + ".oh.wal", dump=out + ".oh.dump.jsonl")
    try:
        port = json.loads(coll.stdout.readline())["port"]
        p = _spawn("dataplane", args.cpu, seed=args.seed,
                   waves=args.waves, ship_mode="overhead", port=port,
                   obs_out=out + ".dp.overhead.jsonl")
        po, _ = p.communicate(timeout=600.0)
        coll.stdin.write("stop\n")
        coll.stdin.flush()
        coll.communicate(timeout=60.0)
    finally:
        _reap(p, coll)
    assert p.returncode == 0, f"dataplane overhead failed: {po!r}"
    oh = json.loads(po.strip().splitlines()[-1])
    base, ship_ms = oh["median_base_ms"], oh["median_ship_ms"]
    overhead_pct = oh["overhead_pct_median"]
    assert overhead_pct < 1.0, \
        f"exporter overhead {overhead_pct:.3f}% >= 1% " \
        f"(per-pair median; pooled base {base} ms, " \
        f"shipped {ship_ms} ms)"
    print(f"ship soak: exporter overhead {overhead_pct:+.3f}% of the "
          f"steady-state wave wall (per-pair median; pooled base "
          f"{base} ms, shipped {ship_ms} ms)", flush=True)

    row = ledger.ingest_record(
        {
            "platform": platform_of(dev),
            "metric": "ship exporter overhead pct of wave wall",
            "value": round(overhead_pct, 4),
            "kernel": "obs",
            "config": f"seed={args.seed} rounds={args.rounds} "
                      f"waves={args.waves} soak=ship",
            "smoke": False,
        },
        source="ship-soak seeded chaos fleet",
        kind="ship",
        extra={"ship": {
            "producers": len(fleet["handoffs"]),
            "journeys": fleet["journeys"],
            "accepted": fleet["summary"]["stats"]["accepted_records"],
            "missed": fleet["summary"]["stats"]["missed_records"],
            "dup_skipped": fleet["summary"]["stats"]["dup_records"],
            "evidenced_drops": sum(h["dropped"]
                                   for h in fleet["handoffs"]),
            "faults_injected": sum(h["injected"]
                                   for h in fleet["handoffs"]),
            "clock_edges": fleet["clock_edges"],
            "dataplane_digest": runs["off"]["digest"],
            "overhead_pct": round(overhead_pct, 4),
            "median_base_ms": base,
            "median_ship_ms": ship_ms,
        }, "card": card},
    )
    print(f"ship soak: clean — ledger row ({row['platform']}) -> "
          f"{ledger.default_path()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
