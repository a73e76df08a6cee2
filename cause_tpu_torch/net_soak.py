"""Wire-level chaos soak for the port's network transport: N loopback
client endpoints replicate into a ``SyncService`` through real sockets
(``cause_tpu_torch.net``) under a seeded fault plan — partitions
(refused dials), connection resets, injected latency, blackholed
frames, wire-duplicated frames, payload reordering, and a mid-soak
SERVER crash restored from checkpoint + journal — and the run gates
the transport's contracts machine-to-machine. A port of
``scripts/net_soak.py``.

    python -m cause_tpu_torch.net_soak --obs-out net.jsonl \\
        [--clients 4] [--doc 20] [--seconds 8] [--mint-every 0.12] \\
        [--max-ops 256] [--d-max 32] [--seed 13] \\
        [--chaos measurements/net_plan_r13.json] [--frame-bench 200] \\
        [--proc-clients 0] [--proc-ops 6] [--state-dir DIR] [--cpu]

Runs on the card unless ``--cpu`` asks for the plain versions on the
CPU: without a card and without ``--cpu`` it exits 2 with one line
naming ``net_soak`` and the missing device (a client driver's failure
also exits 2, printing ``CLIENT DRIVER FAILED``). The gates:

- **bit-identical reconvergence, zero admitted ops lost** (exit 4) —
  after the final drain every tenant's materialized document must
  equal the fault-free single-process oracle (the tenant's pure pair
  merge + a pure replay of the whole write-ahead journal, computed
  with chaos suspended and obs off), every client must have drained
  its outbound queue completely (all minted ops acked, zero client
  sheds), and every minted op id must be present in the converged
  document;
- **every injected fault detected** (exit 5) — wire-duplicate frames
  EXACTLY equal the server's ``dup_frames`` evidence, payload mangles
  land ``sync.reject`` NACKs, resets/blackholes force reconnects,
  partition injections appear as failed dials, and the armed crash
  fires exactly once and restores;
- **evidence is exact** — the committed sidecar's ``net.*`` events
  must agree with the endpoints' own stats (reconnects, NACKs);
- **journeys across processes** (exit 6, with ``--proc-clients``) —
  every child interpreter's trace reconstructs complete, with zero
  orphan hops, across pids in the merged per-process streams.

A clean run lands a ``--kind net`` row in the port's ledger (value =
mean partition MTTR ms; extra = reconnect count, duplicates
suppressed, NACK/backoff histograms, per-frame round-trip overhead,
crash MTTR). Its ``platform`` is the device's tag (``gpu`` or ``cpu``)
and ``card`` the card's ``name, power.limit`` (null on the CPU).

Clients are one thread each (the NetClient contract), minting 1-3 op
batches on their own site at a seeded cadence and pumping the session;
the server tick loop runs in the main thread, on the device. The chaos
plan arms AFTER the warm/checkpoint phase so fault schedules are
stable against warm-up variance; the plan's ``crash`` spec (site
``serve.tick``) fires on the Nth tick and the harness drops the WHOLE
server process-equivalent — replication server, service object, queue
— and restores from checkpoint + journal on the same port, exactly
what the clients' reconnect/backoff + watermark resume exists to heal.
``--proc-clients`` children are ``journey_smoke``'s host-only client
half (``python -m cause_tpu_torch.journey_smoke --child``, started from
the checkout's root).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import threading
import time

import cause_tpu_torch as c
from . import chaos, obs, serde, sync
from .collections import clist as c_list
from .collections.clist import CausalList
from .ids import new_site_id
from .journey_smoke import ROOT, child_command
from .net import Backoff, NetClient, ReplicationServer, transport
from .serve import IngestJournal, IngestQueue, ResidencyManager, \
    ServiceCrashed, SyncService

EXIT_CONVERGENCE = 4
EXIT_UNDETECTED = 5
EXIT_JOURNEY = 6


class ClientDriver(threading.Thread):
    """One producer endpoint: mints chained op batches on its own
    site at a seeded cadence, queues them into its NetClient and
    pumps the session. Everything network-shaped degrades inside the
    client; this thread only ever sees queued-or-acked."""

    def __init__(self, idx, port, uuid, seed, mint_every_s,
                 stop_evt):
        super().__init__(name=f"net-soak-c{idx}", daemon=True)
        self.idx = idx
        self.uuid = uuid
        self.site = new_site_id()
        self.rng = random.Random(seed * 7919 + idx)
        self.mint_every_s = mint_every_s
        self.stop_evt = stop_evt
        self.minted = 0
        self.minted_ids = []
        self._last = c.root_id
        self._ts = 10_000 + idx * 1_000_000
        self.errors = []
        self.client = NetClient(
            "127.0.0.1", port, [uuid], client_id=f"c{idx}",
            read_timeout_s=1.0, heartbeat_s=0.5,
            connect_timeout_s=0.5, site=f"net.c{idx}",
            backoff=Backoff(base_ms=20, cap_ms=500, seed=seed + idx))

    def _mint_batch(self):
        n = self.rng.randrange(1, 4)
        out = []
        for _ in range(n):
            self._ts += 1
            nid = (self._ts, self.site, 0)
            out.append((nid, self._last, f"c{self.idx}.{self._ts}"))
            self.minted_ids.append(nid)
            self._last = nid
        self.minted += n
        return out

    def run(self):
        try:
            while not self.stop_evt.is_set():
                if not self.client.queue_ops(self.uuid, self.site,
                                             self._mint_batch()):
                    self.errors.append("client shed minted ops "
                                       "(outbound bound too small)")
                    return
                self.client.pump()
                self.stop_evt.wait(self.mint_every_s)
        except Exception as e:  # noqa: BLE001 - surfaced in main
            self.errors.append(f"{type(e).__name__}: {e}")


def _mk_tenants(svc, n, doc):
    """``n`` DISTINCT documents (a fresh clist per tenant — evolve()
    keeps the doc uuid, and tenants are keyed by it), each a (left,
    right) replica pair at one shared doc size (one compile
    bucket)."""
    uuids, pairs = [], {}
    for i in range(n):
        base = CausalList(c_list.weave(
            c.clist(weaver="torch").extend(
                [f"w{i}.{j}" for j in range(doc)]).ct))
        base.ct.lanes.segments()
        a = CausalList(base.ct.evolve(site_id=new_site_id())).conj(
            f"A{i}")
        b = CausalList(base.ct.evolve(site_id=new_site_id())).conj(
            f"B{i}")
        uuid = svc.add_tenant(a, b)
        uuids.append(uuid)
        pairs[uuid] = (a, b)
    return uuids, pairs


def _pure(h):
    return CausalList(h.ct.evolve(weaver="pure", lanes=None))


def _journal_oracle(pairs_init, journal_path):
    """The fault-free single-process oracle (serve_soak's shape): the
    tenant's pure pair merge + a pure replay of the whole write-ahead
    journal (read back through IngestJournal itself — ONE torn-line/
    format authority, not a reimplementation), chaos suspended + obs
    off."""
    out = {u: _pure(a).merge(_pure(b))
           for u, (a, b) in pairs_init.items()}
    jr = IngestJournal(journal_path)
    entries = sorted(jr.iter_from(0), key=lambda e: int(e["seq"]))
    jr.close()
    for e in entries:
        uuid = str(e.get("uuid"))
        if uuid not in out:
            continue
        sync.validate_node_items(e["items"])
        out[uuid] = sync.apply_delta(
            out[uuid], serde.decode_node_items(e["items"]),
            _count_as_delta=False)
    return out, len(entries)


def _doc_equal(dev_handle, pure_handle) -> bool:
    return (c.causal_to_edn(dev_handle) == c.causal_to_edn(pure_handle)
            and dict(dev_handle.ct.nodes) == dict(pure_handle.ct.nodes)
            and [n[0] for n in dev_handle.get_weave()]
            == [n[0] for n in pure_handle.get_weave()])


def _frame_bench(port, uuid, n_frames):
    """Per-frame overhead on the healthy loopback link: mean/max
    round-trip of a 1-op delta frame (send → validate → watermark →
    offer → journal → ack). Real admitted ops — they ride into the
    oracle like any other."""
    site = new_site_id()
    fs = transport.dial("127.0.0.1", port, site="net.bench")
    transport.send_msg(fs, {"op": "hello", "client": "bench",
                            "uuids": [uuid]})
    transport.recv_msg(fs, timeout_s=5.0)
    last = c.root_id
    walls = []
    for i in range(n_frames):
        nid = (1_000_000 + i, site, 0)
        enc = serde.encode_node_items({nid: (last, f"b{i}")})
        last = nid
        t0 = time.perf_counter()
        transport.send_msg(fs, {"op": "delta", "seq": i + 1,
                                "uuid": uuid, "site": site,
                                "nodes": enc,
                                "crc": sync.payload_checksum(enc)})
        r = transport.recv_msg(fs, timeout_s=5.0)
        walls.append((time.perf_counter() - t0) * 1000.0)
        assert r.get("op") == "ack", r
    transport.send_msg(fs, {"op": "bye"})
    fs.close()
    walls.sort()
    return {"frames": n_frames,
            "mean_ms": round(sum(walls) / len(walls), 4),
            "p50_ms": round(walls[len(walls) // 2], 4),
            "max_ms": round(walls[-1], 4)}


def _restart(svc, srv, ckpt_dir, journal_path, max_ops, d_max,
             capacity, port):
    """The server crash protocol: drop the whole serve-side object
    graph (replication server, service, queue) and restore from the
    last checkpoint + write-ahead journal, re-listening on the SAME
    port — the clients' reconnect ladder does the rest."""
    srv.stop()
    svc.close()
    svc.queue.close_admission()
    if svc.queue.journal is not None:
        svc.queue.journal.close()
    del svc
    queue = IngestQueue(max_ops=max_ops, defer_frac=1.0,
                        journal=IngestJournal(journal_path))
    svc2 = SyncService.restore(
        ckpt_dir, queue=queue,
        residency=ResidencyManager(capacity=capacity), d_max=d_max)
    srv2 = ReplicationServer(svc2, port=port).start()
    return svc2, srv2


def main(argv=None) -> int:
    from .bench import card_name_power
    from .device import claim_device
    from .obs import ledger
    from .obs.core import platform_of
    from .obs.journey import JourneyFold
    from .obs.perfetto import load_jsonl, load_streams

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--clients", type=int, default=4,
                    help="client endpoints (= tenants, one each)")
    ap.add_argument("--doc", type=int, default=20)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--mint-every", type=float, default=0.12)
    ap.add_argument("--max-ops", type=int, default=256)
    ap.add_argument("--d-max", type=int, default=32)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--tick-every", type=float, default=0.03)
    ap.add_argument("--chaos", default=None,
                    help="seeded fault plan JSON (path or inline); "
                         "armed AFTER the warm/checkpoint phase")
    ap.add_argument("--frame-bench", type=int, default=200,
                    help="per-frame overhead bench frames on the "
                         "healthy link (0 disables)")
    ap.add_argument("--obs-out", required=True)
    ap.add_argument("--proc-clients", type=int, default=0,
                    help="additional client endpoints as REAL child "
                         "interpreters (one tenant each), each "
                         "writing its own obs stream to "
                         "<obs-out>.pK — the per-process evidence "
                         "`obs journey` merges; a clean run gates "
                         "every child trace reconstructing complete "
                         "(zero orphan hops) across pids (exit 6)")
    ap.add_argument("--proc-ops", type=int, default=6,
                    help="ops each --proc-clients child mints")
    ap.add_argument("--state-dir", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = claim_device(args.cpu, "net_soak")
    card = card_name_power(dev)

    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform(dev)
    sync.quarantine_reset()
    chaos.reset()

    state_dir = args.state_dir or (args.obs_out + ".state")
    ckpt_dir = os.path.join(state_dir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    journal_path = os.path.join(state_dir, "ingest.jsonl")
    if os.path.exists(journal_path):
        os.unlink(journal_path)

    capacity = args.clients + args.proc_clients
    queue = IngestQueue(max_ops=args.max_ops, defer_frac=1.0,
                        journal=IngestJournal(journal_path))
    svc = SyncService(queue,
                      residency=ResidencyManager(capacity=capacity),
                      checkpoint_dir=ckpt_dir, d_max=args.d_max)
    uuids, pairs_init = _mk_tenants(svc, args.clients, args.doc)
    proc_uuids = []
    if args.proc_clients:
        # out-of-process endpoints get tenants of their own: their
        # ops ride the SAME oracle/digest gates (appended to uuids),
        # their traces the journey gate below
        proc_uuids, proc_pairs = _mk_tenants(svc, args.proc_clients,
                                             args.doc)
        uuids = uuids + proc_uuids
        pairs_init.update(proc_pairs)
    srv = ReplicationServer(svc).start()
    port = srv.port
    print(f"net soak: {args.clients} client(s)/tenant(s) on "
          f"127.0.0.1:{port}, max_ops {args.max_ops}", flush=True)

    # ---- warm + per-frame overhead on the healthy link -------------
    frame_rt = None
    if args.frame_bench:
        frame_rt = _frame_bench(port, uuids[0], args.frame_bench)
        for _ in range(200):
            if not queue.depth:
                break
            svc.tick()
        print(f"net soak: per-frame round-trip mean "
              f"{frame_rt['mean_ms']} ms (p50 {frame_rt['p50_ms']}, "
              f"max {frame_rt['max_ms']}) over "
              f"{frame_rt['frames']} frames", flush=True)
    svc.checkpoint()  # the durable baseline every crash restores past

    # ---- arm the plan, start the fleet -----------------------------
    plan = None
    if args.chaos:
        raw = args.chaos.strip()
        if raw.startswith("{"):
            plan = json.loads(raw)
        else:
            with open(raw) as f:
                plan = json.load(f)
        chaos.configure(plan=plan)
        print(f"net soak: chaos armed — {len(plan['faults'])} "
              f"fault spec(s), seed {plan.get('seed')}", flush=True)
    stop_evt = threading.Event()
    drivers = [ClientDriver(i, port, uuids[i], args.seed,
                            args.mint_every, stop_evt)
               for i in range(args.clients)]
    for d in drivers:
        d.start()

    # ---- genuinely separate processes: the per-host evidence shape.
    # Each child interpreter (journey_smoke's --child half) dials in
    # over loopback, mints ONE traced batch on its own tenant, pumps
    # until its outbound drains (reconnect ladder included — chaos is
    # armed), writes its OWN obs stream, and hands its trace id back
    # on stdout for the journey gate.
    proc_streams = [f"{args.obs_out}.p{k + 1}"
                    for k in range(args.proc_clients)]
    for p in proc_streams:
        if os.path.exists(p):
            os.unlink(p)
    procs = [subprocess.Popen(
        child_command(port, proc_uuids[k], args.proc_ops,
                      proc_streams[k]),
        cwd=ROOT, stdout=subprocess.PIPE, stdin=subprocess.DEVNULL,
        text=True)
        for k in range(args.proc_clients)]

    # ---- the timed run (main thread = the serve tick loop) ---------
    retired_server_stats = []
    crashes = 0
    crash_mttr_ms = []
    state = {"svc": svc, "srv": srv}

    def tick_protected():
        """One service tick; an armed crash drops the WHOLE serve
        side (server + service + queue) and restores — every ticking
        phase (timed run, client flush, final drain) must survive the
        crash wherever the plan lands it."""
        nonlocal crashes
        try:
            state["svc"].tick()
            return 1
        except ServiceCrashed as e:
            print(f"net soak: SERVER CRASH ({e}) — restoring",
                  flush=True)
            t_crash = time.perf_counter()
            retired_server_stats.append(dict(state["srv"].stats))
            state["svc"], state["srv"] = _restart(
                state["svc"], state["srv"], ckpt_dir, journal_path,
                args.max_ops, args.d_max, capacity, port)
            state["svc"].tick()
            crashes += 1
            crash_mttr_ms.append(
                round(1000 * (time.perf_counter() - t_crash), 3))
            return 2

    try:
        t_start = time.perf_counter()
        deadline = t_start + args.seconds
        ticks = 0
        while time.perf_counter() < deadline:
            ticks += tick_protected()
            time.sleep(args.tick_every)
        stop_evt.set()
        for d in drivers:
            d.join(timeout=10.0)
        gen_errors = [e for d in drivers for e in d.errors]
        if gen_errors:
            print("net soak: CLIENT DRIVER FAILED: "
                  + "; ".join(gen_errors), flush=True)
            return 2
        proc_handoffs = []
        for k, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=40.0)
            except subprocess.TimeoutExpired:
                p.kill()
                out = ""
            if p.returncode != 0:
                print(f"net soak: PROC CLIENT p{k + 1} FAILED "
                      f"(rc={p.returncode}): {out!r}", flush=True)
                return 2
            proc_handoffs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        stop_evt.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    # ---- drain: every client flushes, the service flushes. ONE tick
    # per iteration so client pumps interleave with the queue drain —
    # a backlogged post-crash queue must not starve the reconnect
    # ladder of pump() calls for whole seconds
    flush_deadline = time.monotonic() + 30.0
    while time.monotonic() < flush_deadline:
        pending = 0
        for d in drivers:
            d.client.pump()
            pending += d.client.outbound_depth
        if state["svc"].queue.depth or state["svc"].queue.deferred:
            tick_protected()
        elif pending == 0:
            break
        else:
            time.sleep(0.01)
    for d in drivers:
        d.client.close()
    for _ in range(200):
        if not state["svc"].queue.depth:
            break
        tick_protected()
    svc, srv = state["svc"], state["srv"]
    digests = {u: svc.converged_digest(u) for u in uuids}
    retired_server_stats.append(dict(srv.stats))
    srv.stop()

    # ---- gates ------------------------------------------------------
    obs.flush()
    with chaos.suspended():
        obs.configure(enabled=False)
        oracle, journal_entries = _journal_oracle(pairs_init,
                                                  journal_path)
        mismatched = [u for u in uuids
                      if not _doc_equal(svc.materialize(u), oracle[u])]
        missing_ops = 0
        for d_ in drivers:
            nodes = svc.materialize(d_.uuid).ct.nodes
            missing_ops += sum(1 for nid in d_.minted_ids
                               if nid not in nodes)

    srv_total = {}
    for st in retired_server_stats:
        for k, v in st.items():
            srv_total[k] = srv_total.get(k, 0) + v
    stuck = [d.idx for d in drivers if d.client.outbound_depth]
    minted = sum(d.minted for d in drivers)
    acked = sum(d.client.stats["acked_ops"] for d in drivers)
    # a crash between the journal append and the ack loses the ACK,
    # not the op: the resend is either watermark-filtered client-side
    # (resumed_skipped) or suppressed server-side and acked as dup
    # (dup_acked) — all three buckets together must account for every
    # minted op, and the doc-presence gate below proves none was lost
    dup_acked = sum(d.client.stats["dup_acked_ops"] for d in drivers)
    resumed = sum(d.client.stats["resumed_skipped_ops"]
                  for d in drivers)
    accounted = acked + dup_acked + resumed
    shed = sum(d.client.stats["shed_ops"] for d in drivers)
    reconnects = sum(d.client.stats["reconnects"] for d in drivers)
    dial_failures = sum(d.client.stats["dial_failures"]
                        for d in drivers)
    nack_hist = {}
    backoff_hist = {}
    mttr_s = []
    for d in drivers:
        mttr_s.extend(d.client.partition_mttr_s)
        for k, v in d.client.stats["nacks"].items():
            nack_hist[k] = nack_hist.get(k, 0) + v
        for k, v in d.client.stats["backoff_hist"].items():
            backoff_hist[k] = backoff_hist.get(k, 0) + v
    partition_mttr_ms = [round(x * 1000, 3) for x in sorted(mttr_s)]
    mttr_mean = (round(sum(partition_mttr_ms)
                       / len(partition_mttr_ms), 3)
                 if partition_mttr_ms else None)

    # planned-vs-detected accounting (explicit `at` schedules only)
    planned = {"reset": 0, "partition": 0, "dup": 0, "blackhole": 0,
               "latency": 0, "payload": 0, "crash": 0}
    if plan:
        for spec in plan["faults"]:
            fam = spec["family"]
            key = spec.get("mode", "reset") if fam == "net" else fam
            planned[key] = planned.get(key, 0) + len(spec.get("at")
                                                    or ())

    evs = load_jsonl(args.obs_out)

    def count_ev(name):
        return sum(1 for e in evs if e.get("ev") == "event"
                   and e.get("name") == name)

    summary = {
        "clients": args.clients, "seconds": args.seconds,
        "ticks": ticks, "minted_ops": minted, "acked_ops": acked,
        "dup_acked_ops": dup_acked, "resumed_skipped_ops": resumed,
        "client_shed_ops": shed,
        "journal_entries": journal_entries,
        "admitted_ops": srv_total.get("admitted_ops", 0),
        "reconnects": reconnects, "dial_failures": dial_failures,
        "dup_frames": srv_total.get("dup_frames", 0),
        "dup_ops_suppressed": srv_total.get("dup_ops_suppressed", 0),
        "ooo_frames": srv_total.get("ooo_frames", 0),
        "poison_nacks": srv_total.get("poison_nacks", 0),
        "nacks": nack_hist, "backoff_hist": backoff_hist,
        "partition_mttr_ms": partition_mttr_ms,
        "partition_mttr_mean_ms": mttr_mean,
        "crashes": crashes, "crash_mttr_ms": crash_mttr_ms,
        "frame_rt": frame_rt,
        "planned": {k: v for k, v in planned.items() if v},
        "sync_rejects_evidenced": count_ev("sync.reject"),
        "reconnect_events": count_ev("net.reconnect"),
        "oracle_mismatches": mismatched,
        "minted_ops_missing": missing_ops,
        "stuck_clients": stuck,
    }
    print("net soak:", json.dumps(summary, indent=1), flush=True)

    # (1) reconvergence bit-identity + zero loss
    if mismatched or missing_ops or stuck or shed \
            or accounted != minted:
        print("net soak: CONVERGENCE GATE FAILED "
              f"(mismatched={mismatched} missing={missing_ops} "
              f"stuck={stuck} shed={shed} "
              f"accounted={accounted}/{minted})",
              flush=True)
        return EXIT_CONVERGENCE
    # (2) every injected fault family detected; duplicates EXACT
    if plan:
        fails = []
        if srv_total.get("dup_frames", 0) != planned.get("dup", 0):
            fails.append(f"dup frames {srv_total.get('dup_frames')} "
                         f"!= planned {planned.get('dup')}")
        if planned.get("payload") \
                and summary["sync_rejects_evidenced"] \
                < planned["payload"]:
            fails.append("payload mangle undetected")
        if planned.get("reset") and reconnects < planned["reset"]:
            fails.append("resets did not force reconnects")
        if planned.get("blackhole") \
                and reconnects < planned["reset"] \
                + planned["blackhole"]:
            fails.append("blackhole did not force a reconnect")
        if planned.get("partition") \
                and dial_failures < planned["partition"]:
            fails.append("partition refusals unobserved")
        if planned.get("crash") and crashes != planned["crash"]:
            fails.append(f"crashes {crashes} != planned "
                         f"{planned['crash']}")
        if summary["reconnect_events"] != reconnects:
            fails.append("reconnect evidence != client stats")
        if fails:
            print("net soak: DETECTION GATE FAILED: "
                  + "; ".join(fails), flush=True)
            return EXIT_UNDETECTED
    assert digests  # every tenant digest fetched before srv.stop

    # (3) cross-process journeys reconstruct complete: every child
    # interpreter's trace spans both pids with zero orphan hops in
    # the MERGED per-process streams — exactly what `obs journey`
    # gives an operator holding the per-host sidecars
    journey_summary = None
    if args.proc_clients:
        jfold = JourneyFold(retain_all=True)
        jfold.feed_many(load_streams([args.obs_out] + proc_streams))
        jrep = jfold.report()
        jfails = []
        for k, hand in enumerate(proc_handoffs):
            if hand["accounted"] != args.proc_ops:
                jfails.append(f"p{k + 1} accounted "
                              f"{hand['accounted']}/{args.proc_ops}")
            j = jfold.journey(hand["trace"])
            if j is None:
                jfails.append(f"p{k + 1} trace {hand['trace']} "
                              f"absent from merged streams")
            elif not j["complete"] or j["orphans"] \
                    or len(j["pids"]) < 2:
                jfails.append(
                    f"p{k + 1} trace {hand['trace']}: "
                    f"complete={j['complete']} "
                    f"orphans={j['orphans']} pids={j['pids']}")
        if jrep["orphan_hops"]:
            jfails.append(f"{jrep['orphan_hops']} orphan hop(s) "
                          f"fleet-wide")
        if not jrep["clock"]["edges"]:
            jfails.append("no clock edge measured")
        if any(j_["orphans"] for j_ in jfold.worst(5)):
            jfails.append("a worst-5 (p99 offender) journey has "
                          "orphan hops")
        if jfails:
            print("net soak: JOURNEY GATE FAILED: "
                  + "; ".join(jfails), flush=True)
            return EXIT_JOURNEY
        journey_summary = {
            "proc_clients": args.proc_clients,
            "streams": 1 + len(proc_streams),
            "traces": jrep["traces"],
            "complete": jrep["complete"],
            "orphan_hops": jrep["orphan_hops"],
            "clock_edges": len(jrep["clock"]["edges"]),
            "total_p99_ms": jrep["total"]["p99_ms"],
            "proc_traces": [h["trace"] for h in proc_handoffs],
        }
        print("net soak: journey gate clean — "
              + json.dumps(journey_summary), flush=True)

    try:
        row = ledger.ingest_record(
            {
                "platform": platform_of(dev),
                "metric": "net soak partition MTTR (mean)",
                "value": mttr_mean,
                "kernel": "net",
                "config": f"clients={args.clients} doc={args.doc} "
                          f"max_ops={args.max_ops} "
                          f"chaos={int(bool(plan))}",
                "smoke": False,
            },
            source=f"net-soak seed={args.seed} "
                   f"seconds={args.seconds:g}",
            obs_jsonl=args.obs_out,
            kind="net",
            extra={"net": {k: v for k, v in summary.items()
                           if k not in ("oracle_mismatches",
                                        "stuck_clients")},
                   **({"journey": journey_summary}
                      if journey_summary else {}),
                   "card": card},
        )
        print(f"net soak: ledger row ({row['platform']}) -> "
              f"{ledger.default_path()}", flush=True)
    except Exception as e:  # noqa: BLE001 - best-effort ledger append
        print(f"net soak: ledger append skipped "
              f"({type(e).__name__}: {e})", flush=True)

    print(f"net soak: clean — {minted} op(s) replicated over the "
          f"wire, {reconnects} reconnect(s), "
          f"{srv_total.get('dup_frames', 0)} wire duplicate(s) "
          f"suppressed exactly, {crashes} server crash(es) survived, "
          f"every tenant bit-identical to the journal oracle",
          flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    chaos.reset()
    sys.exit(rc)
