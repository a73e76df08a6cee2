"""Open-loop overload soak for the port's sync service: a
zipf-hot/bursty workload generator drives
``cause_tpu_torch.serve.SyncService`` at a MULTIPLE of the measured
steady-state wave rate — the offered load, not the operator, decides
what happens next — and the run gates the service's robustness
contracts machine-to-machine. A port of ``scripts/serve_soak.py``.

    python -m cause_tpu_torch.serve_soak --obs-out serve.jsonl \\
        [--tenants 8] [--capacity 4] [--seconds 20] [--rate-mult 2] \\
        [--max-ops 256] [--seed 0] [--chaos [crash|disk]] \\
        [--fsync batch] [--disk-plan measurements/disk_plan_r15.json] \\
        [--slo-ms 5000] [--batched on|off] [--gate-dispatch] [--cpu]

Runs on the card unless ``--cpu`` asks for the plain versions on the
CPU: without a card and without ``--cpu`` it exits 2 with one line
naming ``serve_soak`` and the missing device (a generator failure's 2
prints ``GENERATOR FAILED`` instead).

The gates:

- **bounded queue depth** — the admitted depth never exceeds
  ``--max-ops`` on any queue incarnation (exit 6);
- **every shed evidenced** — the queues' cumulative shed stats must
  equal the ``serve.shed`` events in the sidecar exactly (exit 5);
- **zero admitted ops lost / bit-identical convergence** — after the
  final drain the service state must equal an independent PURE-oracle
  replay of the write-ahead ingest journal (EDN + node bags + weave
  order), and a drain→restore round-trip must reproduce every
  tenant's converged digest bit-for-bit (exit 4). With ``--chaos``
  this holds ACROSS a seeded crash mid-steady-state and a second
  crash mid-drain: the harness drops the whole service object and
  restores from checkpoint + journal;
- **p99 admitted-op lag** — create→converged over the lag tracer;
  reported always, gated when ``--slo-ms`` is given (exit 3).

The journal is the segmented CRC WAL (``serve/wal.py``): retired
segments move to a retire dir, so the oracle replays the WHOLE
admission history (retired + live segments) even after GC.
``--chaos disk`` (exit 7 on any miss) arms a committed seeded plan
(``--disk-plan``, read from the repo's ``measurements/``) covering all
five disk fault modes plus a mid-GC crash, drives periodic checkpoints
so the WAL GC actually cycles, and adds the storage gates:

- **zero admitted-op loss across storage faults** — refused appends
  (ENOSPC/torn) must surface as ``durability``-rung sheds with
  ``retry_after_ms`` in EXACT injected counts (the producer re-offers;
  nothing acked is lost), bit-rot must be found by the scrubber's CRC
  walk in exact count (the intact ground truth rides the chaos
  injection log back into the oracle), fsync failures and the
  checkpoint-rename failure must each land their ``serve.disk``
  evidence, and the previous manifest must stay intact;
- **replay-after-GC bit-identity** — a restore AFTER the mid-GC crash
  and an explicit end-of-run GC pass must reproduce every digest and
  the exact record list above the watermark;
- **bounded disk** — live WAL bytes sampled across >=3 checkpoint/GC
  cycles stay bounded while the cumulative appended-bytes baseline
  (what a single unrotated file would hold) grows monotonically;
- **final scrub clean** — the faulty segments sealed, retired, and
  out of the live WAL by the end of the run.

A clean run lands a ``--kind serve`` row in the port's ledger
(``obs.ledger.default_path()``, or ``CAUSE_TPU_LEDGER``; value = p99
admitted-op lag ms; extra = p50/p99, sustained waves/sec, shed counts
by rung, admitted totals, crash count + MTTR) — or a ``--kind disk``
row (value = live WAL bytes after the final GC; extra = the full
storage-gate evidence) under ``--chaos disk``. The row's ``platform``
is the device's tag (``gpu`` or ``cpu``) and ``card`` the card's
``name, power.limit`` from ``nvidia-smi`` (null on the CPU).

``--batched on`` (the default) serves every touched tenant with ONE
fused device dispatch per pow2 bucket; ``--batched off`` keeps the
per-tenant wave path (~3 dispatches per touched tenant).
``--gate-dispatch`` turns the collapse into a gate (exit 8): summed
over the timed window, wave dispatches must track the bucket count
(with explicit fallback/restore allowances), not the touched-tenant
count — the acceptance shape for the 8x-tenant config (e.g.
``--tenants 32 --gate-dispatch`` vs the 4-tenant smoke).

The generator is OPEN-LOOP: it offers per-site delta batches (zipf
tenant pick, occasional no-sleep bursts) on its own clock and never
waits for the service; a rejected offer simply leaves that site's
cumulative delta to be re-offered next time (exactly a real
producer's retry), so overload exercises the declared shed ladder
instead of silently throttling the load.

The calibration's closed-loop round is ``_calib_round`` at module
level, so that a caller can drive it without the timed run; it makes
the reference's draws in the reference's order.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import threading
import time

import cause_tpu_torch as c
from . import chaos, obs, serde, sync
from .collections import clist as c_list
from .collections import shared as _shared
from .collections.clist import CausalList
from .ids import new_site_id
from .obs import lag as _lag
from .serve import IngestQueue, ResidencyManager, ServiceCrashed, \
    SyncService, WriteAheadLog
from .serve import wal as wal_mod
from .serve.scrub import scrub_wal
from .serve.service import MANIFEST_NAME

# the committed disk plan, read from the checkout's root whatever the
# working directory
DISK_PLAN_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "measurements", "disk_plan_r15.json")

# exit codes (soak.py's vocabulary, extended)
EXIT_LAG = 3
EXIT_CONVERGENCE = 4
EXIT_UNEVIDENCED_SHED = 5
EXIT_DEPTH = 6
EXIT_DISK = 7
EXIT_DISPATCH = 8


class _SiteState:
    """One producing site's client-side state: its own yarn tail (the
    causal anchor every new op hangs off — a site types a run, no
    weave needed) and the UNACKED ops minted so far. A rejected offer
    keeps them pending, so the next offer re-ships the cumulative
    suffix — the producer retry loop. Minting is O(1): a real client
    is a thin front-end, not a replica with an accelerator."""

    __slots__ = ("site", "last_id", "ts", "pending")

    def __init__(self, handle):
        self.site = str(handle.ct.site_id)
        yarn = handle.ct.yarns[self.site]
        self.last_id = yarn[-1][0]
        self.ts = int(self.last_id[0])
        self.pending = []

    def mint(self, value):
        self.ts += 1
        nid = (self.ts, self.site, 0)
        self.pending.append((nid, self.last_id, value))
        self.last_id = nid
        return nid


class _Tenant:
    __slots__ = ("uuid", "sites", "minted_ops")

    def __init__(self, uuid, left, right):
        self.uuid = uuid
        self.sites = [_SiteState(left), _SiteState(right)]
        self.minted_ops = 0


def _offer_pending(queue, tenant, st):
    """Offer one site's cumulative unacked suffix; on admission the
    pending list clears (the service owns those ops now — they are
    journaled)."""
    items = serde.encode_node_items(
        {nid: (cause, value) for nid, cause, value in st.pending})
    adm = queue.offer(tenant.uuid, st.site, items,
                      crc=sync.payload_checksum(items))
    if adm.admitted:
        st.pending = []
    return adm


def _zipf_weights(n: int, alpha: float):
    w = [1.0 / ((i + 1) ** alpha) for i in range(n)]
    total = sum(w)
    return [x / total for x in w]


class Generator(threading.Thread):
    """The open-loop producer. ``holder["queue"]`` indirection lets
    the harness swap in a restored service's queue after a chaos
    crash — offers during the outage land on the CLOSED old queue and
    are refused with evidence, exactly a real front-end's view of a
    restarting backend."""

    def __init__(self, holder, tenants, rate_per_s, seed, alpha=1.2,
                 burst_p=0.15):
        super().__init__(name="serve-soak-gen", daemon=True)
        self.holder = holder
        self.tenants = tenants
        self.interval_s = 1.0 / max(1e-6, rate_per_s)
        self.rng = random.Random(seed)
        self.weights = _zipf_weights(len(tenants), alpha)
        self.burst_p = burst_p
        self.stop_evt = threading.Event()
        self.offered = 0
        self.admitted = 0
        self.refused = 0

    def _mint_and_offer(self):
        t = self.rng.choices(self.tenants, weights=self.weights)[0]
        st = t.sites[self.rng.randrange(2)]
        n_ops = self.rng.randrange(1, 4)
        ids = [st.mint(f"g{self.offered}.{j}") for j in range(n_ops)]
        t.minted_ops += n_ops
        if obs.enabled():
            # the create-side lag stamp a handle append would have
            # minted (the queue wait is part of admitted-op lag)
            _lag.op_created(t.uuid, ids)
        adm = _offer_pending(self.holder["queue"], t, st)
        self.offered += 1
        if adm.admitted:
            self.admitted += 1
        else:
            self.refused += 1

    def run(self):
        while not self.stop_evt.is_set():
            try:
                self._mint_and_offer()
            except Exception as e:  # noqa: BLE001 - surfaced in main
                self.holder.setdefault("gen_errors", []).append(
                    f"{type(e).__name__}: {e}")
                return
            if self.rng.random() < self.burst_p:
                continue  # burst: no sleep, back-to-back offers
            self.stop_evt.wait(self.interval_s)


def _mk_fleet(n_tenants: int, doc: int):
    """``n_tenants`` distinct documents, each a (left, right) replica
    pair of ``weaver="torch"`` handles at one shared doc size."""
    out = []
    for i in range(n_tenants):
        fresh = CausalList(
            c.clist(weaver="torch").extend(
                [f"w{i}.{j}" for j in range(doc)]).ct)
        fresh = CausalList(c_list.weave(fresh.ct))
        fresh.ct.lanes.segments()
        a = CausalList(fresh.ct.evolve(site_id=new_site_id())).conj(
            f"A{i}")
        b = CausalList(fresh.ct.evolve(site_id=new_site_id())).conj(
            f"B{i}")
        out.append((a, b))
    return out


def _pure(h):
    return CausalList(h.ct.evolve(weaver="pure", lanes=None))


def _wal_entries(wal_dir, retired_dir):
    """Every admitted record the storage layer ever held, seq-sorted:
    live PLUS retired segments (GC MOVES sealed segments into the
    retire dir, so the union is the whole admission history), with
    bit-rotted records' intact ground truth read back from the chaos
    injection log — the durable copy is wrong ON PURPOSE; the oracle
    replays what was acknowledged, not what the rot left behind."""
    entries = {}
    for d in (retired_dir, wal_dir):
        if not d or not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if not (name.startswith("wal-") and name.endswith(".seg")):
                continue
            for kind, e in wal_mod.scan_segment_file(
                    os.path.join(d, name)):
                if kind in ("rec", "legacy") and isinstance(e, dict) \
                        and "seq" in e:
                    entries[int(e["seq"])] = e
    for r in chaos.injected():
        if r.get("family") == "disk" and r.get("mode") == "bitrot" \
                and isinstance(r.get("rec"), dict):
            rec = r["rec"]
            entries[int(rec["seq"])] = rec
    return [entries[k] for k in sorted(entries)]


def _journal_oracle(pairs_init, wal_dir, retired_dir):
    """The independent no-loss oracle: each tenant's initial PURE
    pair merge, plus a pure replay of EVERY journaled entry (the
    write-ahead log is the authoritative record of admission) —
    computed with chaos suspended and obs off so the replay neither
    consumes fault counters nor pollutes the lag stream."""
    out = {}
    for uuid, (a, b) in pairs_init.items():
        out[uuid] = _pure(a).merge(_pure(b))
    entries = _wal_entries(wal_dir, retired_dir)
    for e in entries:
        uuid = str(e.get("uuid"))
        if uuid not in out:
            continue
        sync.validate_node_items(e["items"])
        nodes = serde.decode_node_items(e["items"])
        out[uuid] = sync.apply_delta(out[uuid], nodes,
                                     _count_as_delta=False)
    return out, len(entries)


def _doc_equal(dev_handle, pure_handle) -> bool:
    """The chaos-soak convergence gate: EDN + node bags + weave
    order."""
    return (c.causal_to_edn(dev_handle) == c.causal_to_edn(pure_handle)
            and dict(dev_handle.ct.nodes) == dict(pure_handle.ct.nodes)
            and [n[0] for n in dev_handle.get_weave()]
            == [n[0] for n in pure_handle.get_weave()])


def _restart(svc, ckpt_dir, capacity, d_max, watchdog_s, mk_journal,
             batched=True):
    """The crash protocol: close the old incarnation's front door and
    journal handle, drop EVERY in-memory structure, restore from the
    last checkpoint + journal (same admission bound, same residency
    pressure, same window budget, same measured controller floor — a
    restart must not quietly relax the memory, admission or control
    regime). ``mk_journal`` reopens the SAME WAL directory with the
    same rotation/fsync/retire policy — a restart must not quietly
    relax the durability regime either."""
    from .serve import BatchController

    floor_ms = svc.controller.floor_ms
    t_batch_ms = svc.controller.t_batch_ms
    max_ops = svc.queue.max_ops
    svc.close()  # watchdog + the incarnation's live obs subscriber
    svc.queue.close_admission()
    if svc.queue.journal is not None:
        svc.queue.journal.close()
    del svc
    queue = IngestQueue(max_ops=max_ops, journal=mk_journal())
    return SyncService.restore(
        ckpt_dir, queue=queue,
        residency=ResidencyManager(capacity=capacity),
        controller=BatchController(floor_ms=floor_ms,
                                   initial_ms=t_batch_ms),
        d_max=d_max, watchdog_s=watchdog_s, batched=batched)


def _flush(svc) -> None:
    """Tick until nothing is queued or deferred (at most 500 ticks)."""
    for _ in range(500):
        if not (svc.queue.depth or svc.queue.deferred):
            return
        svc.tick()


def _calib_round(svc, tenants, rng, weights, k) -> int:
    """One closed-loop calibration round: ``3 * len(tenants)`` offers
    (zipf tenant pick by ``weights``, one of its two sites, 1-3 ops,
    all drawn from ``rng``), then ticks until the queue is flushed.
    Returns the offers admitted.

    The calibration load mirrors the open-loop shape (zipf tenant pick,
    1-3 op batches, several batches coalescing per tick) so the
    measured walls price the REAL window sizes, not a best-case one-op
    wave; each round drains completely, so its wall is its own work and
    nothing leaks across rounds."""
    n = 0
    for j in range(3 * len(tenants)):
        t = rng.choices(tenants, weights=weights)[0]
        st = t.sites[rng.randrange(2)]
        ids = [st.mint(f"c{k}.{j}.{i}")
               for i in range(rng.randrange(1, 4))]
        if obs.enabled():
            _lag.op_created(t.uuid, ids)
        if _offer_pending(svc.queue, t, st).admitted:
            n += 1
    _flush(svc)
    return n


def main(argv=None) -> int:
    from .bench import card_name_power
    from .device import claim_device
    from .obs.core import platform_of

    ap = argparse.ArgumentParser(
        description="open-loop overload soak of the port's sync service")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=None,
                    help="residency capacity (default tenants//2: the "
                         "zipf tail lives spilled on host)")
    ap.add_argument("--doc", type=int, default=30)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rate-mult", type=float, default=2.0,
                    help="offered batch rate as a multiple of the "
                         "MEASURED steady-state wave rate (1x = "
                         "sustainable, 2x/4x = overload)")
    ap.add_argument("--max-ops", type=int, default=256)
    ap.add_argument("--d-max", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib-ticks", type=int, default=4)
    ap.add_argument("--chaos", nargs="?", const="crash", default=None,
                    choices=("crash", "disk"),
                    help="arm a seeded fault arm: 'crash' (bare "
                         "--chaos keeps meaning this) arms one mid-"
                         "steady-state serve.tick crash and one mid-"
                         "drain serve.drain crash; 'disk' arms the "
                         "committed --disk-plan (all five disk fault "
                         "modes + a mid-GC crash) and the storage "
                         "gates (exit 7). Either way the harness "
                         "restores from checkpoint + journal and the "
                         "no-loss gates must still hold")
    ap.add_argument("--fsync", default="batch",
                    choices=("none", "batch", "always"),
                    help="WAL fsync policy")
    ap.add_argument("--disk-plan", default=DISK_PLAN_DEFAULT,
                    help="seeded chaos plan JSON for --chaos disk "
                         "(the COMMITTED plan is the reproducible "
                         "acceptance artifact)")
    ap.add_argument("--rotate-bytes", type=int, default=None,
                    help="WAL segment rotation threshold (default "
                         "8 KiB under --chaos disk so GC cycles "
                         "several times per run, 512 KiB otherwise)")
    ap.add_argument("--batched", default="on", choices=("on", "off"),
                    help="cross-tenant batched ticks (one fused "
                         "dispatch per pow2 bucket) vs the per-tenant "
                         "wave path — the A/B axis for the "
                         "dispatch-collapse evidence")
    ap.add_argument("--gate-dispatch", action="store_true",
                    help="gate the dispatch collapse (exit 8): over "
                         "the timed window, wave dispatches per tick "
                         "must scale with the BUCKET count, not the "
                         "touched-tenant count (the 8x-tenant soak "
                         "config's acceptance gate; requires "
                         "--batched on)")
    ap.add_argument("--obs-out", required=True,
                    help="obs JSONL sidecar (required: the committed "
                         "stream IS the shed/lag/crash evidence)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="gate p99 admitted-op lag (exit 3 past it)")
    ap.add_argument("--state-dir", default=None,
                    help="journal + checkpoint dir (default: a fresh "
                         "tempdir next to --obs-out)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = claim_device(args.cpu, "serve_soak")
    card = card_name_power(dev)

    # the sidecar IS the run's evidence: the gates compare engine
    # stats against THIS run's events, so a stale file from an
    # earlier run must not pollute the counts
    if os.path.exists(args.obs_out):
        os.unlink(args.obs_out)
    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform(dev)
    sync.quarantine_reset()

    state_dir = args.state_dir or (args.obs_out + ".state")
    ckpt_dir = os.path.join(state_dir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    wal_dir = os.path.join(state_dir, "wal")
    retired_dir = os.path.join(state_dir, "wal_retired")
    for d in (wal_dir, retired_dir):
        if os.path.isdir(d):
            shutil.rmtree(d)
    legacy_journal = os.path.join(state_dir, "ingest.jsonl")
    if os.path.exists(legacy_journal):
        os.unlink(legacy_journal)
    rotate_bytes = args.rotate_bytes or (
        8192 if args.chaos == "disk" else 512 * 1024)

    def _mk_journal():
        # the segmented WAL: same policy on every incarnation; GC
        # retires sealed segments INTO retired_dir so the oracle can
        # replay the whole admission history after GC
        return WriteAheadLog(wal_dir, rotate_bytes=rotate_bytes,
                             fsync=args.fsync, retire_dir=retired_dir)

    capacity = args.capacity or max(1, args.tenants // 2)
    batched = args.batched == "on"
    queue = IngestQueue(max_ops=args.max_ops, journal=_mk_journal())
    svc = SyncService(queue,
                      residency=ResidencyManager(capacity=capacity),
                      checkpoint_dir=ckpt_dir, d_max=args.d_max,
                      watchdog_s=5.0, batched=batched)
    holder = {"queue": queue}
    retired_queues = []

    pairs = _mk_fleet(args.tenants, args.doc)
    pairs_init = {}
    tenants = []
    for a, b in pairs:
        uuid = svc.add_tenant(a, b)
        pairs_init[uuid] = (a, b)
        tenants.append(_Tenant(uuid, a, b))
    print(f"serve soak: {args.tenants} tenant(s), residency capacity "
          f"{capacity}, max_ops {args.max_ops}, "
          f"batched={args.batched}", flush=True)

    # ---- calibration: the MEASURED steady-state wave rate ----------
    # closed-loop: mint one batch per tenant, tick, repeat — the
    # achieved batch rate includes every real cost (host mint +
    # validate + journal, per-batch apply, the wave, doc growth), so
    # "1x" genuinely means sustainable and 2x/4x genuinely mean
    # overload. The first rounds pay the kernels' builds and the
    # allocator's growth: warm separately first.
    rng = random.Random(args.seed ^ 0x5EED)
    calib_weights = _zipf_weights(len(tenants), 1.2)
    for k in range(args.calib_ticks):  # warm: builds, first waves,
        _calib_round(svc, tenants, rng, calib_weights, k)  # budgets
    calib_s = 2.0
    t0 = time.perf_counter()
    batches = 0
    rounds = 0
    k = args.calib_ticks
    while rounds < 5 or time.perf_counter() - t0 < calib_s:
        batches += _calib_round(svc, tenants, rng, calib_weights, k)
        rounds += 1
        k += 1
    calib_elapsed = time.perf_counter() - t0
    steady_per_s = batches / max(1e-3, calib_elapsed)
    offered_per_s = args.rate_mult * steady_per_s
    # the measured controller floor: the per-tenant wave wall of this
    # run, not the controller's default (``DISPATCH_FLOOR_MS``, the
    # H100's one-tenant bucket dispatch) — the inversion target must be
    # computed in this host's and device's own cost units
    floor_ms = 1000.0 * calib_elapsed / rounds / max(1, args.tenants)
    svc.controller.floor_ms = floor_ms
    print(f"serve soak: measured steady-state {steady_per_s:.1f} "
          f"batch/s over {rounds} drained closed-loop round(s) "
          f"(measured floor {floor_ms:.2f} ms/wave); offering "
          f"{args.rate_mult:g}x = {offered_per_s:.1f} batch/s",
          flush=True)

    # flush the calibration backlog completely so the timed window's
    # lag distribution prices ONLY the open-loop run (calibration ops
    # converge — and their lag records land — before t_run_start)
    _flush(svc)
    # scope the measured lag to the run: calibration ops are resolved
    # (queue flushed above), so a lag epoch bump here means every
    # cumulative lag.window histogram from now on prices ONLY the
    # open-loop run
    _lag.reset()
    run_epoch = _lag.current_epoch()
    svc.checkpoint()  # the durable baseline every crash restores past

    if args.chaos == "disk":
        # arm AFTER calibration + the baseline checkpoint so the
        # plan's per-hook invocation indices count from the run's
        # first real append — the committed plan is reproducible
        with open(args.disk_plan) as f:
            disk_plan = json.load(f)
        chaos.configure(plan=disk_plan)
        print(f"serve soak: disk chaos armed from {args.disk_plan} "
              f"(seed {disk_plan.get('seed')}, "
              f"{len(disk_plan.get('faults') or [])} fault spec(s); "
              f"fsync={args.fsync} rotate_bytes={rotate_bytes})",
              flush=True)

    gen = Generator(holder, tenants, offered_per_s, args.seed)
    t_run_start_us = time.time_ns() // 1000
    gen.start()

    # ---- the timed open-loop run -----------------------------------
    svc.start_watchdog()
    t_start = time.perf_counter()
    deadline = t_start + args.seconds
    ticks = 0
    crashes = 0
    mttr_ms = []
    chaos_armed = False
    # --chaos disk: periodic checkpoints drive the retention policy —
    # each one advances the watermark and the WAL GC retires the
    # fully-applied segments; the bounded-disk gate samples across
    # these cycles while baseline_accum carries the would-have-been
    # single-file size (lifetime appended bytes) across restarts
    ckpt_every = max(1.0, args.seconds / 8.0)
    next_ckpt = t_start + ckpt_every
    gc_cycles = 0
    gc_crashes = 0
    rename_survived = 0
    manifest_intact = True
    baseline_accum = 0
    live_bytes_series = []
    baseline_bytes_series = []
    manifest_path = os.path.join(ckpt_dir, MANIFEST_NAME)
    # per-tick dispatch accounting: every timed tick's touched-tenant /
    # bucket / costmodel-counted dispatch triple — the dispatch-collapse
    # gate's evidence base
    tick_series = []

    def _note_tick(ts):
        if ts["tenants"]:
            tick_series.append((ts["tenants"], ts["buckets"],
                                ts["wave_dispatches"]))

    # disk-arm extension: the bounded-disk evidence needs >= 3
    # checkpoint/GC cycles, and on a slow host the timed window may
    # simply not fit them. Rather than a red gate for being slow, keep
    # the open-loop run going past the deadline until the cycles land —
    # bounded by a HARD op-count cap so a wedged GC can never spin
    # forever (past the cap the gate reports an honest skip instead)
    ext_cap_ops = max(4096, args.max_ops * 16)

    def _loop_live():
        if time.perf_counter() < deadline:
            return True
        return (args.chaos == "disk" and gc_cycles < 3
                and gen.admitted < ext_cap_ops)

    while _loop_live():
        if args.chaos == "crash" and not chaos_armed \
                and time.perf_counter() - t_start > args.seconds / 2:
            # arm at the wall-clock midpoint: the NEXT tick crashes
            # (mid-steady-state) and the FIRST drain invocation
            # crashes (mid-drain) — both restored below
            chaos.configure(plan={"seed": args.seed, "faults": [
                {"family": "crash", "site": "serve.tick", "at": [1]},
                {"family": "crash", "site": "serve.drain",
                 "at": [1]}]})
            chaos_armed = True
            print("serve soak: chaos armed at run midpoint",
                  flush=True)
        try:
            _note_tick(svc.tick())
            ticks += 1
        except ServiceCrashed as e:
            print(f"serve soak: CRASH ({e}) — restoring", flush=True)
            t_crash = time.perf_counter()
            retired_queues.append(svc.queue)
            baseline_accum += svc.queue.journal.appended_bytes
            svc = _restart(svc, ckpt_dir, capacity, args.d_max,
                           5.0, _mk_journal, batched=batched)
            holder["queue"] = svc.queue
            svc.start_watchdog()
            # the first post-restore tick closes the MTTR
            _note_tick(svc.tick())
            ticks += 1
            crashes += 1
            mttr_ms.append(round(1000 * (time.perf_counter()
                                         - t_crash), 3))
        if args.chaos == "disk" and time.perf_counter() >= next_ckpt:
            try:
                svc.checkpoint()
                gc_cycles += 1
            except ServiceCrashed as e:
                # the seeded mid-GC crash: the watermark manifest
                # landed, the retired-but-not-yet-moved segments are
                # still on disk — the restore must replay identically
                # and the NEXT cycle's GC finishes the retirement
                print(f"serve soak: CRASH mid-GC ({e}) — restoring",
                      flush=True)
                t_crash = time.perf_counter()
                retired_queues.append(svc.queue)
                baseline_accum += svc.queue.journal.appended_bytes
                svc = _restart(svc, ckpt_dir, capacity, args.d_max,
                               5.0, _mk_journal, batched=batched)
                holder["queue"] = svc.queue
                svc.start_watchdog()
                crashes += 1
                gc_crashes += 1
                mttr_ms.append(round(1000 * (time.perf_counter()
                                             - t_crash), 3))
            except _shared.CausalError as e:
                causes = getattr(e, "info", {}).get("causes", ())
                if "checkpoint-rename" not in causes:
                    raise
                # the injected manifest-rename failure: the PREVIOUS
                # manifest must still parse — the service keeps
                # serving and the next cycle's checkpoint supersedes
                try:
                    with open(manifest_path) as f:
                        m = json.load(f)
                    ok = (isinstance(m, dict)
                          and "~serve_manifest" in m)
                except (OSError, ValueError):
                    ok = False
                manifest_intact = manifest_intact and ok
                rename_survived += 1
                print("serve soak: checkpoint rename failed "
                      f"(previous manifest intact: {ok})", flush=True)
            live_bytes_series.append(svc.queue.journal.dir_bytes())
            baseline_bytes_series.append(
                baseline_accum + svc.queue.journal.appended_bytes)
            # re-space from NOW (not += ckpt_every): a slow restore
            # must not make missed slots fire back-to-back — each
            # bounded-disk sample prices a real interval of appends.
            # Past the deadline (the GC-cycle extension) tighten the
            # cadence: the extension exists only to land cycles
            next_ckpt = time.perf_counter() + (
                ckpt_every if time.perf_counter() < deadline
                else min(ckpt_every, 1.0))
        if svc.queue.depth == 0:
            # T_batch is a coalescing window, not a pure delay: with
            # a backlog waiting the batch is already built — tick on
            time.sleep(svc.controller.t_batch_ms / 1000.0)
    extended_s = round(max(0.0, time.perf_counter() - deadline), 3)
    if extended_s:
        print(f"serve soak: GC-cycle extension ran {extended_s:g}s "
              f"past the timed window ({gc_cycles} cycle(s) landed)",
              flush=True)
    gen.stop_evt.set()
    gen.join(timeout=10.0)
    elapsed = time.perf_counter() - t_start
    if holder.get("gen_errors"):
        print("serve soak: GENERATOR FAILED: "
              + "; ".join(holder["gen_errors"]), flush=True)
        return 2

    # ---- drain (chaos: crashes once mid-drain, restored, re-drained;
    # disk: the drain-time checkpoint may hit the injected manifest-
    # rename failure — the previous manifest is intact by contract
    # and the drain is simply retried, exactly a real operator's move)
    for _ in range(4):
        try:
            svc.drain()
            break
        except ServiceCrashed as e:
            print(f"serve soak: CRASH mid-drain ({e}) — restoring",
                  flush=True)
            t_crash = time.perf_counter()
            retired_queues.append(svc.queue)
            baseline_accum += svc.queue.journal.appended_bytes
            svc = _restart(svc, ckpt_dir, capacity, args.d_max,
                           None, _mk_journal, batched=batched)
            holder["queue"] = svc.queue
            crashes += 1
            mttr_ms.append(round(1000 * (time.perf_counter()
                                         - t_crash), 3))
        except _shared.CausalError as e:
            causes = getattr(e, "info", {}).get("causes", ())
            if "checkpoint-rename" not in causes:
                raise
            try:
                with open(manifest_path) as f:
                    m = json.load(f)
                ok = isinstance(m, dict) and "~serve_manifest" in m
            except (OSError, ValueError):
                ok = False
            manifest_intact = manifest_intact and ok
            rename_survived += 1
            print("serve soak: drain checkpoint rename failed "
                  f"(previous manifest intact: {ok}) — retrying",
                  flush=True)
    else:
        print("serve soak: drain did not complete in 4 attempts",
              flush=True)
        return EXIT_CONVERGENCE
    if args.chaos == "disk":
        # the drain checkpoint is the run's last GC cycle — sample it
        gc_cycles += 1
        live_bytes_series.append(svc.queue.journal.dir_bytes())
        baseline_bytes_series.append(
            baseline_accum + svc.queue.journal.appended_bytes)
    digests = {u: svc.converged_digest(u) for u in pairs_init}
    t_batch_final = round(svc.controller.t_batch_ms, 3)
    control_changes = svc.controller.changes
    svc.stop_watchdog()

    # ---- gates ------------------------------------------------------
    # (1) drain→restore bit-identity
    retired_queues.append(svc.queue)
    svc.queue.journal.close()
    svc2 = SyncService.restore(
        ckpt_dir, residency=ResidencyManager(capacity=capacity),
        d_max=args.d_max)
    restore_ok = all(svc2.converged_digest(u) == digests[u]
                     for u in pairs_init)
    # (2) the pure-oracle journal replay (no admitted op lost)
    obs.flush()
    with chaos.suspended():
        obs.configure(enabled=False)
        oracle, journal_entries = _journal_oracle(pairs_init, wal_dir,
                                                  retired_dir)
        mismatched = [u for u in pairs_init
                      if not _doc_equal(svc2.materialize(u),
                                        oracle[u])]
    # (2b) disk arm: replay-after-GC bit-identity + the final scrub —
    # an explicit end-of-run GC pass at the manifest watermark must
    # not change the replayable suffix, a THIRD restore after it must
    # reproduce every digest, and the live WAL must scrub clean (the
    # faulty segments sealed + retired during the run)
    replay_after_gc_ok = True
    gc_restore_ok = True
    final_live_bytes = None
    scrub_rep = None
    if args.chaos == "disk":
        with chaos.suspended():
            with open(manifest_path) as f:
                final_wm = int(json.load(f).get("gc_watermark") or 0)
            svc2.queue.journal.close()
            jx = _mk_journal()
            pre_gc = list(jx.iter_from(final_wm))
            jx.gc(final_wm)
            post_gc = list(jx.iter_from(final_wm))
            replay_after_gc_ok = pre_gc == post_gc
            svc3 = SyncService.restore(
                ckpt_dir,
                residency=ResidencyManager(capacity=capacity),
                d_max=args.d_max)
            gc_restore_ok = all(svc3.converged_digest(u) == digests[u]
                                for u in pairs_init)
            final_live_bytes = jx.dir_bytes()
            jx.close()
            scrub_rep = scrub_wal(wal_dir, retired=retired_dir)
    # (3) evidence + bounds, over the committed sidecar
    from .obs import lag as lag_mod
    from .obs import ledger
    from .obs.perfetto import load_jsonl

    evs = load_jsonl(args.obs_out)
    shed_events = [e for e in evs if e.get("ev") == "event"
                   and e.get("name") == "serve.shed"]
    stats_total = {"sheds": 0, "shed_ops": 0, "admitted_ops": 0,
                   "admitted_batches": 0, "max_depth": 0}
    by_rung = {"defer": 0, "reject": 0, "drop_oldest": 0,
               "durability": 0}
    for q in retired_queues:
        for k in ("sheds", "shed_ops", "admitted_ops",
                  "admitted_batches"):
            stats_total[k] += q.stats[k]
        stats_total["max_depth"] = max(stats_total["max_depth"],
                                       q.stats["max_depth"])
        for k in by_rung:
            by_rung[k] += q.stats["shed_by_rung"][k]
    # lag epoch-scoped to the run (the calibration epoch's cumulative
    # histograms are a different generation); wave rate over the run
    # window by timestamp
    summary_lag = lag_mod.lag_summary(evs, epoch=run_epoch)
    conv = summary_lag["converged"]
    waves = sum(1 for e in evs if e.get("ev") == "event"
                and e.get("name") == "wave.digest"
                and (e.get("ts_us") or 0) >= t_run_start_us)
    waves_per_s = round(waves / max(1e-3, elapsed), 2)
    chaos_injects = sum(1 for e in evs if e.get("ev") == "event"
                        and e.get("name") == "chaos.inject")

    # ---- dispatch-collapse evidence -----------------------------------
    # every timed tick's (touched tenants, buckets, costmodel-counted
    # wave dispatches); restores cost extra dispatches (digest-gated
    # re-upload) and are priced separately so the gate below compares
    # the WAVE cost, not the residency churn
    touches_total = sum(t for t, _b, _d in tick_series)
    buckets_total = sum(b for _t, b, _d in tick_series)
    disp_total = sum(d for _t, _b, d in tick_series)
    restores_run = sum(1 for e in evs if e.get("ev") == "event"
                       and e.get("name") == "serve.restore"
                       and (e.get("ts_us") or 0) >= t_run_start_us)
    fallbacks_run = sum((e.get("fields") or {}).get("fallbacks", 0)
                        for e in evs if e.get("ev") == "event"
                        and e.get("name") == "serve.tick"
                        and (e.get("ts_us") or 0) >= t_run_start_us)
    dispatch_summary = {
        "batched": batched,
        "ticks_touched": len(tick_series),
        "tenant_touches": touches_total,
        "buckets": buckets_total,
        "wave_dispatches": disp_total,
        "fallbacks": fallbacks_run,
        "restores": restores_run,
        "per_touch": round(disp_total / max(1, touches_total), 3),
        "per_bucket": round(disp_total / max(1, buckets_total), 3)
        if buckets_total else None,
    }

    # ---- disk-arm detection + bounded-disk evidence -----------------
    # every INJECTED storage fault must be DETECTED with exact
    # evidence on the right ladder: refused appends as durability
    # sheds, bit-rot by the scrubber's CRC walk, fsync/rename
    # failures as serve.disk events, the mid-GC crash survived
    disk_summary = None
    disk_failures = []
    if args.chaos == "disk":
        inj_by_mode = {}
        inj_gc_crashes = 0
        for r in chaos.injected():
            if r.get("family") == "disk":
                m = r.get("mode")
                inj_by_mode[m] = inj_by_mode.get(m, 0) + 1
            elif r.get("family") == "crash" \
                    and r.get("site") == "serve.wal.gc":
                inj_gc_crashes += 1
        shed_reasons = {}
        for e in shed_events:
            f = e.get("fields") or {}
            if f.get("rung") == "durability":
                shed_reasons[f.get("reason")] = \
                    shed_reasons.get(f.get("reason"), 0) + 1
        disk_ops = {}
        for e in evs:
            if e.get("ev") == "event" and e.get("name") == "serve.disk":
                op = (e.get("fields") or {}).get("op")
                disk_ops[op] = disk_ops.get(op, 0) + 1
        retired_rep = (scrub_rep or {}).get("retired") or {}
        crc_found = ((scrub_rep or {}).get("crc_failures", 0)
                     + retired_rep.get("crc_failures", 0))
        torn_found = ((scrub_rep or {}).get("torn", 0)
                      + retired_rep.get("torn", 0))
        checks = {
            "enospc_refused_exactly":
                inj_by_mode.get("enospc", 0) > 0
                and shed_reasons.get("wal-enospc", 0)
                == inj_by_mode["enospc"],
            "torn_refused_exactly":
                inj_by_mode.get("torn", 0) > 0
                and shed_reasons.get("wal-torn", 0)
                == inj_by_mode["torn"]
                and torn_found == inj_by_mode["torn"],
            "bitrot_scrubbed_exactly":
                inj_by_mode.get("bitrot", 0) > 0
                and crc_found == inj_by_mode["bitrot"],
            "fsync_fail_evidenced":
                inj_by_mode.get("fsync", 0) > 0
                and disk_ops.get("fsync", 0) == inj_by_mode["fsync"],
            "rename_fail_evidenced":
                inj_by_mode.get("rename", 0) > 0
                and disk_ops.get("checkpoint", 0)
                == inj_by_mode["rename"],
            "manifest_intact": manifest_intact and rename_survived > 0,
            "gc_crash_survived": gc_crashes >= 1
                and inj_gc_crashes >= 1,
            "replay_after_gc_identical": replay_after_gc_ok
                and gc_restore_ok,
            "live_scrub_clean": bool((scrub_rep or {}).get("clean")),
            # Baseline must grow strictly while the generator runs
            # (appends never starved); the final drain-time sample may
            # tie — generation has already stopped by then. When even
            # the extension could not land 3 GC cycles (hard op cap),
            # the claim is UNTESTED on this host — report the honest
            # skip, never a red gate for being slow.
            "disk_bounded": (
                "skipped: insufficient_gc_cycles"
                if gc_cycles < 3 or len(live_bytes_series) < 3
                else (all(b2 > b1 for b1, b2 in zip(
                          baseline_bytes_series[:-1],
                          baseline_bytes_series[1:-1]))
                      and baseline_bytes_series[-1]
                      >= baseline_bytes_series[-2]
                      and live_bytes_series[-1] * 2
                      < baseline_bytes_series[-1])),
        }
        disk_failures = sorted(k for k, ok in checks.items() if not ok)
        disk_summary = {
            "fsync": args.fsync, "rotate_bytes": rotate_bytes,
            "plan": os.path.relpath(args.disk_plan),
            "injected_by_mode": inj_by_mode,
            "gc_crashes_injected": inj_gc_crashes,
            "durability_sheds_by_reason": shed_reasons,
            "serve_disk_events_by_op": disk_ops,
            "gc_cycles": gc_cycles, "gc_crashes": gc_crashes,
            "extension_s": extended_s,
            "extension_cap_ops": ext_cap_ops,
            "rename_survived": rename_survived,
            "live_bytes_series": live_bytes_series,
            "baseline_bytes_series": baseline_bytes_series,
            "final_live_bytes": final_live_bytes,
            "scrub": {"clean": bool((scrub_rep or {}).get("clean")),
                      "crc_failures": crc_found,
                      "torn": torn_found,
                      "live_segments":
                          len((scrub_rep or {}).get("segments") or []),
                      "retired_segments":
                          len(retired_rep.get("segments") or [])},
            "checks": checks,
        }

    summary = {
        "rate_mult": args.rate_mult,
        "steady_per_s": round(steady_per_s, 2),
        "offered_per_s": round(offered_per_s, 2),
        "offered": gen.offered, "gen_admitted": gen.admitted,
        "gen_refused": gen.refused,
        "admitted_ops": stats_total["admitted_ops"],
        "admitted_batches": stats_total["admitted_batches"],
        "journal_entries": journal_entries,
        "ticks": ticks, "waves_per_s": waves_per_s,
        "max_depth": stats_total["max_depth"],
        "max_ops": args.max_ops,
        "sheds": stats_total["sheds"], "shed_by_rung": by_rung,
        "shed_events": len(shed_events),
        "p50_ms": conv["p50_ms"], "p99_ms": conv["p99_ms"],
        "pending": summary_lag["pending"],
        "t_batch_ms": t_batch_final,
        "control_changes": control_changes,
        "floor_ms": round(floor_ms, 3),
        "crashes": crashes, "mttr_ms": mttr_ms,
        "chaos_injects": chaos_injects,
        "fsync": args.fsync,
        "batched": batched,
        "dispatch": dispatch_summary,
        "restore_bit_identical": bool(restore_ok),
        "oracle_mismatches": mismatched,
    }
    if disk_summary is not None:
        summary["disk"] = disk_summary
    print("serve soak:", json.dumps(summary, indent=1), flush=True)

    if stats_total["max_depth"] > args.max_ops:
        print("serve soak: QUEUE DEPTH BOUND VIOLATED", flush=True)
        return EXIT_DEPTH
    if stats_total["sheds"] != len(shed_events):
        print(f"serve soak: UNEVIDENCED SHEDS (stats "
              f"{stats_total['sheds']} != events {len(shed_events)})",
              flush=True)
        return EXIT_UNEVIDENCED_SHED
    if mismatched or not restore_ok:
        print("serve soak: CONVERGENCE GATE FAILED "
              f"(restore_ok={restore_ok}, mismatched={mismatched})",
              flush=True)
        return EXIT_CONVERGENCE
    if args.chaos == "crash" and crashes < 2:
        print(f"serve soak: chaos armed but only {crashes} crash(es) "
              "fired — the no-loss claim was not exercised",
              flush=True)
        return EXIT_CONVERGENCE
    if args.chaos == "disk" and disk_failures:
        print(f"serve soak: DISK GATES FAILED: {disk_failures}",
              flush=True)
        return EXIT_DISK
    if args.gate_dispatch:
        # the batched tick's whole claim: dispatches scale with the
        # BUCKET count, not the touched-tenant count. Allowances are
        # explicit and evidenced: a fallback's full-width wave is ~3
        # dispatches, a digest-gated restore ~2, and each touched
        # tick gets one dispatch of slack (capacity-growth full
        # re-uploads on a growing document)
        bound = (buckets_total + 3 * fallbacks_run + 2 * restores_run
                 + len(tick_series))
        collapsed = (batched and disp_total <= bound
                     and disp_total < 3 * max(1, touches_total))
        if not collapsed:
            print("serve soak: DISPATCH COLLAPSE GATE FAILED "
                  f"(batched={batched}, dispatches {disp_total} vs "
                  f"bucket-bound {bound}, 3x-touches "
                  f"{3 * touches_total}): {dispatch_summary}",
                  flush=True)
            return EXIT_DISPATCH
        print(f"serve soak: dispatch collapse held — {disp_total} "
              f"dispatch(es) over {touches_total} tenant-touches in "
              f"{len(tick_series)} tick(s) ({buckets_total} bucket "
              f"dispatch(es), {fallbacks_run} fallback(s), "
              f"{restores_run} restore(s))", flush=True)

    try:
        if args.chaos == "disk":
            row_kind = "disk"
            metric = "disk soak live WAL bytes after final GC"
            value = final_live_bytes
        else:
            row_kind = "serve"
            metric = "serve soak p99 admitted-op lag"
            value = conv["p99_ms"]
        row = ledger.ingest_record(
            {
                "platform": platform_of(dev),
                "metric": metric,
                "value": value,
                "kernel": row_kind,
                "config": f"tenants={args.tenants} cap={capacity} "
                          f"mult={args.rate_mult:g} "
                          f"max_ops={args.max_ops} "
                          f"chaos={args.chaos or 'off'} "
                          f"fsync={args.fsync} "
                          f"batched={args.batched}",
                "smoke": False,
            },
            source=f"serve-soak seed={args.seed} "
                   f"seconds={args.seconds:g}",
            obs_jsonl=args.obs_out,
            kind=row_kind,
            extra={row_kind: {k: v for k, v in summary.items()
                              if k != "oracle_mismatches"},
                   "card": card},
        )
        print(f"serve soak: ledger row ({row['platform']}) -> "
              f"{ledger.default_path()}", flush=True)
    except Exception as e:  # noqa: BLE001 - best-effort ledger append
        print(f"serve soak: ledger append skipped "
              f"({type(e).__name__}: {e})", flush=True)

    if args.slo_ms is not None:
        if conv["p99_ms"] is None or conv["p99_ms"] > args.slo_ms:
            print(f"serve soak: LAG GATE BREACH (p99 "
                  f"{conv['p99_ms']} ms > {args.slo_ms:g} ms)",
                  flush=True)
            return EXIT_LAG
    print(f"serve soak: clean — {stats_total['admitted_ops']} op(s) "
          f"admitted, {stats_total['sheds']} shed(s) all evidenced, "
          f"{crashes} crash(es) survived, every tenant bit-identical "
          f"to the journal oracle", flush=True)
    return 0


if __name__ == "__main__":
    rc = main()
    chaos.reset()
    sys.exit(rc)
