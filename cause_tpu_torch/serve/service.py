"""The long-lived serving loop: admission → coalesce → wave, with a
crash-safe lifecycle. The port of ``cause_tpu.serve.service``.

One :class:`SyncService` owns the three serve pieces (queue,
controller, residency) plus the per-tenant journal watermarks:

- **tick** — drain admitted batches, route each per-site delta to its
  tenant pair's side (stable site hash), apply through the validated
  merge path (``sync.apply_delta``), splice the appends into the
  resident session (``FleetSession.update``) and wave: batched, one
  ``batched_delta_weave`` dispatch per pow2 bucket over every touched
  tenant (``serve.batch``; the B1, B2 and B3 kernels on the card), or
  one wave per tenant with ``batched=False``;
- **watchdog** — a daemon thread watching the tick heartbeat, firing
  once per excursion past ``watchdog_s`` (one ``serve.watchdog`` event
  per excursion with telemetry on);
- **drain** — stop admission → flush the queue (deferred entries
  included) → every tenant wave-current → checkpoint everything
  (per-tenant packs + one atomic manifest with the journal
  watermarks);
- **restore** — rebuild every tenant from its pack (digest
  bit-identity gated), then replay the ingest journal ABOVE
  each tenant's manifest watermark — so a crash at ANY point between
  admission and checkpoint loses zero admitted ops (the journal is
  write-ahead; replayed merges are idempotent). The restored fleet resumes steady-state DELTA waves
  (the frontier rides the pack).

Chaos: the engine's crash points (``serve.tick`` / ``serve.drain``)
raise :class:`ServiceCrashed` — the harness drops the service object
(all in-memory state: queue contents, sessions, watermarks) and calls
:meth:`SyncService.restore`, exactly the soak's session-crash shape
one level up.

Devices: every session the service builds (``add_tenant``, ``restore``,
a residency restore) lands on the package default device
(``use_device``) and raises without a card unless the CPU was asked
for. Only the ticking thread touches CUDA; admission, the journal and a
net server's connection threads stay on the host.

Telemetry (``obs`` on): construction attaches a live fold
(``obs.live.attach``) with the controller's ``on_alert`` as its alert
callback; each tick polls it and feeds the snapshot to
``BatchController.update``, emits ``serve.tick`` and a
``run.heartbeat``, and reads the tick's ``wave_dispatches`` from the
cost model's ``costmodel.dispatches`` counter (0 with telemetry off, as
in the reference). With ``CAUSE_TPU_OBS_SHIP=host:port`` set,
construction also attaches the telemetry uplink
(``obs.ship.attach_exporter``), whose pump thread ships every record to
that collector from the host. ``close()`` detaches the subscriber and
flushes and closes the uplink.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Dict, List, Optional

from .. import chaos as _chaos
from .. import obs
from .. import serde
from .. import sync
from ..collections import shared as s
from ..obs import xtrace
from .batch import BatchScheduler
from .controller import BatchController
from .ingest import IngestQueue, _Entry
from .residency import ResidencyManager
from .wal import fsync_dir, open_journal

__all__ = ["ServiceCrashed", "SyncService"]

MANIFEST_VERSION = 1
MANIFEST_NAME = "serve_manifest.json"


class ServiceCrashed(RuntimeError):
    """A chaos-injected service crash: the harness must drop this
    instance and ``SyncService.restore`` from the last checkpoint +
    journal. Nothing else in the repo raises it."""


class SyncService:
    """See the module docstring. Construction wires the live
    attachment (obs on) with the controller registered as the alert
    callback; tenants register via :meth:`add_tenant` (or arrive via
    :meth:`restore`)."""

    def __init__(self, queue: IngestQueue,
                 controller: Optional[BatchController] = None,
                 residency: Optional[ResidencyManager] = None,
                 checkpoint_dir: Optional[str] = None,
                 d_max: int = 64, watchdog_s: Optional[float] = None,
                 batched: bool = True):
        self.queue = queue
        if queue.tenant_known is None:
            # close the front door to uuids nobody serves — such an op
            # would be journaled and acknowledged but never appliable
            queue.tenant_known = self._knows_tenant
        self.controller = controller or BatchController()
        self.residency = residency or ResidencyManager(capacity=64)
        # cross-tenant batched ticks: touched tenants' delta
        # windows ride ONE fused dispatch per pow2 bucket instead of
        # one wave per tenant. ``batched=False`` is the escape hatch —
        # the per-tenant path, kept for the bit-identity pin and for
        # bisection; digests, journal contents and lag resolution are
        # identical either way.
        self.batched = bool(batched)
        self.residency.batched = self.batched
        self._scheduler = BatchScheduler()
        self.checkpoint_dir = checkpoint_dir
        self.d_max = int(d_max)
        self.watchdog_s = watchdog_s
        self.tenants: Dict[str, dict] = {}  # uuid -> {"applied_seq"}
        self.ticks = 0
        self.last_tick_us = 0
        self._watchdog_thread = None
        self._watchdog_stop = threading.Event()
        self._watchdog_firing = False
        self._live = None
        self._ship = None
        if obs.enabled():
            from ..obs import live as _live

            self._live = _live.attach(
                on_alert=[self.controller.on_alert], source="serve")
            # the fleet telemetry uplink — every obs record this
            # process mints ships to the collector named by
            # CAUSE_TPU_OBS_SHIP ("host:port"). Best-effort by
            # contract: an unreachable collector costs a bounded
            # buffer + evidenced drops, never admission latency; an
            # unparseable endpoint is ignored (the local sidecar
            # still has everything). The exporter's pump thread stays
            # on the host.
            endpoint = ship_mod = None
            raw = os.environ.get("CAUSE_TPU_OBS_SHIP")
            if raw:
                from ..obs import ship as ship_mod

                endpoint = ship_mod.parse_endpoint(raw)
            if endpoint is not None:
                self._ship = ship_mod.attach_exporter(*endpoint)

    # ------------------------------------------------------- tenants

    def _knows_tenant(self, uuid: str) -> bool:
        return uuid in self.tenants

    def add_tenant(self, left, right,
                   d_max: Optional[int] = None) -> str:
        """Register one tenant document as the replica pair (left,
        right) — distinct sites of one uuid. Uploads the session and
        runs the first (full) wave so the tenant is immediately
        checkpointable/evictable. ``d_max`` overrides the service's
        delta budget for THIS tenant (a hot tenant earns a wider
        window); tenants with different budgets land in different
        pow2 batch buckets — heterogeneity costs extra dispatches per
        tick, never correctness."""
        from ..parallel.session import FleetSession

        uuid = str(left.ct.uuid)
        if uuid in self.tenants:
            # evolve() KEEPS the uuid, so two tenants built from one
            # ancestor collide here — and a silent overwrite would
            # cross-wire both tenants' journal watermarks and residency
            # slots. Mint a fresh clist per tenant instead.
            if obs.enabled():
                obs.counter("serve.refusals").inc()
                obs.event("serve.refusal", op="add_tenant",
                          why="duplicate-tenant", uuid=uuid)
            raise s.CausalError(
                "serve: duplicate tenant uuid",
                {"causes": {"duplicate-tenant"}, "uuid": uuid,
                 "why": "evolve() keeps the uuid — a second tenant "
                        "must start from a fresh clist, not an "
                        "evolve() of an already-registered one"})
        sess = FleetSession([(left, right)],
                            d_max=self.d_max if d_max is None
                            else int(d_max))
        sess.wave()
        self.residency.insert(uuid, sess)
        self.tenants[uuid] = {"applied_seq": 0}
        return uuid

    # ---------------------------------------------------------- tick

    @staticmethod
    def _side_of(site: str, side_ids) -> int:
        """Stable site→side routing: a delta from one of the pair's
        OWN sites lands on that replica (its causes live there by
        construction); a foreign site hashes to a stable side, so all
        of one site's deltas land on one side of the pair, preserving
        the per-site prefix order the delta protocol assumes."""
        site = str(site)
        if site == side_ids[0]:
            return 0
        if site == side_ids[1]:
            return 1
        return zlib.crc32(site.encode()) & 1

    def _apply_batches(self, uuid: str, entries: List,
                       sess=None, wave: bool = True):
        """COALESCE one tenant's drained batches into one wave batch
        per side, apply, and wave once — the admission queue's whole
        point: a deep backlog costs two merges of the unioned delta
        (O(coalesced ops)), not one merge per journaled batch, so the
        tick wall scales with the offered op rate, never with how far
        behind the service fell. The union is sound because a site's
        re-offered deltas are cumulative (yarn suffixes nest) and
        identical nodes union idempotently. Sides whose causes are
        not yet visible (cross-site ordering inside one tick) retry
        after the other side; a union that still fails is retried on
        the other replica before being declared poison — admitted ops
        are never silently dropped.

        ``wave=False`` stops before the wave (the batched tick waves
        all touched tenants at once via the scheduler); ``sess`` skips
        the residency touch when the caller already holds the session
        (``get_many``). Returns the session."""
        if sess is None:
            sess = self.residency.get(uuid)
        if sess is None:
            if obs.enabled():
                obs.counter("serve.refusals").inc()
                obs.event("serve.refusal", op="apply",
                          why="unknown-tenant", uuid=uuid)
            raise s.CausalError(
                "serve: batch for unknown tenant",
                {"causes": {"unknown-tenant"}, "uuid": uuid})
        left, right = sess.pairs[0]
        sides = [left, right]
        side_ids = (str(left.ct.site_id), str(right.ct.site_id))
        unions: List[dict] = [{}, {}]
        for e in entries:
            i = self._side_of(e.site, side_ids)
            unions[i].update(serde.decode_node_items(e.items))
        pending = [i for i in (0, 1) if unions[i]]
        for attempt in (0, 1):
            retry = []
            for i in pending:
                try:
                    sides[i] = sync.apply_delta(sides[i], unions[i])
                except s.CausalError as ce:
                    if "cause-must-exist" not in \
                            ce.info.get("causes", ()):
                        raise
                    if attempt == 0:
                        retry.append(i)
                        continue
                    # last resort: a foreign-site delta whose causes
                    # live only on the other replica — try the other
                    # side before declaring it poison
                    sides[1 - i] = sync.apply_delta(sides[1 - i],
                                                    unions[i])
            pending = retry
            if not pending:
                break
        sess.update([(sides[0], sides[1])])
        if wave:
            sess.wave()
        self.tenants[uuid]["applied_seq"] = max(
            self.tenants[uuid]["applied_seq"],
            max(e.seq for e in entries))
        return sess

    def tick(self, max_ops: Optional[int] = None) -> dict:
        """One service tick: drain → apply/update per touched tenant →
        wave (batched: one fused dispatch per pow2 bucket over ALL
        touched tenants; unbatched: one wave per tenant). Returns a small summary dict (ops
        drained, tenants touched, current t_batch_ms, queue depth
        after, and the tick's bucket/dispatch accounting).

        The default drain bound is ``d_max`` — the session's delta
        window budget. Coalescing more ops than the window holds
        would bounce every touched tenant to the O(doc) full-width
        wave, so a
        deep backlog drains as several cheap delta ticks instead of
        one catastrophic full one; a SINGLE batch larger than the
        window still degrades loudly rather than wedging the queue
        (the queue always yields at least one batch)."""
        if _chaos.enabled() and _chaos.should_crash("serve.tick"):
            raise ServiceCrashed("chaos: crash point at serve.tick")
        self.ticks += 1
        self.last_tick_us = time.time_ns() // 1000
        self._watchdog_firing = False
        entries = self.queue.drain(self.d_max if max_ops is None
                                   else max_ops)
        by_tenant: Dict[str, List] = {}
        for e in entries:
            by_tenant.setdefault(e.uuid, []).append(e)
        known: List = []
        for uuid, batch in by_tenant.items():
            if uuid not in self.tenants:
                # the door predicate makes this unreachable for new
                # offers; a batch admitted before its tenant vanished
                # is an orphan — skipped LOUDLY, never a crashed tick
                # that drops the other tenants' drained entries
                if obs.enabled():
                    obs.counter("serve.orphan_batches").inc()
                    obs.event("serve.orphan_batch", uuid=uuid,
                              ops=sum(e.ops for e in batch))
                continue
            known.append((uuid, batch))
        # trace continuation: every drained entry's traces get a
        # "tick" hop here and the per-tenant map rides into the
        # scheduler so the fused bucket span can fan out per-tenant
        # "wave" child hops
        traces_by_uuid: Dict[str, List[str]] = {}
        if obs.enabled():
            for uuid, batch in known:
                seen = traces_by_uuid.setdefault(uuid, [])
                for e in batch:
                    for tr in (e.traces or ()):
                        xtrace.hop("tick", tr, uuid=uuid, seq=e.seq,
                                   ops=e.ops, tick=self.ticks)
                        if tr not in seen:
                            seen.append(tr)
        # the tick's device dispatch count, read from the costmodel
        # counter (not inferred): the batched tick's whole claim is
        # that this collapses from O(#tenants) to O(#buckets)
        disp0 = obs.counter("costmodel.dispatches").value \
            if obs.enabled() else 0
        buckets = 0
        batch_rows = 0
        fallbacks = 0
        if self.batched:
            # batched tick: residency-capacity-sized groups — touch
            # the whole group first (a restore's evictions can only
            # hit tenants outside the group, which are wave-current
            # between ticks), coalesce and update every member, then
            # ONE fused dispatch per pow2 bucket via the scheduler
            cap = max(1, self.residency.capacity)
            for i in range(0, len(known), cap):
                chunk = known[i:i + cap]
                group = self.residency.get_many(
                    [u for u, _b in chunk])
                for uuid, batch in chunk:
                    self._apply_batches(uuid, batch,
                                        sess=group.get(uuid),
                                        wave=False)
                self._scheduler.wave_fleet(
                    group, traces_by_uuid=traces_by_uuid)
                buckets += self._scheduler.last_buckets
                batch_rows += self._scheduler.last_batch_rows
                fallbacks += self._scheduler.last_fallbacks
        else:
            for uuid, batch in known:
                self._apply_batches(uuid, batch)
                if obs.enabled():
                    for tr in traces_by_uuid.get(uuid, ()):
                        xtrace.hop("wave", tr, uuid=uuid,
                                   path="per-tenant")
        wave_dispatches = (obs.counter("costmodel.dispatches").value
                           - disp0) if obs.enabled() else 0
        snap = None
        if self._live is not None and not self._live.closed:
            snap = self._live.poll(emit_snapshot=True)
        if snap is not None:
            self.controller.update(snap)
        ops = sum(e.ops for e in entries)
        if obs.enabled():
            obs.counter("serve.ticks").inc()
            obs.event("serve.tick", ops=ops,
                      tenants=len(by_tenant),
                      depth=self.queue.depth,
                      resident=self.residency.resident_docs,
                      t_batch_ms=round(self.controller.t_batch_ms, 3),
                      buckets=buckets, batch_rows=batch_rows,
                      wave_dispatches=wave_dispatches,
                      fallbacks=fallbacks)
            obs.event("run.heartbeat", stage="serve.tick",
                      ticks=self.ticks, ops=ops)
        return {"ops": ops, "tenants": len(by_tenant),
                "t_batch_ms": self.controller.t_batch_ms,
                "depth": self.queue.depth,
                "buckets": buckets, "batch_rows": batch_rows,
                "wave_dispatches": wave_dispatches}

    def run(self, seconds: float, max_ops: Optional[int] = None) -> int:
        """The paced loop: tick, then sleep the controller's current
        ``T_batch`` — but only when the queue is EMPTY. The coalescing
        sleep exists to build a batch worth waving; once a backlog
        exists the batch is already built, and sleeping would add pure
        admission lag. Returns ticks run. Starts the watchdog when
        ``watchdog_s`` is set."""
        self.start_watchdog()
        deadline = time.monotonic() + float(seconds)
        n = 0
        try:
            while time.monotonic() < deadline:
                self.tick(max_ops)
                n += 1
                if self.queue.depth == 0:
                    time.sleep(self.controller.t_batch_ms / 1000.0)
        finally:
            self.stop_watchdog()
        return n

    # ------------------------------------------------------ watchdog

    def start_watchdog(self) -> None:
        if self.watchdog_s is None or self._watchdog_thread is not None:
            return
        self._watchdog_stop.clear()

        def _watch():
            while not self._watchdog_stop.wait(self.watchdog_s / 4.0):
                last = self.last_tick_us
                if not last:
                    continue
                age_s = (time.time_ns() // 1000 - last) / 1e6
                if age_s > self.watchdog_s and not self._watchdog_firing:
                    # one event per excursion — tick() re-arms
                    self._watchdog_firing = True
                    if obs.enabled():
                        obs.counter("serve.watchdog").inc()
                        obs.event("serve.watchdog",
                                  age_s=round(age_s, 3),
                                  limit_s=self.watchdog_s)

        self._watchdog_thread = threading.Thread(
            target=_watch, name="serve-watchdog", daemon=True)
        self._watchdog_thread.start()

    def stop_watchdog(self) -> None:
        if self._watchdog_thread is None:
            return
        self._watchdog_stop.set()
        self._watchdog_thread.join(timeout=2.0)
        self._watchdog_thread = None

    def close(self) -> None:
        """Release the service's process-global hooks: stop the
        watchdog, detach the live subscription, flush and detach the
        telemetry uplink and unhook the queue's tenant predicate. A
        crash/restore loop builds a fresh
        SyncService per incarnation — without this, every dead
        incarnation's subscriber stays registered on the obs sink and
        every later record pays an enqueue into it. Idempotent;
        drain() calls it once the checkpoint lands."""
        self.stop_watchdog()
        if self._live is not None:
            self._live.close()
            self._live = None
        if self._ship is not None:
            # best-effort final flush then detach — whatever cannot
            # ship in the bounded window is counted in
            # stats["unshipped"], never waited on
            self._ship.close()
            self._ship = None
        if self.queue.tenant_known == self._knows_tenant:
            # a retired queue handle must not pin this service's whole
            # object graph (residency -> every tenant's device state)
            # through the bound predicate
            self.queue.tenant_known = None

    # -------------------------------------------------- checkpointing

    def checkpoint(self, out_dir: Optional[str] = None) -> str:
        """Persist the whole service: every tenant's pack (resident
        sessions are wave-current after any tick) plus ONE manifest
        carrying the per-tenant journal watermarks, atomically
        renamed last — a crash mid-checkpoint leaves the previous
        manifest intact and the journal replays the difference."""
        out_dir = out_dir or self.checkpoint_dir
        if not out_dir:
            raise ValueError("no checkpoint dir configured")
        with obs.span("serve.checkpoint", tenants=len(self.tenants)):
            files = self.residency.checkpoint_all(out_dir)
            # the minimum live watermark: every journal record at or
            # below it is applied by its tenant AND captured by the
            # packs just written — the WAL's GC retires segments
            # wholly below it once the manifest rename lands
            min_seq = min((t["applied_seq"]
                           for t in self.tenants.values()), default=0)
            manifest = {
                "~serve_manifest": MANIFEST_VERSION,
                "ts_us": time.time_ns() // 1000,
                "journal": (self.queue.journal.path
                            if self.queue.journal else None),
                "gc_watermark": min_seq,
                # the admission regime rides the manifest so a
                # queue-less restore() rebuilds the SAME bounds — a
                # restart must not quietly relax them
                "queue": {
                    "max_ops": self.queue.max_ops,
                    "defer_watermark": self.queue.defer_watermark,
                    "defer_max": self.queue.defer_max,
                    "deadline_ms": self.queue.deadline_ms,
                },
                "residency_capacity": self.residency.capacity,
                "tenants": {
                    uuid: {"file": files[uuid]["file"],
                           "seq": self.tenants[uuid]["applied_seq"]}
                    for uuid in self.tenants if uuid in files
                },
            }
            path = os.path.join(out_dir, MANIFEST_NAME)
            tmp = f"{path}.tmp.{os.getpid()}"
            # the rename below is the commit point the post-checkpoint
            # GC trusts before it unlinks superseded packs and WAL
            # segments — fsync the contents first (and the directory
            # after) so a crash cannot persist the unlinks while
            # losing the manifest that justified them
            with open(tmp, "w") as f:
                f.write(json.dumps(manifest))
                f.flush()
                os.fsync(f.fileno())
            try:
                if _chaos.enabled() \
                        and _chaos.disk_rename_fail("serve.checkpoint"):
                    raise OSError("chaos: injected rename failure")
                os.replace(tmp, path)
            except OSError as e:
                # the atomic swap failed: the PREVIOUS manifest is
                # untouched (that is the whole point of rename-last)
                # and the journal still covers everything since it —
                # evidence the fault, drop the orphan tmp, and let the
                # caller retry the checkpoint
                try:
                    os.unlink(tmp)
                except OSError:  # pragma: no cover - best-effort
                    pass
                if obs.enabled():
                    obs.counter("serve.disk_faults").inc()
                    obs.event("serve.disk", op="checkpoint",
                              why="rename-failed", path=path)
                raise s.CausalError(
                    "serve: checkpoint manifest rename failed "
                    "(previous manifest intact)",
                    {"causes": {"checkpoint-rename"},
                     "path": path}) from e
            fsync_dir(out_dir)
            if obs.enabled():
                obs.counter("serve.checkpoints").inc()
            self._storage_gc(out_dir, min_seq, manifest)
        return path

    def _storage_gc(self, out_dir: str, min_seq: int,
                    manifest: dict) -> None:
        """Post-checkpoint retention, one policy for all three
        storage surfaces: retire WAL segments wholly below the
        manifest's watermark (crash-safe inside ``wal.gc``), sweep
        superseded checkpoint packs + orphaned tmp files out of the
        checkpoint dir, and sweep stale residency spill packs. Runs
        only AFTER the manifest rename landed — everything removed is
        re-derivable from the manifest + surviving journal suffix.

        The checkpoint dir is assumed EXCLUSIVE to one service: the
        sweep removes every ``*.ckpt.json``/``.tmp.`` file the current
        manifest doesn't name, deliberately including debris a crashed
        prior incarnation left behind (whose in-memory ownership is
        unrecoverable). Two services — or an operator's manual
        checkpoint — sharing one directory WOULD have their packs
        swept by each other; point each at its own directory."""
        j = self.queue.journal
        wal_gc = None
        if j is not None and hasattr(j, "gc"):
            wal_gc = j.gc(min_seq)
        live = {info["file"] for info in manifest["tenants"].values()}
        live.add(MANIFEST_NAME)
        swept = swept_bytes = 0
        for name in os.listdir(out_dir):
            if name in live:
                continue
            if not (name.endswith(".ckpt.json") or ".tmp." in name):
                continue  # never touch files this service didn't write
            fp = os.path.join(out_dir, name)
            try:
                nb = os.path.getsize(fp)
                os.unlink(fp)
            except OSError:
                continue
            swept += 1
            swept_bytes += nb
        spill_bytes = self.residency.sweep_spill()
        if obs.enabled():
            obs.event("serve.gc", watermark=min_seq,
                      wal_retired=(wal_gc or {}).get("retired", 0),
                      wal_retired_bytes=(wal_gc or {}).get(
                          "retired_bytes", 0),
                      wal_aborted=bool((wal_gc or {}).get("aborted")),
                      packs_swept=swept,
                      packs_swept_bytes=swept_bytes,
                      spill_swept_bytes=spill_bytes)

    def drain(self, out_dir: Optional[str] = None) -> str:
        """Graceful drain: stop admission → flush the queue (deferred
        promotion included) → converge (every touched tenant waves in
        its flush tick; the fleet state IS a wave's output) →
        checkpoint. Returns the manifest path. The chaos crash point
        ``serve.drain`` fires between flush ticks — a crash mid-drain
        restores from the previous checkpoint + journal with zero
        admitted-op loss."""
        self.queue.close_admission()
        if obs.enabled():
            obs.event("serve.drain", phase="start",
                      depth=self.queue.depth,
                      deferred=self.queue.deferred)
        while self.queue.depth or self.queue.deferred:
            if _chaos.enabled() and _chaos.should_crash("serve.drain"):
                raise ServiceCrashed(
                    "chaos: crash point at serve.drain")
            before_depth = self.queue.depth
            before_def = self.queue.deferred
            self.tick()
            if before_depth == 0 and self.queue.depth == 0 \
                    and self.queue.deferred >= before_def:
                # a whole tick neither drained nor promoted anything:
                # the parked entries can never promote (a single batch
                # larger than the defer watermark) — shed them with
                # evidence rather than spin; they were never admitted
                # (never journaled), so the no-loss contract holds.
                # NOTE the exit condition is exact, not a heuristic:
                # the loop only ever ends with depth == 0 AND
                # deferred == 0 — a promotion that lands new admitted
                # (journaled) ops in the queue forces another flush
                # tick, so the checkpoint below can never strand an
                # admitted op (that hole is what the journal replay
                # would otherwise have to cover)
                self.queue.shed_stranded()
        path = self.checkpoint(out_dir)
        if obs.enabled():
            obs.event("serve.drain", phase="done",
                      tenants=len(self.tenants))
        self.close()
        return path

    def converged_digest(self, uuid: str) -> int:
        """The tenant's last wave digest — the drain/restart
        bit-identity gate's comparand (one int per tenant)."""
        sess = self.residency.get(uuid)
        return int(sess._last_digest[0])

    def materialize(self, uuid: str):
        """The tenant's converged document (host handle) from the
        resident wave state — the oracle comparison surface."""
        sess = self.residency.get(uuid)
        return sess.merged(0)

    # -------------------------------------------------------- restore

    @classmethod
    def restore(cls, checkpoint_dir: str,
                queue: Optional[IngestQueue] = None,
                controller: Optional[BatchController] = None,
                residency: Optional[ResidencyManager] = None,
                d_max: int = 64,
                watchdog_s: Optional[float] = None,
                batched: bool = True) -> "SyncService":
        """Rebuild a service from :meth:`checkpoint` output: every
        tenant restored through the digest gate, then the ingest
        journal replayed above each tenant's watermark (validated
        again at the boundary — a journal is a file, files tear).
        The restored tenants resume steady-state delta waves."""
        from ..parallel.session import FleetSession

        if os.path.basename(checkpoint_dir) == MANIFEST_NAME:
            # drain() returns the manifest PATH; accept it here too so
            # restore(drain()) round-trips without a dirname() dance
            checkpoint_dir = os.path.dirname(checkpoint_dir)
        mpath = os.path.join(checkpoint_dir, MANIFEST_NAME)
        with open(mpath) as f:
            manifest = json.load(f)
        if not (isinstance(manifest, dict)
                and manifest.get("~serve_manifest") == MANIFEST_VERSION):
            # causelint: disable-next-line=EVD001 -- restore() runs pre-stream at process start; the raise reaches the operator directly and there is no obs stream to evidence into yet
            raise s.CausalError(
                "not a serve manifest (or unknown version)",
                {"causes": {"checkpoint-mismatch"}})
        journal_path = manifest.get("journal")
        if queue is None:
            # open_journal routes a directory to the segmented WAL
            # and a legacy single-file path to IngestJournal — old
            # manifests restore unchanged
            journal = (open_journal(journal_path)
                       if journal_path else None)
            qcfg = manifest.get("queue") or {}
            queue = IngestQueue(
                max_ops=int(qcfg.get("max_ops", 4096)),
                defer_max=int(qcfg.get("defer_max", 256)),
                deadline_ms=qcfg.get("deadline_ms"),
                journal=journal)
            if "defer_watermark" in qcfg:
                queue.defer_watermark = int(qcfg["defer_watermark"])
        if residency is None and manifest.get("residency_capacity"):
            residency = ResidencyManager(
                capacity=int(manifest["residency_capacity"]))
        svc = cls(queue, controller=controller, residency=residency,
                  checkpoint_dir=checkpoint_dir, d_max=d_max,
                  watchdog_s=watchdog_s, batched=batched)
        with obs.span("serve.restore",
                      tenants=len(manifest.get("tenants") or {})):
            for uuid, info in (manifest.get("tenants") or {}).items():
                sess = FleetSession.restore(
                    os.path.join(checkpoint_dir, info["file"]))
                svc.residency.insert(uuid, sess)
                svc.tenants[uuid] = {"applied_seq": int(info["seq"])}
            replayed = svc._replay_journal(journal_path)
            if obs.enabled():
                obs.counter("serve.journal_replays").inc(replayed)
                obs.event("serve.restored",
                          tenants=len(svc.tenants), replayed=replayed)
        return svc

    def _replay_journal(self, journal_path: Optional[str]) -> int:
        """Apply journal entries above each tenant's watermark —
        admission-order, re-validated, grouped per tenant so each
        touched tenant pays one update+wave. Returns ops replayed.
        Idempotence: merges of already-present nodes are no-ops."""
        if not journal_path or not os.path.exists(journal_path):
            return 0
        min_seq = min((t["applied_seq"] for t in self.tenants.values()),
                      default=0)
        by_tenant: Dict[str, List] = {}
        # replay the MANIFEST's journal, not whatever journal the
        # caller's queue happens to carry — a restart that rotates to
        # a fresh journal file must still replay the old one, or every
        # op admitted after the last checkpoint silently vanishes
        qj = self.queue.journal
        if qj is not None and qj.path == journal_path:
            journal, borrowed = qj, True
        else:
            journal, borrowed = open_journal(journal_path), False
        for e in journal.iter_from(min_seq):
            uuid = str(e.get("uuid"))
            t = self.tenants.get(uuid)
            if t is None or int(e["seq"]) <= t["applied_seq"]:
                continue
            items = e.get("items")
            try:
                sync.validate_node_items(items)
            except s.CausalError:
                # a torn journal VALUE (valid JSON, poisoned payload)
                # cannot reach a merge — counted, skipped, loud in the
                # stream
                if obs.enabled():
                    obs.counter("serve.journal_rejects").inc()
                    obs.event("serve.journal_reject", seq=e.get("seq"),
                              uuid=uuid)
                continue
            # re-link the journey: a journal row written by an obs-on
            # process carries its batch's trace ids — the restored
            # process continues those chains ("replay" hop, ops
            # re-bound for the lag join) instead of orphaning them
            traces = None
            if obs.enabled():
                raw = e.get("trace")
                if isinstance(raw, list):
                    traces = [str(tr) for tr in raw[:16]
                              if isinstance(tr, str) and tr]
                for tr in (traces or ()):
                    xtrace.hop("replay", tr, uuid=uuid, seq=int(e["seq"]))
                    xtrace.bind_ops(tr, [tuple(it[0]) for it in items])
            by_tenant.setdefault(uuid, []).append(
                _Entry(uuid, str(e.get("site")), items, len(items),
                       int(e["seq"]), int(e.get("ts_us") or 0),
                       traces=traces))
        ops = 0
        for uuid, batch in by_tenant.items():
            self._apply_batches(uuid, batch)
            ops += sum(x.ops for x in batch)
            if obs.enabled():
                # replayed entries never re-enter the queue (no tick
                # hop): the replay's own per-tenant wave is the
                # journey's next edge after "replay"
                seen: List[str] = []
                for x in batch:
                    for tr in (x.traces or ()):
                        if tr not in seen:
                            seen.append(tr)
                            xtrace.hop("wave", tr, uuid=uuid,
                                       path="replay")
        # torn/corrupt lines were COUNTED by the scan; any skip on a
        # replay is evidence (a torn tail is expected after a crash;
        # CRC corruption never is — both deserve an alert, not a
        # buried counter)
        torn = int(getattr(journal, "skipped", 0) or 0)
        rot = int(getattr(journal, "corrupt", 0) or 0)
        if (torn or rot) and obs.enabled():
            obs.counter("serve.journal_torn").inc(torn + rot)
            obs.event("serve.journal_torn", skipped=torn, corrupt=rot,
                      journal=journal_path)
        if not borrowed:
            journal.close()
        return ops
