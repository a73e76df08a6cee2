"""Bounded-queue admission: the host side of the SafarDB offload split.

A copy of ``cause_tpu.serve.ingest`` without its telemetry (the
``serve.shed`` events, counters and trace hops come back with the
telemetry port); the stats, the refusals and the journal bytes are the
reference's.

The admission queue is the seam where the service meets the world, and
it is designed around three refusals:

- **poison never enters the queue** — every offered payload runs
  ``sync.validate_node_items`` (plus the CRC when the frame carries
  one) AT THE BOUNDARY; a failing payload is rejected through the
  offender machinery (``sync.note_reject``, repeat offenders
  quarantined) and a quarantined site's
  offers are refused outright until the usual full-bag resync
  re-admits it. Validation happens once, here: everything downstream
  (journal, drain, replay) trusts admitted bytes.
- **admitted ops are never lost** — admission is WRITE-AHEAD: the op
  batch lands in the append-only ingest journal before the offer is
  acknowledged, so a crash at any later point replays it (idempotent:
  CRDT merges re-apply harmlessly). Only *unadmitted* work
  (deferred or rejected offers) can ever be shed.
- **overload is a declared policy, not an accident** — when depth
  crosses the ladder's watermarks the queue sheds in a fixed order:

  1. ``defer`` — offers for COLD tenants (below the hot-share
     threshold of the decaying per-tenant rate) are parked unadmitted
     in a bounded side buffer and promoted when depth falls;
  2. ``reject`` — at capacity (or when the deadline-aware estimate
     says the op would miss its admission deadline anyway), the offer
     is refused with a ``retry_after_ms`` hint;
  3. ``drop_oldest`` — the defer buffer overflowing drops its OLDEST
     *unadmitted* entry to make room.

  An orthogonal ``durability`` rung: when the write-ahead
  journal itself refuses the append (ENOSPC, torn write — the chaos
  ``disk`` family or a real storage fault), the offer is refused with
  ``retry_after_ms`` instead of acknowledged — an unappendable
  journal must NEVER ack, or a crash would lose an "admitted" op.

  Every shed — every rung — is counted in the queue's ``stats``.

Stdlib + this package's ``sync`` only: admission is host work by
design (the accelerator owns merge, nothing else), and this module
imports nothing of torch itself.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Iterator, List, Optional

from .. import sync
from ..collections import shared as s

__all__ = ["Admission", "IngestJournal", "IngestQueue"]

# decaying per-tenant admission rate: half-life of the hotness score
_HOT_HALF_LIFE_S = 10.0
_HOT_MAX = 4096  # hotness registry LRU bound (entries)
_HOT_MEAN_TTL_US = 100_000  # cached fleet-mean hotness lifetime
# a tenant is COLD when its decayed score falls below this fraction of
# the mean tenant score (1.0 == exactly the fair share)
_COLD_FRAC = 0.5
# drain-rate EMA smoothing (per drain call)
_RATE_ALPHA = 0.3
# backpressure hint when the JOURNAL refuses the write and no drain
# rate is measured yet: storage faults are transient on the chaos
# timescale, so a short fixed retry beats no hint at all
_DURABILITY_RETRY_MS = 50.0


class Admission:
    """One offer's outcome. ``admitted`` with a journal ``seq`` on
    success; otherwise ``rung`` names the refusal (``"poison"`` /
    ``"quarantined"`` for boundary rejects, ``"defer"`` / ``"reject"``
    for sheds) and ``retry_after_ms`` carries the backpressure hint
    where one exists."""

    __slots__ = ("admitted", "seq", "rung", "reason", "retry_after_ms")

    def __init__(self, admitted: bool, seq: int = -1, rung: str = "",
                 reason: str = "", retry_after_ms: Optional[float] = None):
        self.admitted = admitted
        self.seq = seq
        self.rung = rung
        self.reason = reason
        self.retry_after_ms = retry_after_ms

    def __repr__(self):  # pragma: no cover - debugging nicety
        if self.admitted:
            return f"Admission(admitted, seq={self.seq})"
        return (f"Admission({self.rung}"
                + (f"/{self.reason}" if self.reason else "") + ")")


class IngestJournal:
    """The write-ahead ingest journal: one JSON line per admitted
    batch (``{"seq", "uuid", "site", "items", "ts_us"}``), O_APPEND +
    flush-per-append so a crashed process loses at most the torn
    trailing line it never acknowledged. ``iter_from`` replays
    entries above a watermark, skipping torn/garbage lines (counted,
    never silent)."""

    __slots__ = ("path", "_fh", "_seq", "_lock", "skipped")

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self.skipped = 0
        self._seq = 0
        # resume the seq counter past any existing journal (a restored
        # service appends to the same journal its checkpoint names)
        for e in self._scan():
            self._seq = max(self._seq, int(e.get("seq", 0)))
        self._fh = open(self.path, "a", encoding="utf-8")

    def _scan(self) -> Iterator[dict]:
        # ``skipped`` is the torn-line count of the LATEST scan, not a
        # lifetime accumulator — the constructor's seq-resume scan and
        # every replay walk the same file, and summing them would
        # over-report one torn line as several
        self.skipped = 0
        if not os.path.exists(self.path):
            return
        with open(self.path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except ValueError:
                    self.skipped += 1
                    continue
                if isinstance(e, dict) and "seq" in e:
                    yield e
                else:
                    self.skipped += 1

    def append(self, uuid: str, site: str, items: list,
               ts_us: Optional[int] = None,
               trace: Optional[list] = None) -> int:
        """Durably record one admitted batch; returns its seq. The
        write happens BEFORE the queue acknowledges admission — the
        no-admitted-op-lost contract hangs on that order. ``trace``
        (a list of trace ids) is recorded only when given; without it
        the journal bytes are the reference's obs-off bytes."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            rec = {"seq": seq, "uuid": str(uuid), "site": str(site),
                   "items": items,
                   "ts_us": int(ts_us if ts_us is not None
                                else time.time_ns() // 1000)}
            if trace:
                rec["trace"] = list(trace)
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return seq

    def iter_from(self, min_seq_exclusive: int = 0) -> Iterator[dict]:
        """Entries with ``seq > min_seq_exclusive``, journal order."""
        for e in self._scan():
            if int(e.get("seq", 0)) > int(min_seq_exclusive):
                yield e

    def close(self) -> None:
        with self._lock:
            try:
                self._fh.close()
            except OSError:  # pragma: no cover - close is best-effort
                pass


class _Entry:
    __slots__ = ("uuid", "site", "items", "ops", "seq", "ts_us",
                 "traces")

    def __init__(self, uuid, site, items, ops, seq, ts_us,
                 traces=None):
        self.uuid = uuid
        self.site = site
        self.items = items
        self.ops = ops
        self.seq = seq
        self.ts_us = ts_us
        # trace ids riding this batch (None without telemetry)
        self.traces = traces


class IngestQueue:
    """The bounded admission queue (module docstring). Thread-safe:
    generators offer from their own threads while the service thread
    drains.

    ``max_ops`` bounds the ADMITTED depth (ops, not batches) — the
    structural guarantee the soak gates; ``defer_frac`` is the
    high-watermark fraction where cold-tenant deferral starts;
    ``defer_max`` bounds the unadmitted side buffer (entries);
    ``deadline_ms``, when set, refuses offers whose estimated queue
    wait already exceeds it (deadline-aware admission: shedding at
    the door beats admitting work that will miss its SLO anyway)."""

    def __init__(self, max_ops: int = 4096, defer_frac: float = 0.75,
                 defer_max: int = 256,
                 deadline_ms: Optional[float] = None,
                 journal: Optional[IngestJournal] = None,
                 tenant_known: Optional[Callable[[str], bool]] = None):
        if max_ops < 1:
            raise ValueError("max_ops must be >= 1")
        self.max_ops = int(max_ops)
        self.defer_watermark = max(1, int(defer_frac * max_ops))
        self.defer_max = int(defer_max)
        self.deadline_ms = deadline_ms
        self.journal = journal
        # optional tenant-existence predicate (SyncService wires its
        # registry in): an offer for a uuid nobody serves is refused
        # at the door — admitting it would journal an op no tenant
        # can ever apply
        self.tenant_known = tenant_known
        self._lock = threading.Lock()
        self._q: deque = deque()
        self._deferred: deque = deque()
        self._depth = 0              # admitted ops pending
        self._seq = 0                # journal-less fallback counter
        self._closed = False
        self._drain_ops_per_s = 0.0  # EMA, the deadline estimator
        # uuid -> [score, t_us]; LRU-bounded at _HOT_MAX (the repo's
        # every-registry-bounded invariant) — the LRU tail is by
        # construction the coldest claim, so evicting it never
        # promotes a hot tenant to "cold"
        self._hot: "OrderedDict[str, List[float]]" = OrderedDict()
        self._hot_mean = (None, 0)  # (cached mean, computed_at_us)
        self.stats = {
            "admitted_ops": 0, "admitted_batches": 0,
            "poison_rejects": 0, "quarantine_refusals": 0,
            "unknown_tenant_rejects": 0,
            "sheds": 0, "shed_ops": 0, "max_depth": 0,
            "shed_by_rung": {"defer": 0, "reject": 0,
                             "drop_oldest": 0, "durability": 0},
            "deferred_promoted": 0,
        }

    # ------------------------------------------------------- helpers

    @property
    def depth(self) -> int:
        with self._lock:
            return self._depth

    @property
    def deferred(self) -> int:
        with self._lock:
            return len(self._deferred)

    @property
    def closed(self) -> bool:
        return self._closed

    def _now_us(self, now_us):
        return int(now_us if now_us is not None
                   else time.time_ns() // 1000)

    def _touch_hot(self, uuid: str, ops: int, now_us: int) -> None:
        ent = self._hot.get(uuid)
        if ent is None:
            while len(self._hot) >= _HOT_MAX:
                self._hot.popitem(last=False)
            self._hot[uuid] = [float(ops), float(now_us)]
            return
        dt_s = max(0.0, (now_us - ent[1]) / 1e6)
        ent[0] = ent[0] * (0.5 ** (dt_s / _HOT_HALF_LIFE_S)) + ops
        ent[1] = float(now_us)
        self._hot.move_to_end(uuid)

    def _is_cold(self, uuid: str, now_us: int) -> bool:
        """Cold = decayed admission score below _COLD_FRAC of the mean
        tenant score. A tenant the queue has never seen is cold by
        definition (it has no claim on a congested queue yet).

        The mean is cached for ``_HOT_MEAN_TTL_US``: recomputing it is
        an O(registry) scan under the queue lock, and this method only
        runs on congested offers — exactly when offer latency matters
        most. Only the caller's own score is decayed per call (O(1));
        the mean moves on the half-life timescale, far slower than the
        TTL."""
        if not self._hot:
            return False
        mean, computed = self._hot_mean
        if mean is None or now_us - computed > _HOT_MEAN_TTL_US:
            total = 0.0
            for score, t in self._hot.values():
                total += score * (0.5 ** (max(0.0, (now_us - t) / 1e6)
                                          / _HOT_HALF_LIFE_S))
            mean = total / len(self._hot)
            self._hot_mean = (mean, now_us)
        ent = self._hot.get(uuid)
        mine = 0.0
        if ent is not None:
            mine = ent[0] * (0.5 ** (max(0.0, (now_us - ent[1]) / 1e6)
                                     / _HOT_HALF_LIFE_S))
        return mine < _COLD_FRAC * mean

    def _retry_after_ms(self, extra_ops: int = 0) -> Optional[float]:
        """How long until the queue has plausibly drained to its
        defer watermark — the backpressure hint a rejected producer
        should honor. None until a drain rate is measured."""
        if self._drain_ops_per_s <= 0:
            return None
        backlog = max(0, self._depth + extra_ops - self.defer_watermark)
        return round(1000.0 * backlog / self._drain_ops_per_s, 3)

    def _shed(self, rung: str, reason: str, uuid: str, site: str,
              ops: int, retry_after_ms: Optional[float] = None,
              traces=None) -> None:
        """The one funnel every shed goes through: the stats (the
        reference also emits its ``serve.shed`` event here). Called
        under the lock."""
        self.stats["sheds"] += 1
        self.stats["shed_ops"] += ops
        self.stats["shed_by_rung"][rung] += 1

    # ------------------------------------------------------ admission

    def offer(self, uuid: str, site: str, items: list,
              crc: Optional[int] = None,
              now_us: Optional[int] = None,
              traces: Optional[list] = None) -> Admission:
        """Offer one per-site delta batch (``serde.encode_node_items``
        wire form) for tenant ``uuid``. See the module docstring for
        the refusal ladder. Validation runs OUTSIDE the queue lock
        (it is O(ops) host work). ``traces`` carries the
        batch's trace ids from an upstream hop (the wire); they ride
        into the journal record."""
        uuid, site = str(uuid), str(site)
        now = self._now_us(now_us)
        # --- the trust boundary (poison never enters the queue)
        if sync.is_quarantined(site):
            with self._lock:
                self.stats["quarantine_refusals"] += 1
            return Admission(False, rung="quarantined",
                             reason="site-quarantined")
        try:
            sync.validate_node_items(items)
            if crc is not None and sync.payload_checksum(items) != crc:
                raise s.CausalError(
                    "sync payload rejected",
                    {"causes": {"payload-checksum"},
                     "why": "checksum mismatch"})
        except s.CausalError as e:
            causes = e.info.get("causes", ("payload-invalid",))
            with self._lock:
                self.stats["poison_rejects"] += 1
            sync.note_reject(site, uuid=uuid, why=next(iter(causes)))
            return Admission(False, rung="poison",
                             reason=next(iter(causes)))
        if self.tenant_known is not None \
                and not self.tenant_known(uuid):
            # refuse at the door: an op for a uuid nobody serves must
            # not be journaled/acknowledged — it could never be
            # applied, and a crash replay would trip over it
            with self._lock:
                self.stats["unknown_tenant_rejects"] += 1
            return Admission(False, rung="reject",
                             reason="unknown-tenant")
        ops = len(items)
        if ops == 0:
            return Admission(True, seq=0)  # nothing to admit
        with self._lock:
            if self._closed:
                # drain already started: admission is closed, the
                # producer retries against the restarted service
                self._shed("reject", "closed", uuid, site, ops,
                           traces=traces)
                return Admission(False, rung="reject", reason="closed")
            retry = self._retry_after_ms(ops)
            if (self.deadline_ms is not None and retry is not None
                    and retry > self.deadline_ms):
                # deadline-aware admission: the op would sit in the
                # queue past its own deadline — shed at the door
                self._shed("reject", "deadline", uuid, site, ops,
                           retry_after_ms=retry, traces=traces)
                return Admission(False, rung="reject",
                                 reason="deadline",
                                 retry_after_ms=retry)
            if self._depth + ops > self.max_ops:
                # rung 2: at capacity — reject with the hint
                self._shed("reject", "capacity", uuid, site, ops,
                           retry_after_ms=retry, traces=traces)
                return Admission(False, rung="reject",
                                 reason="capacity",
                                 retry_after_ms=retry)
            if self._depth >= self.defer_watermark \
                    and self._is_cold(uuid, now):
                # rung 1: the ADMITTED depth itself is past the
                # watermark (true congestion — never just an oversized
                # batch on a quiet queue, which must admit) and the
                # tenant is cold — park UNADMITTED; rung 3 drops the
                # oldest parked entry when the side buffer overflows.
                # A site's offers are cumulative, so a newer offer
                # SUPERSEDES its own parked entry (replaced, not
                # duplicated)
                if any(d.uuid == uuid and d.site == site
                       for d in self._deferred):
                    self._deferred = deque(
                        d for d in self._deferred
                        if not (d.uuid == uuid and d.site == site))
                elif len(self._deferred) >= self.defer_max:
                    old = self._deferred.popleft()
                    self._shed("drop_oldest", "defer-overflow",
                               old.uuid, old.site, old.ops,
                               traces=old.traces)
                self._deferred.append(
                    _Entry(uuid, site, items, ops, -1, now,
                           traces=traces))
                self._shed("defer", "cold-tenant", uuid, site, ops,
                           retry_after_ms=retry, traces=traces)
                return Admission(False, rung="defer",
                                 reason="cold-tenant",
                                 retry_after_ms=retry)
            return self._admit_locked(uuid, site, items, ops, now,
                                      traces=traces)

    def _admit_locked(self, uuid, site, items, ops, now,
                      traces=None) -> Admission:
        # a site's offers are cumulative: admitting this one makes any
        # parked older entry from the same (uuid, site) a strict
        # subset — drop it, or promotion would re-journal and
        # double-count ops already in the queue
        if self._deferred and any(d.uuid == uuid and d.site == site
                                  for d in self._deferred):
            self._deferred = deque(
                d for d in self._deferred
                if not (d.uuid == uuid and d.site == site))
        if self.journal is not None:
            try:
                seq = self.journal.append(uuid, site, items, ts_us=now,
                                          trace=traces)
            except (s.CausalError, OSError) as e:
                causes = getattr(e, "info", {}).get("causes", ())
                reason = next(iter(causes), "journal-error")
                retry = self._retry_after_ms(ops)
                if retry is None:
                    retry = _DURABILITY_RETRY_MS
                self._shed("durability", reason, uuid, site, ops,
                           retry_after_ms=retry, traces=traces)
                return Admission(False, rung="durability",
                                 reason=reason, retry_after_ms=retry)
        else:
            self._seq += 1
            seq = self._seq
        self._q.append(_Entry(uuid, site, items, ops, seq, now,
                              traces=traces))
        self._depth += ops
        self._touch_hot(uuid, ops, now)
        self.stats["admitted_ops"] += ops
        self.stats["admitted_batches"] += 1
        if self._depth > self.stats["max_depth"]:
            self.stats["max_depth"] = self._depth
        return Admission(True, seq=seq)

    def close_admission(self) -> None:
        """Stop admitting (the drain's first step). Parked deferred
        entries remain eligible for promotion — they were offered in
        good faith and the drain flushes them if capacity allows."""
        with self._lock:
            self._closed = True

    def shed_stranded(self) -> int:
        """Drop every still-parked deferred entry with ``drop_oldest``
        evidence — the drain's last resort for entries that can never
        promote. They were never admitted (never journaled), so the
        no-admitted-op-loss contract is untouched. Returns entries
        shed."""
        n = 0
        with self._lock:
            while self._deferred:
                d = self._deferred.popleft()
                self._shed("drop_oldest", "drain-stranded",
                           d.uuid, d.site, d.ops, traces=d.traces)
                n += 1
        return n

    # ---------------------------------------------------------- drain

    def drain(self, max_ops: Optional[int] = None,
              now_us: Optional[int] = None) -> List[_Entry]:
        """Dequeue up to ``max_ops`` admitted ops (whole batches, FIFO)
        and, capacity permitting, promote deferred entries into
        admission. Updates the drain-rate EMA the deadline estimator
        reads."""
        now = self._now_us(now_us)
        out: List[_Entry] = []
        took = 0
        with self._lock:
            # the first batch always drains regardless of max_ops: a
            # single batch larger than the cap must degrade (one
            # oversized wave), never wedge the queue
            while self._q and (max_ops is None or took == 0
                               or took + self._q[0].ops <= max_ops):
                e = self._q.popleft()
                out.append(e)
                took += e.ops
                self._depth -= e.ops
            if took:
                # EMA over this drain's instantaneous rate: drained
                # ops against the elapsed span since the oldest
                # drained entry was admitted (coarse but stable)
                span_s = max(1e-3, (now - out[0].ts_us) / 1e6)
                inst = took / span_s
                self._drain_ops_per_s = (
                    inst if self._drain_ops_per_s == 0.0
                    else (1 - _RATE_ALPHA) * self._drain_ops_per_s
                    + _RATE_ALPHA * inst)
            # promotion: deferred entries admit once depth is back
            # under the watermark (FIFO — oldest deferred first). The
            # entry's own size is only checked against the HARD bound
            # (max_ops) — gating it on the watermark would starve a
            # parked batch larger than the remaining watermark slack
            # forever, even on an empty queue
            while self._deferred \
                    and self._depth < self.defer_watermark \
                    and self._depth + self._deferred[0].ops \
                    <= self.max_ops:
                d = self._deferred.popleft()
                adm = self._admit_locked(d.uuid, d.site, d.items,
                                         d.ops, now, traces=d.traces)
                self.stats["deferred_promoted"] += 1
                # promoted entries are admitted but not drained this
                # call: the next drain picks them up in FIFO order
                assert adm.admitted
        return out
