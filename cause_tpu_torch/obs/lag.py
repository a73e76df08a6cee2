"""Convergence-lag tracer: per-op create→converged latency.

Every existing obs layer measures what a wave COSTS (dispatch
accounting, devprof flops, wave wall spans). None of them measures the
quantity a user of a serving-shaped sync fleet actually experiences:
how long an op takes from its creation at a site to visibility on
every replica. The north star is stated in exactly those units
(<100 ms convergence for 1024-replica fleets), and the serving
controller's adaptive wave batching needs a latency signal to batch *against* —
SafarDB's split (accelerator owns merge, host owns admission/ordering)
only works if the host can see per-op replication lag against an SLO.

This module is that signal, as op-level provenance resolved against
the events the substrate already emits:

- **stamping** — ops are stamped host-side at mutation time
  (``collections/shared.py``'s ``insert`` funnel — every conj/extend/
  cons/insert lands there) and at ingest time (``sync.apply_delta``),
  with site, lamport and a monotonic clock captured OUTSIDE jit; the
  first stamp wins, so an op created in-process and later synced to a
  sibling replica keeps its true creation time;
- **resolution** — visibility comes from the substrate's own wave
  evidence: every merge wave / session wave (``_observe_semantics`` in
  ``parallel/wave.py``, shared with ``parallel/session.py``) marks the
  document's stamped ops *locally woven* (the wave's kernel wove them
  into the device-resident weave), and the first wave whose
  convergence digests AGREE across every replica pair holding the
  document marks them *fleet-converged*; merge-tree convergence
  (``parallel/tree.py``) resolves at its final level the same way.
  Two lags per op: create→woven and create→converged;
- **aggregation** — mergeable log-bucketed streaming histograms
  (HDR-style pow2 buckets over microseconds: bounded memory, bounded
  relative error, merge = per-bucket sum), a sliding window of recent
  converged lags surfaced as ``lag.p50_ms``/``.p95_ms``/``.p99_ms``
  gauges (Perfetto counter tracks), and SLO attainment + burn rate
  against a configurable target (default: the 100 ms north star,
  ``CAUSE_TPU_LAG_SLO_MS`` / :func:`set_slo`);
- **events** — per-op ``op.lag`` records (sampled per resolution
  batch — histograms always see every op), one cumulative
  ``lag.window`` record per resolving wave (window percentiles, the
  mergeable histogram state, exact SLO counters), and per-replica
  ``lag.replica`` apply-lag records from the sync ingest path (which
  replicas apply other sites' ops slowest — the worst-offender axis
  the CLI ranks);
- **the read side** — ``python -m cause_tpu_torch.obs lag events.jsonl...``
  renders the distribution, the per-replica apply-lag worst offenders
  and the SLO verdict from any obs stream(s); :func:`lag_summary` is
  the same aggregation as a library call (the ``obs fleet`` report
  folds it in).

Resolution granularity is the wave: an op stamped for a document is
considered included in the document's next wave (the instrumented
paths stamp at mutation/ingest and wave afterwards), so lag resolves
at wave boundaries — exactly the granularity a wave-batching admission
controller can act on.

Contract (same as the rest of ``cause_tpu_torch.obs``): stdlib + core only,
importable without jax/numpy; with ``CAUSE_TPU_OBS`` unset every entry
point returns immediately — no records, no registry state, no env or
``TRACE_SWITCHES`` reads, byte-identical program-cache keys (pinned by
tests/test_lag.py). On jit-reachable paths, call sites must sit behind
``obs.enabled()`` guards — causelint rule OBS006 gates that. State is
bounded everywhere: documents LRU-evict past ``_DOC_MAX`` (the
semantic-monitor rule — a 600k-round soak mints a uuid per round),
per-document op maps FIFO-evict past ``_OPS_MAX``, per-replica
apply-lag histograms LRU-evict past ``_REPLICA_MAX``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import core
from . import xtrace

__all__ = [
    "SLO_DEFAULT_MS",
    "SLO_GOAL",
    "LagHistogram",
    "enabled",
    "reset",
    "set_slo",
    "slo_ms",
    "op_created",
    "ops_applied",
    "wave_observed",
    "level_observed",
    "pending_ops",
    "current_epoch",
    "LagReducer",
    "lag_summary",
    "render",
    "main",
]

# BASELINE.json config 5 / the north star: convergence under 100 ms.
SLO_DEFAULT_MS = 100.0
# the attainment objective the burn rate is judged against: 99% of ops
# converge within the target; the error budget is the remaining 1%,
# and burn_rate = (observed breach fraction) / (error budget) — 1.0
# burns the budget exactly, >1.0 exhausts it early (SRE convention)
SLO_GOAL = 0.99

# state bounds (see module docstring)
_DOC_MAX = 4096
_OPS_MAX = 32768
_REPLICA_MAX = 256
# per-op op.lag events emitted per resolution batch; histograms and
# counters always account every op — the sample only bounds stream size
_OP_EVENT_SAMPLE = 64
# distinct traces earning a "converged" journey hop per wave
_TRACE_HOP_MAX = 256
# sliding window of recent converged lags behind the p50/p95/p99 gauges
_WINDOW_MAX = 256


class LagHistogram:
    """A mergeable log-bucketed (HDR-style) latency histogram.

    Bucket ``b`` holds lags in ``[2^(b-1), 2^b)`` microseconds (bucket
    0 holds sub-microsecond lags), so ~40 buckets cover ns..hours with
    a bounded √2 relative error per recorded value; exact count/sum/
    min/max ride alongside. Merging two histograms is a per-bucket sum
    — the property that makes multi-process streams and multi-stream
    CLI inputs aggregate without any raw-sample replay."""

    __slots__ = ("buckets", "count", "sum_us", "min_us", "max_us")

    def __init__(self):
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum_us = 0
        self.min_us = None  # type: Optional[int]
        self.max_us = None  # type: Optional[int]

    def record_us(self, us: float) -> None:
        u = max(0, int(us))
        b = u.bit_length()
        self.buckets[b] = self.buckets.get(b, 0) + 1
        self.count += 1
        self.sum_us += u
        self.min_us = u if self.min_us is None else min(self.min_us, u)
        self.max_us = u if self.max_us is None else max(self.max_us, u)

    def merge(self, other: "LagHistogram") -> "LagHistogram":
        for b, n in other.buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + n
        self.count += other.count
        self.sum_us += other.sum_us
        for attr, pick in (("min_us", min), ("max_us", max)):
            o = getattr(other, attr)
            if o is not None:
                mine = getattr(self, attr)
                setattr(self, attr, o if mine is None else pick(mine, o))
        return self

    @staticmethod
    def _bounds(b: int) -> Tuple[float, float]:
        return (0.0 if b == 0 else float(1 << (b - 1)), float(1 << b))

    def quantile_ms(self, q: float) -> Optional[float]:
        """The q-quantile in ms (linear interpolation inside the
        straddling pow2 bucket, clamped to the exact observed min/max).
        None on an empty histogram."""
        if not self.count:
            return None
        target = q * self.count
        cum = 0.0
        val = float(self.max_us or 0)
        for b in sorted(self.buckets):
            n = self.buckets[b]
            if cum + n >= target:
                lo, hi = self._bounds(b)
                frac = (target - cum) / n
                val = lo + frac * (hi - lo)
                break
            cum += n
        if self.min_us is not None:
            val = max(val, float(self.min_us))
        if self.max_us is not None:
            val = min(val, float(self.max_us))
        return round(val / 1000.0, 4)

    def mean_ms(self) -> Optional[float]:
        if not self.count:
            return None
        return round(self.sum_us / self.count / 1000.0, 4)

    def within_us(self, limit_us: float) -> float:
        """Estimated count of recorded lags <= ``limit_us`` (buckets
        fully below count whole; the straddling bucket interpolates)."""
        if limit_us < 0:
            return 0.0
        got = 0.0
        for b, n in self.buckets.items():
            lo, hi = self._bounds(b)
            if hi <= limit_us:
                got += n
            elif lo <= limit_us:
                got += n * (limit_us - lo) / (hi - lo)
        return got

    def to_fields(self) -> dict:
        """The JSON-serializable mergeable state (``lag.window`` /
        ``lag.replica`` event payloads)."""
        return {
            "buckets": {str(b): n for b, n in sorted(self.buckets.items())},
            "count": self.count,
            "sum_us": self.sum_us,
            "min_us": self.min_us,
            "max_us": self.max_us,
        }

    @classmethod
    def from_fields(cls, fields: Optional[dict]) -> "LagHistogram":
        h = cls()
        f = fields or {}
        for b, n in (f.get("buckets") or {}).items():
            try:
                h.buckets[int(b)] = int(n)
            except (TypeError, ValueError):
                continue
        h.count = int(f.get("count") or 0)
        h.sum_us = int(f.get("sum_us") or 0)
        for attr in ("min_us", "max_us"):
            v = f.get(attr)
            if isinstance(v, (int, float)):
                setattr(h, attr, int(v))
        return h


# ------------------------------------------------------------- state

_LOCK = threading.Lock()
# uuid -> {"new": {op_id: stamp}, "woven": {op_id: stamp}} with stamp =
# (perf_counter, site, lamport); LRU over documents, FIFO over ops
_DOCS: Dict[str, dict] = {}
# replica site_id -> (generation, apply-lag histogram). The histogram
# is cumulative per generation: LRU eviction past _REPLICA_MAX drops a
# replica's in-memory history, so a returning replica starts a FRESH
# generation — the generation rides in every ``lag.replica`` record,
# and the read side merges across generations instead of letting the
# restarted cumulative record clobber the richer pre-eviction one
# replica -> [generation, histogram, worst (lag_us, trace_id) | None]
_REPLICAS: Dict[str, list] = {}
_REPLICA_GEN = 0
_HIST_WOVEN = LagHistogram()
_HIST_CONVERGED = LagHistogram()
_WINDOW: List[float] = []        # recent converged lags, ms
_CONVERGED_TOTAL = 0
_BREACH_TOTAL = 0
_SLO_MS: Optional[float] = None  # lazily resolved (enabled paths only)
# cumulative-record generation: ``lag.window``/``lag.replica`` carry
# histograms cumulative SINCE THE LAST reset(), so the read side must
# not collapse records across a reset to one last-per-pid value (a
# multi-fleet BENCH_LAG run resets between fleets — without the epoch
# every fleet but the last would vanish from the merged report)
_EPOCH = 0


def enabled() -> bool:
    """Whether the lag tracer records anything (== ``obs.enabled()``)."""
    return core.enabled()


def reset() -> None:
    """Drop all lag-tracer state (tests, bench warm phases; obs.reset
    does not reach into this layer)."""
    global _CONVERGED_TOTAL, _BREACH_TOTAL, _SLO_MS, _EPOCH
    with _LOCK:
        _DOCS.clear()
        _REPLICAS.clear()
        _HIST_WOVEN.__init__()
        _HIST_CONVERGED.__init__()
        del _WINDOW[:]
        _CONVERGED_TOTAL = 0
        _BREACH_TOTAL = 0
        _SLO_MS = None
        _EPOCH += 1


def set_slo(ms: Optional[float]) -> None:
    """Pin the convergence SLO target (None re-reads the environment
    on next enabled use; soak's ``--slo-ms`` flag lands here)."""
    global _SLO_MS
    _SLO_MS = float(ms) if ms is not None else None


def slo_ms() -> float:
    """The active SLO target: :func:`set_slo`'s pin, else
    ``CAUSE_TPU_LAG_SLO_MS``, else the 100 ms north star. Called from
    enabled paths only (the obs-off contract is zero env reads)."""
    global _SLO_MS
    if _SLO_MS is None:
        raw = os.environ.get("CAUSE_TPU_LAG_SLO_MS", "").strip()
        try:
            _SLO_MS = float(raw) if raw else SLO_DEFAULT_MS
        except ValueError:
            _SLO_MS = SLO_DEFAULT_MS
    return _SLO_MS


def _doc(uuid: str) -> dict:
    """The document's op registry, LRU-refreshed. Caller holds _LOCK.
    ``hwm`` is the highest lamport among the document's RESOLVED ops:
    a full-bag resend replays every node of the document, and without
    the watermark each replay would re-stamp thousands of long-
    converged ops as freshly created (their near-zero "lags" would
    swamp the distribution). Ops at or below the watermark are
    replays, not new work — O(1) memory instead of a resolved-id set."""
    d = _DOCS.pop(uuid, None)
    if d is None:
        d = {"new": {}, "woven": {}, "hwm": -1}
    _DOCS[uuid] = d
    while len(_DOCS) > _DOC_MAX:
        _DOCS.pop(next(iter(_DOCS)))
    return d


def _bound_ops(ops: Dict) -> None:
    while len(ops) > _OPS_MAX:
        ops.pop(next(iter(ops)))


def _site_of(op_id) -> str:
    """The origin site of a node id ``(ts, site, tx)`` — best-effort
    (foreign key shapes stringify)."""
    try:
        return str(op_id[1])
    except (TypeError, IndexError):
        return "?"


def _lamport_of(op_id):
    try:
        return int(op_id[0])
    except (TypeError, IndexError, ValueError):
        return None


# ---------------------------------------------------------- stamping


def op_created(uuid: str, op_ids: Iterable, t: Optional[float] = None) -> None:
    """Stamp newly-minted ops for document ``uuid`` (host-side, at the
    mutation funnel — OUTSIDE any jit trace). ``op_ids`` are node ids
    ``(ts, site, tx)``; the first stamp for an id wins, so a replayed
    or re-ingested op keeps its original creation time."""
    if not core.enabled():
        return
    now = time.perf_counter() if t is None else t
    u = str(uuid)
    n = 0
    with _LOCK:
        d = _doc(u)
        new, woven = d["new"], d["woven"]
        for op in op_ids:
            if op in new or op in woven:
                continue
            # no watermark filter here (unlike ops_applied): the
            # insert funnel's idempotency check returns before the
            # stamp point for true replays, so everything reaching
            # this path is genuinely new work — including fresh
            # concurrent ops minted by stale replicas at lamports the
            # fleet already converged past, which are exactly the
            # worst-lag tail the tracer must not drop
            new[op] = now
            n += 1
        _bound_ops(new)
    if n:
        core.counter("lag.ops_created").inc(n)


def ops_applied(uuid: str, op_ids: Iterable, replica: str = "") -> None:
    """Sync-ingest resolution + stamping: ops in a received delta (or
    full bag) just became visible on ``replica``. Ops already stamped
    in-process record their create→applied lag into the replica's
    apply-lag histogram (the per-replica worst-offender axis); unknown
    ops are stamped now (ingest time IS their local creation time).
    Emits one cumulative ``lag.replica`` record per call."""
    global _REPLICA_GEN
    if not core.enabled():
        return
    now = time.perf_counter()
    u = str(uuid)
    rep = str(replica) if replica else "?"
    applied = 0
    stamped = 0
    with _LOCK:
        d = _doc(u)
        new, woven = d["new"], d["woven"]
        entry = _REPLICAS.pop(rep, None)
        if entry is None:
            _REPLICA_GEN += 1
            entry = [_REPLICA_GEN, LagHistogram(), None]
        gen, hist = entry[0], entry[1]
        _REPLICAS[rep] = entry
        while len(_REPLICAS) > _REPLICA_MAX:
            _REPLICAS.pop(next(iter(_REPLICAS)))
        for op in op_ids:
            stamp = new.get(op)
            if stamp is None:
                stamp = woven.get(op)
            if stamp is not None:
                lag_us = (now - stamp) * 1e6
                hist.record_us(lag_us)
                applied += 1
                # worst-offender exemplar: the replica's slowest apply
                # keeps its trace id, so `obs lag` can print the exact
                # id `obs journey` drills into
                if entry[2] is None or lag_us > entry[2][0]:
                    entry[2] = (lag_us, xtrace.trace_of(op))
            else:
                lam = _lamport_of(op)
                if lam is not None and lam <= d["hwm"]:
                    # a full-bag resend replays every node of the
                    # document; the watermark keeps long-converged
                    # ops from re-entering as freshly created. Known
                    # approximation: a stale replica's fresh
                    # concurrent op arriving BY SYNC at a lamport the
                    # fleet converged past is skipped too (only ids
                    # could distinguish it, at unbounded memory);
                    # ops stamped at their own mutation funnel —
                    # the common case — are unaffected
                    continue
                new[op] = now
                stamped += 1
        _bound_ops(new)
        hist_fields = hist.to_fields()
        worst = entry[2]
    if stamped:
        core.counter("lag.ops_created").inc(stamped)
    if applied:
        core.counter("lag.ops_applied").inc(applied)
        extra = {}
        if worst is not None:
            extra["worst_lag_ms"] = round(worst[0] / 1000.0, 3)
            if worst[1]:
                extra["worst_trace"] = worst[1]
        core.event("lag.replica", replica=rep, uuid=u,
                   applied=applied, epoch=_EPOCH, gen=gen,
                   hist=hist_fields, **extra)


# -------------------------------------------------------- resolution


def _resolve_locked(u: str, agreed: bool, now: float):
    """Move the document's pending ops through woven (always) and
    converged (on digest agreement). Caller holds _LOCK. Returns the
    per-op sample lists + window snapshot the emitter needs."""
    global _CONVERGED_TOTAL, _BREACH_TOTAL
    d = _doc(u)
    new, woven = d["new"], d["woven"]
    woven_out: List[Tuple[object, float]] = []
    for op, stamp in new.items():
        _HIST_WOVEN.record_us((now - stamp) * 1e6)
        woven_out.append((op, stamp))
        woven[op] = stamp
    new.clear()
    _bound_ops(woven)
    conv_out: List[Tuple[object, float]] = []
    breaches = 0
    slo = slo_ms()
    if agreed and woven:
        for op, stamp in woven.items():
            lag_ms = (now - stamp) * 1000.0
            _HIST_CONVERGED.record_us(lag_ms * 1000.0)
            conv_out.append((op, stamp))
            _WINDOW.append(lag_ms)
            if lag_ms > slo:
                breaches += 1
            lam = _lamport_of(op)
            if lam is not None and lam > d["hwm"]:
                d["hwm"] = lam
        woven.clear()
        del _WINDOW[:-_WINDOW_MAX]
        _CONVERGED_TOTAL += len(conv_out)
        _BREACH_TOTAL += breaches
    return woven_out, conv_out, breaches, slo


def _window_stats(window: Sequence[float], slo: float) -> dict:
    """p50/p95/p99 + breach fraction + burn rate of the sliding
    window (tiny: sort is fine)."""
    if not window:
        return {}
    xs = sorted(window)
    n = len(xs)

    def pct(q: float) -> float:
        return round(xs[min(n - 1, int(q * n))], 3)

    breach = sum(1 for x in xs if x > slo) / n
    budget = 1.0 - SLO_GOAL
    return {
        "n": n,
        "p50_ms": pct(0.50),
        "p95_ms": pct(0.95),
        "p99_ms": pct(0.99),
        "breach_frac": round(breach, 4),
        "burn_rate": round(breach / budget, 2),
    }


def wave_observed(uuid: str, agreed: bool, source: str = "wave",
                  level: Optional[int] = None) -> Optional[dict]:
    """One wave completed for document ``uuid``: every op stamped
    before it is now locally woven (the wave's kernel wove the whole
    document), and — when the wave's convergence digests ``agreed``
    across all replica pairs — fleet-converged. Emits sampled per-op
    ``op.lag`` events, one cumulative ``lag.window`` record, and the
    sliding-window percentile gauges. Returns the ``lag.window``
    fields (None when obs is off or nothing resolved)."""
    if not core.enabled():
        return None
    now = time.perf_counter()
    u = str(uuid)
    with _LOCK:
        woven_out, conv_out, breaches, slo = _resolve_locked(
            u, bool(agreed), now)
        if not woven_out and not conv_out:
            return None
        window = list(_WINDOW)
        fields = {
            "uuid": u,
            "source": str(source),
            "epoch": _EPOCH,
            "woven": len(woven_out),
            "converged": len(conv_out),
            "pending": sum(len(d["new"]) + len(d["woven"])
                           for d in _DOCS.values()),
            "slo_ms": slo,
            "slo_breach": breaches,
            "converged_total": _CONVERGED_TOTAL,
            "breach_total": _BREACH_TOTAL,
            "hist_woven": _HIST_WOVEN.to_fields(),
            "hist_converged": _HIST_CONVERGED.to_fields(),
        }
    if level is not None:
        fields["level"] = int(level)
    for phase, batch in (("woven", woven_out), ("converged", conv_out)):
        core.counter(f"lag.ops_{phase}").inc(len(batch))
        for op, stamp in batch[:_OP_EVENT_SAMPLE]:
            extra = {}
            tr = xtrace.trace_of(op)
            if tr:
                # the lag→journey drill-down: this id is
                # exactly what `obs journey <trace>` accepts
                extra["trace"] = tr
            core.event("op.lag", uuid=u, phase=phase,
                       site=_site_of(op), lamport=_lamport_of(op),
                       lag_ms=round((now - stamp) * 1000.0, 3),
                       source=str(source), **extra)
    # terminal journey hop: one "converged" hop per distinct
    # trace whose ops just fleet-converged, carrying that trace's
    # WORST create→converged lag (the per-hop SLO decomposition's
    # final edge). Bounded per wave like every other emission here.
    if conv_out:
        worst_by_trace: Dict[str, float] = {}
        for op, stamp in conv_out:
            tr = xtrace.trace_of(op)
            if tr is None:
                continue
            lag_ms = (now - stamp) * 1000.0
            if lag_ms > worst_by_trace.get(tr, -1.0):
                worst_by_trace[tr] = lag_ms
            if len(worst_by_trace) >= _TRACE_HOP_MAX:
                break
        for tr, lag_ms in worst_by_trace.items():
            xtrace.hop("converged", tr, uuid=u,
                       lag_ms=round(lag_ms, 3), source=str(source))
    if breaches:
        core.counter("lag.slo_breach").inc(breaches)
    win = _window_stats(window, slo)
    if win:
        fields["window"] = win
        core.gauge("lag.p50_ms").set(win["p50_ms"])
        core.gauge("lag.p95_ms").set(win["p95_ms"])
        core.gauge("lag.p99_ms").set(win["p99_ms"])
    core.event("lag.window", **fields)
    return fields


def level_observed(uuid: str, agreed: bool, level: int,
                   final: bool) -> Optional[dict]:
    """Merge-tree resolution: intermediate levels converge SUBTREES
    (distinct digests are a converging fleet's expected shape — no op
    converges yet), so only the final level's fleet-wide agreement
    resolves; level 0 still marks the document's stamped ops woven
    (the first full-width level wove every replica's lanes)."""
    if not core.enabled():
        return None
    if final:
        return wave_observed(uuid, agreed, source="tree", level=level)
    if level == 0:
        return wave_observed(uuid, False, source="tree", level=level)
    return None


def current_epoch() -> int:
    """The live cumulative-record generation (bumped by every
    :func:`reset`): pass it to :func:`lag_summary` to scope a report
    to records emitted SINCE the last reset — e.g. one bench fleet's
    measured block — without positional ring arithmetic (the bounded
    ring may evict arbitrarily between a snapshot and the read)."""
    return _EPOCH


def pending_ops(uuid: Optional[str] = None) -> int:
    """Stamped-but-unresolved op count (one document, or all)."""
    with _LOCK:
        if uuid is not None:
            d = _DOCS.get(str(uuid))
            return len(d["new"]) + len(d["woven"]) if d else 0
        return sum(len(d["new"]) + len(d["woven"])
                   for d in _DOCS.values())


# -------------------------------------------------------- read side


class LagReducer:
    """The incremental twin of :func:`lag_summary`: feed obs records
    ONE AT A TIME (a live tail, an in-process subscriber queue) and
    ask for the report at any point. ``lag_summary`` itself is this
    reducer fed with the whole stream, so the two are bit-equal by
    construction — the acceptance property ``obs.live`` pins.

    The merge rule is unchanged: cumulative ``lag.window`` records
    collapse to the LAST per (pid, reset-epoch) and then SUM;
    ``lag.replica`` records collapse per (pid, epoch, replica,
    generation). Memory is bounded by the number of distinct
    (pid, epoch[, replica, gen]) keys in the stream — process count ×
    reset count, not op count."""

    __slots__ = ("_windows", "_replicas")

    def __init__(self):
        # key -> fields; dict preserves FIRST-insertion order under
        # reassignment, exactly like the batch pass's last-per-key
        # fold, so merge order (and float summation order) is
        # identical to the whole-stream pass
        self._windows: Dict[Tuple, dict] = {}
        self._replicas: Dict[Tuple, dict] = {}

    def feed(self, e: dict) -> None:
        """Consume one obs record (non-lag records are free)."""
        if e.get("ev") != "event":
            return
        name = e.get("name")
        if name == "lag.window":
            f = e.get("fields") or {}
            self._windows[(e.get("pid", 0), f.get("epoch"))] = f
        elif name == "lag.replica":
            f = e.get("fields") or {}
            self._replicas[(e.get("pid", 0), f.get("epoch"),
                            f.get("replica"), f.get("gen"))] = f

    def report(self, slo_ms_override: Optional[float] = None,
               epoch: Optional[int] = None) -> dict:
        """The lag report (see :func:`lag_summary` for the fields).
        Cheap relative to the stream: cost is proportional to the
        number of distinct cumulative-record keys, so a live monitor
        can call it on every snapshot tick."""
        windows = [f for f in self._windows.values()
                   if epoch is None or f.get("epoch") == epoch]
        h_woven = LagHistogram()
        h_conv = LagHistogram()
        converged_total = 0
        breach_total = 0
        pending = 0
        recorded_slo = None
        last_win = {}
        for f in windows:
            h_woven.merge(LagHistogram.from_fields(f.get("hist_woven")))
            h_conv.merge(LagHistogram.from_fields(f.get("hist_converged")))
            converged_total += int(f.get("converged_total") or 0)
            breach_total += int(f.get("breach_total") or 0)
            pending += int(f.get("pending") or 0)
            if f.get("slo_ms") is not None:
                recorded_slo = float(f["slo_ms"])
            if f.get("window"):
                last_win = f["window"]
        slo = (float(slo_ms_override) if slo_ms_override is not None
               else (recorded_slo if recorded_slo is not None
                     else SLO_DEFAULT_MS))
        if converged_total and (slo_ms_override is None
                                or recorded_slo == slo):
            within = converged_total - breach_total
            exact = True
        else:
            within = h_conv.within_us(slo * 1000.0)
            exact = False
        attainment = (within / h_conv.count) if h_conv.count else None
        budget = 1.0 - SLO_GOAL

        def dist(h: LagHistogram) -> dict:
            return {
                "count": h.count,
                "p50_ms": h.quantile_ms(0.50),
                "p90_ms": h.quantile_ms(0.90),
                "p95_ms": h.quantile_ms(0.95),
                "p99_ms": h.quantile_ms(0.99),
                "mean_ms": h.mean_ms(),
                "max_ms": (round(h.max_us / 1000.0, 4)
                           if h.max_us is not None else None),
            }

        replicas = []
        rep_hists: Dict[str, LagHistogram] = {}
        rep_worst: Dict[str, tuple] = {}  # (worst_lag_ms, trace)
        for f in self._replicas.values():
            if epoch is not None and f.get("epoch") != epoch:
                continue
            h = LagHistogram.from_fields(f.get("hist"))
            if not h.count:
                continue
            rep = str(f.get("replica"))
            rep_hists.setdefault(rep, LagHistogram()).merge(h)
            w = f.get("worst_lag_ms")
            if isinstance(w, (int, float)) \
                    and w > rep_worst.get(rep, (-1.0, None))[0]:
                rep_worst[rep] = (float(w), f.get("worst_trace"))
        for rep, h in rep_hists.items():
            row = {
                "replica": rep,
                "count": h.count,
                "p95_ms": h.quantile_ms(0.95),
                "max_ms": (round(h.max_us / 1000.0, 4)
                           if h.max_us is not None else None),
            }
            worst = rep_worst.get(rep)
            if worst is not None and worst[1]:
                # the drill-down id: `obs journey <worst_trace>`
                row["worst_trace"] = worst[1]
            replicas.append(row)
        replicas.sort(key=lambda r: -(r["p95_ms"] or 0.0))

        return {
            "windows": len(windows),
            "ops_woven": h_woven.count,
            "ops_converged": h_conv.count,
            "pending": pending,
            "woven": dist(h_woven),
            "converged": dist(h_conv),
            "slo": {
                "target_ms": slo,
                "goal": SLO_GOAL,
                "attainment": (round(attainment, 4)
                               if attainment is not None else None),
                "attainment_exact": exact,
                "breaches": (breach_total if exact
                             else (round(h_conv.count - within, 1)
                                   if h_conv.count else 0)),
                "burn_rate": (round((1.0 - attainment) / budget, 2)
                              if attainment is not None else None),
                "verdict": (None if attainment is None
                            else ("OK" if attainment >= SLO_GOAL
                                  else "BREACH")),
            },
            "window": last_win,
            "replicas": replicas,
        }


def lag_summary(events: Sequence[dict],
                slo_ms_override: Optional[float] = None,
                epoch: Optional[int] = None) -> dict:
    """Aggregate one (merged) obs event stream into the lag report the
    CLI renders: cumulative woven/converged distributions (merged
    per-pid histogram states from the last ``lag.window`` per
    process), exact SLO attainment + burn rate (re-derived from the
    histogram when ``slo_ms_override`` differs from the recorded
    target), the last sliding-window percentiles, and the per-replica
    apply-lag worst offenders. Empty streams report zeros — the first
    question to a broken run is "did anything record at all?".
    ``epoch`` scopes the report to one cumulative-record generation
    (:func:`current_epoch` — one in-process reset span); by default
    every generation in the stream is summed.

    Implementation-wise this IS :class:`LagReducer` fed with the whole
    stream — the batch pass and the live incremental fold share one
    body, so they cannot drift apart."""
    r = LagReducer()
    for e in events:
        r.feed(e)
    return r.report(slo_ms_override=slo_ms_override, epoch=epoch)


def render(report: dict) -> str:
    """The human layout of :func:`lag_summary` — one glanceable
    block."""
    s = report["slo"]
    lines = [
        f"convergence lag: {report['ops_converged']} op(s) converged, "
        f"{report['ops_woven']} woven, {report['pending']} pending "
        f"({report['windows']} window record(s))",
    ]

    def dist_line(label: str, d: dict) -> str:
        if not d["count"]:
            return f"  {label}: no ops resolved"
        return (f"  {label}: p50 {d['p50_ms']:g} ms  "
                f"p95 {d['p95_ms']:g}  p99 {d['p99_ms']:g}  "
                f"max {d['max_ms']:g}  (mean {d['mean_ms']:g}, "
                f"n={d['count']})")

    lines.append(dist_line("create→woven    ", report["woven"]))
    lines.append(dist_line("create→converged", report["converged"]))
    if s["verdict"] is None:
        lines.append(f"  SLO {s['target_ms']:g} ms: no converged ops "
                     "to judge")
    else:
        lines.append(
            f"  SLO {s['target_ms']:g} ms: {100 * s['attainment']:.1f}% "
            f"within target (goal {100 * s['goal']:.0f}%, "
            f"burn {s['burn_rate']:g}x"
            + ("" if s["attainment_exact"] else ", histogram-estimated")
            + f") -> {s['verdict']}")
    win = report.get("window") or {}
    if win:
        lines.append(
            f"  sliding window (last {win['n']}): "
            f"p50 {win['p50_ms']:g} ms  p95 {win['p95_ms']:g}  "
            f"p99 {win['p99_ms']:g}  (burn {win['burn_rate']:g}x)")
    reps = report.get("replicas") or []
    if reps:
        lines.append("  worst replica apply-lag:")
        for r in reps[:5]:
            tr = r.get("worst_trace")
            lines.append(
                f"    {r['replica']}: p95 {r['p95_ms']:g} ms "
                f"(max {r['max_ms']:g}, n={r['count']})"
                + (f"  worst trace {tr}" if tr else ""))
        if len(reps) > 5:
            lines.append(f"    ... {len(reps) - 5} more replica(s)")
    return "\n".join(lines)


# ----------------------------------------------------------------- CLI


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from .perfetto import load_streams

    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.obs lag",
        description="Render per-op convergence-lag distributions "
                    "(create→woven, create→converged), per-replica "
                    "apply-lag worst offenders and the SLO verdict "
                    "from obs JSONL stream(s). Multiple streams merge "
                    "by timestamp (multi-process soaks).")
    ap.add_argument("jsonl", nargs="+",
                    help="obs event file(s) (JSON lines)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="SLO target in ms (default: the stream's "
                         "recorded target, else the 100 ms north star)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    a = ap.parse_args(argv)
    for path in a.jsonl:
        if not os.path.exists(path):
            print(f"lag: no such file: {path}", file=sys.stderr)
            return 2
    report = lag_summary(load_streams(a.jsonl), slo_ms_override=a.slo_ms)
    if a.json:
        print(json.dumps(report, indent=1))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
