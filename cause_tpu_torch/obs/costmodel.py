"""The wave cost model: dispatch accounting joined to divergence.

Waves pay full-document-width cost even when replicas diverge by a
handful of ops, unless the delta-native path runs. The semantic events
measure divergence per wave (delta rounds, token headroom) and devprof
prices the programs a wave runs; this module joins the two into one
record, so "cost ∝ document size, not divergence" is
machine-checkable, in three layers:

- **dispatch accounting** — every device program invocation at the
  program-cache call sites (``benchgen.merge_wave_scalar``), the wave
  kernels (``parallel/wave.py``) and the session's resident-splice
  path (``parallel/session.py``) lands via :func:`record_dispatch`
  with a program-identity string; the open wave window counts
  invocations and distinct identities, and the dispatch-floor budget
  arithmetic PERF.md narrates (floor_ms × dispatches vs measured
  wall) becomes computed fields instead of prose;
- **the cost-vs-divergence join** — each wave emits ONE ``wave.cost``
  event carrying the wave's semantic evidence (delta ops noted by the
  sync layer and the session delta path, token budget used, full-bag
  count) NEXT TO its cost (dispatches, the devprof flops/bytes digest
  of the programs run when known, wall span), so any obs stream
  directly yields the cost-vs-divergence curve that motivates — and
  later gates — the delta-native weave;
- **the gap report** — ``python -m cause_tpu_torch.obs gap`` reads the
  committed perf ledger plus any obs JSONL stream and renders the
  north-star decomposition: best same-platform headline, the dispatch
  -floor share, per-phase shares from ``stages.prefix`` events when
  present, the cost-vs-divergence slope with an explicit
  O(doc)-vs-O(delta) verdict, and the projected headline if cost
  scaled with the measured divergence.

Contract (same as the rest of ``cause_tpu_torch.obs``): stdlib + core
only at import time; with ``CAUSE_TPU_OBS`` unset every entry point
returns immediately — no records, no registry state. Call sites sit
behind ``obs.enabled()`` guards.

The dispatch floor is the port's one floor constant,
``serve.controller.DISPATCH_FLOOR_MS`` (measured on an NVIDIA H100),
read here lazily: ``DISPATCH_FLOOR_MS`` below IS that object.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from . import core
from .ledger import CHIP_PLATFORM

__all__ = [
    "DISPATCH_FLOOR_MS",
    "NORTH_STAR_MS",
    "enabled",
    "reset",
    "register_program",
    "record_dispatch",
    "note_delta_ops",
    "note_full_bag",
    "wave_begin",
    "wave_abandon",
    "wave_cost",
    "CostReducer",
    "costmodel_digest",
    "cost_vs_divergence",
    "tree_decomposition",
    "gap_report",
    "render_gap",
]

# BASELINE.json config 5: p50 < 100 ms on one chip.
NORTH_STAR_MS = 100.0


def _floor_ms() -> float:
    """The H100's per-tick dispatch floor, held by the serving
    controller (imported late: the serve package imports obs)."""
    from ..serve.controller import DISPATCH_FLOOR_MS as floor

    return floor


def __getattr__(name):
    if name == "DISPATCH_FLOOR_MS":
        return _floor_ms()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

# verdict rule: over the observed divergence range, the fitted slope
# must move the cost by at least this fraction OF THE MEAN COST before
# the curve counts as O(delta) — i.e. cost must scale MATERIALLY with
# divergence, not merely correlate (a 3 ms drift on a 1000 ms wave is
# O(doc) however tight its fit). Below the threshold the wave is
# paying document width regardless of divergence.
_SLOPE_EXPLAINS = 0.5

_LOCK = threading.Lock()
# program identity -> devprof cost dict ({"flops", "bytes_accessed",
# ...}); bounded LRU — identities are few (one per compiled program)
_PROGRAMS: Dict[str, dict] = {}
_PROGRAMS_MAX = 512
# uuid -> host-side divergence evidence noted since that document's
# last wave.cost (sync deltas, full-bag fallbacks); bounded like the
# semantic monitor — a soak mints a uuid per round
_PENDING_OPS: Dict[str, int] = {}
_PENDING_BAGS: Dict[str, int] = {}
_PENDING_MAX = 4096
_TLS = threading.local()  # .window — the open per-thread wave window


def enabled() -> bool:
    """Whether the cost model records anything (== ``obs.enabled()``)."""
    return core.enabled()


def reset() -> None:
    """Drop all cost-model state (tests; obs.reset does not reach into
    this layer)."""
    with _LOCK:
        _PROGRAMS.clear()
        _PENDING_OPS.clear()
        _PENDING_BAGS.clear()
    _TLS.window = None


def _bound(d: Dict, cap: int) -> None:
    while len(d) > cap:
        d.pop(next(iter(d)))


# --------------------------------------------------------- accounting


def register_program(program: str, cost: Optional[dict]) -> None:
    """Remember a compiled program's devprof cost digest under its
    identity string, so later ``wave.cost`` events can attach the
    flops/bytes of the programs a wave actually ran. Called at the
    program-cache miss right after ``devprof.profile_program``."""
    if not core.enabled():
        return
    with _LOCK:
        _PROGRAMS.pop(program, None)
        _PROGRAMS[program] = dict(cost or {})
        _bound(_PROGRAMS, _PROGRAMS_MAX)


def record_dispatch(program: str, site: str = "", n: int = 1) -> None:
    """One (or ``n``) device program invocation(s) with identity
    ``program``. Bumps the global ``costmodel.dispatches`` counter and
    attributes the invocation to the calling thread's open wave
    window, when one is open (dispatches outside any wave — session
    splices, bench warmups — still count globally)."""
    if not core.enabled():
        return
    core.counter("costmodel.dispatches").inc(n)
    if site:
        core.counter(f"costmodel.dispatches.{site}").inc(n)
    w = getattr(_TLS, "window", None)
    if w is not None:
        w["dispatches"] += int(n)
        w["programs"].add(str(program))


def note_delta_ops(uuid: str, n: int) -> None:
    """Host-side divergence evidence: ``n`` delta ops (synced nodes,
    appended lanes) landed on document ``uuid`` since its last wave.
    Drained into the next ``wave.cost`` for that document, so the
    event's ``delta_ops`` matches the semantic stream's delta
    accounting."""
    if not core.enabled():
        return
    u = str(uuid)
    with _LOCK:
        _PENDING_OPS[u] = _PENDING_OPS.pop(u, 0) + int(n)
        _bound(_PENDING_OPS, _PENDING_MAX)


def note_full_bag(uuid: str, n: int = 1) -> None:
    """A full-bag (O(doc) resend) degradation landed on ``uuid`` since
    its last wave; drained into the next ``wave.cost`` like
    :func:`note_delta_ops`."""
    if not core.enabled():
        return
    u = str(uuid)
    with _LOCK:
        _PENDING_BAGS[u] = _PENDING_BAGS.pop(u, 0) + int(n)
        _bound(_PENDING_BAGS, _PENDING_MAX)


# ------------------------------------------------------- wave windows


def wave_begin(source: str) -> Optional[dict]:
    """Open this thread's wave window: subsequent
    :func:`record_dispatch` calls attribute to it until
    :func:`wave_cost` closes it. Re-entrant by replacement — a window
    leaked by a raised wave is simply superseded."""
    if not core.enabled():
        return None
    w = {"source": str(source), "t0": time.perf_counter(),
         "dispatches": 0, "programs": set()}
    _TLS.window = w
    return w


def wave_abandon() -> None:
    """Drop the open window without emitting (overflowed session waves:
    their digests are garbage and ``fleet.session_overflow`` already
    records the incident)."""
    _TLS.window = None


def wave_cost(uuid: str = "", pairs: int = 0, lanes: int = 0,
              tokens: Optional[int] = None, token_budget: int = 0,
              delta_ops: int = 0, full_bag: int = 0,
              poisoned: int = 0, overflow_retries: int = 0,
              semantic: Optional[dict] = None,
              path: str = "", level: Optional[int] = None,
              bucket: Optional[int] = None,
              batch_rows: Optional[int] = None,
              uuids: Optional[Sequence[str]] = None) -> Optional[dict]:
    """Close the open wave window and emit ONE ``wave.cost`` event —
    the per-wave join of cost and divergence:

    - cost: ``dispatches`` / distinct ``programs`` from the window,
      wall span since :func:`wave_begin`, the dispatch-floor budget
      (``floor_budget_ms = DISPATCH_FLOOR_MS × dispatches`` — the
      budget of this wave's dispatches at the card's measured per-tick
      floor), and the devprof flops/bytes sum of the programs
      run where :func:`register_program` priced them;
    - divergence: ``delta_ops`` (the caller's directly-measured ops —
      session delta lanes — plus everything :func:`note_delta_ops`
      accumulated for ``uuid``), ``tokens`` used vs ``token_budget``,
      ``full_bag`` count (caller's fallbacks plus noted full bags),
      and the wave's semantic summary (``wave.digest`` fields) when
      given;
    - scale: ``pairs`` and ``lanes`` (the O(doc) axis the divergence
      fields are judged against);
    - ``path``: which wave generation ran — ``"full"`` (document-width
      kernel) or ``"delta"`` (the delta-native window weave). The gap
      report fits a separate cost-vs-divergence curve per path, so a
      sweep stream renders the O(doc) control verdict NEXT TO the
      delta path's O(delta) verdict instead of mixing them;
    - ``level``: the merge-tree round this wave IS, when the wave is
      one level of a ``parallel.tree`` reduction — joined with the
      ``tree.level`` semantic events into the gap report's per-level
      cost decomposition;
    - ``bucket`` / ``batch_rows``: cross-tenant batched serving — the
      pow2 window budget this dispatch's rows shared and how many
      rows rode it, so the gap report and the live fold can attribute
      the dispatch-count collapse (one floor per BUCKET, not per
      tenant). ``uuids`` lists every document the bucket served:
      their :func:`note_delta_ops` accumulations all drain into this
      one event instead of dangling.

    Returns the emitted fields (or None when obs is off / no window).
    """
    if not core.enabled():
        return None
    w = getattr(_TLS, "window", None)
    _TLS.window = None
    if w is None:
        return None
    wall_ms = (time.perf_counter() - w["t0"]) * 1000.0
    u = str(uuid)
    drain = [u] + [str(x) for x in (uuids or ()) if str(x) != u]
    with _LOCK:
        pend_ops = sum(_PENDING_OPS.pop(x, 0) for x in drain)
        pend_bags = sum(_PENDING_BAGS.pop(x, 0) for x in drain)
        devprof_sum: Dict[str, float] = {}
        for p in w["programs"]:
            for k, v in (_PROGRAMS.get(p) or {}).items():
                if isinstance(v, (int, float)):
                    devprof_sum[k] = devprof_sum.get(k, 0) + v
    dispatches = int(w["dispatches"])
    floor = _floor_ms()
    fields: dict = {
        "uuid": u,
        "source": w["source"],
        "pairs": int(pairs),
        "lanes": int(lanes),
        "delta_ops": int(delta_ops) + pend_ops,
        "full_bag": int(full_bag) + pend_bags,
        "poisoned": int(poisoned),
        "overflow_retries": int(overflow_retries),
        "dispatches": dispatches,
        "programs": len(w["programs"]),
        "wall_ms": round(wall_ms, 3),
        "floor_ms": floor,
        "floor_budget_ms": round(floor * dispatches, 3),
    }
    if path:
        fields["path"] = str(path)
    if level is not None:
        fields["level"] = int(level)
    if bucket is not None:
        fields["bucket"] = int(bucket)
    if batch_rows is not None:
        fields["batch_rows"] = int(batch_rows)
    if uuids is not None:
        fields["tenants"] = len(uuids)
    if tokens is not None:
        fields["tokens"] = int(tokens)
        fields["token_budget"] = int(token_budget)
    if devprof_sum:
        fields["devprof"] = devprof_sum
    if semantic:
        # the divergence join proper: the wave.digest summary rides
        # next to the cost numbers (agreed/distinct/valid — staleness
        # histograms stay on the wave.digest event itself)
        fields["semantic"] = {
            k: semantic[k]
            for k in ("agreed", "distinct", "valid", "wave")
            if k in semantic
        }
    core.event("wave.cost", **fields)
    core.counter("costmodel.waves").inc()
    # Perfetto counter tracks: each set lands as a timestamped gauge
    # event, so dispatches and divergence render as curves next to the
    # wave spans they price
    core.gauge("costmodel.dispatches.wave").set(dispatches)
    core.gauge("costmodel.delta_ops.wave").set(fields["delta_ops"])
    if tokens is not None:
        core.gauge("costmodel.tokens.wave").set(int(tokens))
    return fields


# ---------------------------------------------------------- analysis


def _wave_cost_events(events: Sequence[dict]) -> List[dict]:
    return [e.get("fields") or {} for e in events
            if e.get("ev") == "event" and e.get("name") == "wave.cost"]


def _divergence_of(f: dict) -> Optional[int]:
    """The wave's divergence measure: delta ops where the stream
    recorded them (zero counts — a converged wave that still paid
    full cost is the strongest O(doc) evidence), else the kernel's
    token count (the segment-union work size — divergent regions
    explode to tokens, the shared base dedupes). A full-bag wave with
    no delta count is excluded: its divergence was shipped as O(doc),
    not measured."""
    if f.get("delta_ops"):
        return int(f["delta_ops"])
    if f.get("full_bag"):
        # full-bag work with no delta count: divergence was shipped
        # as O(doc), never measured — the tokens of the surviving
        # live rows would understate it
        return None
    if f.get("tokens"):
        return int(f["tokens"])
    if "delta_ops" in f:
        return 0
    return None


def cost_vs_divergence(waves: Sequence[dict]) -> dict:
    """Least-squares fit of wave cost (wall ms) against wave
    divergence over a stream of ``wave.cost`` fields, with the
    explicit O(doc)-vs-O(delta) verdict the delta-native roadmap item
    gates on:

    - ``O(delta)`` — over the observed divergence range the fitted
      slope moves the cost by at least half its MEAN: cost scales
      materially with divergence;
    - ``O(doc)`` — it does not: waves pay document-width cost however
      small the divergence (the PERF.md claim, now computed — a tiny
      correlated drift on a large flat cost stays O(doc));
    - ``insufficient-data`` — fewer than two waves, or no divergence
      spread to regress over.
    """
    pts = []
    for f in waves:
        x = _divergence_of(f)
        y = f.get("wall_ms")
        if x is not None and isinstance(y, (int, float)):
            pts.append((float(x), float(y)))
    return _fit_points(pts)


def _fit_points(pts: Sequence[Tuple[float, float]]) -> dict:
    """The fit proper, over already-extracted (divergence, wall_ms)
    points — shared by the batch pass and :class:`CostReducer` so the
    live fold's curve is bit-equal to the batch one."""
    out: dict = {"points": len(pts)}
    if len(pts) < 2:
        out["verdict"] = "insufficient-data"
        return out
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    n = len(pts)
    mx = sum(xs) / n
    my = sum(ys) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    syy = sum((y - my) ** 2 for y in ys)
    sxy = sum((x - mx) * (y - my) for x, y in pts)
    out.update(
        divergence_min=min(xs), divergence_max=max(xs),
        cost_min_ms=round(min(ys), 3), cost_max_ms=round(max(ys), 3),
        mean_cost_ms=round(my, 3),
    )
    if sxx == 0:
        out["verdict"] = "insufficient-data"
        return out
    slope = sxy / sxx
    intercept = my - slope * mx
    corr = (sxy / (sxx * syy) ** 0.5) if syy > 0 else 0.0
    # how far the divergence slope moves the cost over the observed
    # range, relative to the MEAN cost (see _SLOPE_EXPLAINS): a
    # negative slope is noise, not delta-scaling
    explained = max(slope, 0.0) * (max(xs) - min(xs))
    ratio = explained / my if my > 0 else 0.0
    out.update(
        slope_ms_per_op=round(slope, 6),
        intercept_ms=round(intercept, 3),
        corr=round(corr, 4),
        explained_ratio=round(ratio, 4),
        verdict="O(delta)" if ratio >= _SLOPE_EXPLAINS else "O(doc)",
    )
    return out


class CostReducer:
    """Incremental form of :func:`costmodel_digest`: feed obs records
    one at a time (a live tail, a subscriber queue), read the
    cost-model aggregate at any point. Totals accumulate in stream
    order — integer sums are exact and the wall-ms float sum runs in
    the identical order as the batch pass, so :meth:`digest` is
    bit-equal to ``costmodel_digest(events)`` on the same stream.

    Regression points are kept per path too (``"delta"`` / ``"full"``
    / the emitting source), on bounded oldest-dropped deques
    (``points_max``) — a live monitor over an unbounded stream must
    not grow without bound, and the fold must stay O(1) per record;
    truncation is reported honestly, pooled via ``points_dropped``
    and per path in the ``curves_by_path`` fits."""

    __slots__ = ("waves", "dispatches", "delta_ops", "full_bag",
                 "wall_ms", "lanes_max", "_pts", "_pts_by_path",
                 "_dropped_by_path", "points_max", "points_dropped")

    def __init__(self, points_max: int = 65536):
        self.waves = 0
        self.dispatches = 0
        self.delta_ops = 0
        self.full_bag = 0
        self.wall_ms = 0.0
        self.lanes_max = 0
        self.points_max = int(points_max)
        self._pts = deque(maxlen=self.points_max)
        self._pts_by_path: Dict[str, deque] = {}
        self._dropped_by_path: Dict[str, int] = {}
        self.points_dropped = 0

    def feed(self, e: dict) -> None:
        if e.get("ev") != "event" or e.get("name") != "wave.cost":
            return
        f = e.get("fields") or {}
        self.waves += 1
        self.dispatches += int(f.get("dispatches") or 0)
        self.delta_ops += int(f.get("delta_ops") or 0)
        self.full_bag += int(f.get("full_bag") or 0)
        self.wall_ms += float(f.get("wall_ms") or 0.0)
        self.lanes_max = max(self.lanes_max, int(f.get("lanes") or 0))
        x = _divergence_of(f)
        y = f.get("wall_ms")
        if x is not None and isinstance(y, (int, float)):
            pt = (float(x), float(y))
            if len(self._pts) == self.points_max:
                self.points_dropped += 1
            self._pts.append(pt)
            path = str(f.get("path") or f.get("source") or "?")
            by = self._pts_by_path.get(path)
            if by is None:
                by = self._pts_by_path[path] = deque(
                    maxlen=self.points_max)
            if len(by) == by.maxlen:
                self._dropped_by_path[path] = \
                    self._dropped_by_path.get(path, 0) + 1
            by.append(pt)

    def curve(self) -> dict:
        """The pooled cost-vs-divergence fit (``_fit_points``)."""
        return _fit_points(self._pts)

    def curves_by_path(self) -> Dict[str, dict]:
        """Per-path fits, only meaningful with >1 path (the delta
        -vs-full A/B shape ``gap_report`` renders). A path whose
        deque truncated carries its own ``points_dropped`` — the
        verdict was fitted over a window, and the reader must know."""
        out = {}
        for k, v in sorted(self._pts_by_path.items()):
            fit = _fit_points(v)
            if self._dropped_by_path.get(k):
                fit["points_dropped"] = self._dropped_by_path[k]
            out[k] = fit
        return out

    def digest(self) -> dict:
        """``costmodel_digest``'s dict (empty when no waves fed)."""
        if not self.waves:
            return {}
        out = {
            "waves": self.waves,
            "dispatches": self.dispatches,
            "delta_ops": self.delta_ops,
            "full_bag": self.full_bag,
            "wall_ms": round(self.wall_ms, 3),
            "lanes_max": self.lanes_max,
        }
        out["slope"] = self.curve()
        if self.points_dropped:
            out["points_dropped"] = self.points_dropped
        return out


def costmodel_digest(events: Sequence[dict]) -> dict:
    """The cost-model aggregate of one obs stream — the ledger row
    extension (``row["cost"]``): wave/dispatch totals, divergence
    totals, and the slope verdict. Empty dict when the stream carries
    no ``wave.cost`` events. The batch form of :class:`CostReducer` —
    one shared body, so live folds match ledger digests bit-for-bit."""
    r = CostReducer()
    for e in events:
        r.feed(e)
    return r.digest()


# --------------------------------------------------------- gap report


def _best_bench_rows(rows: Sequence[dict]) -> Dict[str, dict]:
    """Best (lowest headline) non-quarantined full-size bench row per
    platform string — the only rows a headline claim may cite."""
    best: Dict[str, dict] = {}
    for r in rows:
        if (r.get("kind") or "bench") != "bench":
            continue
        if r.get("quarantined") or r.get("smoke"):
            continue
        v = r.get("value_ms")
        if not isinstance(v, (int, float)):
            continue
        p = str(r.get("platform") or "?")
        if p not in best or v < best[p]["value_ms"]:
            best[p] = r
    return best


def _stage_shares(events: Sequence[dict]) -> List[dict]:
    """Per-phase shares from ``stages.prefix`` events (the v5 stage
    ladder), when the stream carries them: each stage's delta over the
    FULL prefix's p50. Last ladder wins (streams may hold several)."""
    ladder: Dict[str, dict] = {}
    for e in events:
        if e.get("ev") == "event" and e.get("name") == "stages.prefix":
            f = e.get("fields") or {}
            if f.get("stage") and f.get("p50_ms") is not None:
                ladder[str(f["stage"])] = f
    if not ladder:
        return []
    full = ladder.get("FULL") or max(
        ladder.values(), key=lambda f: f["p50_ms"])
    total = float(full["p50_ms"]) or 1.0
    out = []
    for name, f in ladder.items():
        delta = float(f.get("delta_ms") or 0.0)
        out.append({"stage": name, "delta_ms": round(delta, 3),
                    "share": round(delta / total, 4)})
    out.sort(key=lambda d: -d["delta_ms"])
    return out


def tree_decomposition(events: Sequence[dict]) -> Optional[dict]:
    """Per-level cost decomposition of merge-tree convergence runs in
    one obs stream: join each ``tree.level`` semantic event with the
    ``wave.cost`` events carrying the same level index (a stream may
    hold several tree runs; levels aggregate). None when the stream
    carries no tree levels."""
    levels: Dict[int, dict] = {}
    for e in events:
        if e.get("ev") != "event":
            continue
        f = e.get("fields") or {}
        if e.get("name") == "tree.level":
            lv = levels.setdefault(int(f.get("level") or 0), {
                "level": int(f.get("level") or 0), "waves": 0,
                "pairs": 0, "delta_ops": 0, "dispatches": 0,
                "wall_ms": 0.0, "paths": set(), "agreed": 0,
            })
            lv["waves"] += 1
            lv["pairs"] += int(f.get("pairs") or 0)
            lv["delta_ops"] += int(f.get("delta_ops") or 0)
            lv["dispatches"] += int(f.get("dispatches") or 0)
            if f.get("path"):
                lv["paths"].add(str(f["path"]))
            if f.get("agreed"):
                lv["agreed"] += 1
        elif e.get("name") == "wave.cost" and f.get("level") is not None:
            lv = levels.get(int(f["level"]))
            if lv is not None:
                lv["wall_ms"] += float(f.get("wall_ms") or 0.0)
    if not levels:
        return None
    out = []
    total = sum(lv["wall_ms"] for lv in levels.values()) or 1.0
    for k in sorted(levels):
        lv = levels[k]
        lv["paths"] = "+".join(sorted(lv["paths"])) or "?"
        lv["wall_ms"] = round(lv["wall_ms"], 3)
        lv["share"] = round(lv["wall_ms"] / total, 4)
        out.append(lv)
    post = [lv for lv in out if lv["level"] > 0]
    return {
        "rounds": len(out),
        "levels": out,
        "wall_ms": round(sum(lv["wall_ms"] for lv in out), 3),
        # the tree's acceptance shape: later levels ride the delta
        # path (inter-level divergence shrinks as subtrees converge)
        "post_level0_delta_share": round(
            sum(1 for lv in post if "delta" in lv["paths"])
            / len(post), 4) if post else None,
    }


def gap_report(rows: Sequence[dict],
               events: Optional[Sequence[dict]] = None,
               target_ms: float = NORTH_STAR_MS,
               floor_ms: Optional[float] = None) -> dict:
    """The north-star decomposition from the perf ledger plus an
    optional obs stream. Total on empty inputs (every section states
    its absence) — the first question to a broken run is "is there any
    evidence at all?". The headline is the card's (``gpu``) row;
    ``floor_ms`` defaults to the card's dispatch floor."""
    if floor_ms is None:
        floor_ms = _floor_ms()
    events = list(events or [])
    best = _best_bench_rows(rows)
    head = best.get(CHIP_PLATFORM)
    head_note = ""
    if head is None and best:
        head = min(best.values(), key=lambda r: r["value_ms"])
        head_note = (f"no {CHIP_PLATFORM} row in the ledger; best "
                     "available platform shown — the 100 ms target is "
                     f"defined on {CHIP_PLATFORM}")
    waves = _wave_cost_events(events)
    report: dict = {
        "target_ms": target_ms,
        "floor_ms": floor_ms,
        "ledger_rows": len(rows),
        "stream_waves": len(waves),
        "platforms": {
            p: {"value_ms": r["value_ms"],
                "single_dispatch_ms": r.get("single_dispatch_ms"),
                "kernel": r.get("kernel"), "source": r.get("source")}
            for p, r in sorted(best.items())
        },
    }
    if head is not None:
        single = head.get("single_dispatch_ms")
        report["headline"] = {
            "value_ms": head["value_ms"],
            "single_dispatch_ms": single,
            "platform": head.get("platform"),
            "kernel": head.get("kernel"),
            "source": head.get("source"),
            "gap_x": round(float(head["value_ms"]) / target_ms, 2),
        }
        if head_note:
            report["headline"]["note"] = head_note
        # dispatch-floor arithmetic, lifted from PERF.md prose: the
        # floor's share of a single dispatch (amortized bursts pay it
        # once per burst), and the per-wave floor budget under the
        # stream's measured dispatches-per-wave
        dpw = None
        if waves:
            ds = sorted(int(f.get("dispatches") or 0) for f in waves)
            dpw = ds[len(ds) // 2]
        report["dispatch_floor"] = {
            "floor_ms": floor_ms,
            "dispatches_per_wave": dpw,
            "floor_budget_ms": (round(floor_ms * dpw, 3)
                                if dpw is not None else floor_ms),
            "share_of_single": (
                round(floor_ms / float(single), 4)
                if isinstance(single, (int, float)) and single else None),
            "share_of_target": round(floor_ms / target_ms, 4),
        }
    else:
        report["headline"] = None
    stages = _stage_shares(events)
    if stages:
        report["stages"] = stages
    tree = tree_decomposition(events)
    if tree:
        report["tree"] = tree
    curve = cost_vs_divergence(waves)
    report["cost_vs_divergence"] = curve
    # per-path curves: when the stream carries waves from more than
    # one generation ("delta" vs "full", else the emitting source),
    # each gets its own slope verdict — the delta-native acceptance
    # gate is "O(delta) for the delta path AND O(doc) for the
    # full-weave control", which one pooled fit cannot express
    groups: Dict[str, List[dict]] = {}
    for f in waves:
        groups.setdefault(
            str(f.get("path") or f.get("source") or "?"), []
        ).append(f)
    if len(groups) > 1:
        report["cost_vs_divergence_by_path"] = {
            k: cost_vs_divergence(v) for k, v in sorted(groups.items())
        }
    # projection: if wave cost scaled with the measured divergence
    # (the delta-native weave's promise), the headline would shrink to
    # its divergence fraction — floored by the dispatch floor, which
    # no kernel can amortize below one dispatch
    fracs = [(_divergence_of(f) or 0) / float(f["lanes"])
             for f in waves
             if f.get("lanes") and _divergence_of(f) is not None]
    if head is not None and fracs:
        fracs.sort()
        frac = fracs[len(fracs) // 2]
        projected = max(floor_ms, float(head["value_ms"]) * frac)
        report["projected"] = {
            "divergence_fraction": round(frac, 6),
            "headline_ms": round(projected, 3),
            "gap_x": round(projected / target_ms, 2),
            "assumes": "cost scales with measured divergence "
                       "(the delta-native weave contract)",
        }
    return report


def render_gap(report: dict) -> str:
    """The human layout of :func:`gap_report` — one glanceable
    decomposition block."""
    lines = [f"north-star gap (target {report['target_ms']:g} ms, "
             f"dispatch floor {report['floor_ms']:g} ms)"]
    head = report.get("headline")
    if head is None:
        lines.append("  headline: NO eligible bench row in the ledger "
                     "(nothing non-quarantined at full size)")
    else:
        lines.append(
            f"  headline: {head['value_ms']:g} ms amortized "
            f"({head['platform']}, {head['kernel']}, {head['source']})"
            f" = {head['gap_x']:g}x off target")
        if head.get("note"):
            lines.append(f"    note: {head['note']}")
        if head.get("single_dispatch_ms"):
            lines.append(f"  single dispatch: "
                         f"{head['single_dispatch_ms']:g} ms")
        fl = report.get("dispatch_floor") or {}
        if fl:
            share = fl.get("share_of_single")
            lines.append(
                f"  dispatch floor: {fl['floor_budget_ms']:g} ms/wave"
                + (f" ({fl['dispatches_per_wave']} dispatch(es)/wave)"
                   if fl.get("dispatches_per_wave") is not None else "")
                + (f", {100 * share:.1f}% of a single dispatch"
                   if share is not None else "")
                + f", {100 * fl['share_of_target']:.0f}% of the target")
    for st in report.get("stages", []):
        lines.append(f"  phase {st['stage']}: {st['delta_ms']:g} ms "
                     f"({100 * st['share']:.1f}%)")
    tree = report.get("tree")
    if tree:
        lines.append(
            f"  merge tree: {tree['rounds']} round(s), "
            f"{tree['wall_ms']:g} ms total"
            + (f", post-level-0 delta share "
               f"{100 * tree['post_level0_delta_share']:.0f}%"
               if tree.get("post_level0_delta_share") is not None
               else ""))
        for lv in tree["levels"]:
            lines.append(
                f"    level {lv['level']}: {lv['pairs']} pair(s), "
                f"{lv['delta_ops']} delta op(s), "
                f"{lv['dispatches']} dispatch(es), "
                f"{lv['wall_ms']:g} ms ({100 * lv['share']:.1f}%), "
                f"path {lv['paths']}")
    def _curve_line(c, label="cost vs divergence"):
        if c.get("verdict") == "insufficient-data":
            return (f"  {label}: insufficient data "
                    f"({c.get('points', 0)} wave(s) in the stream)")
        return (
            f"  {label}: {c['points']} waves, divergence "
            f"{c['divergence_min']:g}-{c['divergence_max']:g} ops, "
            f"slope {c['slope_ms_per_op']:g} ms/op "
            f"(corr {c['corr']:g}, explains "
            f"{100 * c['explained_ratio']:.0f}% of spread) -> "
            f"verdict: {c['verdict']}")

    c = report.get("cost_vs_divergence") or {}
    if c:
        lines.append(_curve_line(c))
    for name, cp in sorted(
            (report.get("cost_vs_divergence_by_path") or {}).items()):
        lines.append(_curve_line(cp, label=f"path {name}"))
    proj = report.get("projected")
    if proj:
        lines.append(
            f"  projected if cost ∝ divergence: {proj['headline_ms']:g}"
            f" ms ({proj['gap_x']:g}x target; measured divergence "
            f"fraction {proj['divergence_fraction']:g})")
    return "\n".join(lines)


# ----------------------------------------------------------------- CLI


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import sys

    from . import ledger as ledger_mod
    from .perfetto import load_jsonl

    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.obs gap",
        description="Render the north-star gap decomposition from the "
                    "committed perf ledger plus any obs JSONL streams "
                    "(dispatch-floor share, per-phase shares, the "
                    "cost-vs-divergence slope with its O(doc)-vs-"
                    "O(delta) verdict, and the projected headline if "
                    "cost scaled with divergence).")
    ap.add_argument("--ledger", default="",
                    help="ledger path (default: CAUSE_TPU_LEDGER or "
                         "measurements_torch/ledger.jsonl)")
    ap.add_argument("--obs", action="append", default=[],
                    help="obs JSONL stream(s) carrying wave.cost / "
                         "stages.prefix events (repeatable)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report as JSON instead of text")
    ap.add_argument("--append", action="store_true",
                    help="also land the report as a --kind gap summary "
                         "row in the ledger (platform-partitioned like "
                         "every other row)")
    ap.add_argument("--source", default="obs-gap",
                    help="source tag for the --append row")
    ap.add_argument("--target", type=float, default=NORTH_STAR_MS,
                    help="target ms (default: the 100 ms north star)")
    ap.add_argument("--floor", type=float, default=_floor_ms(),
                    help="dispatch floor ms (default: the H100's "
                         "measured per-tick floor)")
    a = ap.parse_args(argv)

    rows = ledger_mod.load(a.ledger or None)
    events: List[dict] = []
    for path in a.obs:
        if not os.path.exists(path):
            print(f"gap: no such obs stream: {path}", file=sys.stderr)
            return 2
        events.extend(load_jsonl(path))
    report = gap_report(rows, events, target_ms=a.target,
                        floor_ms=a.floor)
    if a.json:
        print(json.dumps(report, indent=1))
    else:
        print(render_gap(report))
    if a.append:
        head = report.get("headline") or {}
        platform = head.get("platform")
        if not platform:
            # no headline in the target ledger (fresh/scratch): tag
            # the row with the stream's own platform so it still
            # partitions honestly instead of quarantining as "none"
            plats = [e.get("platform") for e in events
                     if e.get("ev") == "event"
                     and e.get("name") == "wave.cost"
                     and e.get("platform")]
            platform = plats[0] if plats else "none"
        row = ledger_mod.ingest_record(
            {"platform": platform,
             "metric": f"north-star gap decomposition "
                       f"(target {a.target:g} ms)",
             "value": None,
             "kernel": head.get("kernel"),
             "config": "gap-report"},
            source=a.source, path=a.ledger or None, kind="gap",
            extra={"gap": report},
        )
        print(f"gap: ledger row ({row['platform']}) -> "
              f"{a.ledger or ledger_mod.default_path()}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
