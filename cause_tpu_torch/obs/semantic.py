"""CRDT-semantic events: what the fleet *means*, not how long it took.

Spans and counters say how long a wave took, devprof what it cost the
device. This module is the third layer — the *semantic* health of the replicated state itself,
the signal causally-consistent-replication systems treat as primary
(arXiv:1703.05424's staleness/divergence metrics; SafarDB-style
continuously-checked convergence digests, arXiv:2603.08003):

- **sync events** — every anti-entropy delta application (node count,
  incremental vs union path) and every full-bag fallback with its
  reason, so a fleet operator can see what fraction of rounds degrade
  to O(doc) resends;
- **wave digest agreement** — each merge wave / session wave emits one
  ``wave.digest`` event: how many pairs computed device digests, how
  many distinct values, whether the fleet agreed, plus a staleness
  histogram;
- **divergence monitors** — a per-pair staleness count (waves since
  the pair last matched the fleet's modal convergence digest) kept
  per document across waves, surfaced as ``fleet.staleness.max`` /
  ``.mean`` gauges; and when a wave's digests disagree, exactly one
  ``divergence`` event carrying first-differing-site provenance
  (which site's history the odd replica pair disagrees about first);
- **GC evidence** — ``gc.compact`` events and counters for nodes
  examined / reclaimed / safety-valve declines, so compaction stops
  throwing its evidence away;
- **collection health** — lazy-weave materializations with weave
  length vs live-value count and the tombstone ratio, the read-side
  cost signal the lazy fleet-editing mode exists to manage.

Contract (same as the rest of ``cause_tpu_torch.obs``): stdlib-only at
import time, importable without jax/numpy; with ``CAUSE_TPU_OBS``
unset every entry point returns immediately — no records, no state,
no ``TRACE_SWITCHES`` env reads, byte-identical program-cache keys
(pinned by tests/test_fleet_obs.py). On jit-reachable paths, call
sites must sit behind ``obs.enabled()`` guards — causelint rule
OBS004 gates that (these functions assemble real field dicts, unlike
the no-op span/counter factories).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import core

__all__ = [
    "SEMANTIC_EVENT_PREFIXES",
    "enabled",
    "reset",
    "sync_applied",
    "sync_full_bag",
    "sync_rejected",
    "sync_quarantined",
    "sync_readmitted",
    "observe_wave",
    "observe_tree_level",
    "session_overflow",
    "token_headroom",
    "gc_compacted",
    "lazy_materialized",
    "first_differing_site",
]

# Instant events whose name matches one of these prefixes are the
# semantic vocabulary: the Perfetto exporter routes them onto named
# instant-event tracks (one track per family) instead of burying them
# in the per-thread span track.
SEMANTIC_EVENT_PREFIXES = (
    "sync.",
    "wave.digest",
    "wave.cost",
    "divergence",
    "gc.",
    "collection.",
    "fleet.",
    "tree.",
    "op.",
    "lag.",
    # the live-telemetry read side's own vocabulary
    # (``live.snapshot`` periodic rollups, ``live.alert`` rule
    # firings) and the run heartbeats (``run.heartbeat`` from wave
    # dispatch, sync rounds, harvest ladder items, soak rounds) —
    # each renders as its own named Perfetto track, so a wedge
    # investigation reads alert/heartbeat swim-lanes directly above
    # the spans that stalled
    "live.",
    "run.",
    # the chaos/recovery pairing — every injected fault
    # (``chaos.inject``) and every recovery-ladder transition
    # (``recovery.step``/``retry``/``restore``) on its own named
    # track, so a chaos soak reads as inject -> detect -> recover
    # swim-lanes over the wave spans they disrupted
    "chaos.",
    "recovery.",
    # the serve-loop and network-transport vocabularies —
    # admission sheds/ticks, and the wire's connect/reconnect/
    # heartbeat/nack/duplicate evidence — each on its own named
    # track, so a partition investigation reads disconnect ->
    # backoff -> reconnect -> resumed-suffix swim-lanes over the
    # serve ticks they starved
    "serve.",
    "net.",
)


def enabled() -> bool:
    """Whether semantic events record anything (== ``obs.enabled()``)."""
    return core.enabled()


# ------------------------------------------------------------------ sync


def sync_applied(n_nodes: int, path: str, uuid: str = "") -> None:
    """One anti-entropy delta landed: ``path`` is ``"incremental"``
    (pure-weaver small-delta replay) or ``"union"`` (one-pass union +
    reweave), matching ``sync.apply_delta``'s dispatch."""
    if not core.enabled():
        return
    core.counter("sync.delta_rounds").inc()
    core.counter("sync.delta_nodes").inc(int(n_nodes))
    core.event("sync.delta_apply", nodes=int(n_nodes), path=path,
               **({"uuid": uuid} if uuid else {}))


def sync_full_bag(reason: str, uuid: str = "") -> None:
    """The prefix-gap fallback fired: the whole bag of nodes is being
    exchanged instead of a delta. ``reason`` is ``"cause-must-exist"``
    (our merge rejected the peer's delta), ``"peer-resync"`` (the
    peer rejected ours and asked for the bag),
    ``"payload-reject"`` (validate-before-apply refused the delta) or
    ``"quarantined"`` (the peer is serving its re-admission resync)."""
    if not core.enabled():
        return
    core.counter("sync.full_bag").inc()
    core.event("sync.full_bag", reason=reason,
               **({"uuid": uuid} if uuid else {}))


def sync_rejected(why: str, uuid: str = "", peer: str = "") -> None:
    """Validate-before-apply refused a sync payload at the ingest
    boundary: the document is untouched, the round degrades
    to a full-bag resync, and this is the DETECTION evidence the
    chaos soak gates injected payload faults against."""
    if not core.enabled():
        return
    core.counter("sync.reject").inc()
    core.event("sync.reject", why=why,
               **{k: v for k, v in (("uuid", uuid), ("peer", peer))
                  if v})


def sync_quarantined(peer: str, uuid: str = "", rejects: int = 0) -> None:
    """A repeat offender crossed the consecutive-reject threshold and
    is quarantined out of delta exchanges and device waves until a
    clean full-bag resync re-admits it."""
    if not core.enabled():
        return
    core.counter("sync.quarantine").inc()
    core.event("sync.quarantine", peer=peer, rejects=int(rejects),
               **({"uuid": uuid} if uuid else {}))


def sync_readmitted(peer: str, uuid: str = "") -> None:
    """A quarantined replica served a clean validated full-bag resync
    and is back in the delta/wave fast paths."""
    if not core.enabled():
        return
    core.counter("sync.readmit").inc()
    core.event("sync.readmit", peer=peer,
               **({"uuid": uuid} if uuid else {}))


# ----------------------------------------------------------- divergence

# Per-(uuid, source) wave monitor state: wave index + per-pair
# staleness counts. Process-wide (waves on one document accumulate
# across merge_wave calls); reset() drops it for tests. Bounded:
# a 600k-round soak mints a fresh document per round, so the monitor
# evicts its least-recently-waved documents past _MON_MAX — staleness
# for a document nobody is waving is not a signal anyone reads.
_MON_LOCK = threading.Lock()
_MON: Dict[Tuple[str, str], dict] = {}
_MON_MAX = 4096


def reset() -> None:
    """Drop all divergence-monitor state (tests; obs.reset does not
    reach into the semantic layer)."""
    with _MON_LOCK:
        _MON.clear()


def first_differing_site(vv_ref: dict, vv_got: dict) -> Optional[dict]:
    """Divergence provenance between two merged version vectors
    (``sync.version_vector`` shape, ``{site: [ts, tx]}``): the first
    site — in sorted site order — whose entry differs, with both
    entries. None when the vectors are identical (digests that differ
    under identical vectors would mean the per-site prefix property
    broke, which the sync protocol precludes)."""
    for site in sorted(set(vv_ref) | set(vv_got)):
        a, b = vv_ref.get(site), vv_got.get(site)
        if a != b:
            return {"site": site, "expected": a, "got": b}
    return None


def observe_wave(uuid: str, digests: Sequence, valid: Sequence,
                 vv_of: Optional[Callable[[int], dict]] = None,
                 source: str = "wave") -> Optional[dict]:
    """Record one wave's convergence digests for document ``uuid``.

    ``digests[i]`` / ``valid[i]`` follow ``WaveResult``: a digest only
    counts where valid is truthy (fallback/poisoned rows carry no
    device digest). Emits one ``wave.digest`` event (pair count, valid
    count, distinct digest count, agreement verdict, staleness
    histogram), updates the per-pair staleness counts ("waves since
    this pair last matched the fleet's modal digest" — rows with no
    valid digest age too), sets the ``fleet.staleness.max`` / ``.mean``
    gauges, and when the valid digests disagree emits exactly one
    ``divergence`` event for the wave, with first-differing-site
    provenance when ``vv_of(pair_index) -> version_vector`` is given
    (called lazily, only for the reference and first-divergent pair).

    Returns the wave summary dict (the event's fields), or None when
    obs is off.
    """
    if not core.enabled():
        return None
    B = len(valid)
    vals = [int(digests[i]) for i in range(B) if valid[i]]
    counts: Dict[int, int] = {}
    for v in vals:
        counts[v] = counts.get(v, 0) + 1
    # the modal digest is the fleet's presumed-converged value; ties
    # break toward the earliest pair's digest (deterministic)
    modal = None
    if vals:
        best = max(counts.values())
        for i in range(B):
            if valid[i] and counts[int(digests[i])] == best:
                modal = int(digests[i])
                break
    agreed = bool(vals) and len(counts) == 1

    key = (str(uuid), source)
    with _MON_LOCK:
        st = _MON.pop(key, None)  # re-insert below: LRU order
        if st is None or len(st["stale"]) != B:
            st = {"wave": 0, "stale": [0] * B}
        _MON[key] = st
        while len(_MON) > _MON_MAX:
            _MON.pop(next(iter(_MON)))
        st["wave"] += 1
        wave_idx = st["wave"]
        stale: List[int] = st["stale"]
        ref_pair = None
        bad_pair = None
        for i in range(B):
            if valid[i] and int(digests[i]) == modal:
                stale[i] = 0
                if ref_pair is None:
                    ref_pair = i
            else:
                stale[i] += 1
                if bad_pair is None and valid[i]:
                    bad_pair = i
        hist: Dict[int, int] = {}
        for s_ in stale:
            hist[s_] = hist.get(s_, 0) + 1
        stale_max = max(stale) if stale else 0
        stale_mean = (sum(stale) / len(stale)) if stale else 0.0

    fields = {
        "uuid": str(uuid),
        "source": source,
        "wave": wave_idx,
        "pairs": B,
        "valid": len(vals),
        "distinct": len(counts),
        "agreed": agreed,
        "staleness": {str(k): v for k, v in sorted(hist.items())},
    }
    core.event("wave.digest", **fields)
    core.counter("fleet.waves").inc()
    core.gauge("fleet.staleness.max").set(stale_max)
    core.gauge("fleet.staleness.mean").set(round(stale_mean, 4))
    if vals and not agreed:
        core.counter("fleet.divergence").inc()
        div = {
            "uuid": str(uuid),
            "source": source,
            "wave": wave_idx,
            "pair": bad_pair,
            "digest": int(digests[bad_pair]) if bad_pair is not None
            else None,
            "expected": modal,
            "disagreeing": sum(1 for i in range(B)
                               if valid[i] and int(digests[i]) != modal),
        }
        if vv_of is not None and ref_pair is not None \
                and bad_pair is not None:
            try:
                prov = first_differing_site(vv_of(ref_pair),
                                            vv_of(bad_pair))
            except Exception:  # noqa: BLE001 - telemetry never raises
                prov = None
            if prov is not None:
                div["site"] = prov["site"]
                div["site_expected"] = prov["expected"]
                div["site_got"] = prov["got"]
        core.event("divergence", **div)
    return fields


def observe_tree_level(uuid: str, level: int, digests: Sequence,
                       valid: Sequence, pairs: int, byes: int = 0,
                       delta_ops: int = 0, window: int = 0,
                       path: str = "", dispatches: int = 0,
                       final: bool = False) -> Optional[dict]:
    """Record one merge-tree LEVEL's convergence evidence for document
    ``uuid`` (the hierarchical fleet-convergence rounds of
    ``parallel.tree``): a ``wave.digest`` event with ``source="tree"``
    plus a ``tree.level`` event carrying the level's shape
    (pairs/byes), divergence work (``delta_ops`` window lanes,
    ``window`` = per-side lane budget), kernel ``path``
    ("full"/"delta") and dispatch count.

    Unlike :func:`observe_wave`, intermediate levels deliberately run
    NO staleness aging and mint NO ``divergence`` incidents: mid-tree,
    each pair converges a *different* subtree, so distinct digests are
    the expected shape of a converging fleet, not a health incident —
    ``agreed`` is still reported (a symmetric fleet's levels agree,
    the CI smoke gates on it). The root level (``final=True``) has one
    pair whose digest IS the fleet's converged value; callers feed it
    to the ordinary :func:`observe_wave` monitors if they track the
    document across convergence calls.

    Returns the ``tree.level`` fields dict (the ``wave.cost`` join
    summary), or None when obs is off."""
    if not core.enabled():
        return None
    B = len(valid)
    vals = [int(digests[i]) for i in range(B) if valid[i]]
    distinct = len(set(vals))
    agreed = bool(vals) and distinct == 1
    dig_fields = {
        "uuid": str(uuid),
        "source": "tree",
        "level": int(level),
        "wave": int(level) + 1,
        "pairs": B,
        "valid": len(vals),
        "distinct": distinct,
        "agreed": agreed,
    }
    core.event("wave.digest", **dig_fields)
    fields = {
        "uuid": str(uuid),
        "level": int(level),
        "pairs": int(pairs),
        "byes": int(byes),
        "delta_ops": int(delta_ops),
        "window": int(window),
        "path": str(path),
        "dispatches": int(dispatches),
        "distinct": distinct,
        "agreed": agreed,
        "final": bool(final),
    }
    core.event("tree.level", **fields)
    core.counter("tree.levels").inc()
    if final:
        core.counter("tree.converges").inc()
    return fields


def session_overflow(rows: Sequence[int]) -> None:
    """A FleetSession wave blew its resident token budget (the session
    raises after this — the event is the post-mortem breadcrumb)."""
    if not core.enabled():
        return
    core.counter("fleet.session_overflow").inc()
    core.event("fleet.session_overflow", rows=list(rows))


def token_headroom(slack: int, site: str) -> None:
    """Gauge the token-budget headroom of a dispatch: how many tokens
    of the (pow2-quantized) ``u_max`` the current fleet does NOT need.
    Zero-adjacent headroom means the next divergence spike overflows
    and retries/falls back; ``site`` is ``wave`` or ``session``."""
    if not core.enabled():
        return
    core.gauge(f"fleet.token_headroom.{site}").set(int(slack))


# -------------------------------------------------------------------- gc


def gc_compacted(examined: int, reclaimed: int, refused: bool = False,
                 frontier: bool = False, uuid: str = "") -> None:
    """One ``gc.compact`` run's evidence: node counts in/out, whether
    the EDN safety valve declined the result, whether a stability
    frontier bounded the drop set."""
    if not core.enabled():
        return
    core.counter("gc.runs").inc()
    core.counter("gc.nodes_examined").inc(int(examined))
    core.counter("gc.nodes_reclaimed").inc(int(reclaimed))
    if refused:
        core.counter("gc.safety_valve").inc()
    core.event("gc.compact", examined=int(examined),
               reclaimed=int(reclaimed), refused=bool(refused),
               frontier=bool(frontier),
               **({"uuid": uuid} if uuid else {}))


# ------------------------------------------------------------ collections


def lazy_materialized(ct) -> None:
    """A lazy tree's weave was materialized (``shared.ensure_weave``
    paid the full rebuild). Records the weave length vs live-value
    count and the tombstone ratio — the exact quantity compaction
    exists to reclaim. List trees get the real hide-scan numbers;
    other shapes record lengths only."""
    if not core.enabled():
        return
    weave = ct.weave
    nodes = len(ct.nodes)
    fields = {"type": str(getattr(ct, "type", "?")), "nodes": nodes}
    if isinstance(weave, list):
        # imported lazily from the caller's own package: ensure_weave
        # runs inside collections, so this is always already loaded
        from ..collections.clist import hide_q
        from ..ids import ROOT_ID, is_special

        live = 0
        values = 0
        for i, n in enumerate(weave):
            if n[0] == ROOT_ID or is_special(n[2]):
                continue
            values += 1
            nxt = weave[i + 1] if i + 1 < len(weave) else None
            if not hide_q(n, nxt):
                live += 1
        ratio = (values - live) / values if values else 0.0
        fields.update(weave_len=len(weave), values=values, live=live,
                      tombstone_ratio=round(ratio, 4))
        core.gauge("collection.tombstone_ratio").set(round(ratio, 4))
        core.gauge("collection.weave_len").set(len(weave))
        core.gauge("collection.live").set(live)
    elif isinstance(weave, dict):
        fields.update(weave_len=sum(len(v) for v in weave.values()),
                      keys=len(weave))
    core.counter("collection.lazy_materialize").inc()
    core.event("collection.materialize", **fields)
