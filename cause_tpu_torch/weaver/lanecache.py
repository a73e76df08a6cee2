"""Persistent per-handle device-lane caches.

The device marshal (``NodeArrays.from_nodes_map`` + ``tree_segments``)
used to be recomputed from the Python node dicts on every merge wave,
even though a tree's lanes and chain runs are a static per-tree fact
that each op changes only incrementally. The reference's whole design
is incremental caches — yarns and weave are maintained per-op and only
rebuilt from the bag of nodes on demand (shared.cljc:9-12,121-149);
this module gives the device lanes the same discipline:

- a ``LaneArena`` is an append-only structure-of-arrays store of one
  tree's marshalled lanes (the ``NodeArrays`` columns), shared across
  tree versions the way persistent vectors share tails: a ``LaneView``
  is ``(arena, n)`` and owning the arena tip lets an append extend in
  place (amortized O(k) per op); a non-tip extend copies first.
- appends are the common case by construction: a freshly minted node's
  lamport-ts exceeds every ts in the tree (``shared.insert`` fast-
  forwards the clock), so ``conj``/``extend``/``append`` always add
  lanes in ascending id order. Anything else — foreign mid-order
  inserts, wefts — drops the cache; the next device use rebuilds it
  lazily from the node dict (always correct, never stale: see
  ``CausalTree.evolve``, which clears ``lanes`` whenever ``nodes``
  changes without an explicit new cache).
- site-id ranks come from a per-collection-uuid ``SharedInterner``
  with *gapped* ranks, so every replica of one document in the process
  packs ids identically — a batched merge wave can ship cached lanes
  from many replicas straight into one kernel with no re-ranking —
  and a new site almost never disturbs existing ranks (it takes the
  midpoint of its neighbors' gap; only gap exhaustion forces a global
  reassignment, which bumps a generation stamp that invalidates
  stale-ranked arenas).
- per-view segment tables (``tree_segments``) are memoized on the
  arena, so a merge wave ships cached segment tables too.

The cache is only ever an accelerator: every consumer falls back to
``NodeArrays.from_nodes_map`` when a view is absent, stale, or outside
the PackSpec domain, and the invalidation fuzz suite asserts cached
lanes are indistinguishable from from-scratch lanes after arbitrary op
sequences (tests/test_lanecache.py).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional

import numpy as np

from .arrays import (
    DEFAULT_PACK,
    NodeArrays,
    PackSpec,
    vclass_of,
    next_pow2,
)
from ..ids import is_id
from ..obs import counter as _obs_counter, enabled as _obs_enabled

__all__ = [
    "SharedInterner",
    "interner_for",
    "LaneArena",
    "LaneView",
    "build_view",
    "extend_view",
    "view_for",
    "compatible",
    "shared_prefix_len",
    "union_views",
    "union_views_many",
]


_RANK_CEIL = (1 << DEFAULT_PACK.site_bits) - 1  # rank 2^18-1 is reserved
# (the all-ones lo packing is the padding sentinel, arrays.PackSpec)


class SharedInterner:
    """Order-preserving site-id -> rank map shared by every replica of
    one collection uuid in this process.

    Ranks are *gapped*: sites spread over the 18-bit rank space so a
    new site takes the midpoint of its neighbors' gap and existing
    assignments never move — which is what keeps independently grown
    replica caches mutually comparable (same string, same rank, in
    every arena). When a gap is exhausted all ranks are reassigned
    evenly and ``generation`` bumps; arenas stamped with an older
    generation re-rank lazily (their internal order stays valid — the
    reassignment is order-preserving — but they can no longer be mixed
    with fresh lanes in one kernel invocation).

    ``len()`` reports ``max_rank + 1`` so ``PackSpec.check``'s site
    bound covers the gapped layout, and ``NodeArrays``' one-past-the-
    end ghost rank stays collision-free.
    """

    __slots__ = ("sites", "rank", "generation", "max_rank", "_lock")

    def __init__(self):
        self.sites: List[str] = []
        self.rank: Dict[str, int] = {}
        self.generation = 0
        self.max_rank = -1  # cached: __len__ sits on the append hot path
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return self.max_rank + 1

    def __contains__(self, site: str) -> bool:
        return site in self.rank

    def _reassign(self) -> None:
        # bump the generation BEFORE swapping the dict: a reader that
        # captures the new dict is then guaranteed to see the bumped
        # generation and bail (extend_view's capture-then-check), while
        # one that captured the old dict writes old-generation ranks
        # that its arena stamp still matches
        step = max(1, _RANK_CEIL // (len(self.sites) + 1))
        self.generation += 1
        self.rank = {s: (i + 1) * step for i, s in enumerate(self.sites)}
        self.max_rank = len(self.sites) * step

    def ensure(self, sites) -> int:
        """Intern any missing sites; returns the (possibly bumped)
        generation."""
        missing = sorted(set(s for s in sites if s not in self.rank))
        if not missing:
            return self.generation
        with self._lock:
            for s in missing:
                if s in self.rank:
                    continue
                pos = bisect.bisect_left(self.sites, s)
                lo = self.rank[self.sites[pos - 1]] if pos > 0 else -1
                hi = (
                    self.rank[self.sites[pos]]
                    if pos < len(self.sites)
                    else _RANK_CEIL
                )
                mid = (lo + hi) // 2
                self.sites.insert(pos, s)
                if mid <= lo or mid >= hi:
                    self._reassign()  # gap exhausted: spread + new gen
                else:
                    self.rank[s] = mid
                    if mid > self.max_rank:
                        self.max_rank = mid
        return self.generation


_REGISTRY: Dict[str, SharedInterner] = {}
_REGISTRY_LOCK = threading.Lock()
_REGISTRY_CAP = 4096


def interner_for(uuid: str) -> SharedInterner:
    """The process-wide shared interner of one collection uuid."""
    it = _REGISTRY.get(uuid)
    if it is None:
        with _REGISTRY_LOCK:
            it = _REGISTRY.get(uuid)
            if it is None:
                if len(_REGISTRY) >= _REGISTRY_CAP:
                    # drop ~half, oldest-inserted first (dict order);
                    # evicted uuids simply mint a fresh interner (their
                    # existing arenas keep a reference and stay valid)
                    for k in list(_REGISTRY)[: _REGISTRY_CAP // 2]:
                        del _REGISTRY[k]
                it = SharedInterner()
                _REGISTRY[uuid] = it
    return it


def _seg_cache_put(cache: dict, n: int, segs) -> None:
    """Shared bounded-insert policy for arena segment caches (callers
    hold whatever locking they need)."""
    if len(cache) >= 4:
        try:
            cache.pop(min(cache))
        except (ValueError, KeyError):
            pass  # concurrent evictor got there first
    cache[n] = segs


class LaneArena:
    """Append-only lane arena shared by successive versions of one
    tree. ``committed_n`` is the arena tip: a view owning the tip may
    extend in place; any other extension copies into a fresh arena
    first (so sibling branches can never see each other's lanes)."""

    __slots__ = (
        "ts", "site", "tx", "cause_idx", "vclass", "cause_hi", "cause_lo",
        "nodes", "lane_of", "interner", "generation", "spec",
        "committed_n", "seg_cache", "lock",
    )

    def __init__(self, ts, site, tx, cause_idx, vclass, cause_hi, cause_lo,
                 nodes, lane_of, interner, generation, spec, committed_n):
        self.ts = ts
        self.site = site
        self.tx = tx
        self.cause_idx = cause_idx
        self.vclass = vclass
        self.cause_hi = cause_hi
        self.cause_lo = cause_lo
        self.nodes = nodes          # list of (id, cause, value), lane order
        self.lane_of = lane_of      # {id: lane}
        self.interner = interner
        self.generation = generation
        self.spec = spec
        self.committed_n = committed_n
        self.seg_cache = {}         # {n: tree_segments result}
        self.lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return int(self.ts.shape[0])

    def sync_ranks(self) -> None:
        """Upgrade this arena in place after an interner rank
        reassignment. Reassignment is order-preserving, so only the
        site lane and the packed cause-lo lane carry stale VALUES —
        one vectorized rewrite each brings every view over this arena
        back into the current generation (no rebuild, no drop). The
        memoized segment tables embed packed ids, so they clear."""
        it = self.interner
        if self.generation == it.generation:
            return
        with self.lock:
            with it._lock:  # consistent (generation, rank) snapshot;
                # ensure() never takes an arena lock, so no cycle
                gen = it.generation
                rank = it.rank
            if self.generation == gen:
                return
            n = self.committed_n
            self.site[:n] = np.fromiter(
                (rank[nd[0][1]] for nd in self.nodes[:n]), np.int64, n
            )
            has_c = self.cause_idx[:n] >= 0
            ci = np.clip(self.cause_idx[:n], 0, max(0, n - 1))
            self.cause_lo[:n] = np.where(
                has_c,
                self.spec.pack_lo(self.site[:n][ci], self.tx[:n][ci]),
                self.cause_lo[:n],
            )
            # dangling id causes (no lane to gather from): re-pack off
            # the host cause tuple — rare, weft-gibberish only
            dang = (self.cause_hi[:n] >= 0) & ~has_c
            if dang.any():
                ghost = len(it)
                for i in np.flatnonzero(dang):
                    cz = self.nodes[i][1]
                    self.cause_lo[i] = self.spec.pack_lo(
                        np.int32(rank.get(cz[1], ghost)), np.int32(cz[2])
                    )
            self.seg_cache.clear()
            self.generation = gen


class LaneView:
    """An immutable (arena, n) snapshot — the ``lanes`` cache slot of
    one ``CausalTree`` version."""

    __slots__ = ("arena", "n")

    def __init__(self, arena: LaneArena, n: int):
        self.arena = arena
        self.n = n

    @property
    def generation(self) -> int:
        return self.arena.generation

    @property
    def interner(self) -> SharedInterner:
        return self.arena.interner

    def node_arrays(self) -> NodeArrays:
        """A ``NodeArrays`` over this view. Lanes at or beyond ``n``
        may hold a newer version's data in the shared arena, so every
        column is masked to the view (cheap vectorized copies)."""
        self.arena.sync_ranks()
        a, n, cap = self.arena, self.n, self.arena.capacity
        valid = np.zeros(cap, bool)
        valid[:n] = True
        return NodeArrays(
            ts=np.where(valid, a.ts, 0),
            site=np.where(valid, a.site, 0),
            tx=np.where(valid, a.tx, 0),
            cause_idx=np.where(valid, a.cause_idx, -1),
            vclass=np.where(valid, a.vclass, 0),
            valid=valid,
            cause_hi=np.where(valid, a.cause_hi, -1),
            cause_lo=np.where(valid, a.cause_lo, -1),
            nodes=a.nodes[:n],
            interner=a.interner,
            n=n,
            spec=a.spec,
            spec_ok=True,
        )

    def segments(self, na: Optional[NodeArrays] = None):
        """Memoized ``tree_segments`` of this view (the per-tree chain
        tables the v5 kernel unions). Pass the ``node_arrays()`` you
        already built to skip re-masking the columns on a miss."""
        segs = self.arena.seg_cache.get(self.n)
        if segs is None:
            _obs_counter("lanecache.segments.miss").inc()
            from .segments import tree_segments

            if na is None:
                na = self.node_arrays()
            hi, lo = na.id_lanes()
            segs = tree_segments(hi, lo, na.cause_idx, na.vclass, na.n)
            with self.arena.lock:
                _seg_cache_put(self.arena.seg_cache, self.n, segs)
        else:
            _obs_counter("lanecache.segments.hit").inc()
        return segs


def _arena_from_node_arrays(na: NodeArrays, interner: SharedInterner,
                            generation: int) -> LaneArena:
    return LaneArena(
        ts=na.ts.copy(), site=na.site.copy(), tx=na.tx.copy(),
        cause_idx=na.cause_idx.copy(), vclass=na.vclass.copy(),
        cause_hi=na.cause_hi.copy(), cause_lo=na.cause_lo.copy(),
        nodes=list(na.nodes),
        lane_of={nid: i for i, (nid, _, _) in enumerate(na.nodes)},
        interner=interner, generation=generation, spec=na.spec,
        committed_n=na.n,
    )


def build_view(nodes_map: dict, uuid: str,
               spec: PackSpec = DEFAULT_PACK) -> Optional[LaneView]:
    """Marshal a node dict into a fresh cached view (shared-interner
    ranks). Returns None when the ids are outside the PackSpec domain
    — callers keep their existing from-scratch fallbacks."""
    interner = interner_for(uuid)
    gen = interner.ensure(nid[1] for nid in nodes_map)
    na = NodeArrays.from_nodes_map(
        nodes_map, capacity=next_pow2(len(nodes_map)),
        interner=interner, spec=spec,
    )
    if not na.spec_ok:
        return None
    view = LaneView(_arena_from_node_arrays(na, interner, gen), na.n)
    if _obs_enabled():
        # devprof host-memory telemetry: a from-scratch marshal is the
        # expensive rebuild path, so its arena footprint is the curve
        # that shows fleet-cache growth in a trace
        from ..obs import devprof as _devprof

        _devprof.arena_footprint(view.arena, site="lanecache.build")
    return view


def _copy_arena(view: LaneView, min_capacity: int) -> LaneArena:
    a, n = view.arena, view.n
    cap = next_pow2(min_capacity)

    def grow(arr, fill):
        out = np.full(cap, fill, arr.dtype)
        out[:n] = arr[:n]
        return out

    return LaneArena(
        ts=grow(a.ts, 0), site=grow(a.site, 0), tx=grow(a.tx, 0),
        cause_idx=grow(a.cause_idx, -1), vclass=grow(a.vclass, 0),
        cause_hi=grow(a.cause_hi, -1), cause_lo=grow(a.cause_lo, -1),
        nodes=a.nodes[:n],
        lane_of={nid: i for i, (nid, _, _) in enumerate(a.nodes[:n])},
        interner=a.interner, generation=a.generation, spec=a.spec,
        committed_n=n,
    )


def extend_view(view: Optional[LaneView], new_nodes) -> Optional[LaneView]:
    """Append freshly inserted nodes to a cached view.

    Applies only to the append fast path: every new id must exceed the
    view's tail id and arrive in ascending order (what ``conj`` /
    ``extend`` / ``append`` mint, since the lamport clock fast-forwards
    past every known ts). Anything else — mid-order foreign inserts, a
    site whose interning reassigned ranks, ids beyond the PackSpec —
    returns None and the cache is simply dropped (rebuilt lazily).
    """
    if view is None:
        return None
    # attempt/append counters: the gap between them is the bail rate
    # (cache drops that force a lazy rebuild) — the signal the round-3
    # incremental-marshal work exists to keep near zero
    _obs_counter("lanecache.extend.attempt").inc()
    arena = view.arena
    interner = arena.interner
    arena.sync_ranks()  # a rank reassignment upgrades in place
    n = view.n
    tail = arena.nodes[n - 1][0] if n > 0 else None
    prev = tail
    for nd in new_nodes:
        if prev is not None and nd[0] <= prev:
            return None
        prev = nd[0]
    gen = interner.ensure(nd[0][1] for nd in new_nodes)
    if gen != arena.generation:
        return None
    k = len(new_nodes)
    spec = arena.spec
    try:
        spec.check(
            max(nd[0][0] for nd in new_nodes),
            len(interner),
            max(max(nd[0][2] for nd in new_nodes),
                max((nd[1][2] for nd in new_nodes if is_id(nd[1])),
                    default=0)),
        )
    except OverflowError:
        return None

    # resolve every id cause BEFORE mutating anything (a mid-append
    # bail would leave the arena corrupt). The shared lane_of may hold
    # a sibling branch's lanes at index >= n — those are NOT ours.
    pos = {nd[0]: n + j for j, nd in enumerate(new_nodes)}
    cause_lane = []
    for nd in new_nodes:
        c = nd[1]
        if is_id(c):
            c = tuple(c)
            ci = pos.get(c)
            if ci is None:
                ci = arena.lane_of.get(c)
                if ci is None or ci >= n:
                    return None  # dangling / foreign-branch cause
            cause_lane.append(ci)
        else:
            cause_lane.append(-1)

    with arena.lock:
        if arena.committed_n != n or n + k > arena.capacity:
            arena = _copy_arena(view, n + k)
        # capture-then-check: a concurrent gap-exhaustion reassignment
        # swaps the rank dict after bumping the generation, so a rank
        # dict captured under a still-matching generation is guaranteed
        # to carry this arena's generation of ranks
        rank = interner.rank
        if interner.generation != arena.generation:
            return None
        lane_of = arena.lane_of
        i = n
        for (nid, cause, value), ci in zip(new_nodes, cause_lane):
            arena.ts[i] = nid[0]
            arena.site[i] = rank[nid[1]]
            arena.tx[i] = nid[2]
            arena.vclass[i] = vclass_of(value)
            arena.cause_idx[i] = ci
            if ci >= 0:
                arena.cause_hi[i] = cause[0]
                arena.cause_lo[i] = spec.pack_lo(
                    np.int32(rank.get(cause[1], len(interner))),
                    np.int32(cause[2]),
                )
            else:
                arena.cause_hi[i] = -1
                arena.cause_lo[i] = -1
            arena.nodes.append((nid, cause, value))
            lane_of[nid] = i
            i += 1
        arena.committed_n = n + k
        # extend the memoized segment tables in O(k) when the append
        # shape allows (segments.extend_segments); a bail just leaves
        # the next device use to recompute lazily
        old_segs = arena.seg_cache.get(n)
        if old_segs is not None:
            from .segments import extend_segments

            lo_win = spec.pack_lo(arena.site[n - 1: n + k],
                                  arena.tx[n - 1: n + k])
            new_segs = extend_segments(
                old_segs, arena.ts, lo_win, arena.cause_idx,
                arena.vclass, n, n + k,
            )
            if new_segs is not None:
                _seg_cache_put(arena.seg_cache, n + k, new_segs)
    _obs_counter("lanecache.extend.append").inc()
    return LaneView(arena, n + k)


def _list_shaped_types():
    """Tree types whose lanes ARE list lanes (maps need the key-rooted
    forest encoding of ``weaver.mapw``). Derived from the type
    constants so a rename can't silently diverge."""
    from ..collections.shared import COUNTER_TYPE, LIST_TYPE, SET_TYPE

    return frozenset((LIST_TYPE, SET_TYPE, COUNTER_TYPE))


LIST_SHAPED: frozenset = None  # populated lazily (import-cycle safety)


def view_for(ct) -> Optional[LaneView]:
    """The tree's cached view if fresh, else a new build — LIST-SHAPED
    trees only: a map tree through these lanes would mint a
    list-semantics weave, so it returns None and callers take their
    fallback path. None also when the tree is outside the
    cacheable domain (PackSpec overflow)."""
    global LIST_SHAPED
    if LIST_SHAPED is None:
        LIST_SHAPED = _list_shaped_types()
    if ct.type not in LIST_SHAPED:
        _obs_counter("lanecache.view.unshaped").inc()
        return None
    view = getattr(ct, "lanes", None)
    if isinstance(view, LaneView) and view.n == len(ct.nodes):
        _obs_counter("lanecache.view.hit").inc()
        return view
    _obs_counter("lanecache.view.rebuild").inc()
    return build_view(ct.nodes, ct.uuid)


def compatible(views) -> bool:
    """Whether these views' lanes are directly comparable in one kernel
    invocation: same shared interner object, same rank generation
    (stale arenas are upgraded in place first — see sync_ranks)."""
    views = [v for v in views if v is not None]
    if not views:
        return False
    it = views[0].interner
    for v in views:
        if v.interner is not it:
            return False
        v.arena.sync_ranks()
    gen = it.generation
    return all(v.generation == gen for v in views)


def _packed_keys(a: LaneArena, n: int) -> np.ndarray:
    lo = a.spec.pack_lo(a.site[:n], a.tx[:n])
    return (a.ts[:n].astype(np.int64) << 32) | (
        lo.astype(np.int64) & 0xFFFFFFFF
    )


def shared_prefix_len(va: LaneView, vb: LaneView) -> int:
    """Length of the leading lane range holding IDENTICAL node ids in
    both views — the converged resident prefix of a replica pair, the
    quantity the delta-native wave pins its frozen region to. Lanes
    are id-sorted, so one vectorized packed-key compare finds the
    first divergence point. Views must be ``compatible`` (same rank
    generation) or the packed site ranks would not be comparable;
    the delta-session caller guarantees that."""
    n = min(va.n, vb.n)
    if n <= 0:
        return 0
    ka = _packed_keys(va.arena, n)
    kb = _packed_keys(vb.arena, n)
    eq = ka == kb
    if eq.all():
        return n
    return int(np.argmin(eq))


def union_views(va: LaneView, vb: LaneView) -> Optional[LaneView]:
    """Vectorized union of two cached views into a fresh view over the
    merged node set (see ``union_views_many``)."""
    return union_views_many((va, vb))


def union_views_many(views) -> Optional[LaneView]:
    """Vectorized K-way union of cached views into a fresh view over
    the merged node set — the marshal half of an accelerated merge
    with NO per-node Python loop and no dict sort: one packed-key
    argsort of every view's concatenated lanes, adjacent-duplicate
    drop, and one searchsorted pass to re-resolve causes against the
    union. Requires ``compatible`` views (same interner generation, or
    the packed keys would not be comparable); body conflicts between
    duplicate ids are NOT checked here — callers run the append-only
    union validation (shared.union_nodes semantics) before trusting
    the result."""
    views = list(views)
    if not views or not compatible(views):
        return None
    arenas = [v.arena for v in views]
    ns = [v.n for v in views]
    keys = np.concatenate([
        _packed_keys(a, n) for a, n in zip(arenas, ns)
    ])
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    dup = np.zeros(len(ks), bool)
    dup[1:] = ks[1:] == ks[:-1]
    kept = order[~dup]
    n = len(kept)
    cap = next_pow2(n)

    def col(name, fill):
        src = np.concatenate([
            getattr(a, name)[:cnt] for a, cnt in zip(arenas, ns)
        ])
        out = np.full(cap, fill, src.dtype)
        out[:n] = src[kept]
        return out

    ts = col("ts", 0)
    site = col("site", 0)
    tx = col("tx", 0)
    vclass = col("vclass", 0)
    cause_hi = col("cause_hi", -1)
    cause_lo = col("cause_lo", -1)
    # re-resolve causes against the union's packed keys
    union_keys = ks[~dup]
    q = (cause_hi[:n].astype(np.int64) << 32) | (
        cause_lo[:n].astype(np.int64) & 0xFFFFFFFF
    )
    posq = np.searchsorted(union_keys, q)
    posc = np.clip(posq, 0, max(0, n - 1))
    found = (cause_hi[:n] >= 0) & (n > 0) & (union_keys[posc] == q)
    cause_idx = np.full(cap, -1, np.int32)
    cause_idx[:n] = np.where(found, posc, -1)

    # map each kept concat position back to its source (view, lane)
    bounds = np.cumsum([0] + ns)
    src_view = np.searchsorted(bounds, kept, side="right") - 1
    src_lane = kept - bounds[src_view]
    node_lists = [a.nodes for a in arenas]
    nodes = [
        node_lists[int(v)][int(i)] for v, i in zip(src_view, src_lane)
    ]
    arena = LaneArena(
        ts=ts, site=site, tx=tx, cause_idx=cause_idx, vclass=vclass,
        cause_hi=cause_hi, cause_lo=cause_lo, nodes=nodes,
        lane_of={nid: i for i, (nid, _, _) in enumerate(nodes)},
        interner=arenas[0].interner, generation=views[0].generation,
        spec=arenas[0].spec, committed_n=n,
    )
    return LaneView(arena, n)
