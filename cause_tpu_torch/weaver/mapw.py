"""Batched device path for MAP trees: key-rooted forests on the list
merge kernels.

Port of ``cause_tpu.weaver.mapw``. Map weaves are first-class in the
reference (map.cljc:21-45, merge at :248-249): every key holds a mini
list-weave — key-caused nodes hang at the key's root in recency order,
id-caused nodes hang under their target (undo by id). That IS a forest
of list-weave components, so the batched device story reuses the list
machinery wholesale: encode each map tree as lanes over a synthetic id
space —

- lane 0: one global root, id ``(-2, 0)`` (sorts below everything;
  the kernels' "sorted lane 0 is the root" contract);
- next: one key-root lane per key present in the tree, id
  ``(-1, key_rank)`` — key ranks interned over the UNION of keys in a
  batch (same contract as ``SiteInterner`` for sites), so two
  replicas' roots for one key carry the SAME id and the kernel's
  duplicate elimination dedupes them exactly like shared base nodes;
- then the real nodes in ascending id order: key-caused lanes point
  ``cci`` at their key root, id-caused lanes at their target.

Since real ids are non-negative, synthetic ids can never collide, and
within each tree the lane order remains ascending-id. The merged
per-key weave falls out of the kernel's Euler order: each key subtree
is contiguous, specials-first / descending-id sibling order is exactly
map recency order, and id-caused chains resolve through the same
host-jump the list path uses.

``merge_map_wave`` runs the forest lanes through the v5 segment-union
kernel (``torchw5.batched_merge_weave_v5``: on the card its six sorts
are the B1 kernel, the forest walk B2 and the lane expansion B3) or,
with ``kernel="v4"``, through the reference's original full-width route
(``batched_merge_map_weave``: ``torchw4.batched_merge_weave_v4`` at a
run budget of the full row, its two sorts B1 and its forest walk B2).
The sharded twins wait for the multi-device port (ROADMAP A.15): they
raise.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..collections import shared as s
from ..device import default_device
from ..ids import is_id
from .arrays import (
    DEFAULT_PACK,
    I32_MAX,
    OutsideDomain,
    SiteInterner,
    next_pow2,
    vclass_of,
)

__all__ = [
    "key_table",
    "forest_lanes",
    "pair_rows",
    "batched_merge_map_weave",
    "batched_merge_map_weave_v5",
    "map_v5_inputs",
    "sharded_merge_map_weave",
    "sharded_merge_map_weave_v5",
    "merged_map_weave",
    "map_row_digest",
    "MapWaveResult",
    "merge_map_wave",
]

GLOBAL_ROOT_HI = np.int32(-2)
KEY_ROOT_HI = np.int32(-1)


def _key_sort_token(k) -> tuple:
    """Deterministic, type-stable ordering token for map keys (keys may
    mix keywords, strings, numbers — Python can't compare those
    directly)."""
    return (type(k).__name__, repr(k))


def key_table(trees_nodes: Sequence[dict]) -> Dict[object, int]:
    """Rank every key appearing across the batch (order-preserving
    over the union — the key twin of SiteInterner's contract)."""
    keys = set()
    for nodes_map in trees_nodes:
        for cause, _v in nodes_map.values():
            if not is_id(cause) and cause is not None:
                keys.add(cause)
    ordered = sorted(keys, key=_key_sort_token)
    return {k: i for i, k in enumerate(ordered)}


def forest_lanes(nodes_map: dict, key_rank: Dict[object, int],
                 interner: SiteInterner, cap: int,
                 spec=DEFAULT_PACK):
    """One map tree as forest lanes padded to ``cap``.

    Returns ``(hi, lo, cci, vc, valid, lane_nodes, lane_keys)`` where
    ``lane_nodes[i]`` is the host node triple of a real lane (None for
    synthetic lanes) and ``lane_keys`` the key of each key-root lane.
    Raises OutsideDomain for shapes the pure weaver defines but the
    forest encoding doesn't (dangling id causes, id-caused targets that
    are themselves id-caused — same domain rule as ``map_lanes``).
    """
    ids = sorted(nodes_map)
    present = set()
    for cause, _v in nodes_map.values():
        if not is_id(cause):
            present.add(cause)
    tree_keys = sorted(present, key=_key_sort_token)
    n_keys = len(tree_keys)
    n = 1 + n_keys + len(ids)
    if n > cap:
        raise OverflowError(f"capacity {cap} < {n} forest lanes")
    if ids:
        # ids beyond the PackSpec bit layout would silently wrap the
        # packed lo lane and reorder the merge — same off-device stance
        # as NodeArrays.from_nodes_map
        try:
            spec.check(max(i[0] for i in ids), len(interner),
                       max(i[2] for i in ids))
        except OverflowError:
            raise OutsideDomain() from None

    hi = np.full(cap, I32_MAX, np.int32)
    lo = np.full(cap, I32_MAX, np.int32)
    cci = np.full(cap, -1, np.int32)
    vc = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    lane_nodes: List[Optional[tuple]] = [None] * cap
    lane_keys: List[Optional[object]] = [None] * cap

    hi[0], lo[0] = GLOBAL_ROOT_HI, 0
    valid[0] = True
    key_lane = {}
    for j, k in enumerate(tree_keys):
        lane = 1 + j
        hi[lane] = KEY_ROOT_HI
        lo[lane] = key_rank[k]
        cci[lane] = 0
        valid[lane] = True
        lane_keys[lane] = k
        key_lane[k] = lane

    idx_of = {nid: 1 + n_keys + i for i, nid in enumerate(ids)}
    rank = interner.rank
    n_real = len(ids)
    if n_real:
        base = 1 + n_keys
        sl = slice(base, base + n_real)
        # vectorized columns (dict lookups stay Python — they carry the
        # domain checks — but the numeric packing is numpy)
        hi[sl] = np.fromiter((nid[0] for nid in ids), np.int64, n_real)
        site_r = np.fromiter((rank[nid[1]] for nid in ids), np.int64,
                             n_real)
        tx_r = np.fromiter((nid[2] for nid in ids), np.int64, n_real)
        lo[sl] = spec.pack_lo(site_r.astype(np.int32),
                              tx_r.astype(np.int32))
        valid[sl] = True
        bodies = [nodes_map[nid] for nid in ids]
        vc[sl] = np.fromiter((vclass_of(v) for _, v in bodies), np.int32,
                             n_real)

        def resolve(cause):
            if is_id(cause):
                t = idx_of.get(tuple(cause))
                if t is None:
                    raise OutsideDomain()  # dangling target
                if is_id(nodes_map[tuple(cause)][0]):
                    raise OutsideDomain()  # id-caused targeting id-caused
                return t
            return key_lane[cause]

        cci[sl] = np.fromiter((resolve(c) for c, _ in bodies), np.int64,
                              n_real)
        for i, nid in enumerate(ids):
            lane_nodes[base + i] = (nid, bodies[i][0], bodies[i][1])
    return hi, lo, cci, vc, valid, lane_nodes, lane_keys


def _assemble(rows, cap: int):
    """``[B, 2*cap]`` lane arrays from each row's two ``forest_lanes``
    results (tree b's cause lanes offset by ``cap``), and each row's
    ``(lane_nodes, lane_keys)`` pairs."""
    B, N = len(rows), 2 * cap
    out = {
        "hi": np.full((B, N), I32_MAX, np.int32),
        "lo": np.full((B, N), I32_MAX, np.int32),
        "cci": np.full((B, N), -1, np.int32),
        "vc": np.zeros((B, N), np.int32),
        "valid": np.zeros((B, N), bool),
    }
    meta_rows = []
    for r, row in enumerate(rows):
        rm = []
        for t, (hi, lo, cci, vc, valid, lane_nodes, lane_keys) in enumerate(
                row):
            sl = slice(t * cap, (t + 1) * cap)
            out["hi"][r, sl] = hi
            out["lo"][r, sl] = lo
            out["cci"][r, sl] = np.where(cci >= 0, cci + t * cap, -1)
            out["vc"][r, sl] = vc
            out["valid"][r, sl] = valid
            rm.append((lane_nodes, lane_keys))
        meta_rows.append(rm)
    return out, meta_rows


def pair_rows(pairs: Sequence[Tuple[dict, dict]],
              spec=DEFAULT_PACK):
    """[B, 2*cap] forest-lane batch for replica pairs of one map doc.

    Key ranks and site ranks are interned over the whole batch, so
    every row's synthetic and real ids are mutually comparable and
    shared keys/nodes dedupe on device. Returns ``(lanes, meta)``:
    ``lanes`` the dict of [B, 2*cap] arrays (``benchgen.LANE_KEYS4``
    layout), ``meta`` the per-row host artifacts for
    ``merged_map_weave``.
    """
    from ..obs import span as _span

    with _span("mapw.pair_rows", pairs=len(pairs)):
        trees = [t for pair in pairs for t in pair]
        krank = key_table(trees)
        interner = SiteInterner(nid[1] for t in trees for nid in t)
        cap = next_pow2(max(1 + len(krank) + len(t) for t in trees))
        lanes, meta = _assemble(
            [[forest_lanes(t, krank, interner, cap, spec) for t in pair]
             for pair in pairs], cap)
        return lanes, {"rows": meta, "capacity": cap, "key_rank": krank}


def batched_merge_map_weave(lanes: Dict[str, np.ndarray], k_max: int = 0,
                            device=None):
    """The full-width v4 forest route on ``device`` (the package default,
    ``use_device``, when None): ``torchw4.batched_merge_weave_v4`` over
    ``[B, 2*cap]`` forest lanes. ``k_max`` 0 sizes the run budget at
    full width (map forests have no chain runs to compress — every
    key-caused node is a sibling, so the run count ~ lane count).
    Returns ``(order, rank, visible, conflict, overflow)`` tensors per
    row, rank and visibility per SORTED lane."""
    from ..benchgen import LANE_KEYS4
    from .torchw4 import batched_merge_weave_v4

    if k_max <= 0:
        k_max = int(lanes["hi"].shape[1])
    dev = default_device() if device is None else device
    return batched_merge_weave_v4(*(lanes[k] for k in LANE_KEYS4),
                                  k_max=k_max, device=dev)


def map_v5_inputs(lanes: Dict[str, np.ndarray], cap: int):
    """Segment-union (v5) inputs for forest-lane rows: the SAME
    marshal the list path uses (benchgen.batched_v5_inputs — segment
    extraction is id-layout-agnostic; synthetic key-root ids sort
    below every real id, so per-tree lanes stay ascending and the
    shared key roots dedupe as single-lane twins exactly like shared
    base segments). Returns ``(v5lanes, u_budget)``."""
    from .. import benchgen

    v5b = benchgen.batched_v5_inputs(lanes, cap)
    return v5b, benchgen.v5_token_budget(v5b)


def batched_merge_map_weave_v5(lanes: Dict[str, np.ndarray], cap: int,
                               u_max: int = 0, v5b=None, device="cuda"):
    """The v5 segment-union route for map forests: merge cost scales
    with divergence, like list fleets. Returns ``(rank, visible,
    conflict, overflow)`` tensors on ``device`` in CONCAT-LANE
    coordinates (the v5 contract: no order array) plus the effective
    token budget. ``v5b``: pre-marshalled segment lanes
    (``map_v5_inputs``) so an overflow retry does not redo the host
    segment extraction."""
    from .. import benchgen
    from .torchw5 import batched_merge_weave_v5

    if v5b is None:
        v5b, est = map_v5_inputs(lanes, cap)
        if u_max <= 0:
            u_max = est
    elif u_max <= 0:
        u_max = benchgen.v5_token_budget(v5b)
    t = benchgen.lanes_from_numpy(v5b, device)
    out = batched_merge_weave_v5(
        *(t[k] for k in benchgen.LANE_KEYS5),
        u_max=u_max, k_max=u_max, device=device,
    )
    return out, u_max


def sharded_merge_map_weave_v5(mesh, lanes: Dict[str, np.ndarray],
                               cap: int, u_max: int = 0):
    """The reference's sharded v5 map route: not ported yet."""
    raise NotImplementedError(
        "sharded_merge_map_weave_v5: the sharded map wave is not ported "
        "yet (ROADMAP A.15)")


def sharded_merge_map_weave(mesh, lanes: Dict[str, np.ndarray],
                            k_max: int = 0):
    """The reference's sharded v4 map route: not ported yet."""
    raise NotImplementedError(
        "sharded_merge_map_weave: the sharded map wave is not ported yet "
        "(ROADMAP A.15)")


def merged_map_weave(lanes, meta, order, rank, row: int):
    """Rebuild pair ``row``'s merged per-key weave dict from the
    kernel's order — the map twin of the list paths' rank argsort.
    Key subtrees are contiguous in Euler order; each key's segment
    starts at its key-root lane.

    ``order`` is a sorted-lane permutation (the v4 route);
    ``None`` means the v5 contract — ``rank`` is already indexed by
    concat lane."""
    from ..ids import ROOT_ID, ROOT_NODE

    cap = meta["capacity"]
    rank_r = np.asarray(rank[row])
    N = 2 * cap
    # presort-lane visit order: sorted positions ordered by rank
    kept = rank_r < N
    pos = np.flatnonzero(kept)
    pos = pos[np.argsort(rank_r[pos], kind="stable")]
    if order is None:
        lanes_in_order = pos
    else:
        lanes_in_order = np.asarray(order[row])[pos]
    (nodes_a, keys_a), (nodes_b, keys_b) = meta["rows"][row]

    weave: Dict[object, list] = {}
    current = None
    for lane in lanes_in_order:
        lane = int(lane)
        t, j = divmod(lane, cap)
        lane_nodes, lane_keys = (nodes_a, keys_a) if t == 0 else (
            nodes_b, keys_b)
        if lane_keys[j] is not None:
            current = lane_keys[j]
            weave.setdefault(current, [ROOT_NODE])
            continue
        nd = lane_nodes[j]
        if nd is None:
            continue  # the global root
        nid, cause, value = nd
        in_weave_cause = cause if is_id(cause) else ROOT_ID
        weave[current].append((nid, in_weave_cause, value))
    return weave


def map_row_digest(lanes, order, rank, visible):
    """Per-row uint32 digests over the forest lanes, on the host — the
    reference's ``map_row_digest`` bit for bit. ``order=None`` is the
    v5 contract: rank/visible already index concat lanes, and the mix
    is lane-order-invariant. An ``order`` (the v4 route
    reports rank/visible per SORTED lane) re-sorts the id lanes first."""
    if order is None:
        hi = np.asarray(lanes["hi"]).astype(np.uint32)
        lo = np.asarray(lanes["lo"]).astype(np.uint32)
    else:
        order = np.asarray(order).astype(np.int64)
        hi = np.take_along_axis(
            lanes["hi"], order, axis=1).astype(np.uint32)
        lo = np.take_along_axis(
            lanes["lo"], order, axis=1).astype(np.uint32)
    rank = np.asarray(rank).astype(np.int64)
    m = rank.shape[1]
    keptm = rank < m
    pos = np.where(keptm, rank, 0).astype(np.uint32)
    vis = np.asarray(visible).astype(np.uint32)
    x = (
        hi * np.uint32(0x9E3779B1)
        + lo * np.uint32(0x85EBCA77)
        + pos * np.uint32(0xC2B2AE35)
        + vis * np.uint32(40503)
        + np.uint32(1)
    )
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return np.where(keptm, x, np.uint32(0)).sum(axis=1, dtype=np.uint32)


class MapWaveResult:
    """Converged device state of a map-fleet wave + lazy host
    materialization (the map twin of parallel.wave.WaveResult)."""

    def __init__(self, pairs, lanes, meta, order, rank, visible, digest,
                 fallback=None, digest_valid=None):
        self._pairs = pairs
        self._lanes = lanes
        self._meta = meta
        self._order = order
        self._rank = rank
        self._visible = visible
        self.digest = digest
        self._fallback = fallback or {}
        self.digest_valid = (
            digest_valid if digest_valid is not None
            else np.ones(len(pairs), bool)
        )

    @property
    def fallback(self):
        return sorted(self._fallback)

    def __len__(self):
        return len(self._pairs)

    def merged(self, i: int):
        """Pair ``i``'s converged CausalMap handle — identical to
        ``pairs[i][0].merge(pairs[i][1])`` (with the same append-only
        body validation)."""
        if i in self._fallback:
            return self._fallback[i]
        a, b = self._pairs[i]
        nodes = dict(a.ct.nodes)
        s.check_no_conflicting_bodies(nodes, b.ct.nodes)
        nodes.update(b.ct.nodes)
        weave = merged_map_weave(self._lanes, self._meta, self._order,
                                 self._rank, i)
        lamport = max(
            a.ct.lamport_ts, b.ct.lamport_ts,
            max((nid[0] for nid in nodes), default=0),
        )
        ct = s.spin(a.ct.evolve(nodes=nodes, weave=weave,
                                lamport_ts=lamport))
        return type(a)(ct)


def merge_map_wave(pairs, kernel: str = "v5", device=None) -> MapWaveResult:
    """Converge many CausalMap replica pairs in one batched device
    dispatch on ``device`` (the package default, ``use_device``, when
    None) — the map twin of ``parallel.merge_wave`` (map trees cannot
    ride the list-lane wave; their forest encoding lives here). Pairs
    outside the forest domain (exotic id-cause chains, weft gibberish,
    PackSpec overflow) fall back to the per-pair host merge exactly
    like the list wave's fallback. Body validation between duplicate
    ids is host-side in ``merged``, same contract.

    ``kernel``: "v5", the segment-union route (the shared parts of a
    map fleet union at segment granularity, so the union cost scales
    with divergence), or "v4", the original full-width forest route."""
    pairs = list(pairs)
    if not pairs:
        raise s.CausalError("Nothing to merge.",
                            {"causes": {"empty-fleet"}})
    if kernel not in ("v5", "v4"):
        raise ValueError(
            f"merge_map_wave kernel must be 'v5' or 'v4', got {kernel!r}")
    from ..obs import span as _span

    dev = default_device() if device is None else device
    with _span("mapw.merge_wave", pairs=len(pairs), kernel=kernel):
        return _merge_map_wave(pairs, dev, kernel)


def _dispatch_v5(lanes, cap, u, v5b, device):
    """One v5 forest dispatch; host numpy ``(rank, visible, overflow)``
    (the one place the wave's device outputs come back)."""
    (rank, visible, _conflict, overflow), _u = batched_merge_map_weave_v5(
        lanes, cap, u_max=u, v5b=v5b, device=device)
    return (rank.cpu().numpy(), visible.cpu().numpy(),
            overflow.cpu().numpy().astype(bool))


def _dispatch_v4(lanes, device):
    """One full-width v4 forest dispatch; host numpy ``(order, rank,
    visible)``. A full-width run budget cannot overflow (a row has no
    more runs than lanes)."""
    order, rank, visible, _conflict, overflow = batched_merge_map_weave(
        lanes, device=device)
    if bool(overflow.any()):  # pragma: no cover
        raise s.CausalError("map wave overflowed its run budget",
                            {"causes": {"token-overflow"}})
    return order.cpu().numpy(), rank.cpu().numpy(), visible.cpu().numpy()


def _merge_map_wave(pairs, device, kernel: str) -> MapWaveResult:
    for a, b in pairs:
        s.check_mergeable(a.ct, b.ct)
        if a.ct.type != s.MAP_TYPE:
            raise s.CausalError(
                "merge_map_wave is for map trees; use "
                "parallel.merge_wave for list-shaped fleets",
                {"causes": {"type-missmatch"}, "type": a.ct.type},
            )

    # batch-level key/site tables cover every tree (fallback pairs
    # included: extra entries cost rank space, not correctness)
    trees = [t.ct.nodes for pair in pairs for t in pair]
    krank = key_table(trees)
    interner = SiteInterner(nid[1] for t in trees for nid in t)
    cap = next_pow2(max(1 + len(krank) + len(t) for t in trees))
    fallback = {}
    live = []
    live_rows = []
    for i, (a, b) in enumerate(pairs):
        try:
            row = [forest_lanes(a.ct.nodes, krank, interner, cap),
                   forest_lanes(b.ct.nodes, krank, interner, cap)]
        except OutsideDomain:
            fallback[i] = a.merge(b)
            continue
        live.append(i)
        live_rows.append(row)

    B = len(pairs)
    dig_valid = np.zeros(B, bool)
    digest = np.zeros(B, np.uint32)
    if not live:
        return MapWaveResult(pairs, None, {"rows": [], "capacity": cap},
                             None, None, None, digest, fallback,
                             dig_valid)
    N = 2 * cap
    lanes, meta_rows = _assemble(live_rows, cap)

    if kernel == "v4":
        order, rank, visible = _dispatch_v4(lanes, device)
        row_ovf = np.zeros(len(live), bool)
    else:
        # segment-union route; the overflow flag backstops the sampled
        # token estimate — double and re-dispatch (the segment marshal
        # is done once, only the device program re-runs), and rows that
        # STILL overflow fall back to the host merge per row
        order = None
        v5b, u = map_v5_inputs(lanes, cap)
        for _ in range(3):
            rank, visible, row_ovf = _dispatch_v5(lanes, cap, u, v5b,
                                                  device)
            if not row_ovf.any():
                break
            u *= 2
    live_digest = map_row_digest(lanes, order, rank, visible)

    # expand live rows back to the full index space; overflowed rows
    # carry unspecified ranks — they join the host-merge fallback
    full_order = None if order is None else np.zeros((B, N), np.int32)
    full_rank = np.full((B, N), N, np.int32)
    full_vis = np.zeros((B, N), bool)
    full_meta = [None] * B
    for j, i in enumerate(live):
        if row_ovf[j]:
            a, b = pairs[i]
            fallback[i] = a.merge(b)
            continue
        if order is not None:
            full_order[i] = order[j]
        full_rank[i] = rank[j]
        full_vis[i] = visible[j]
        full_meta[i] = meta_rows[j]
        digest[i] = live_digest[j]
        dig_valid[i] = True
    # merged_map_weave indexes meta["rows"][i] and the full arrays
    full_lanes = {
        k: np.zeros((B,) + v.shape[1:], v.dtype) for k, v in lanes.items()
    }
    for j, i in enumerate(live):
        for k in full_lanes:
            full_lanes[k][i] = lanes[k][j]
    meta_full = {"rows": full_meta, "capacity": cap, "key_rank": krank}
    return MapWaveResult(pairs, full_lanes, meta_full, full_order,
                         full_rank, full_vis, digest, fallback, dig_valid)
