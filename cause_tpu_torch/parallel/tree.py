"""Hierarchical merge reduction tree: fleet convergence in O(log n)
batched device rounds.

Counterpart of ``cause_tpu.parallel.tree``. Folding n replicas through
pairwise merges pays n-1 sequential wave rounds, each at full document
width. The tree pairs the replicas up and batches each LEVEL as one
device dispatch:

- **level 0** (first contact) runs the full-width batched v5 kernel +
  digest over all n/2 pairs in one dispatch (``wave.dispatch_full_rows``);
  its ranks freeze the fleet frontier (the shared converged lane
  prefix, its weave-final anchor, and the prefix's exact uint32 digest
  contribution);
- **levels 1..L** ride the delta path: each surviving subtree is a
  *symbolic* record — the frozen prefix plus a pooled, id-sorted
  **side** of its members' divergent lanes (two sides merge by one
  vectorized merge-dedupe, never re-materializing the subtree) — and a
  level's pairwise merges become ONE ``weaver.torchwd.batched_delta_weave``
  dispatch over the anchor+side windows, returning each subtree's TOTAL
  document digest, bit-identical to a full-width weave;
- **pipelining**: a delta level's windows depend only on the pooled host
  sides, so the host merges level k+1's sides after level k is
  dispatched and before its digests are fetched, the level's one sync
  point. PyTorch launches on the card are asynchronous, so this order
  overlaps the host's merging with the device's tail of the level
  without a second stream (the v5 host walk synchronizes inside the
  dispatch, so the overlap is that tail, not the whole level);
- **the root** materializes ONCE: prefix weave ++ root-window weave,
  with the same append-only node-union validation any fold of ``merge``
  performs.

A level whose window outgrows ``w_budget`` (or whose establishment
fails: no shared prefix, tombstoned anchor, out-of-domain causes)
**bounces** to a full-width level — materialize the survivors, run the
document-width kernel, re-establish — and later levels ride delta
again. Convergence is bit-identical to the pairwise fold in every
regime (the weave is a pure function of the node set).

Round count: ceil(log2(n)) levels (odd survivor counts carry a bye to
the next level). The device is the package default (``use_device``)
unless ``device=`` names one. With the chaos engine armed, a
``budget_exhaust("tree")`` fault bounces a delta level to full width
exactly as an outgrown window does (the root is bit-identical), and
injected dispatch faults are retried by ``recovery.run_dispatch``. The
telemetry hooks of the reference are not ported yet (ROADMAP A.13).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import chaos as _chaos
from ..benchgen import LANE_KEYS5, lanes_from_numpy
from ..collections import shared as s
from ..device import resolve_device
from ..weaver import lanecache
from ..weaver.arrays import next_pow2
from . import recovery as _recovery
from .mesh import mix32_np
from .wave import (WaveResult, _assemble_rows, delta_domain_ok,
                   delta_window_rows, dispatch_full_rows, fetch_digest)

__all__ = [
    "merge_tree",
    "merge_tree_report",
    "merge_all_tree",
    "flat_fold",
    "tree_rounds",
]


def tree_rounds(n: int) -> int:
    """ceil(log2(n)) — the tree's round count for ``n`` replicas (0
    for a single replica; byes don't add rounds: survivors halve,
    rounding up, every level)."""
    return (int(n) - 1).bit_length() if n > 1 else 0


# ------------------------------------------------------------- sides


class _Side:
    """One subtree's pooled divergent lanes: id-sorted, deduped, with
    causes carried as packed ids (-1 = the anchor) so window-local
    cause indices re-derive by one searchsorted per level. ``nodes``
    parallels the lanes for root materialization."""

    __slots__ = ("keys", "hi", "lo", "vc", "cause_key", "nodes")

    def __init__(self, keys, hi, lo, vc, cause_key, nodes):
        self.keys = keys
        self.hi = hi
        self.lo = lo
        self.vc = vc
        self.cause_key = cause_key
        self.nodes = nodes

    def __len__(self) -> int:
        return len(self.keys)


def _side_of(view, sp: int, anchor: int) -> _Side:
    """The divergent side of one view w.r.t. the fleet frontier: lanes
    ``[sp, n)`` with causes re-keyed by packed id (anchor -> -1). Lanes
    are already id-sorted (arena layout); the delta-domain check ran at
    establishment."""
    a = view.arena
    n = view.n - sp
    sl = slice(sp, view.n)
    hi = a.ts[sl].astype(np.int32)
    lo = a.spec.pack_lo(a.site[sl], a.tx[sl]).astype(np.int32)
    keys = (hi.astype(np.int64) << 32) | (lo.astype(np.int64)
                                          & 0xFFFFFFFF)
    ci = a.cause_idx[sl]
    ci_c = np.clip(ci, 0, max(0, view.n - 1))
    c_hi = a.ts[ci_c].astype(np.int64)
    c_lo = (a.spec.pack_lo(a.site[ci_c], a.tx[ci_c]).astype(np.int64)
            & 0xFFFFFFFF)
    cause_key = np.where(ci == anchor, np.int64(-1), (c_hi << 32) | c_lo)
    nodes = list(a.nodes[sp:view.n])
    if n > 1 and not bool(np.all(keys[1:] >= keys[:-1])):
        order = np.argsort(keys, kind="stable")
        keys, hi, lo = keys[order], hi[order], lo[order]
        cause_key = cause_key[order]
        vc = a.vclass[sl][order]
        nodes = [nodes[int(i)] for i in order]
        return _Side(keys, hi, lo, vc, cause_key, nodes)
    return _Side(keys, hi, lo, a.vclass[sl].copy(), cause_key, nodes)


def _merge_sides(x: _Side, y: _Side) -> _Side:
    """Partial aggregation: the level-k+1 side is one vectorized
    merge-dedupe of the two level-k sides — O(side), no subtree
    re-materialization."""
    keys = np.concatenate([x.keys, y.keys])
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    dup = np.zeros(len(ks), bool)
    dup[1:] = ks[1:] == ks[:-1]
    keep = order[~dup]

    def take(ax, ay):
        return np.concatenate([ax, ay])[keep]

    nodes_cat = x.nodes + y.nodes
    return _Side(
        ks[~dup], take(x.hi, y.hi), take(x.lo, y.lo),
        take(x.vc, y.vc), take(x.cause_key, y.cause_key),
        [nodes_cat[int(i)] for i in keep],
    )


# ---------------------------------------------------------- subtrees


class _Sub:
    """One surviving subtree. ``handle`` is set for materialized
    survivors (leaves, full-level winners); symbolic delta-level
    winners carry instead the pooled ``side`` plus the level output
    that can materialize them on demand (``ranks``/``wcap``/
    ``sides_lr`` — window ranks stay on the device until asked for)."""

    __slots__ = ("handle", "members", "views", "side", "ranks", "wcap",
                 "sides_lr")

    def __init__(self, handle=None, members=None, views=None, side=None,
                 ranks=None, wcap=0, sides_lr=None):
        self.handle = handle
        self.members = members or ([handle] if handle is not None else [])
        self.views = views or []
        self.side = side
        self.ranks = ranks
        self.wcap = wcap
        self.sides_lr = sides_lr


def _union_nodes(members) -> dict:
    """N-way node union with the append-only validation every merge
    path shares (earlier members win the union so a conflict reports
    the body already in the merge target)."""
    nodes: dict = {}
    for h in reversed(members):
        nodes.update(h.ct.nodes)
    for h in members:
        if not (h.ct.nodes.items() <= nodes.items()):
            for nid, body in h.ct.nodes.items():
                if nodes[nid] != body:
                    raise s.CausalError(
                        "This node is already in the tree and can't "
                        "be changed.",
                        {"causes": {"append-only", "edits-not-allowed"},
                         "existing_node": (nid,) + nodes[nid]},
                    )
    return nodes


def _materialize(sub: _Sub, state: Optional[dict]):
    """A subtree's host handle: the prefix weave ++ its window weave —
    paid once per materialized subtree, which in the steady state means
    ONCE, for the root."""
    if sub.handle is not None:
        return sub.handle
    if state is None or sub.ranks is None:  # pragma: no cover
        raise s.CausalError("merge-tree subtree without a frontier",
                            {"causes": {"tree-internal"}})
    wcap = sub.wcap
    n_w = 2 * wcap
    rw = sub.ranks.cpu().numpy()
    side_l, side_r = sub.sides_lr
    win_nodes: List = [None] * n_w
    for t, side in ((0, side_l), (1, side_r)):
        off = t * wcap
        for j, nd in enumerate(side.nodes):
            win_nodes[off + 1 + j] = nd
    mask = rw < n_w
    mask[0] = False
    mask[wcap] = False
    idx = np.flatnonzero(mask)
    order = idx[np.argsort(rw[idx], kind="stable")]
    prefix_order = np.argsort(state["pr"], kind="stable")
    v0 = state["prefix_view"]
    weave = [v0.arena.nodes[int(j)] for j in prefix_order]
    weave += [win_nodes[int(i)] for i in order]

    nodes = _union_nodes(sub.members)
    union = lanecache.union_views_many(sub.views)
    if union is not None and union.n != len(weave):  # pragma: no cover
        raise s.CausalError(
            "merge-tree materialization inconsistency (weave length "
            "!= union size) — please report",
            {"causes": {"tree-internal"},
             "weave": len(weave), "union": union.n},
        )
    yarns: dict = {}
    if union is not None:
        for nd in union.arena.nodes[:union.n]:
            yarns.setdefault(nd[0][1], []).append(nd)
    first = sub.members[0]
    lamport = max(
        max(h.ct.lamport_ts for h in sub.members),
        max(nid[0] for nid in nodes),
    )
    ct = first.ct.evolve(nodes=nodes, yarns=yarns, weave=weave,
                         lamport_ts=lamport, lanes=union)
    sub.handle = type(first)(ct)
    sub.members = [sub.handle]
    sub.views = [union] if union is not None else sub.views
    return sub.handle


# ----------------------------------------------------- establishment


def _establish(check_views, survivor_views, rank0, vis0, cap) -> Optional[dict]:
    """Freeze the fleet delta frontier from a completed full level:
    the shared converged lane prefix across EVERY view that feeds
    later levels, its weave-final anchor (from pair 0's output ranks,
    with the permutation check the delta session runs), and the
    prefix's frozen digest contribution. None when any check fails —
    later levels then run full width (correct, O(doc)).

    ``check_views`` are the level's INPUT views (pair sides + byes):
    pair 0's rank row indexes input lanes, and the delta domain must
    hold for every divergent lane that exists anywhere in the fleet.
    ``survivor_views`` are the views the sides will slice — their
    first ``s`` lanes must BE the prefix."""
    v0 = check_views[0]
    sp = v0.n
    for v in check_views[1:]:
        sp = min(sp, lanecache.shared_prefix_len(v0, v))
        if sp < 1:
            return None
    for v in survivor_views:
        if lanecache.shared_prefix_len(v0, v) < sp:
            return None
    ra = rank0[:sp]
    rb = rank0[cap:cap + sp]
    pr = np.minimum(ra, rb).astype(np.int32)
    if not bool((pr < sp).all()):
        return None
    if int(pr.max()) != sp - 1 or \
            int(np.bincount(pr, minlength=sp).max()) != 1:
        return None
    anchor = int(np.argmax(pr))
    arena = v0.arena
    if int(arena.vclass[anchor]) > 0:
        return None
    for v in list(check_views) + list(survivor_views):
        if not delta_domain_ok(v, sp, anchor):
            return None
    keep_a = ra < 2 * cap
    vis = np.where(keep_a, vis0[:sp], vis0[cap:cap + sp])
    hi = arena.ts[:sp].astype(np.int32)
    lo = arena.spec.pack_lo(arena.site[:sp], arena.tx[:sp])
    pdig = int(np.uint32(
        mix32_np(hi, lo, pr, vis).sum(dtype=np.uint64)
        & np.uint64(0xFFFFFFFF)))
    return {
        "s": int(sp),
        "anchor": anchor,
        "anchor_hi": np.int32(arena.ts[anchor]),
        "anchor_lo": np.int32(arena.spec.pack_lo(
            arena.site[anchor:anchor + 1],
            arena.tx[anchor:anchor + 1])[0]),
        "pr": pr,
        "prefix_view": v0,
        "pdig": pdig,
    }


# ----------------------------------------------------- level windows


def _assemble_level(sides_pairs, state, wcap: int) -> Dict[str, np.ndarray]:
    """The level's ``[P, 2*wcap]`` delta-window batch
    (``wave.delta_window_rows``): per pair, each tree is the anchor
    followed by that subtree's pooled side, causes re-derived into
    window coordinates by one searchsorted against the side's sorted
    keys."""
    def tree(side):
        pos = np.searchsorted(side.keys, side.cause_key)
        local = np.where(side.cause_key < 0, 0, pos + 1).astype(np.int32)
        return side.hi, side.lo, side.vc, local

    return delta_window_rows(
        ((state["anchor_hi"], state["anchor_lo"], (tree(a), tree(b)))
         for a, b in sides_pairs), wcap)


# ------------------------------------------------------- level runs


def _level_stats(level, P, byes, path, window, delta_ops, digests):
    distinct = len(set(int(d) for d in digests))
    return {"level": level, "pairs": P, "byes": byes, "path": path,
            "window": int(window), "delta_ops": int(delta_ops),
            "distinct": distinct, "agreed": distinct == 1}


def _delta_level(pairs, state, level, byes, device):
    """One delta level: windows assembled from pooled sides, ONE
    ``batched_delta_weave`` dispatch for the whole level, the next
    level's sides merged on the host after the dispatch is queued (the
    pipeline), then one digest fetch. Returns ``(new_subs, digests,
    stats)``, or None if the dispatch overflowed."""
    from ..weaver import torchwd

    sides_pairs = [(a.side, b.side) for a, b in pairs]
    wmax = max(max(len(l), len(r)) for l, r in sides_pairs)
    wcap = next_pow2(max(8, 1 + wmax))
    n_w = 2 * wcap
    P = len(pairs)
    delta_ops = sum(len(l) + len(r) for l, r in sides_pairs)
    lanes = _assemble_level(sides_pairs, state, wcap)
    pdig = np.full(P, np.uint32(state["pdig"]), np.uint32)
    r0 = np.full(P, state["s"] - 1, np.int32)
    t = lanes_from_numpy(lanes, device)
    rank_w, _vis_w, dig, ovf = _recovery.run_dispatch(
        "tree",
        lambda: torchwd.batched_delta_weave(
            *(t[k] for k in LANE_KEYS5), pdig, r0,
            u_max=int(n_w), k_max=int(n_w), device=device))
    # pipeline: merge the NEXT level's sides on the host while the
    # window weave finishes on the device; the digest fetch below is
    # this level's only sync point
    new_subs = [
        _Sub(members=a.members + b.members, views=a.views + b.views,
             side=_merge_sides(a.side, b.side), ranks=rank_w[i],
             wcap=wcap, sides_lr=(a.side, b.side))
        for i, (a, b) in enumerate(pairs)
    ]
    digests = fetch_digest(dig)
    if bool(ovf.any()):  # pragma: no cover - unreachable at u = N_w
        return None
    return new_subs, digests, _level_stats(level, P, byes, "delta", wcap,
                                           delta_ops, digests)


def _full_level(pairs, state, level, byes, bye_subs, device):
    """One full-width level (first contact / bounce): materialize both
    sides of every pair, run the document-width kernel+digest over the
    whole level in one dispatch, materialize the winners, and
    (re-)establish the delta frontier for the levels that follow."""
    handles_pairs = [(_materialize(a, state), _materialize(b, state))
                     for a, b in pairs]
    views_pairs = []
    for ha, hb in handles_pairs:
        va = lanecache.view_for(ha.ct)
        vb = lanecache.view_for(hb.ct)
        if va is not None and vb is not None \
                and not lanecache.compatible((va, vb)):
            va = lanecache.build_view(ha.ct.nodes, ha.ct.uuid)
            vb = lanecache.build_view(hb.ct.nodes, hb.ct.uuid)
        if va is None or vb is None or not lanecache.compatible(
                (va, vb)):
            raise s.CausalError(
                "fleet outside the device domain (PackSpec overflow "
                "or map-shaped tree)",
                {"causes": {"outside-domain"}},
            )
        views_pairs.append((va, vb))
    P = len(pairs)
    cap = next_pow2(max(max(va.n, vb.n) for va, vb in views_pairs))
    lanes = _assemble_rows(views_pairs, cap)
    rank, vis, dig, _info = dispatch_full_rows(lanes, site="tree",
                                               device=device)
    res = WaveResult(handles_pairs, views_pairs, cap, rank, vis,
                     dig, {}, "v5", digest_valid=np.ones(P, bool))
    winners = [res.merged(i) for i in range(P)]
    delta_ops = sum(
        (va.n - state["s"]) + (vb.n - state["s"])
        for va, vb in views_pairs
    ) if state is not None else 0
    new_subs = []
    for w, (va, vb) in zip(winners, views_pairs):
        wv = lanecache.view_for(w.ct)
        new_subs.append(_Sub(handle=w, members=[w],
                             views=[wv] if wv is not None else [va, vb]))
    # (re-)establish the frontier for the levels that follow — over the
    # level's INPUT views (the rank row indexes them) plus every view
    # that survives (winners and byes)
    check_views = [v for vp in views_pairs for v in vp]
    survivor_views = []
    bye_views = []
    for sub in new_subs:
        survivor_views.extend(sub.views)
    for sub in bye_subs:
        h = _materialize(sub, state)
        v = lanecache.view_for(h.ct)
        if v is None:
            raise s.CausalError(
                "fleet outside the device domain",
                {"causes": {"outside-domain"}},
            )
        sub.views = [v]
        bye_views.append(v)
        survivor_views.append(v)
    new_state = None
    if len(new_subs) + len(bye_subs) > 1:
        new_state = _establish(check_views + bye_views, survivor_views,
                               rank[0], vis[0], cap)
        if new_state is not None:
            sp, anchor = new_state["s"], new_state["anchor"]
            for sub in new_subs + list(bye_subs):
                sub.side = _side_of(sub.views[0], sp, anchor)
    return new_subs, new_state, _level_stats(level, P, byes, "full", cap,
                                             delta_ops, dig)


# ---------------------------------------------------------- the tree


def _merge_tree_impl(handles, w_budget: Optional[int], device):
    first = handles[0]
    for h in handles[1:]:
        s.check_mergeable(first.ct, h.ct)
    report = {"n": len(handles), "rounds": tree_rounds(len(handles)),
              "levels": []}
    if len(handles) == 1:
        return handles[0], report
    subs = [_Sub(handle=h) for h in handles]
    for sub in subs:
        v = lanecache.view_for(sub.handle.ct)
        if v is None:
            raise s.CausalError(
                "fleet outside the device domain (PackSpec overflow "
                "or map-shaped tree)",
                {"causes": {"outside-domain"}},
            )
        sub.views = [v]
    if not lanecache.compatible([sub.views[0] for sub in subs]):
        rebuilt = [lanecache.build_view(sub.handle.ct.nodes,
                                        sub.handle.ct.uuid)
                   for sub in subs]
        if any(v is None for v in rebuilt) or not lanecache.compatible(
                rebuilt):
            raise s.CausalError(
                "fleet outside the device domain",
                {"causes": {"outside-domain"}},
            )
        for sub, v in zip(subs, rebuilt):
            sub.views = [v]
    state = None
    level = 0
    while len(subs) > 1:
        pairs = [(subs[i], subs[i + 1])
                 for i in range(0, len(subs) - 1, 2)]
        bye_subs = [subs[-1]] if len(subs) % 2 else []
        byes = len(bye_subs)
        use_delta = (
            state is not None
            and all(sub.side is not None for sub in subs)
        )
        if use_delta and w_budget is not None:
            wmax = max(len(sub.side) for sub in subs)
            # mid-tree full-width bounce: the pooled windows outgrew
            # the budget — run this level at document width and
            # re-establish for the rest (the old state stays live: the
            # symbolic survivors still materialize through it)
            use_delta = 1 + wmax <= int(w_budget)
        if use_delta and _chaos.enabled() \
                and _chaos.budget_exhaust("tree"):
            # injected window-budget exhaustion: the same ladder rung,
            # the same (bit-identical) full-width bounce
            _recovery.step("tree", "delta", "full", "budget-exhaustion",
                           uuid=str(first.ct.uuid), level=level)
            use_delta = False
        t0 = time.perf_counter()
        out = _delta_level(pairs, state, level, byes, device) \
            if use_delta else None
        if out is None:
            new_subs, state, stats = _full_level(
                pairs, state, level, byes, bye_subs, device)
        else:
            new_subs, _dig, stats = out
        # the level's digests are on the host by now (the fetch waits
        # for the device), so this is the level's whole time
        stats["ms"] = (time.perf_counter() - t0) * 1e3
        subs = new_subs + bye_subs
        report["levels"].append(stats)
        level += 1
    root = _materialize(subs[0], state)
    report["path_counts"] = {
        p: sum(1 for lv in report["levels"] if lv["path"] == p)
        for p in ("full", "delta")
    }
    return root, report


def merge_tree_report(handles: Sequence, *, w_budget: Optional[int] = None,
                      device=None) -> Tuple[object, dict]:
    """Converge a fleet of list-shaped replica handles into ONE handle
    via the merge reduction tree, returning ``(root, report)`` with
    the per-level stats (``report["levels"]``: level, pairs, byes,
    path, window, delta_ops, digest agreement, and ``ms``, the level's
    host-clock time through its digest fetch, which the reference's
    report does not carry). ``w_budget`` bounds the
    per-side window width before a level bounces to full document width
    (None = unbounded); ``device`` defaults to the package default."""
    handles = list(handles)
    if not handles:
        raise s.CausalError("Nothing to merge.",
                            {"causes": {"empty-fleet"}})
    return _merge_tree_impl(handles, w_budget, resolve_device(device))


def merge_tree(handles: Sequence, *, w_budget: Optional[int] = None,
               device=None):
    """``merge_tree_report`` without the report: the fleet's converged
    root handle, bit-identical to folding pairwise ``merge`` over the
    same replicas, in ceil(log2(n)) batched device rounds."""
    return merge_tree_report(handles, w_budget=w_budget, device=device)[0]


def merge_all_tree(handles: Sequence):
    """``merge_all``'s tree router: the converged root for >= 4
    ``weaver="torch"`` list-shaped handles, or None when the fleet is
    outside the tree domain (pure weaver, PackSpec overflow, token
    overflow) — the caller then takes the flat ``merge_many`` path.
    Raises only REAL merge errors (append-only body conflicts,
    type/uuid mismatches), exactly like the fold."""
    handles = list(handles)
    if len(handles) < 4:
        return None
    if getattr(handles[0].ct, "weaver", "") != "torch":
        # pure users picked the host oracle: never drag the device path
        # into their merge_all
        return None
    for h in handles:
        if lanecache.view_for(h.ct) is None:
            return None
    try:
        return merge_tree(handles)
    except s.CausalError as err:
        causes = set(err.info.get("causes") or ())
        if causes & {"outside-domain", "token-overflow"}:
            return None
        raise


def flat_fold(handles: Sequence, ctx=None, device=None):
    """The O(n)-round baseline the tree replaces: fold the fleet
    through n-1 SEQUENTIAL pairwise merge waves, materializing every
    intermediate winner. Kept as the A/B control and
    ``FleetSession.converge(tree=False)``."""
    from .wave import merge_wave

    handles = list(handles)
    if not handles:
        raise s.CausalError("Nothing to merge.",
                            {"causes": {"empty-fleet"}})
    acc = handles[0]
    for h in handles[1:]:
        acc = merge_wave([(acc, h)], ctx=ctx, device=device).merged(0)
    return acc
