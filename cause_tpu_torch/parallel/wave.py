"""Batched API-level merge waves: many replica pairs, one dispatch.

Counterpart of ``cause_tpu.parallel.wave``: the end-to-end north-star
path (1024 divergent replica pairs of 10k-node CausalLists). A wave of
pairs becomes ONE batched v5 segment-union dispatch plus the per-pair
convergence digest on the device (B1 sorts, the B2 walk and the B3
expansion on the card), whose host side is assembly of *cached*
per-tree lanes and segment tables (``weaver.lanecache``) — no node-dict
walking, no Python-per-node work.

``BENCH_KERNEL`` picks the pipeline of the dispatch, as in the
reference: ``""``/``v5``/``v5w`` run the v5 kernel (whose forest ranking
is already the B2 walk on the card), ``v5f`` the fused token pipeline
(``torchw5f``: the K1, K2 and K4 kernels); any other value raises.

Contract (deliberately device-resident): ``merge_wave`` returns a
``WaveResult`` holding per-pair rank/visibility lanes and digests; a
pair becomes a host ``CausalList`` again only on demand
(``result.merged(i)``).

Pairs outside the accelerated domain (ids beyond the PackSpec, rank
generations that cannot be aligned), pairs with a replica the sync
layer quarantined (``sync.is_quarantined``: a repeat payload offender
must pass the host merge's full append-only validation, and a corrupt
one lands in ``poisoned``) and rows that still overflow the doubled
token budget fall back to the ordinary per-pair ``merge`` — same trees
out, just slower. Not ported yet: the ``mesh=`` sharding (a mesh
raises).

The delta-native pieces the session and the merge tree share live here
too, as in the reference: ``delta_domain_ok`` (may a divergent lane
ride the delta window?) and ``assemble_delta_window`` (the window batch
from cached views), both host numpy.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..collections import shared as s
from ..device import default_device
from ..weaver import lanecache
from ..weaver.arrays import I32_MAX, next_pow2
from ..weaver.segments import SEG_LANE_KEYS, concat_seg_tables
from . import recovery as _recovery

__all__ = ["merge_wave", "WaveResult", "WaveBuffers",
           "delta_domain_ok", "delta_window_rows", "assemble_delta_window",
           "dispatch_full_rows"]


class WaveBuffers:
    """Reusable host-side assembly buffers for repeated waves.

    Allocating ~0.5 GB of [B, 2*cap] batch arrays dominates assembly
    cost at north-star scale; steady-state sync runs waves over the
    same fleet shape every round, so the buffers persist and each wave
    only rewrites the lanes that exist (plus re-padding the shrink gap
    when a row got shorter). Pass one via ``merge_wave(ctx=...)``."""

    def __init__(self):
        self.shape = None
        self.lanes = None
        self.prev_n = None   # [B, 2] lanes written last wave, per tree

    def ensure(self, B: int, cap: int, s_max: int):
        shape = (B, cap, s_max)
        N = 2 * cap
        if self.shape != shape:
            self.lanes = {
                "hi": np.full((B, N), I32_MAX, np.int32),
                "lo": np.full((B, N), I32_MAX, np.int32),
                "cci": np.full((B, N), -1, np.int32),
                "vc": np.zeros((B, N), np.int32),
                "valid": np.zeros((B, N), bool),
                "seg": np.full((B, N), -1, np.int32),
                "sg_min_hi": np.zeros((B, s_max), np.int32),
                "sg_min_lo": np.zeros((B, s_max), np.int32),
                "sg_max_hi": np.zeros((B, s_max), np.int32),
                "sg_max_lo": np.zeros((B, s_max), np.int32),
                "sg_len": np.zeros((B, s_max), np.int32),
                "sg_lane0": np.zeros((B, s_max), np.int32),
                "sg_dense": np.zeros((B, s_max), bool),
                "sg_tail_special": np.zeros((B, s_max), bool),
                "sg_valid": np.zeros((B, s_max), bool),
                "sg_vsum": np.zeros((B, s_max), np.int32),
            }
            self.prev_n = np.zeros((B, 2), np.int64)
            self.shape = shape
        return self.lanes


_PAD = {
    "hi": I32_MAX, "lo": I32_MAX, "cci": -1, "vc": 0, "valid": False,
    "seg": -1,
}


def delta_domain_ok(view, s: int, anchor: int,
                    start: Optional[int] = None) -> bool:
    """Whether lanes ``[start, view.n)`` stay inside the delta-wave
    domain for a pair whose shared converged prefix is ``[0, s)`` with
    anchor lane ``anchor`` (the prefix weave's final node):

    - every cause resolves inside the divergent window (lane >= s) or
      to the anchor itself — a cause stabbing any other resident lane
      would splice new weave positions into the frozen prefix;
    - no special (tombstone) targets the anchor — that would flip a
      frozen resident lane's visibility.

    ``start`` defaults to ``s`` (validate the whole divergent region,
    the rebuild-time call); updates validate only their appended tail.
    O(lanes checked) vectorized numpy."""
    a = view.arena
    lo = s if start is None else start
    if lo >= view.n:
        return True
    ci = a.cause_idx[lo:view.n]
    if not bool(np.all((ci >= s) | (ci == anchor))):
        return False
    return not bool(np.any((a.vclass[lo:view.n] > 0) & (ci == anchor)))


def delta_window_rows(rows, wcap: int, s_max: Optional[int] = None):
    """The ``[B, 2*wcap]`` delta-window batch the session and the merge
    tree both dispatch. ``rows`` yields, per row, ``(anchor_hi,
    anchor_lo, trees)`` with ``trees`` the two trees' divergent lanes as
    ``(hi, lo, vc, cci)`` arrays, ``cci`` in tree-local window
    coordinates (0 = the anchor). Each tree is lane 0 = the anchor
    (presented as the window root: cause -1) followed by its lanes.
    ``s_max`` defaults to the next power of two of the widest row's
    segment count (at least 8). Returns the ``benchgen.LANE_KEYS5``
    dict. O(total window lanes) on the host."""
    from ..weaver.segments import _TABLE_DTYPES, tree_segments

    rows = list(rows)
    B = len(rows)
    Nw = 2 * wcap
    hi = np.full((B, Nw), I32_MAX, np.int32)
    lo = np.full((B, Nw), I32_MAX, np.int32)
    cci = np.full((B, Nw), -1, np.int32)
    vc = np.zeros((B, Nw), np.int32)
    valid = np.zeros((B, Nw), bool)
    seg = np.full((B, Nw), -1, np.int32)
    per_row = []
    s_need = 8
    for r, (a_hi, a_lo, trees) in enumerate(rows):
        per_tree = []
        for t, (t_hi, t_lo, t_vc, t_cci) in enumerate(trees):
            w = 1 + len(t_hi)
            off = t * wcap
            hi[r, off] = a_hi
            lo[r, off] = a_lo
            valid[r, off] = True
            local_cci = np.full(wcap, -1, np.int32)
            if w > 1:
                hi[r, off + 1:off + w] = t_hi
                lo[r, off + 1:off + w] = t_lo
                vc[r, off + 1:off + w] = t_vc
                valid[r, off + 1:off + w] = True
                local_cci[1:w] = t_cci
                cci[r, off + 1:off + w] = t_cci + off
            segs = tree_segments(hi[r, off:off + wcap],
                                 lo[r, off:off + wcap],
                                 local_cci, vc[r, off:off + wcap], w)
            per_tree.append((segs, w))
        per_row.append(per_tree)
        s_need = max(s_need,
                     sum(sg["sg_len"].shape[0] for sg, _ in per_tree))
    if s_max is None:
        s_max = next_pow2(s_need)
    tables = {k: np.zeros((B, s_max), _TABLE_DTYPES[k])
              for k in SEG_LANE_KEYS}
    for r, per_tree in enumerate(per_row):
        row_out = {k: tables[k][r] for k in SEG_LANE_KEYS}
        _t, bases = concat_seg_tables(per_tree, wcap, s_max,
                                      out=row_out)
        for t, ((segs, w), base) in enumerate(zip(per_tree, bases)):
            off = t * wcap
            seg[r, off:off + w] = segs["run_of_lane"][:w] + base
    lanes = {"hi": hi, "lo": lo, "cci": cci, "vc": vc, "valid": valid,
             "seg": seg}
    lanes.update(tables)
    return lanes


def assemble_delta_window(views, s_arr, anchor_arr, wcap: int,
                          s_max: int):
    """The delta wave's ``[B, 2*wcap]`` window batch from cached views
    (``delta_window_rows``): per tree, the anchor followed by the
    divergent-suffix lanes ``[s, n)``, causes remapped into window
    coordinates (anchor -> 0, lane ``j`` -> ``j - s + 1``). Returns
    ``(lanes, starts, counts)``: ``lanes`` holds every
    ``benchgen.LANE_KEYS5`` key, ``starts``/``counts`` are the [B, 2]
    per-tree shared-prefix length and divergent lane count the splice
    consumes."""
    B = len(views)
    starts = np.zeros((B, 2), np.int32)
    counts = np.zeros((B, 2), np.int32)

    def rows():
        for r, (va, vb) in enumerate(views):
            s = int(s_arr[r])
            anchor = int(anchor_arr[r])
            a0 = va.arena
            trees = []
            for t, v in enumerate((va, vb)):
                a = v.arena
                sl = slice(s, v.n)
                ci = a.cause_idx[sl]
                trees.append((
                    a.ts[sl], a.spec.pack_lo(a.site[sl], a.tx[sl]),
                    a.vclass[sl],
                    np.where(ci == anchor, 0, ci - s + 1).astype(np.int32)))
                starts[r, t] = s
                counts[r, t] = v.n - s
            yield (np.int32(a0.ts[anchor]),
                   a0.spec.pack_lo(a0.site[anchor:anchor + 1],
                                   a0.tx[anchor:anchor + 1])[0], trees)

    return delta_window_rows(rows(), wcap, s_max), starts, counts


def fetch_digest(d) -> np.ndarray:
    """A device digest tensor (``mesh.replica_digest``'s int32 bits) as
    the reference's host uint32 array."""
    return d.cpu().numpy().view(np.uint32)


def _pipeline() -> str:
    """The wave's pipeline from ``BENCH_KERNEL`` (the reference's knob:
    ``cause_tpu/parallel/wave.py:669-680``); unknown values raise."""
    forced = os.environ.get("BENCH_KERNEL", "").strip()
    if forced not in ("", "v5", "v5w", "v5f"):
        raise ValueError(
            f"merge_wave supports BENCH_KERNEL of v5/v5w/v5f only "
            f"(the wave path is segment-union); got {forced!r}")
    return forced or "v5"


def _dispatch(lanes, u: int, device, site: str, pipeline: str = "v5"):
    """One kernel + digest dispatch over an assembled lane batch, v5 or
    (``pipeline="v5f"``) the fused token pipeline; host numpy ``(rank,
    visible, digest, overflow)``."""
    from ..benchgen import LANE_KEYS5, lanes_from_numpy
    from ..weaver.torchw5f import batched_merge_weave_v5f
    from ..weaver.torchwd import batched_weave_digest
    from .mesh import replica_digest

    def run():
        t = lanes_from_numpy(lanes, device)
        args = [t[k] for k in LANE_KEYS5]
        if pipeline == "v5f":
            r, v, _c, ov = batched_merge_weave_v5f(
                *args, u_max=int(u), k_max=int(u), device=device)
            return r, v, replica_digest(t["hi"], t["lo"], r, v), ov
        return batched_weave_digest(*args, u_max=int(u), k_max=int(u),
                                    device=device)

    rank, visible, digest, overflow = _recovery.run_dispatch(site, run)
    return (rank.cpu().numpy(), visible.cpu().numpy(),
            fetch_digest(digest), overflow.cpu().numpy())


def dispatch_full_rows(lanes, site: str = "tree", device="cuda"):
    """One fused full-width kernel+digest dispatch over an assembled
    ``[B, 2*cap]`` v5 lane batch (``benchgen.LANE_KEYS5`` dict), with
    the pow2-quantized token budget and a doubled-budget retry for
    spiky unsampled rows.

    Returns ``(rank, visible, digest, info)`` as numpy arrays plus an
    ``info`` dict (``u_need``/``u_max``/``retried``). Raises
    ``CausalError`` if a row still overflows at the doubled budget
    (there is no per-pair host fallback here: the caller owns the
    batch)."""
    from ..benchgen import LANE_KEYS5, v5_token_budget

    u_need = int(v5_token_budget(lanes))
    u_max = next_pow2(u_need)
    rank, visible, digest, overflow = _dispatch(lanes, u_max, device, site)
    retried = 0
    if overflow.any():
        rows = np.flatnonzero(overflow)
        retried = len(rows)
        sub = {k: lanes[k][rows] for k in LANE_KEYS5}
        r2, v2, d2, ov2 = _dispatch(sub, 2 * u_max, device, site)
        if ov2.any():
            raise s.CausalError(
                "full-width level overflowed its doubled token budget",
                {"causes": {"token-overflow"},
                 "rows": np.flatnonzero(ov2).tolist()},
            )
        rank[rows] = r2
        visible[rows] = v2
        digest[rows] = d2
    return rank, visible, digest, {
        "u_need": u_need, "u_max": int(u_max), "retried": retried,
    }


# Lanes sampled per tree per wave by the body spot-check below.
# CAUSE_TPU_BODY_SAMPLE=0 disables; a value >= the tree size checks
# every lane (what the adversarial tests use).
_BODY_SAMPLE = int(os.environ.get("CAUSE_TPU_BODY_SAMPLE", "16") or 0)
_wave_seq = itertools.count()


def _sampled_body_spotcheck(views, k: Optional[int] = None) -> dict:
    """Close the device value-byte blind spot probabilistically.

    The kernels dedupe twin segments by ids/classes/structure; host
    VALUE bytes never reach the device (jaxw5 module caveat), so two
    replicas sharing an id but differing in its body — an append-only
    violation from a corrupt replica (reference rule:
    shared.cljc:169-171) — would pass the device-only wave/digest
    paths silently. ``WaveResult.merged`` validates fully, but fleets
    that read only digests never call it.

    Returns ``{pair_index: CausalError}`` for the violating pairs
    (the caller quarantines them; raising here would fail every
    healthy pair in the wave — round-4 advisor finding #1).

    This check samples ``k`` random lanes per tree per wave and
    compares bodies with the twin via its O(1) ``lane_of`` index —
    O(k) per pair instead of O(shared base), which is the entire point
    of the segment-union design. Samples rotate each wave (counter
    -seeded RNG), so repeated waves over a fleet accumulate coverage;
    at the north-star scale one wave already draws ~16k samples.
    """
    k = _BODY_SAMPLE if k is None else k
    bad: dict = {}
    if k <= 0:
        return bad
    # fresh entropy + a session counter: samples must differ both
    # across waves in one process AND across process restarts, or the
    # promised coverage accumulation never happens for one-wave-per
    # -process deployments (CLI sync rounds)
    rng = np.random.default_rng(
        [os.getpid(), time.time_ns() & 0xFFFFFFFF, next(_wave_seq)]
    )
    for pair_idx, (va, vb) in enumerate(views):
        for side, (src, dst) in enumerate(((va, vb), (vb, va))):
            ns, nd = src.n, dst.n
            if not ns or not nd:
                continue
            lanes = (range(ns) if k >= ns
                     else rng.integers(0, ns, size=k))
            sn, dn = src.arena.nodes, dst.arena.nodes
            d_lane = dst.arena.lane_of
            for ln in lanes:
                nid, cause, value = sn[int(ln)]
                j = d_lane.get(nid)
                if (j is not None and j < nd
                        and (dn[j][1] != cause or dn[j][2] != value)):
                    # same convention as check_no_conflicting_bodies:
                    # existing_node is the merge TARGET's body (dst);
                    # plus enough context to quarantine the replica.
                    # Collected per pair (round-4 advisor finding #1):
                    # one corrupt replica must poison ITS pair, not
                    # the other 1023 in the wave
                    bad[pair_idx] = s.CausalError(
                        "This node is already in the tree and can't "
                        "be changed.",
                        {"causes": {"append-only", "edits-not-allowed"},
                         "existing_node": (nid,) + tuple(dn[j][1:]),
                         "conflicting_node": (nid, cause, value),
                         "pair": pair_idx,
                         "conflicting_side": "a" if side == 0 else "b"},
                    )
                    break
            if pair_idx in bad:
                break
    return bad


def _assemble_rows(views: Sequence[Tuple["lanecache.LaneView",
                                         "lanecache.LaneView"]],
                   cap: int, bufs: Optional[WaveBuffers] = None):
    """[B, 2*cap] v5 lane batch + segment tables from cached views.
    Pure numpy copies of cached arrays — the per-wave host cost. With
    ``bufs``, batch arrays are reused across waves and only live lanes
    (plus any shrink gap vs the previous wave) are rewritten."""
    B = len(views)
    per_row_segs = [
        [(va.segments(), va.n), (vb.segments(), vb.n)]
        for va, vb in views
    ]
    s_max = next_pow2(max(
        sum(sg["sg_len"].shape[0] for sg, _ in row) for row in per_row_segs
    ))
    bufs = bufs or WaveBuffers()
    lanes = bufs.ensure(B, cap, s_max)
    hi, lo, cci = lanes["hi"], lanes["lo"], lanes["cci"]
    vc, valid, seg = lanes["vc"], lanes["valid"], lanes["seg"]
    for r, (va, vb) in enumerate(views):
        # segment tables: the shared layout helper writes straight into
        # this row's (reused) buffer views
        row_out = {k: lanes[k][r] for k in SEG_LANE_KEYS}
        _t, bases = concat_seg_tables(per_row_segs[r], cap,
                                      s_max, out=row_out)
        for t, v in enumerate((va, vb)):
            v.arena.sync_ranks()
            a, n = v.arena, v.n
            off = t * cap
            sl = slice(off, off + n)
            hi[r, sl] = a.ts[:n]
            lo[r, sl] = a.spec.pack_lo(a.site[:n], a.tx[:n])
            ci = a.cause_idx[:n]
            cci[r, sl] = np.where(ci >= 0, ci + off, -1)
            vc[r, sl] = a.vclass[:n]
            valid[r, sl] = True
            segs = per_row_segs[r][t][0]
            seg[r, sl] = segs["run_of_lane"][:n] + bases[t]
            prev = int(bufs.prev_n[r, t])
            if prev > n:  # re-pad the shrink gap
                gap = slice(off + n, off + prev)
                for key, pad in _PAD.items():
                    lanes[key][r, gap] = pad
            bufs.prev_n[r, t] = n
    return lanes


class WaveResult:
    """One wave's converged device state plus lazy host materialization.

    - ``digest``: [B] uint32 per-pair weave digests (equal digests =>
      identical converged linearizations; see mesh.replica_digest) —
      ONLY where ``digest_valid`` is True. digest_valid is False for
      TWO distinct categories a digest-only consumer must check
      separately: ``fallback`` rows (host path ran; compare their
      ``merged`` trees instead) and ``poisoned`` rows (a corrupt
      replica was caught — see the ``poisoned`` property for the
      sources; ``merged(i)`` raises that pair's CausalError — these
      rows have NO valid result);
    - ``rank``/``visible``: [B, 2*cap] per-concat-lane outputs of the
      v5 kernel (rank == 2*cap for dropped/duplicate/padding lanes);
    - ``merged(i)``: the converged CausalList of pair i as a host
      handle — identical to ``pairs[i][0].merge(pairs[i][1])``,
      including the append-only body validation (conflicting duplicate
      ids raise CausalError exactly like a merge would);
    - ``fallback``: indices of pairs that ran the host path instead
      (outside the device domain or kernel overflow).
    """

    def __init__(self, pairs, views, cap, rank, visible, digest,
                 fallback_results, kernel, digest_valid=None,
                 poisoned=None):
        self._pairs = pairs
        self._views = views
        self.capacity = cap
        self.rank = rank
        self.visible = visible
        self.digest = digest
        self.digest_valid = (
            digest_valid if digest_valid is not None
            else np.zeros(len(pairs), bool)
        )
        self._fallback = fallback_results  # {index: merged_handle}
        self._poisoned = poisoned or {}    # {index: CausalError}
        self.kernel = kernel

    @property
    def fallback(self):
        return sorted(self._fallback)

    @property
    def poisoned(self):
        """Pairs quarantined with their own CausalError — the rest of
        the wave is valid; ``merged(i)`` raises the pair's error
        (round-4 advisor finding #1). Three sources: the sampled body
        spot-check on device rows (probabilistic — CAUSE_TPU_BODY_SAMPLE
        tunes/disables it), and the merge-time validation of host
        fallback and overflow rows (deterministic — those pairs run
        ``a.merge(b)`` eagerly, so a corrupt replica there is caught
        even with sampling off)."""
        return sorted(self._poisoned)

    def __len__(self):
        return len(self._pairs)

    def merged(self, i: int):
        """Materialize pair ``i``'s converged tree as a host handle."""
        if i in self._poisoned:
            raise self._poisoned[i]
        if i in self._fallback:
            return self._fallback[i]
        a, b = self._pairs[i]
        va, vb = self._views[i]
        cap = self.capacity
        rank_row = self.rank[i]
        keep = np.flatnonzero(rank_row < 2 * cap)
        order = keep[np.argsort(rank_row[keep], kind="stable")]
        an, bn = va.arena.nodes, vb.arena.nodes

        def node_at(lane):
            return an[lane] if lane < cap else bn[lane - cap]

        weave = [node_at(int(j)) for j in order]
        union = lanecache.union_views(va, vb)
        nodes = dict(a.ct.nodes)
        # the same append-only validation a.merge(b) runs: a duplicate
        # id with a different body must raise, never yield a
        # weave/nodes-inconsistent tree
        s.check_no_conflicting_bodies(nodes, b.ct.nodes)
        nodes.update(b.ct.nodes)
        yarns = {}
        if union is not None:
            for nd in union.arena.nodes[: union.n]:
                yarns.setdefault(nd[0][1], []).append(nd)
        else:  # pragma: no cover - compatible views built by merge_wave
            for nid in sorted(nodes):
                yarns.setdefault(nid[1], []).append(
                    (nid, nodes[nid][0], nodes[nid][1])
                )
        lamport = max(a.ct.lamport_ts, b.ct.lamport_ts,
                      max(nid[0] for nid in nodes))
        ct = a.ct.evolve(
            nodes=nodes, yarns=yarns, weave=weave, lamport_ts=lamport,
            lanes=union,
        )
        return type(a)(ct)


def merge_wave(pairs: Sequence[Tuple[object, object]],
               mesh=None, ctx: Optional[WaveBuffers] = None,
               device=None) -> WaveResult:
    """Merge every (a, b) replica pair in one batched device dispatch
    on ``device`` (the package default, ``use_device``, when None).

    The positional parameters are the reference's ``(pairs, mesh,
    ctx)``. ``mesh`` (the replica axis sharded over devices) is not
    ported yet and raises; ``ctx`` is a ``WaveBuffers`` reused across
    waves. All pairs must be list-shaped handles; each pair shares a
    uuid/type (the usual merge guards). Body validation between
    duplicate ids follows the device contract (torchw5 module caveat):
    a sampled host-side spot-check poisons corrupt pairs, and
    ``merged(i)`` validates fully.
    """
    if mesh is not None:
        raise NotImplementedError(
            "merge_wave(mesh=...): the sharded wave is not ported yet "
            "(ROADMAP A.15)")
    pairs = list(pairs)
    if not pairs:
        raise s.CausalError("Nothing to merge.", {"causes": {"empty-fleet"}})
    dev = default_device() if device is None else device
    for a, b in pairs:
        s.check_mergeable(a.ct, b.ct)

    from .. import sync as _sync

    quarantine_live = _sync.any_quarantined()
    views: List[Optional[Tuple[object, object]]] = []
    fallback = {}
    poisoned: dict = {}
    for i, (a, b) in enumerate(pairs):
        if quarantine_live and (
                _sync.is_quarantined(a.ct.site_id)
                or _sync.is_quarantined(b.ct.site_id)):
            # a quarantined replica is OUT of the device wave: its pair
            # runs the host merge, whose full append-only body
            # validation is what a repeat payload offender has to pass
            # — a corrupt one lands in poisoned, never in the
            # digest-only device path
            _recovery.step("wave", "full", "host", "quarantined",
                           uuid=str(a.ct.uuid), pair=i)
            try:
                fallback[i] = a.merge(b)
            except s.CausalError as err:
                err.info["pair"] = i
                poisoned[i] = err
            views.append(None)
            continue
        # view_for returns None for off-domain ids: those take the
        # per-pair host merge below
        va = lanecache.view_for(a.ct)
        vb = lanecache.view_for(b.ct)
        if va is not None and vb is not None and not lanecache.compatible(
                (va, vb)):
            # stale rank generation on one side: rebuild both fresh
            va = lanecache.build_view(a.ct.nodes, a.ct.uuid)
            vb = lanecache.build_view(b.ct.nodes, b.ct.uuid)
        if va is None or vb is None or not lanecache.compatible((va, vb)):
            try:
                fallback[i] = a.merge(b)
            except s.CausalError as err:
                # a corrupt replica poisons its own pair, not the wave
                err.info["pair"] = i
                poisoned[i] = err
            views.append(None)
        else:
            views.append((va, vb))

    live = [i for i, v in enumerate(views) if v is not None]
    if live:
        bad = _sampled_body_spotcheck([views[i] for i in live])
        for local_idx, err in bad.items():
            i = live[local_idx]
            err.info["pair"] = i
            poisoned[i] = err
            views[i] = None
        live = [i for i, v in enumerate(views) if v is not None]
    if not live:
        B = len(pairs)
        return WaveResult(pairs, views, 0,
                          np.zeros((B, 0), np.int32),
                          np.zeros((B, 0), bool),
                          np.zeros(B, np.uint32), fallback, "host",
                          poisoned=poisoned)

    cap = next_pow2(max(
        max(va.n, vb.n) for i in live for va, vb in [views[i]]
    ))
    live_views = [views[i] for i in live]
    lanes = _assemble_rows(live_views, cap, bufs=ctx)

    from ..benchgen import LANE_KEYS5, v5_token_budget

    # v5 and v5w are one pipeline here: the port's v5 ranks with the B2
    # walk on the card, and the walk is bit-equal to pointer doubling
    pipeline = _pipeline()

    # pow2-quantized budget: waves whose divergence shifted slightly
    # keep the same shapes
    u_need = int(v5_token_budget(lanes))
    u_max = next_pow2(u_need)
    rank, visible, digest, overflow = _dispatch(lanes, u_max, dev, "wave",
                                                pipeline)
    if overflow.any():
        # the token budget samples rows; a spiky unsampled row can
        # overflow. Retry just those rows with a doubled budget before
        # resorting to host merges.
        rows = np.flatnonzero(overflow)
        sub = {k: lanes[k][rows] for k in LANE_KEYS5}
        r2, v2, d2, ov2 = _dispatch(sub, 2 * u_max, dev, "wave", pipeline)
        rank[rows] = r2
        visible[rows] = v2
        digest[rows] = d2
        overflow[rows] = ov2

    B = len(pairs)
    full_rank = np.full((B, 2 * cap), 2 * cap, np.int32)
    full_vis = np.zeros((B, 2 * cap), bool)
    full_dig = np.zeros(B, np.uint32)
    dig_valid = np.zeros(B, bool)
    for j, i in enumerate(live):
        if bool(overflow[j]):
            a, b = pairs[i]
            try:
                # budget blown at the doubled budget: host path, correct
                fallback[i] = a.merge(b)
            except s.CausalError as err:  # corrupt AND overflowed
                err.info["pair"] = i
                poisoned[i] = err
            views[i] = None
            continue
        full_rank[i] = rank[j]
        full_vis[i] = visible[j]
        full_dig[i] = digest[j]
        dig_valid[i] = True
    return WaveResult(pairs, views, cap, full_rank, full_vis, full_dig,
                      fallback, pipeline, dig_valid, poisoned=poisoned)
