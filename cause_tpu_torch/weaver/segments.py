"""Marshal-side segment extraction for the v5 segment-union kernel.

A causal tree's chain-run structure is a *static per-tree fact*: runs
are maximal stretches of lanes where each node's cause is the previous
lane and the v4 glue rules hold locally (no host-case, parent not
contested). ``NodeArrays`` lanes are id-sorted, so every run is a
contiguous lane range — which means a merge can treat a whole run as
ONE sort token whenever nothing foreign intrudes on it, and only
explode to node granularity where replicas actually diverged. That is
the right asymptotic for a CRDT: merge cost scales with the
divergence, not the document size (the reference pays O(n*m) on the
whole tree, shared.cljc:300-314).

This module computes, per tree, host-side (vectorized numpy — one pass
over the lanes, same cost class as building the lanes themselves):

- ``run_of_lane``: each lane's segment ordinal;
- per-segment tables: head lane, length, head id (= min id), tail id
  (= max id), a *dense* flag (member ids fully determined by
  (min, max, len): consecutive-ts conj chains or same-ts tx-index runs
  — the shapes ``conj`` and ``extend`` mint), and whether the tail is
  special (trailing tombstone chain);
- the root is always forced into its own singleton segment so the
  root+base prefix shared by every replica stays wholesale-dedupable
  (the root id's packed lo differs from the chain site's, which would
  otherwise break the dense test).

Segmentation MUST mirror the union kernel's local glue semantics exactly —
the device kernel re-glues *tokens* with the same rules, so local runs
have to be unions of v4 runs for the expansion to agree. The
correspondence is fuzz-tested against the device kernels.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

__all__ = [
    "tree_segments",
    "extend_segments",
    "concat_segments",
    "SEG_KEYS",
    "SEG_LANE_KEYS",
]

SEG_KEYS = (
    "sg_head_lane",  # lane of the segment head (tree coordinates)
    "sg_len",        # member count
    "sg_min_hi", "sg_min_lo",   # head id (the minimum member id)
    "sg_max_hi", "sg_max_lo",   # tail id (the maximum member id)
    "sg_dense",      # member ids determined by (min, max, len): either
                     # (hi..hi+len-1, constant lo) conj chains or
                     # (constant hi, lo..lo+len-1) tx runs; dedupe ok
    "sg_tail_special",  # tail lane carries a special (tombstone suffix)
    "sg_vsum",       # position-weighted vclass checksum of the members:
                     # sum((i+1) * vclass). Twin dedupe compares it so a
                     # same-id segment whose INTERIOR body classes differ
                     # (append-only violation from a corrupt replica)
                     # explodes and hits the node-level conflict check
                     # instead of vanishing wholesale. Host VALUES stay a
                     # host-side check — the device never sees them.
)

# the device kernel's segment-table lanes (concat coordinates, padded)
SEG_LANE_KEYS = (
    "sg_min_hi", "sg_min_lo", "sg_max_hi", "sg_max_lo",
    "sg_len", "sg_lane0", "sg_dense", "sg_tail_special", "sg_valid",
    "sg_vsum",
)


def tree_segments(hi, lo, cause_idx, vclass, n: int) -> Dict[str, np.ndarray]:
    """Segment one tree's lanes (ascending id order, lane 0 = root).

    Returns ``run_of_lane`` ([capacity] int32, -1 beyond ``n``) plus the
    ``SEG_KEYS`` tables (length = number of segments). Mirrors the v4
    union kernel's glue computation restricted to a single tree:
    ``glued[i] = adj & ~host_case & ~contested[i-1]`` with parents
    resolved through the special-chain host jump.
    """
    cap = hi.shape[0]
    run_of_lane = np.full(cap, -1, np.int32)
    if n <= 0:
        return {
            "run_of_lane": run_of_lane,
            **{k: np.zeros(0, np.int32) for k in SEG_KEYS},
        }

    idx = np.arange(n, dtype=np.int32)
    special = vclass[:n] > 0
    adj = np.zeros(n, bool)
    adj[1:] = cause_idx[1:n] == idx[:-1]
    host_case = adj & ~special
    host_case[1:] &= special[:-1]
    host_case[0] = False
    irregular = (idx > 0) & (~adj | host_case)

    # local parents: specials hang off their cause, non-specials off the
    # first non-special ancestor through the cause chain
    cs = np.clip(cause_idx[:n], 0, n - 1)
    host = cs.copy()
    for _ in range(max(1, math.ceil(math.log2(max(2, n))))):
        on_special = special[host] & (idx > 0)
        if not on_special.any():
            break
        host = np.where(on_special, host[host], host)
    parent = np.where(idx > 0, np.where(special, cs, host), -1)

    # contested: lanes that parent at least one irregular child
    contested = np.zeros(n, bool)
    ip = parent[irregular]
    contested[ip[ip >= 0]] = True

    glued = adj & ~host_case
    glued[1:] &= ~contested[:-1]
    glued[0] = False
    # split at density breaks (site change or ts jump): the dedupable
    # unit is the dense run, and density breaks are exactly where a
    # shared prefix flows into site-local edits — without the split,
    # the shared base would glue into the divergent suffix and lose
    # its wholesale-dedupe (the union kernel re-glues tokens, so extra
    # boundaries never change the final weave). TWO dense patterns:
    # consecutive-ts conj chains (hi+1, lo constant) and same-tx extend
    # runs (hi constant, lo+1 — one transaction's tx-index run, the
    # API's bulk paste path, list.cljc:23-25 analogue)
    dense_hi = np.zeros(n, bool)
    dense_lo = np.zeros(n, bool)
    dense_hi[1:] = (lo[1:n] == lo[: n - 1]) & (hi[1:n] == hi[: n - 1] + 1)
    dense_lo[1:] = (hi[1:n] == hi[: n - 1]) & (lo[1:n] == lo[: n - 1] + 1)
    dense_ok = dense_hi | dense_lo
    dense_ok[0] = True
    glued &= dense_ok
    # the root is always a singleton segment (its packed lo differs
    # from any chain site's, so a root-headed run could never be
    # dense). This must precede the alternation cut: the cut reads
    # glued[1], and the pre-singleton value depends on whether the
    # ROOT is contested — which later root-caused lanes flip, making
    # old segment boundaries depend on the tree's future (raw fuzz
    # caught exactly that prefix instability).
    if n > 1:
        glued[1] = False
    # dedupe soundness: a dense run's member ids must be fully
    # determined by (min, max, len), which holds only when the whole
    # run follows ONE pattern (for len > 1 the endpoints reveal which:
    # exactly one of max_hi == min_hi / max_lo == min_lo). Cut the
    # second of any two consecutive glued pairs whose patterns differ.
    if n > 2:
        alt = np.zeros(n, bool)
        alt[2:] = glued[2:] & glued[1:-1] & (dense_lo[2:] != dense_lo[1:-1])
        glued &= ~alt

    run_start = ~glued
    rid = np.cumsum(run_start).astype(np.int32) - 1
    run_of_lane[:n] = rid
    n_runs = int(rid[-1]) + 1

    head_lane = np.flatnonzero(run_start).astype(np.int32)
    nxt = np.concatenate([head_lane[1:], np.int32([n])])
    sg_len = (nxt - head_lane).astype(np.int32)
    tail_lane = nxt - 1

    sg_min_hi = hi[:n][head_lane].astype(np.int32)
    sg_min_lo = lo[:n][head_lane].astype(np.int32)
    sg_max_hi = hi[:n][tail_lane].astype(np.int32)
    sg_max_lo = lo[:n][tail_lane].astype(np.int32)

    # dense: every adjacent pair follows one of the two dense patterns
    # (hi+1/lo-const conj chains or hi-const/lo+1 tx runs), uniform
    # along the run via the alternation cut above. The glue split makes
    # every multi-lane run dense by construction; keep the aggregate
    # check anyway (robustness against a future glue-rule change
    # silently losing the invariant)
    bad = ~dense_ok & ~run_start  # the head lane never breaks its run
    bad_runs = np.zeros(n_runs, bool)
    bad_runs[rid[bad]] = True
    sg_dense = ~bad_runs

    sg_tail_special = special[tail_lane]

    # position-weighted vclass checksum per run: catches interior body
    # -class divergence between same-id twins (see SEG_KEYS). int64
    # accumulate + 31-bit mask: bincount's float64 path would make the
    # int32 cast platform-dependent for very long special runs, and the
    # checksum only needs deterministic equality
    offset = idx - head_lane[rid[:n]]
    vsum64 = np.zeros(n_runs, np.int64)
    np.add.at(vsum64, rid[:n],
              (offset.astype(np.int64) + 1) * vclass[:n])
    sg_vsum = (vsum64 & 0x7FFFFFFF).astype(np.int32)

    return {
        "run_of_lane": run_of_lane,
        "sg_head_lane": head_lane,
        "sg_len": sg_len,
        "sg_min_hi": sg_min_hi,
        "sg_min_lo": sg_min_lo,
        "sg_max_hi": sg_max_hi,
        "sg_max_lo": sg_max_lo,
        "sg_dense": sg_dense.astype(bool),
        "sg_tail_special": sg_tail_special.astype(bool),
        "sg_vsum": sg_vsum,
    }


_TABLE_DTYPES = {
    "sg_min_hi": np.int32, "sg_min_lo": np.int32,
    "sg_max_hi": np.int32, "sg_max_lo": np.int32,
    "sg_len": np.int32, "sg_lane0": np.int32,
    "sg_dense": bool, "sg_tail_special": bool,
    "sg_valid": bool, "sg_vsum": np.int32,
}


def concat_seg_tables(per_tree, capacity: int, s_max: int,
                      out: Dict[str, np.ndarray] = None):
    """Fill the ``SEG_LANE_KEYS`` table arrays for one concat row —
    the single place that knows the layout (wave assembly, delta
    sessions, and ``concat_segments`` all route through it). ``out``
    may carry preallocated [s_max] arrays (e.g. batch-row views);
    entries beyond each tree's tables are zeroed/invalidated. Returns
    ``(out, bases)`` with each tree's starting segment ordinal."""
    if out is None:
        out = {k: np.zeros(s_max, dt) for k, dt in _TABLE_DTYPES.items()}
    bases = []
    base = 0
    for t, (segs, _n) in enumerate(per_tree):
        k = segs["sg_len"].shape[0]
        if base + k > s_max:
            raise OverflowError(
                f"segment budget {s_max} < {base + k} segments"
            )
        sl = slice(base, base + k)
        out["sg_min_hi"][sl] = segs["sg_min_hi"]
        out["sg_min_lo"][sl] = segs["sg_min_lo"]
        out["sg_max_hi"][sl] = segs["sg_max_hi"]
        out["sg_max_lo"][sl] = segs["sg_max_lo"]
        out["sg_len"][sl] = segs["sg_len"]
        out["sg_lane0"][sl] = segs["sg_head_lane"] + t * capacity
        out["sg_dense"][sl] = segs["sg_dense"]
        out["sg_tail_special"][sl] = segs["sg_tail_special"]
        out["sg_vsum"][sl] = segs["sg_vsum"]
        out["sg_valid"][sl] = True
        bases.append(base)
        base += k
    if base < s_max:  # invalidate any leftover tail (reused buffers)
        tail = slice(base, s_max)
        out["sg_valid"][tail] = False
        out["sg_len"][tail] = 0
    return out, bases


def concat_segments(per_tree, capacity: int, s_max: int) -> Dict[str, np.ndarray]:
    """Assemble per-tree segment tables into the device kernel's concat
    layout: ``per_tree`` is a list of (``tree_segments`` result, n)
    tuples, each tree occupying ``capacity`` concat lanes in order.

    Returns the ``SEG_LANE_KEYS`` arrays padded to ``s_max`` (in lane
    order — marshal order IS ascending concat lane order, which the
    kernel's expansion scans rely on) plus ``seg`` ([n_trees*capacity]
    int32): every concat lane's segment ordinal (-1 padding).
    """
    n_trees = len(per_tree)
    out, bases = concat_seg_tables(per_tree, capacity, s_max)
    seg = np.full(n_trees * capacity, -1, np.int32)
    for t, ((segs, n), base) in enumerate(zip(per_tree, bases)):
        rl = segs["run_of_lane"]
        lane_sl = slice(t * capacity, t * capacity + n)
        seg[lane_sl] = rl[:n] + base
    out["seg"] = seg
    return out


def extend_segments(segs, hi, lo_win, cause_idx, vclass, n_old: int,
                    n_new: int):
    """O(k) extension of a tree's segment tables for appended lanes
    ``[n_old, n_new)`` — the segment twin of the lane cache's append
    fast path (a 10k-tree ``tree_segments`` costs ~1 ms; a sync fleet
    recomputing it per edited replica per wave pays seconds).

    ``hi``/``cause_idx``/``vclass`` are full arena columns (free);
    ``lo_win`` covers lanes ``[n_old-1, n_new)`` only, so the caller
    never packs the whole tree. Returns the new tables, or None when
    the append shape needs a full recompute. The *simple-append
    domain* (everything conj/extend/cons/tail-tombstones mint):

    - every appended cause resolves to the appended chain (i-1), the
      old tail (n_old-1), the root (0), or nothing (-1);
    - a non-special appended whose host jump would walk past a SPECIAL
      old tail into old lanes is out.

    Within that domain OLD glue bits cannot change: new children
    attach only to the old tail (whose contestedness affects only lane
    n_old's glue) or the root (always a singleton) — so the old tables
    survive verbatim except that the LAST segment may extend, and the
    appended lanes segment locally. Fuzz-checked against from-scratch
    ``tree_segments`` (tests/test_lanecache.py).
    """
    k = n_new - n_old
    n_segs_old = segs["sg_len"].shape[0]
    if n_old < 2 or k <= 0 or n_segs_old == 0:
        return None

    def LO(lane):
        return lo_win[lane - (n_old - 1)]

    idx = np.arange(n_old, n_new, dtype=np.int64)
    ci = cause_idx[n_old:n_new].astype(np.int64)
    special = vclass[n_old:n_new] > 0
    chain = ci == idx - 1          # includes the boundary lane n_old
    to_tail = ci == n_old - 1
    to_root = ci == 0
    none_c = ci == -1
    if not bool(np.all(chain | to_tail | to_root | none_c)):
        return None  # stabs an old interior lane: recompute
    old_tail_special = bool(vclass[n_old - 1] > 0)

    # parents (for contestedness): specials hang off their cause,
    # non-specials off the first non-special through the chain. -2
    # stands for root/none (harmless: their glue is already fixed).
    parent = np.full(k, -2, np.int64)
    for j in range(k):
        if special[j]:
            c = ci[j]
            parent[j] = c if c >= n_old - 1 else -2
            continue
        p = ci[j]
        while p >= n_old and vclass[int(p)] > 0:
            p = cause_idx[int(p)]
        if p == n_old - 1 and old_tail_special:
            return None  # host walk would continue into old lanes
        if p >= n_old - 1:
            parent[j] = p
        else:
            parent[j] = -2

    prev_special = np.concatenate([[old_tail_special], special[:-1]])
    adj = chain
    host_case = adj & ~special & prev_special
    irregular = ~adj | host_case
    contested = set(int(p) for p in parent[irregular] if p >= 0)
    prev_contested = np.fromiter(
        (int(p) in contested for p in idx - 1), bool, k
    )
    lo_cur = lo_win[1:]
    lo_prev = lo_win[:-1]
    hi_cur = hi[n_old:n_new]
    hi_prev = hi[n_old - 1:n_new - 1]
    dense_hi_p = (lo_cur == lo_prev) & (hi_cur == hi_prev + 1)
    dense_lo_p = (hi_cur == hi_prev) & (lo_cur == lo_prev + 1)
    glued = adj & ~host_case & ~prev_contested & (dense_hi_p | dense_lo_p)
    pat = dense_lo_p

    # boundary pattern consistency with the old last segment
    old_len = int(segs["sg_len"][-1])
    if glued[0] and old_len > 1:
        old_lo_pat = bool(segs["sg_max_hi"][-1] == segs["sg_min_hi"][-1])
        if bool(pat[0]) != old_lo_pat:
            glued[0] = False
    for j in range(1, k):  # alternation cut within the appended run
        if glued[j] and glued[j - 1] and bool(pat[j]) != bool(pat[j - 1]):
            glued[j] = False

    # run ids for the appended lanes
    last = n_segs_old - 1
    rid = np.empty(k, np.int64)
    cur = last
    new_heads = []
    for j in range(k):
        if not glued[j]:
            cur += 1
            new_heads.append((cur, n_old + j))
        rid[j] = cur
    n_segs_new = cur + 1

    rol = segs["run_of_lane"]
    if n_new > rol.shape[0]:
        grown = np.full(max(n_new, 2 * rol.shape[0]), -1, np.int32)
        grown[: rol.shape[0]] = rol
        rol = grown
    else:
        rol = rol.copy()
    rol[n_old:n_new] = rid.astype(np.int32)

    out = {"run_of_lane": rol}
    for key in SEG_KEYS:
        grow = np.zeros(n_segs_new, segs[key].dtype)
        grow[:n_segs_old] = segs[key]
        out[key] = grow
    for sg, head in new_heads:
        out["sg_head_lane"][sg] = head
        out["sg_min_hi"][sg] = hi[head]
        out["sg_min_lo"][sg] = LO(head)
        out["sg_dense"][sg] = True  # glue requires a dense pattern
    # per-touched-segment tails/lengths/checksums
    for sg in range(last, n_segs_new):
        mask = rid == sg
        c = int(mask.sum())
        if c == 0:
            continue  # the old last segment gained nothing
        lanes = np.flatnonzero(mask) + n_old
        tail = int(lanes[-1])
        base_len = int(out["sg_len"][sg]) if sg == last else 0
        out["sg_len"][sg] = base_len + c
        out["sg_max_hi"][sg] = hi[tail]
        out["sg_max_lo"][sg] = LO(tail)
        out["sg_tail_special"][sg] = bool(vclass[tail] > 0)
        w = (base_len + np.arange(1, c + 1, dtype=np.int64)) * vclass[lanes]
        out["sg_vsum"][sg] = np.int32(
            (int(out["sg_vsum"][sg]) + int(w.sum())) & 0x7FFFFFFF
        )
    return out
