"""Synthetic divergent-replica generators and the v5 marshal helpers.

The subset of ``cause_tpu.benchgen`` the port's main path needs: the
lane-level batch generators (a shared append-only base chain plus two
divergent suffixes per replica pair, every ``hide_every``-th suffix node
a ``hide`` tombstone), the v5 segment-table marshal, the host-side token
budget, the handle-level fleet generator, and ``lanes_from_numpy``,
which turns the marshalled numpy batch into the port's tensors — so one
marshalled batch feeds both packages.

Site-id strings never exist in the lane generators: sites are
materialized directly as order-preserving ranks (root "0" < base <
suffix sites), the same contract ``SiteInterner`` enforces for real
trees.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .weaver.arrays import (
    DEFAULT_PACK,
    I32_MAX,
    PackSpec,
    VCLASS_HIDE,
    next_pow2,
)
from .weaver.segments import SEG_LANE_KEYS as _SEG_LANE_KEYS

__all__ = [
    "chain_tree_lanes",
    "divergent_pair_lanes",
    "batched_pair_lanes",
    "delta_sweep_inputs",
    "tree_fleet_handles",
    "v5_inputs",
    "batched_v5_inputs",
    "v5_token_budget",
    "estimate_tokens",
    "lanes_from_numpy",
    "LANE_KEYS",
    "LANE_KEYS4",
    "LANE_KEYS5",
]

LANE_KEYS = ("hi", "lo", "chi", "clo", "vc", "valid")
# the v4 kernel's lanes: cause ids are replaced by ``cci``, the cause's
# index in the concatenated pre-sort lane array (known at marshal time)
LANE_KEYS4 = ("hi", "lo", "cci", "vc", "valid")
# the v5 segment-union kernel: v4's node lanes + per-lane segment ids
# + the marshal-extracted segment tables
LANE_KEYS5 = LANE_KEYS4 + ("seg",) + _SEG_LANE_KEYS

# which v5 inputs are flags; every other key is an int32 lane or table
V5_BOOL_KEYS = frozenset({"valid", "sg_dense", "sg_tail_special",
                          "sg_valid"})


def lanes_from_numpy(lanes: Dict[str, np.ndarray], device="cuda") -> dict:
    """The ``LANE_KEYS5`` numpy batch (``batched_v5_inputs``) as the
    port's tensors on ``device``, with dtypes fixed: int32 for ids,
    causes, classes, segment ids and tables, bool for the valid and
    dense flags."""
    import torch

    from .device import resolve_device

    dev = resolve_device(device)
    out = {}
    for k in LANE_KEYS5:
        dt = torch.bool if k in V5_BOOL_KEYS else torch.int32
        arr = np.ascontiguousarray(lanes[k])
        out[k] = torch.from_numpy(arr).to(device=dev, dtype=dt)
    return out


def v5_inputs(row: Dict[str, np.ndarray], capacity: int,
              s_max: int = 0) -> Dict[str, np.ndarray]:
    """Build the v5 segment-union kernel's inputs from a concatenated
    multi-tree lane row (``capacity`` lanes per tree): segment each
    tree host-side and assemble the concat segment tables. ``s_max`` 0
    sizes the tables exactly (padded to a multiple of 8)."""
    from .weaver.segments import concat_segments, tree_segments

    n_trees = row["hi"].shape[0] // capacity
    per_tree = []
    for t in range(n_trees):
        sl = slice(t * capacity, (t + 1) * capacity)
        n = int(row["valid"][sl].sum())
        cci = row["cci"][sl]
        local_cci = np.where(cci >= 0, cci - t * capacity, -1).astype(
            np.int32
        )
        segs = tree_segments(
            row["hi"][sl], row["lo"][sl], local_cci, row["vc"][sl], n
        )
        per_tree.append((segs, n))
    total = sum(s["sg_len"].shape[0] for s, _ in per_tree)
    if not s_max:
        s_max = total + (-total) % 8
    out = dict(row)
    out.update(concat_segments(per_tree, capacity, s_max))
    return out


def batched_v5_inputs(batch: Dict[str, np.ndarray],
                      capacity: int) -> Dict[str, np.ndarray]:
    """Per-row ``v5_inputs`` over a [B, n_trees*capacity] batch, with a
    shared segment-table size (rows marshal once; shorter tables pad
    with all-invalid tails to the widest row)."""
    from .weaver.segments import SEG_LANE_KEYS

    B = batch["hi"].shape[0]
    rows = [
        v5_inputs({k: batch[k][i] for k in LANE_KEYS4}, capacity)
        for i in range(B)
    ]
    s_max = max(r["sg_len"].shape[0] for r in rows)
    for r in rows:
        pad = s_max - r["sg_len"].shape[0]
        if pad:
            for k in SEG_LANE_KEYS:
                r[k] = np.concatenate(
                    [r[k], np.zeros(pad, r[k].dtype)]
                )
    return {k: np.stack([r[k] for r in rows]) for k in LANE_KEYS5}


def v5_token_budget(v5batch: Dict[str, np.ndarray],
                    sample_rows: int = 4) -> int:
    """Token budget for the v5 kernel, sampled like ``pair_run_budget``
    (the overflow flag backstops unsampled-row drift)."""
    B = v5batch["hi"].shape[0] if v5batch["hi"].ndim > 1 else 1
    if v5batch["hi"].ndim == 1:
        rows = [v5batch]
    else:
        picks = sorted({0, B // 3, (2 * B) // 3, B - 1})[:sample_rows]
        rows = [{k: v5batch[k][i] for k in LANE_KEYS5} for i in picks]
    worst = max(estimate_tokens(r) for r in rows)
    return int(worst + max(64, worst // 8))


def estimate_tokens(v5row: Dict[str, np.ndarray]) -> int:
    """Host-side token count for one v5 row (numpy twin of the
    kernel's explode/dedupe rules E1/E2) — sizes ``u_max`` before
    dispatch; the kernel's overflow flag backstops drift."""
    va = v5row["sg_valid"]
    mh, ml = v5row["sg_min_hi"][va], v5row["sg_min_lo"][va]
    Mh, Ml = v5row["sg_max_hi"][va], v5row["sg_max_lo"][va]
    ln = v5row["sg_len"][va]
    dense = v5row["sg_dense"][va]
    tsp = v5row["sg_tail_special"][va]
    vsum = v5row["sg_vsum"][va]
    lane0 = v5row["sg_lane0"][va]
    S = ln.shape[0]
    if S == 0:
        return 8
    mins = (mh.astype(np.int64) << 32) | (ml.astype(np.int64) & 0xFFFFFFFF)
    maxs = (Mh.astype(np.int64) << 32) | (Ml.astype(np.int64) & 0xFFFFFFFF)
    order = np.lexsort((ml, mh))
    mins, maxs = mins[order], maxs[order]
    ln, dense, tsp, lane0 = (ln[order], dense[order], tsp[order],
                             lane0[order])
    vsum = vsum[order]
    ncap = len(v5row["cci"])
    hvc = v5row["vc"][np.clip(lane0, 0, ncap - 1)]
    cl0 = v5row["cci"][np.clip(lane0, 0, ncap - 1)]
    cid0 = np.where(
        cl0 >= 0,
        (v5row["hi"][np.clip(cl0, 0, ncap - 1)].astype(np.int64) << 32)
        | (v5row["lo"][np.clip(cl0, 0, ncap - 1)].astype(np.int64)
           & 0xFFFFFFFF),
        -1,
    )
    same = np.zeros(S, bool)
    same[1:] = ((mins[1:] == mins[:-1]) & (maxs[1:] == maxs[:-1])
                & (ln[1:] == ln[:-1]) & dense[1:] & dense[:-1]
                & (hvc[1:] == hvc[:-1]) & (cid0[1:] == cid0[:-1])
                & (tsp[1:] == tsp[:-1]) & (vsum[1:] == vsum[:-1]))
    grp = np.cumsum(~same) - 1
    g_min = mins[np.concatenate([[True], ~same[1:]])]
    g_max = maxs[np.concatenate([[True], ~same[1:]])]
    pm = np.maximum.accumulate(g_max)
    pm_excl = np.concatenate([[np.iinfo(np.int64).min], pm[:-1]])
    nxt_min = np.concatenate([g_min[1:], [np.iinfo(np.int64).max]])
    ov = (mins <= pm_excl[grp]) | (nxt_min[grp] <= maxs)
    # E2 stabs from every segment head's cause (cid0 packs them above)
    has = cl0 >= 0
    cid = cid0
    pg = np.searchsorted(g_min, cid, side="right") - 1
    pgc = np.clip(pg, 0, len(g_min) - 1)
    rep = np.flatnonzero(np.concatenate([[True], ~same[1:]]))
    stab = (
        has & (pg >= 0)
        & (g_min[pgc] <= cid)
        & ((cid < g_max[pgc])
           | ((cid == g_max[pgc]) & tsp[rep[pgc]] & (ln[rep[pgc]] > 1)))
    )
    stabbed = np.zeros(len(g_min), bool)
    stabbed[pgc[stab]] = True
    explode = ov | stabbed[grp]
    twin_drop = same & ~explode
    n_tok = int(np.where(explode, ln,
                         np.where(twin_drop, 0, 1)).sum())
    return max(8, n_tok)


# synthetic site ranks (order-preserving: "0" sorts first, suffix sites
# are minted after and sort above the base site by construction)
SITE_ROOT = 0
SITE_BASE = 1
SITE_A = 2
SITE_B = 3


def chain_tree_lanes(
    n_base: int,
    n_div: int,
    suffix_site: int,
    capacity: int,
    hide_every: int = 0,
    spec: PackSpec = DEFAULT_PACK,
) -> Dict[str, np.ndarray]:
    """Lanes for ONE tree: root + base chain + one divergent suffix.

    Lanes come out in sorted id order (ts is strictly increasing along
    the chain), root at lane 0 — the ``NodeArrays.from_nodes_map``
    layout. Returns hi/lo (id lanes), chi/clo (cause id lanes), vc,
    valid, each of length ``capacity``.
    """
    n = 1 + n_base + n_div
    if capacity < n:
        raise ValueError(f"capacity {capacity} < node count {n}")
    ts = np.zeros(n, np.int64)
    site = np.zeros(n, np.int64)
    vc = np.zeros(n, np.int32)

    # base chain: ts 1..n_base, all from SITE_BASE
    ts[1 : 1 + n_base] = np.arange(1, n_base + 1)
    site[1 : 1 + n_base] = SITE_BASE
    # divergent suffix: ts n_base+1 .., from suffix_site
    ts[1 + n_base :] = np.arange(n_base + 1, n_base + n_div + 1)
    site[1 + n_base :] = suffix_site

    # causes: chain — node i caused by node i-1 (root causes itself as
    # a placeholder; its cause lanes are (-1,-1) below)
    cts = np.concatenate([[0], ts[:-1]])
    csite = np.concatenate([[0], site[:-1]])

    if hide_every > 0:
        # every k-th suffix node is a hide targeting its predecessor
        j = np.arange(1, n_div + 1)
        is_hide = (j % hide_every) == 0
        vc[1 + n_base :][is_hide] = VCLASS_HIDE

    tx = np.zeros(n, np.int64)
    hi = np.full(capacity, I32_MAX, np.int32)
    lo = np.full(capacity, I32_MAX, np.int32)
    chi = np.full(capacity, -1, np.int32)
    clo = np.full(capacity, -1, np.int32)
    cci = np.full(capacity, -1, np.int32)
    vcl = np.zeros(capacity, np.int32)
    valid = np.zeros(capacity, bool)

    hi[:n] = ts.astype(np.int32)
    lo[:n] = (site.astype(np.int32) << spec.tx_bits) | tx.astype(np.int32)[:n]
    chi[1:n] = cts[1:].astype(np.int32)
    clo[1:n] = (csite[1:].astype(np.int32) << spec.tx_bits)
    cci[1:n] = np.arange(n - 1, dtype=np.int32)  # chain: cause = lane i-1
    vcl[:n] = vc
    valid[:n] = True
    return {"hi": hi, "lo": lo, "chi": chi, "clo": clo, "cci": cci,
            "vc": vcl, "valid": valid}


def divergent_pair_lanes(
    n_base: int,
    n_div: int,
    capacity: int,
    hide_every: int = 0,
    spec: PackSpec = DEFAULT_PACK,
) -> Dict[str, np.ndarray]:
    """Concatenated lanes ([2*capacity]) of one divergent replica pair —
    the per-replica input of ``merge_weave_kernel``."""
    a = chain_tree_lanes(n_base, n_div, SITE_A, capacity, hide_every, spec)
    b = chain_tree_lanes(n_base, n_div, SITE_B, capacity, hide_every, spec)
    out = {k: np.concatenate([a[k], b[k]]) for k in a}
    # cci is a concat index: the second tree's causes shift by capacity
    out["cci"][capacity:] = np.where(
        b["cci"] >= 0, b["cci"] + capacity, -1
    )
    return out


def delta_sweep_inputs(
    n_replicas: int,
    n_base: int,
    n_div: int,
    capacity: int,
    hide_every: int = 0,
    spec: PackSpec = DEFAULT_PACK,
    include_full: bool = True,
) -> dict:
    """Paired full-weave / delta-weave inputs: the same synthetic
    workload as the document-width batch the full v5 kernel dispatches
    and as the delta-native WINDOW batch
    (``weaver.torchwd.batched_delta_weave``'s inputs), plus the frozen
    prefix state a resident session would hold.

    The workload is ``batched_pair_lanes`` restricted to the delta
    domain: the first divergent node on each side is never a tombstone
    (its cause is the shared base tail, the anchor, whose frozen
    visibility it would flip; see ``parallel.wave.delta_domain_ok``).

    Returns a dict: ``full`` (``LANE_KEYS5`` arrays, [B, 2*capacity];
    None with ``include_full=False``), ``window`` (``LANE_KEYS5``
    arrays, [B, 2*wcap] with ``wcap = next_pow2(max(8, 1 + n_div))``),
    ``r0`` ([B] int32 anchor ranks = ``n_base``), ``prefix_digest`` ([B]
    uint32, the resident prefix's frozen term sum from
    ``mesh.mix32_np``), ``wcap`` and ``starts``/``counts`` ([B, 2], the
    splice's coordinates). The full kernel's digest equals
    ``prefix_digest`` plus the window's contribution."""
    batch = batched_pair_lanes(
        n_replicas=n_replicas, n_base=n_base, n_div=n_div,
        capacity=capacity, hide_every=hide_every, spec=spec,
    )
    # delta-domain restriction: no tombstone on the first suffix node
    # of either side (its cause is the anchor)
    if n_div > 0:
        batch["vc"][:, 1 + n_base] = 0
        batch["vc"][:, capacity + 1 + n_base] = 0
    full = batched_v5_inputs(batch, capacity) if include_full else None

    wcap = next_pow2(max(8, 1 + n_div))
    B = n_replicas
    n_w = 2 * wcap
    window = {
        "hi": np.full((B, n_w), I32_MAX, np.int32),
        "lo": np.full((B, n_w), I32_MAX, np.int32),
        "cci": np.full((B, n_w), -1, np.int32),
        "vc": np.zeros((B, n_w), np.int32),
        "valid": np.zeros((B, n_w), bool),
    }
    sfx = {0: slice(1 + n_base, 1 + n_base + n_div),
           1: slice(capacity + 1 + n_base,
                    capacity + 1 + n_base + n_div)}
    anchor_hi = np.int32(n_base)
    anchor_lo = np.int32(SITE_BASE << spec.tx_bits)
    for t in range(2):
        off = t * wcap
        window["hi"][:, off] = anchor_hi
        window["lo"][:, off] = anchor_lo
        window["valid"][:, off] = True
        if n_div:
            w = 1 + n_div
            window["hi"][:, off + 1:off + w] = batch["hi"][:, sfx[t]]
            window["lo"][:, off + 1:off + w] = batch["lo"][:, sfx[t]]
            window["vc"][:, off + 1:off + w] = batch["vc"][:, sfx[t]]
            window["valid"][:, off + 1:off + w] = True
            # suffix causes are a pure chain off the anchor: window
            # lane j's cause is lane j-1 (the anchor at j=1)
            window["cci"][:, off + 1:off + w] = off + np.arange(
                n_div, dtype=np.int32)
    window = batched_v5_inputs(
        {k: window[k] for k in LANE_KEYS4}, wcap)

    # the frozen prefix: root + base chain, ranks 0..n_base (the weave
    # IS the chain), root invisible, chain visible — identical for
    # every row, so one host sum serves the whole batch
    from .parallel.mesh import mix32_np

    p_hi = np.arange(n_base + 1, dtype=np.int32)
    p_lo = np.full(n_base + 1, np.int32(SITE_BASE << spec.tx_bits))
    p_lo[0] = 0  # the root's site rank is 0
    p_rank = np.arange(n_base + 1, dtype=np.int32)
    p_vis = np.ones(n_base + 1, bool)
    p_vis[0] = False
    pdig = np.uint32(
        mix32_np(p_hi, p_lo, p_rank, p_vis).sum(dtype=np.uint64)
        & np.uint64(0xFFFFFFFF))
    return {
        "full": full,
        "window": window,
        "wcap": int(wcap),
        "r0": np.full(B, n_base, np.int32),
        "prefix_digest": np.full(B, pdig, np.uint32),
        "starts": np.full((B, 2), n_base + 1, np.int32),
        "counts": np.full((B, 2), n_div, np.int32),
    }


def tree_fleet_handles(n_replicas: int, n_base: int, n_div: int,
                       hide_every: int = 0) -> list:
    """``n_replicas`` REAL divergent replica handles of one shared
    ``n_base``-node CausalList, each extended by its own
    ``n_div``-op suffix (every ``hide_every``-th suffix op a ``hide``
    tombstone targeting its predecessor) — the merge-tree benchmarks'
    and smokes' fleet, as host handles rather than raw lanes, because
    the tree's A/B baseline (the flat pairwise fold) NEEDS handles to
    materialize through.

    The base weave is computed by the PURE host weaver and the trees
    then evolve to ``weaver="torch"`` (the two weavers are
    semantics-identical — the pure weaver is the oracle), so building
    the fleet touches no device. The first suffix op of every replica is a plain
    value (a tombstone there would target the shared base tail — the
    anchor — which is exactly the delta-domain violation the tree
    falls back to full width for)."""
    from .collections import clist as c_list
    from .collections.clist import CausalList, new_causal_list
    from .ids import HIDE, new_site_id

    base = new_causal_list().extend([f"w{i}" for i in range(n_base)])
    base = CausalList(c_list.weave(base.ct))
    base = CausalList(base.ct.evolve(weaver="torch"))
    replicas = []
    for r in range(n_replicas):
        vals: list = []
        for i in range(n_div):
            vals.append(f"r{r}.{i}")
            if hide_every and i and (i + r) % hide_every == 0:
                vals.append(HIDE)
        h = CausalList(base.ct.evolve(site_id=new_site_id()))
        replicas.append(h.extend(vals[:n_div]) if not hide_every
                        else h.extend(vals))
    return replicas


def batched_pair_lanes(
    n_replicas: int,
    n_base: int,
    n_div: int,
    capacity: int,
    hide_every: int = 0,
    spec: PackSpec = DEFAULT_PACK,
) -> Dict[str, np.ndarray]:
    """The [B, 2*capacity] batch of the batched merge kernels: ``n_replicas`` genuinely *distinct*
    divergent pairs. Every row shares the base chain but gets its own
    pair of suffix sites (row r: ranks ``SITE_A+2r`` / ``SITE_A+2r+1``)
    and its own tombstone phase, so no two rows converge to the same
    weave — per-row digests must differ (asserted by the driver
    dryrun). Built as one broadcast plus vectorized per-row lane
    rewrites, so B=1024 stays cheap."""
    row = divergent_pair_lanes(n_base, n_div, capacity, hide_every, spec)
    out = {
        k: np.broadcast_to(v, (n_replicas,) + v.shape).copy() for k, v in row.items()
    }
    if n_replicas <= 1 or n_div == 0:
        return out

    r = np.arange(n_replicas, dtype=np.int32)
    site_a = (SITE_A + 2 * r)[:, None].astype(np.int32)
    site_b = site_a + 1
    # max rank used is SITE_A + 2*n_replicas - 1; generator lanes have
    # tx=0, so even a max-rank lo can't collide with the I32_MAX sentinel
    n_sites = SITE_A + 2 * n_replicas
    if n_sites > (1 << spec.site_bits):
        raise OverflowError(f"{n_sites} sites exceed {spec.site_bits} bits")

    # suffix id lanes (tx = 0 throughout the generator)
    sfx_a = slice(1 + n_base, 1 + n_base + n_div)
    sfx_b = slice(capacity + 1 + n_base, capacity + 1 + n_base + n_div)
    out["lo"][:, sfx_a] = site_a << spec.tx_bits
    out["lo"][:, sfx_b] = site_b << spec.tx_bits
    # within-suffix chain causes (every suffix node but the first, whose
    # cause is the base tail and keeps the base site)
    csfx_a = slice(2 + n_base, 1 + n_base + n_div)
    csfx_b = slice(capacity + 2 + n_base, capacity + 1 + n_base + n_div)
    out["clo"][:, csfx_a] = site_a << spec.tx_bits
    out["clo"][:, csfx_b] = site_b << spec.tx_bits

    if hide_every > 0:
        # per-row tombstone phase; sides get different phases too
        j = np.arange(1, n_div + 1)
        hide_a = ((j[None, :] + r[:, None]) % hide_every) == 0
        hide_b = ((j[None, :] + r[:, None] + 1) % hide_every) == 0
        out["vc"][:, sfx_a] = np.where(hide_a, VCLASS_HIDE, 0).astype(np.int32)
        out["vc"][:, sfx_b] = np.where(hide_b, VCLASS_HIDE, 0).astype(np.int32)
    return out
