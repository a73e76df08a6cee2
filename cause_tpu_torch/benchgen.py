"""Synthetic divergent-replica generators, the marshal helpers and the
scalar merge program.

The port's copy of ``cause_tpu.benchgen``: the lane-level batch
generators (a shared append-only base chain plus two divergent suffixes
per replica pair, every ``hide_every``-th suffix node a ``hide``
tombstone; ``fleet_lanes`` for a whole fleet in one row), the host run
estimator and run budget of the v2-v4 kernels, the v5 segment-table
marshal and token budget, the handle-level fleet generator,
``merge_wave_scalar`` (one batched merge of any kernel generation
reduced to a checksum), ``time_dispatch`` (the burst timer every
mode of ``cause_tpu_torch.bench`` shares) and ``lanes_from_numpy``,
which turns the marshalled numpy batch into the port's tensors — so
one marshalled batch feeds both packages. The reference's compile cache
is not ported: the port compiles nothing per shape.

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
    "fleet_lanes",
    "tree_fleet_handles",
    "estimate_pair_runs",
    "pair_run_budget",
    "merge_wave_scalar",
    "time_dispatch",
    "v5_inputs",
    "batched_v5_inputs",
    "v5_token_budget",
    "estimate_tokens",
    "lane_tensor",
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


def lanes_from_numpy(lanes: Dict[str, np.ndarray], device="cuda",
                     keys=LANE_KEYS5) -> dict:
    """The ``keys`` lanes of a numpy batch (by default the ``LANE_KEYS5``
    lanes of ``batched_v5_inputs``; ``LANE_KEYS`` or ``LANE_KEYS4`` of
    ``batched_pair_lanes`` for v1-v4) as the port's tensors on
    ``device``, with dtypes fixed: int32 for ids, causes, classes,
    segment ids and tables, bool for the valid and dense flags."""
    from .device import resolve_device

    dev = resolve_device(device)
    return {k: lane_tensor(k, lanes[k], dev) for k in keys}


def lane_tensor(key: str, x, device):
    """Lane ``key`` (a numpy array or a tensor) as the port's tensor on
    the torch device ``device``, with ``lanes_from_numpy``'s dtype: bool
    for the ``V5_BOOL_KEYS`` flags, int32 for every other lane."""
    import torch

    dt = torch.bool if key in V5_BOOL_KEYS else torch.int32
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dt)


def _union_lanes_np(hi, lo, chi, clo, vc, valid):
    """Numpy twin of the merge kernel's front half (id lexsort, dup
    drop, sort-join cause resolution) — host-side, so run budgets can
    be derived from the real post-union lane structure before any
    device dispatch."""
    order = np.lexsort((lo, hi))
    hi_s, lo_s = hi[order], lo[order]
    dup = np.concatenate(
        [[False], (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])]
    )
    keep = valid[order] & ~dup
    vc_s = vc[order]
    chi_s, clo_s = chi[order], clo[order]
    kept_idx = np.flatnonzero(keep)
    key = (
        (hi_s[kept_idx].astype(np.int64) << 32)
        | (lo_s[kept_idx].astype(np.int64) & 0xFFFFFFFF)
    )
    q = (
        (chi_s.astype(np.int64) << 32)
        | (clo_s.astype(np.int64) & 0xFFFFFFFF)
    )
    pos = np.searchsorted(key, q)
    pos_c = np.clip(pos, 0, max(0, len(key) - 1))
    found = (len(key) > 0) & (key[pos_c] == q)
    cause_idx = np.where(found, kept_idx[pos_c], -1).astype(np.int32)
    return cause_idx, vc_s, keep


def estimate_pair_runs(row: Dict[str, np.ndarray]) -> int:
    """Chain-contracted run count of one replica-pair merge, computed
    host-side: emulate the union front half in numpy, then run the same
    ``estimate_runs`` the API dispatch uses."""
    from .weaver.torchw import estimate_runs

    cause_idx, vc_s, keep = _union_lanes_np(
        row["hi"], row["lo"], row["chi"], row["clo"], row["vc"], row["valid"]
    )
    return estimate_runs(cause_idx, vc_s, keep)


def pair_run_budget(batch: Dict[str, np.ndarray], sample_rows: int = 4) -> int:
    """Run budget for the compressed (v2-v4) kernels, derived from the
    generated lanes: the host run estimator on sampled rows (all of them
    for a single row dict), plus headroom for unsampled rows — the
    kernel's overflow flag still backstops an underestimate."""
    hi = batch["hi"]
    if hi.ndim == 1:
        rows = [batch]
    else:
        B = hi.shape[0]
        picks = sorted({0, B // 3, (2 * B) // 3, B - 1})[:sample_rows]
        rows = [{k: batch[k][i] for k in LANE_KEYS} for i in picks]
    worst = max(estimate_pair_runs(r) for r in rows)
    return int(worst + max(64, worst // 8))


def _float_checksum(order, rank, visible, conflict):
    """The v1-v4 scalar: the float32 sums of the four outputs."""
    import torch

    f32 = torch.float32
    return (rank.to(f32).sum() + order.to(f32).sum()
            + visible.to(f32).sum() + conflict.to(f32).sum())


def _u32(x):
    """int64 holding the low 32 bits of ``x`` (a uint32 value)."""
    return x & 0xFFFFFFFF


def _mul32(x, c: int):
    """``x * c`` mod 2**32 for int64 ``x`` in [0, 2**32) and a uint32
    constant, in two 16-bit halves so no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = _u32(x * (c >> 16)) & 0xFFFF
    return _u32(lo + (hi << 16))


def _v5_digest(rank, visible, conflict, overflow):
    """The v5-family scalar (``cause_tpu.benchgen.merge_wave_scalar``):
    an exact uint32 avalanche digest of (rank, visibility, lane,
    conflict) per row, each row rotated left by ``row & 31`` bits, the
    rows summed mod 2**32, as int32 bits beside the count of
    overflowed rows."""
    import torch

    B, N = rank.shape
    lane = torch.arange(N, dtype=torch.int64, device=rank.device)
    x = _u32(_mul32(_u32(rank.long()), 0x9E3779B1)
             + _mul32(visible.long(), 0x85EBCA77)
             + _mul32(lane, 0xC2B2AE35)[None] + 1)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    row = _u32(x.sum(dim=1)) ^ (conflict.long() * 0x27D4EB2F)
    rix = torch.arange(B, dtype=torch.int64, device=rank.device) & 31
    row = _u32((row << rix) | (row >> ((32 - rix) & 31)))
    digest = _u32(row.sum())
    digest = torch.where(digest >= 1 << 31, digest - (1 << 32), digest)
    return torch.stack([digest, overflow.long().sum()]).to(torch.int32)


def merge_wave_scalar(*args, k_max: int = 0, kernel: str = "v2",
                      u_max: int = 0, device=None):
    """The timed program of the merge benchmarks: one batched
    merge+weave on ``device`` (the package default, ``use_device``, when
    None) reduced to a scalar on the device.

    ``k_max`` > 0 selects a compressed kernel — ``kernel`` picks which
    ("v2" chain-compressed, "v3" sparse-irregular, "v4"
    marshal-resolved causes, "v4w" = v4 with the Euler walk, "v5"
    segment-union with token budget ``u_max``, "v5w" = v5 with the Euler
    walk, "v5f" = v5 with the fused token pipeline) — with that run
    budget, returning a length-2 tensor ``[checksum,
    n_overflowed_rows]``; ``k_max=0`` runs the uncompressed v1 kernel
    and returns just the checksum. For the v5 family the checksum is
    the reference's EXACT int32 avalanche digest of (rank, visibility,
    lane, conflict), row-rotated, equal integer for integer; v1-v4 keep
    the float32 sum (its summation order differs from the reference's).
    v1-v3 take the ``LANE_KEYS`` lanes, v4/v4w the ``LANE_KEYS4`` lanes,
    v5 the ``LANE_KEYS5`` lanes. The port has no program cache: each
    call runs the kernels, and with telemetry on it counts one dispatch
    at the reference's site, under an identity that names the kernel
    sources' hash where the reference names its switch settings."""
    import torch

    from . import kernels
    from .device import default_device
    from .obs import costmodel

    dev = default_device() if device is None else device
    name = kernel if k_max > 0 else "v1"
    if costmodel.enabled():
        costmodel.record_dispatch(
            f"scalar:{name}:k{int(k_max)}:u{int(u_max)}"
            f":s{kernels.source_hash()}", site="benchgen")
    if k_max > 0 and kernel in ("v5", "v5w", "v5f"):
        if kernel == "v5f":
            from .weaver.torchw5f import batched_merge_weave_v5f as run
        else:
            from .weaver.torchw5 import batched_merge_weave_v5 as run
        return _v5_digest(*run(*args, u_max=int(u_max), k_max=int(k_max),
                               device=dev))
    if k_max > 0:
        if kernel in ("v4", "v4w"):
            from .weaver.torchw4 import batched_merge_weave_v4

            out = batched_merge_weave_v4(
                *args, k_max=k_max, device=dev,
                euler="walk" if kernel == "v4w" else "doubling")
        elif kernel == "v3":
            from .weaver.torchw3 import batched_merge_weave_v3

            out = batched_merge_weave_v3(*args, k_max=k_max, device=dev)
        else:
            from .weaver.torchw import batched_merge_weave_v2

            out = batched_merge_weave_v2(*args, k_max=k_max, device=dev)
        return torch.stack([_float_checksum(*out[:4]),
                            out[4].to(torch.float32).sum()])
    from .weaver.torchw import batched_merge_weave

    return _float_checksum(*batched_merge_weave(*args, device=dev))


def time_dispatch(dispatch, reps: int, burst_n: int = 8,
                  begin=None, end=None):
    """The bench's timing method as one helper, so that every mode times
    alike: ``reps`` single dispatches, each waited for, then bursts of
    ``burst_n`` dispatches with one wait at the end of each: ``reps``
    bursts while the single p50 is under a second, one otherwise (past
    that a burst's launch overhead is noise). ``dispatch`` returns a
    tensor; the wait is its copy to the host (``.cpu()``), which returns
    once the work queued on the device's stream before it is done.
    ``begin``/``end`` bracket each timed single (the cost model's wave
    window), outside its time; bursts are not bracketed (a burst is not
    one wave). Returns ``(singles_ms, bursts_ms)``, host clock, a
    burst's time divided by ``burst_n``."""
    import time as _time

    singles = []
    for _ in range(reps):
        if begin is not None:
            begin()
        t0 = _time.perf_counter()
        dispatch().cpu()
        singles.append((_time.perf_counter() - t0) * 1000.0)
        if end is not None:
            end()
    bursts = []
    burst_reps = reps if float(np.median(singles)) < 1000.0 else 1
    for _ in range(burst_reps):
        t0 = _time.perf_counter()
        out = None
        for _ in range(burst_n):
            out = dispatch()
        out.cpu()
        bursts.append((_time.perf_counter() - t0) * 1000.0 / burst_n)
    return singles, bursts


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


def fleet_lanes(
    n_replicas: int,
    n_base: int,
    n_div: int,
    capacity: int,
    hide_every: int = 0,
    spec: PackSpec = DEFAULT_PACK,
) -> Dict[str, np.ndarray]:
    """Flattened ``[n_replicas * capacity]`` lanes of a whole fleet: K
    divergent replicas of one shared base chain, each with its own
    suffix site and tombstone phase. Feed straight into
    ``merge_weave_kernel`` — its sort-dedupe union front half is K-ary
    for free — to converge the entire fleet into ONE tree on device
    (the north star's "1024 replicas into one" reading)."""
    n_sites = SITE_A + n_replicas
    if n_sites > (1 << spec.site_bits):
        raise OverflowError(f"{n_sites} sites exceed {spec.site_bits} bits")
    rows = []
    for r in range(n_replicas):
        row = chain_tree_lanes(
            n_base, n_div, SITE_A + r, capacity,
            hide_every=0, spec=spec,
        )
        if hide_every > 0 and n_div > 0:
            j = np.arange(1, n_div + 1)
            is_hide = ((j + r) % hide_every) == 0
            row["vc"][1 + n_base:1 + n_base + n_div][is_hide] = VCLASS_HIDE
        row["cci"] = np.where(
            row["cci"] >= 0, row["cci"] + r * capacity, -1
        ).astype(np.int32)
        rows.append(row)
    return {k: np.concatenate([row[k] for row in rows]) for k in rows[0]}


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
