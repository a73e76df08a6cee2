"""The v3 merge+weave kernel: sparse-irregular linearization.

Port of ``cause_tpu.weaver.jaxw3`` (its module docstring gives the
design): after one id sort, full-width work is elementwise and scans
only, and every search, gather and scatter of substance runs at the
chain-compressed run width ``k_max``:

- union and adjacency by shifted key compares against the previous lane;
- the irregular lanes (run heads that are not a plain append) pulled
  into ``k_max`` slots by a search of their running count;
- their causes resolved by a (hi, lo) binary search at ``k_max``, their
  hosts by a walk that steps one cause link a round while any query's
  host is special;
- contracted sibling sort and Euler ranking at ``k_max``;
- ranks expanded by a delta cumsum, visibility by direction-flipped
  scans plus a ``k_max``-wide preorder-successor lookup.

The batch is an explicit leading ``[B, ...]`` dimension. On the card the
two sorts are the B1 kernel; the tour keeps pointer doubling
(``euler.euler_rank``), as the reference's XLA does. The back half from
the host walk on is shared with v4 (``torchw4``), whose causes come
resolved from the marshal. Semantics are exact against the JAX package,
overflow included (a row with more than ``k_max`` runs raises its flag
and carries unspecified ranks).
"""

from __future__ import annotations

import math

import torch

from .arrays import I32_MAX, VCLASS_H_HIDE, VCLASS_HIDE
from .bitonic import sort_pairs
from .euler import euler_rank, link_children
from .gatherops import at_add, at_set, searchsorted_targets_left, take1d
from .torchw import _prepare, _row
from .torchw5 import _cummax, _cumsum, _iota, _shift1

__all__ = ["merge_weave_kernel_v3", "batched_merge_weave_v3"]

BIG = int(I32_MAX)
I32 = torch.int32


def _kept_scan(keep, special, idx):
    """The previous kept lane and whether it is special, from one packed
    forward fill (``lane * 2 | special``), and that fill itself."""
    sp_pack = _cummax(torch.where(keep, idx * 2 + special.to(I32), -1))
    sp_prev = _shift1(sp_pack, -1)
    prev_kept = torch.where(sp_prev >= 0, sp_prev >> 1, -1)
    prev_kept_special = (sp_prev >= 0) & ((sp_prev & 1) == 1)
    return sp_pack, prev_kept, prev_kept_special


def _compact(flags, k_max: int):
    """The lanes of each row where ``flags`` holds, in lane order, in
    ``k_max`` slots: ``(lane, valid slot, count)`` (a search of the
    running count for 1..k_max)."""
    cum = _cumsum(flags)
    count = cum[:, -1:]
    B = flags.shape[0]
    targets = _iota(B, k_max, flags.device) + 1
    lane = searchsorted_targets_left(cum, k_max)
    return lane, targets <= torch.clamp(count, max=k_max), count


def _host_walk(p, q_valid, q_special, special, table):
    """First non-special ancestor of each query: step ``p`` through
    ``table`` while the host it holds is special, every row together
    until no query of any row moves (the reference's batched
    ``while_loop``; a row whose queries have stopped does not change)."""
    N = special.shape[1]
    live = q_valid & ~q_special
    for _ in range(N):
        ps = p.clamp(0, N - 1)
        step = live & take1d(special, ps)
        if not bool(step.any()):
            break
        p = torch.where(step, take1d(table, ps), p)
    return p


def _back_half(keep, vc, idx, kidx, n_kept, is_root, special, sp_pack,
               prev_kept, adj, host_case, irregular, q_lane, q_valid,
               q_parent, k_max: int, rank_runs, tail_is_cause):
    """From resolved query parents to ``(rank, visible, overflow)``: the
    glue rule, chain runs, the contracted sibling sort, the ranking
    (``rank_runs(fc, ns, parent_up, run_len)``), the rank expansion and
    the visibility scans (``jaxw3``/``jaxw4``, from ``extra`` on).
    ``tail_is_cause(s_c, t_c)`` says whether the successor run's head at
    lane ``s_c`` is caused by the run tail at lane ``t_c``."""
    B, N = keep.shape
    dev = keep.device
    K = k_max
    targets = _iota(B, K, dev) + 1

    # glue: an adjacent child glues only if its parent has no other
    # (irregular) child, so child runs attach after whole runs
    extra = at_add(torch.zeros((B, N), dtype=I32, device=dev),
                   torch.where(q_valid, q_parent, N), 1)
    ec_pack = _cummax(torch.where(keep, idx * 2 + (extra > 0).to(I32), -1))
    ec_prev = _shift1(ec_pack, -1)
    prev_contested = (ec_prev >= 0) & ((ec_prev & 1) == 1)
    glued = adj & ~host_case & ~prev_contested
    del extra, ec_pack, ec_prev, prev_contested

    run_start = keep & ~glued
    head_lane, r_valid, n_runs = _compact(run_start, K)
    run_id = _cumsum(run_start) - 1
    overflow = n_runs[:, 0] > K
    head_c = head_lane.clamp(0, N - 1)

    # head parent lane: irregular heads resolved above; the rest are
    # contested-adjacent heads whose parent is their kept predecessor
    parent_full = at_set(torch.full((B, N), -1, dtype=I32, device=dev),
                         torch.where(q_valid, q_lane, N), q_parent)
    h_parent = torch.where(
        take1d(irregular, head_c), take1d(parent_full, head_c),
        torch.where(take1d(adj, head_c), take1d(prev_kept, head_c), -1))
    h_parent = torch.where(r_valid & ~take1d(is_root, head_c), h_parent, -1)
    parent_run = torch.where(h_parent >= 0,
                             take1d(run_id, h_parent.clamp(0, N - 1)),
                             -1).to(I32)
    del parent_full, h_parent

    h_special = take1d(special, head_c)
    h_kidx = take1d(kidx, head_c)
    nxt_kidx = torch.roll(h_kidx, -1, dims=1)  # filler tail
    run_len = torch.where(
        r_valid, torch.where(targets == n_runs, n_kept - h_kidx,
                             nxt_kidx - h_kidx), 0).to(I32)

    # contracted sibling sort + Euler ranking, all at K
    has_parent = r_valid & (parent_run >= 0)
    parent_sort = torch.where(has_parent, parent_run, K).to(I32)
    packed = (parent_sort * 2 + (~h_special).to(I32)).to(I32)
    sord = sort_pairs((packed, (-head_c).to(I32), _iota(B, K, dev)),
                      num_keys=2)[2]
    fc, ns = link_children(sord, parent_sort)
    parent_up = torch.where(has_parent, parent_run, -1).to(I32)
    base = rank_runs(fc, ns, parent_up, run_len)
    del fc, ns, sord, packed, parent_sort

    # expansion: per-run bases -> deltas between lane-consecutive runs
    # -> one cumsum over the lanes
    delta = torch.where(r_valid, base - _shift1(base, 0), 0).to(I32)
    delta_n = at_set(torch.zeros((B, N), dtype=I32, device=dev),
                     torch.where(r_valid, head_c, N), delta)
    base_ff = _cumsum(delta_n)
    ffh = _cummax(torch.where(run_start, kidx, -1))
    rank = torch.where(keep, base_ff + (kidx - ffh), N).to(I32)
    del delta_n, base_ff, ffh

    # visibility. in-run: the next kept lane is a glued hide (its cause
    # is this lane) — a reversed forward fill
    hideish = (vc == VCLASS_HIDE) | (vc == VCLASS_H_HIDE)
    kg = glued & hideish
    rpack = _cummax(torch.where(torch.flip(keep, dims=[1]),
                                idx * 2 + torch.flip(kg, dims=[1]).to(I32),
                                -1))
    rprev = _shift1(rpack, -1)
    killed_inrun = torch.flip((rprev >= 0) & ((rprev & 1) == 1), dims=[1])
    del rpack, rprev

    # run tails: the preorder-successor run's head may hide the tail
    run_by_pos = at_set(torch.full((B, N), -1, dtype=I32, device=dev),
                        torch.where(r_valid, base.clamp(0, N - 1), N),
                        _iota(B, K, dev))
    succ_pos = base + run_len
    succ_run = torch.where(r_valid & (succ_pos < n_kept),
                           take1d(run_by_pos, succ_pos.clamp(0, N - 1)), -1)
    s_c = torch.where(succ_run >= 0,
                      take1d(head_c, succ_run.clamp(0, K - 1)),
                      0).clamp(0, N - 1)
    s_is_hide = (succ_run >= 0) & take1d(hideish, s_c)
    # tail of run r = the kept lane before the NEXT run's head (lane
    # order); the last run's tail is the last kept lane overall
    nxt_head = torch.roll(head_c, -1, dims=1)
    tail_lane = torch.where(
        targets == n_runs, (sp_pack[:, -1:] >> 1).clamp(min=0),
        take1d(prev_kept, nxt_head.clamp(0, N - 1))).to(I32)
    t_c = tail_lane.clamp(0, N - 1)
    kill_tail = r_valid & s_is_hide & tail_is_cause(s_c, t_c)
    killed_tail = at_set(torch.zeros((B, N), dtype=torch.bool, device=dev),
                         torch.where(kill_tail, t_c, N), True)
    visible = keep & (vc == 0) & ~is_root & ~(killed_inrun | killed_tail)
    return rank, visible, overflow


def _rank_doubling(fc, ns, parent_up, run_len):
    return euler_rank(fc, ns, parent_up, run_len)[0]


def _v3(hi, lo, cause_hi, cause_lo, vclass, valid, k_max: int):
    B, N = hi.shape
    dev = hi.device
    idx = _iota(B, N, dev)

    # union: one id sort carrying the other lanes, then elementwise
    h, l, order, ch, cl, vc, va = sort_pairs(
        (hi, lo, idx, cause_hi, cause_lo, vclass, valid.to(I32)),
        num_keys=2)
    va = va.bool()
    prev_h, prev_l = _shift1(h, BIG), _shift1(l, BIG)
    dup = (h == prev_h) & (l == prev_l) & (idx > 0)
    keep = va & ~dup
    conflict = (dup & va & ((ch != _shift1(ch, 0)) | (cl != _shift1(cl, 0))
                            | (vc != _shift1(vc, 0)))).any(dim=1)

    cum_keep = _cumsum(keep)
    kidx = cum_keep - 1
    n_kept = cum_keep[:, -1:]
    is_root = keep & (idx == 0)
    special = keep & (vc > 0)
    rel = keep & ~is_root
    sp_pack, prev_kept, prev_kept_special = _kept_scan(keep, special, idx)

    # adjacency: my cause id IS the previous lane's id (duplicate lanes
    # carry the kept head's key, so this compares against the previous
    # kept node)
    adj = rel & (ch == prev_h) & (cl == prev_l) & (prev_kept >= 0)
    host_case = adj & ~special & prev_kept_special
    irregular = rel & (~adj | host_case)
    del prev_h, prev_l

    # compact irregular lanes into K slots
    q_lane, q_valid, _ = _compact(irregular, k_max)
    q_c = q_lane.clamp(0, N - 1)
    q_ch, q_cl = take1d(ch, q_c), take1d(cl, q_c)
    q_special = take1d(special, q_c)

    # resolve irregular causes: (hi, lo) pair binary search at K
    lo_b = torch.zeros_like(q_lane)
    hi_b = torch.full_like(q_lane, N)
    for _ in range(max(1, math.ceil(math.log2(max(2, N)))) + 1):
        mid = torch.div(lo_b + hi_b, 2, rounding_mode="floor")
        ms = mid.clamp(0, N - 1)
        mh, ml = take1d(h, ms), take1d(l, ms)
        less = (mh < q_ch) | ((mh == q_ch) & (ml < q_cl))
        lo_b, hi_b = torch.where(less, mid + 1, lo_b), torch.where(
            less, hi_b, mid)
    pos = lo_b.clamp(0, N - 1)
    found = (take1d(h, pos) == q_ch) & (take1d(l, pos) == q_cl)
    # a miss is a dangling cause: a child of root (v1/v2 clip semantics)
    q_cause = torch.where(take1d(adj, q_c), take1d(prev_kept, q_c),
                          torch.where(found, pos, 0)).to(I32)

    # host walk at K: glued specials step to their kept predecessor,
    # irregular specials to their resolved cause, non-specials stay
    back1 = torch.where(special & adj, prev_kept, idx).to(I32)
    back1 = at_set(back1, torch.where(q_valid & q_special, q_lane, N),
                   q_cause)
    host_q = _host_walk(q_cause, q_valid, q_special, special, back1)
    q_parent = torch.where(q_special, q_cause, host_q).to(I32)

    def tail_is_cause(s_c, t_c):
        return ((take1d(ch, s_c) == take1d(h, t_c))
                & (take1d(cl, s_c) == take1d(l, t_c)))

    rank, visible, overflow = _back_half(
        keep, vc, idx, kidx, n_kept, is_root, special, sp_pack, prev_kept,
        adj, host_case, irregular, q_lane, q_valid, q_parent, k_max,
        _rank_doubling, tail_is_cause)
    return order, rank, visible, conflict, overflow


def batched_merge_weave_v3(hi, lo, cause_hi, cause_lo, vclass, valid,
                           k_max: int, device="cuda"):
    """Sparse-irregular batch on ``device``: ``[B, M]`` lanes (the
    ``benchgen.LANE_KEYS`` layout) -> per row ``(order, rank, visible,
    conflict, overflow)``, as ``torchw.batched_merge_weave_v2``."""
    args = _prepare((hi, lo, cause_hi, cause_lo, vclass, valid), device)
    return _v3(*args, k_max=int(k_max))


def merge_weave_kernel_v3(hi, lo, cause_hi, cause_lo, vclass, valid,
                          k_max: int, device="cuda"):
    """``batched_merge_weave_v3`` for one replica set's ``[M]`` lanes."""
    out = batched_merge_weave_v3(*_row((hi, lo, cause_hi, cause_lo, vclass,
                                        valid)), k_max=k_max, device=device)
    return tuple(x[0] for x in out)
