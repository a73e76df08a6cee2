"""A1: the v5 wave's phase A after B1's segment sort — twin groups, E1
overlaps and E2 stabs over each row's sorted segments.

Counterpart of the XLA glue of ``cause_tpu.weaver.jaxw5``'s phase A (no
Pallas kernel: the JAX package leaves it to XLA). ``seg_order`` takes
the plain version (``seg_order_plain``: the XLA glue's chain as PyTorch
ops) for tensors on the CPU and launches the
CUDA kernel (``csrc/seg_order.cu``) for tensors on the card: one CTA a
row, three passes over the row's segments (gathers, twins, group scans
and the group table in global scratch; the stab search, through an
index of the group mins in shared memory; explode and survive).

The small lane helpers the v5 modules share (``_shift1``, ``_cumsum``,
...) live here, where phase A's chain needs them first.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..obs.core import span
from .arrays import I32_MAX
from .gatherops import at_set, take1d

__all__ = ["SegOrder", "seg_order", "seg_order_plain", "seg_order_cuda",
           "a1_contract"]

BIG = int(I32_MAX)
I32 = torch.int32


class SegOrder(NamedTuple):
    """Phase A's outputs, each ``[B, S]`` over the sorted segments: the
    valid flag, the length (0 when invalid), first lane and special-tail
    flag of the sorted segment; where a twin group starts and the
    group's ordinal; whether the segment explodes to tokens and whether
    it survives as one token."""
    s_va: torch.Tensor
    s_len: torch.Tensor
    s_lane0: torch.Tensor
    s_tsp: torch.Tensor
    grp: torch.Tensor
    grp_start: torch.Tensor
    explode: torch.Tensor
    survive: torch.Tensor


def _shift1(x, fill):
    """The previous lane's value (x shifted right by one along the last
    axis; counterpart of ``jaxw3._shift1``)."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _cumsum(x):
    return torch.cumsum(x, dim=1, dtype=I32)


def _cummax(x):
    return torch.cummax(x, dim=1).values


def _iota(B, n, dev):
    return torch.arange(n, dtype=I32, device=dev).expand(B, n).contiguous()


def _lt(a1, a2, b1, b2):
    return (a1 < b1) | ((a1 == b1) & (a2 < b2))


def _le(a1, a2, b1, b2):
    return (a1 < b1) | ((a1 == b1) & (a2 <= b2))


def _eq(a1, a2, b1, b2):
    return (a1 == b1) & (a2 == b2)


def _pair_cummax(hi, lo):
    """Inclusive running lexicographic max over (hi, lo) int32 pairs:
    one cummax over the order-preserving int64 packing."""
    key = hi.long() * (1 << 32) + (lo.long() + (1 << 31))
    m = _cummax(key)
    mh = torch.div(m, 1 << 32, rounding_mode="floor")
    ml = m - mh * (1 << 32) - (1 << 31)
    return mh.to(I32), ml.to(I32)


def _pair_search_le(kh, kl, qh, ql, size):
    """For each query id, the rightmost index i in the sorted (kh, kl)
    rows with key[i] <= query (-1 if none): the JAX kernel's binary
    search, step for step."""
    steps = 1
    while (1 << steps) < size + 1:
        steps += 1
    lo_b = torch.full_like(qh, -1)
    hi_b = torch.full_like(qh, size - 1)
    for _ in range(steps):
        mid = torch.div(lo_b + hi_b + 1, 2, rounding_mode="floor")
        ms = mid.clamp(0, size - 1)
        ok = _le(take1d(kh, ms), take1d(kl, ms), qh, ql)
        lo_b, hi_b = torch.where(ok, mid, lo_b), torch.where(ok, hi_b, mid - 1)
    return lo_b


def a1_contract(args, out) -> int:
    """A call's contract in bytes: every ``[B, S]`` input (the sort's
    three, the eight tables it reads) and output once, and the four
    lanes a segment reads (class and cause at its first lane, hi and lo
    at its cause), not the whole ``[B, N]`` lanes."""
    B, S = args[4].shape
    return kernels.contract_bytes(*args[4:], *out) + 4 * 4 * B * S


def seg_order_plain(hi, lo, cci, vclass, s_mh, s_ml, s_src, sg_max_hi,
                    sg_max_lo, sg_len, sg_lane0, sg_dense, sg_tail_special,
                    sg_valid, sg_vsum) -> SegOrder:
    """The plain PyTorch version: phase A's chain after the sort, as the
    JAX package's XLA glue computes it (permutation gathers, the twin
    test, ``[B, 2S]`` dump tables, a pair cummax, a binary search of
    ceil(log2(S + 1)) rounds, the stab scatter)."""
    B, N = hi.shape
    S = sg_len.shape[1]
    dev = hi.device
    sidx = _iota(B, S, dev)
    take = take1d

    s_Mh = take(sg_max_hi, s_src)
    s_Ml = take(sg_max_lo, s_src)
    s_va = take(sg_valid, s_src)
    s_len = torch.where(s_va, take(sg_len, s_src), 0)
    s_lane0 = take(sg_lane0, s_src)
    s_dense = take(sg_dense, s_src)
    s_tsp = take(sg_tail_special, s_src)
    s_vsum = take(sg_vsum, s_src)

    # head body fields (shared by the twin test and the E2 stabs)
    lane0c = s_lane0.clamp(0, N - 1)
    s_hvc = take(vclass, lane0c)
    c_lane = take(cci, lane0c)
    has_c = s_va & (c_lane >= 0)
    c_hi = torch.where(has_c, take(hi, c_lane.clamp(0, N - 1)), -1)
    c_lo = torch.where(has_c, take(lo, c_lane.clamp(0, N - 1)), -1)

    # twin groups: adjacent exact-equal dense segments dedupe wholesale
    same_prev = (
        _eq(s_mh, s_ml, _shift1(s_mh, -1), _shift1(s_ml, -1))
        & _eq(s_Mh, s_Ml, _shift1(s_Mh, -1), _shift1(s_Ml, -1))
        & (s_len == _shift1(s_len, -1))
        & s_dense & _shift1(s_dense, False)
        & (s_hvc == _shift1(s_hvc, -1))
        & (s_tsp == _shift1(s_tsp, False))
        & (s_vsum == _shift1(s_vsum, -1))
        & _eq(c_hi, c_lo, _shift1(c_hi, -1), _shift1(c_lo, -1))
        & s_va & _shift1(s_va, False)
        & (sidx > 0)
    )
    grp_start = ~same_prev
    grp = _cumsum(grp_start) - 1

    # per-group interval tables; group starts scatter to their ordinal,
    # everything else to its own dump slot past S (unique indices)
    is_start = grp_start & s_va
    gsl = torch.where(is_start, grp, S + sidx)

    def _gtable(vals, fill):
        base = torch.full((B, 2 * S), fill, dtype=I32, device=dev)
        return at_set(base, gsl, torch.where(is_start, vals, fill))[:, :S]

    g_mh = _gtable(s_mh, BIG)
    g_ml = _gtable(s_ml, BIG)
    g_Mh = _gtable(s_Mh, -1)
    g_Ml = _gtable(s_Ml, -1)

    # E1: overlap with any earlier group or the next group
    pmh, pml = _pair_cummax(g_Mh, g_Ml)
    pmh_e, pml_e = _shift1(pmh, -1), _shift1(pml, -1)
    gi = grp.clamp(0, S - 1)
    ov_before = _le(s_mh, s_ml, take(pmh_e, gi), take(pml_e, gi))
    big1 = torch.full((B, 1), BIG, dtype=I32, device=dev)
    nxt_mh = torch.cat([g_mh[:, 1:], big1], dim=1)
    nxt_ml = torch.cat([g_ml[:, 1:], big1], dim=1)
    ov_after = _le(take(nxt_mh, gi), take(nxt_ml, gi), s_Mh, s_Ml)
    explode = s_va & (ov_before | ov_after)

    # E2: head-cause stabs. Candidate = rightmost group with min <= c.
    pg = _pair_search_le(g_mh, g_ml, c_hi, c_lo, S)
    pgc = pg.clamp(0, S - 1)
    rep = at_set(torch.zeros((B, 2 * S), dtype=I32, device=dev), gsl,
                 torch.where(is_start, sidx, 0))[:, :S]
    rep_pg = take(rep, pgc)
    r_len = take(s_len, rep_pg)
    r_tsp = take(s_tsp, rep_pg)
    gm_h, gm_l = take(g_mh, pgc), take(g_ml, pgc)
    gM_h, gM_l = take(g_Mh, pgc), take(g_Ml, pgc)
    stab = has_c & (pg >= 0) & _le(gm_h, gm_l, c_hi, c_lo) & (
        _lt(c_hi, c_lo, gM_h, gM_l)
        | (_eq(c_hi, c_lo, gM_h, gM_l) & r_tsp & (r_len > 1))
    )
    g_stabbed = at_set(torch.zeros((B, S), dtype=torch.bool, device=dev),
                       torch.where(stab, pgc, S - 1), True)
    # make the last slot honest (it may have been used as a dump)
    g_stabbed[:, S - 1] = (stab & (pgc == S - 1)).any(dim=1)
    explode = explode | (s_va & take(g_stabbed, gi))

    twin_drop = same_prev & ~explode
    survive = s_va & ~explode & ~twin_drop
    return SegOrder(s_va, s_len, s_lane0, s_tsp, grp, grp_start, explode,
                    survive)


_ARGS = ("hi", "lo", "cci", "vclass", "s_mh", "s_ml", "s_src",
             "sg_max_hi", "sg_max_lo", "sg_len", "sg_lane0", "sg_dense",
             "sg_tail_special", "sg_valid", "sg_vsum")
_BOOL_ARGS = ("sg_dense", "sg_tail_special", "sg_valid")


def _check(*tensors):
    B, N = tensors[0].shape if tensors[0].dim() == 2 else (-1, -1)
    S = tensors[4].shape[1] if tensors[4].dim() == 2 else -1
    for name, x in zip(_ARGS, tensors):
        want = torch.bool if name in _BOOL_ARGS else torch.int32
        if x.dtype != want:
            raise TypeError(f"seg_order: {name} must be {want}, got {x.dtype}")
        if x.dim() != 2 or x.device != tensors[0].device:
            raise ValueError("seg_order takes [B, width] tensors on one "
                             "device")
        if not x.is_contiguous():
            raise ValueError(f"seg_order inputs must be contiguous ({name})")
        if x.shape != ((B, N) if name in _ARGS[:4] else (B, S)):
            raise ValueError(
                "seg_order shapes: hi/lo/cci/vclass [B, N], the sorted "
                "segments and the segment tables [B, S]; got "
                f"{[tuple(t.shape) for t in tensors]}")
    if N < 1 or S < 1:
        raise ValueError("seg_order needs N >= 1 and S >= 1")


def seg_order_cuda(hi, lo, cci, vclass, s_mh, s_ml, s_src, sg_max_hi,
                   sg_max_lo, sg_len, sg_lane0, sg_dense, sg_tail_special,
                   sg_valid, sg_vsum) -> SegOrder:
    """Launch the A1 kernel on CUDA tensors (see ``csrc/seg_order.cu``)."""
    ins = (hi, lo, cci, vclass, s_mh, s_ml, s_src, sg_max_hi, sg_max_lo,
           sg_len, sg_lane0, sg_dense, sg_tail_special, sg_valid, sg_vsum)
    _check(*ins)
    if hi.device.type != "cuda":
        raise ValueError(f"seg_order_cuda needs CUDA tensors, got {hi.device}")
    B, N = hi.shape
    S = s_mh.shape[1]
    dev = hi.device
    out = SegOrder(*(torch.empty((B, S), dtype=dt, device=dev) for dt in (
        torch.bool, I32, I32, torch.bool, I32, torch.bool, torch.bool,
        torch.bool)))
    lib = kernels.library("seg_order")
    scratch = torch.empty(lib.cause_seg_order_scratch_bytes(B, S),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cause_seg_order(
            *(x.data_ptr() for x in ins), *(x.data_ptr() for x in out),
            scratch.data_ptr(), B, N, S, kernels.stream_handle(dev))
    kernels.check(rc, "seg_order")
    kernels.launches["seg_order"] += 1
    return out


def seg_order(hi, lo, cci, vclass, s_mh, s_ml, s_src, sg_max_hi, sg_max_lo,
              sg_len, sg_lane0, sg_dense, sg_tail_special, sg_valid,
              sg_vsum) -> SegOrder:
    """Phase A over ``[B, S]`` sorted segments (B1's sort of (min hi, min
    lo, segment), invalid segments keyed ``(I32_MAX, I32_MAX)``), the
    segment tables and the ``[B, N]`` lanes: the plain version on the
    CPU, the A1 kernel on the card, under the span ``kernel.a1``, whose
    ``bytes`` is the call's contract (``a1_contract``)."""
    args = (hi, lo, cci, vclass, s_mh, s_ml, s_src, sg_max_hi, sg_max_lo,
            sg_len, sg_lane0, sg_dense, sg_tail_special, sg_valid, sg_vsum)
    dev = hi.device
    B, S = s_mh.shape
    with span("kernel.a1", on=s_mh, rows=B, segments=S,
              lanes=hi.shape[1]) as sp:
        if dev.type == "cpu":
            out = seg_order_plain(*args)
        elif dev.type == "cuda":
            out = seg_order_cuda(*args)
        else:
            raise ValueError(f"no seg_order for device {dev}")
        if sp.live:
            sp.set(form="plain" if dev.type == "cpu" else "row",
                   bytes=a1_contract(args, out))
        return out
