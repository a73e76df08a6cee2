"""The v5 segment-union merge kernel: merge cost scales with divergence.

Port of ``cause_tpu.weaver.jaxw5`` (phases A-F). Replicas of a shared
document are identical over almost all of it, so the union runs at
*segment* granularity (per-tree chain runs, marshal-extracted by
``segments.tree_segments``) and a segment explodes to node tokens only
where replicas interact:

E1. its id interval overlaps another segment's, unless the two are
    exact dense twins (the shared prefix every replica carries — those
    dedupe wholesale);
E2. some other segment head's *cause* stabs its interior (or its tail,
    when the tail is special with members before it).

Survivors ride the union as ONE sort token carrying their length;
exploded segments contribute one token per lane. The token pipeline —
sort, dedupe, cause resolution, adjacency/glue, chain runs, sibling
sort, Euler ranking — runs at token width, and the final per-lane
ranks and visibility expand back over the full lane width.

The batch is an explicit leading ``[B, ...]`` dimension. On the card
every sort goes through the B1 kernel, phase A after its sort (twin
groups, E1, E2) through the A1 kernel, the forest ranking through the
B2 walk and the lane expansion through the B3 kernel; on the CPU the
same calls take their plain versions. Semantics are EXACT against the
JAX package (tests/test_torch_v5.py); like it, the kernel takes the
static budgets ``u_max`` tokens and ``k_max`` runs and raises an
overflow flag instead of corrupting. Twin-dedupe integrity and the
host-value blind spot are as the JAX module describes.

A call runs under the obs span ``v5``, each phase under its own
(``v5.A`` ... ``v5.F``, as the ``# ===== X.`` comments mark them) and
each host read of a device value under ``v5.sync`` (``host_wait``):
live while obs is on or a profiler records, each with its interval on
the device's timeline on the card; otherwise one check each.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..benchgen import LANE_KEYS5, V5_BOOL_KEYS
from ..device import resolve_device
from ..obs.core import span
from .arrays import I32_MAX, VCLASS_H_HIDE, VCLASS_HIDE
from .bitonic import sort_pairs
from .euler import euler_walk, link_children
from .fphase import fphase_expand
from .gatherops import (at_add, at_set, searchsorted_iota_right,
                        searchsorted_targets_left, take1d)
from .segorder import _cummax, _cumsum, _eq, _iota, _shift1, seg_order
from .torchw import _row

__all__ = ["merge_weave_kernel_v5", "batched_merge_weave_v5", "STAGES",
           "host_wait"]

BIG = int(I32_MAX)
I32 = torch.int32

# the prefix stages (``stage=``), cumulative: the parity hook whose
# checksums the tests hold to the JAX package's; None runs the whole
# kernel
STAGES = ("A", "B", "C", "D", "E", None)


def host_wait(site: str, step: int):
    """The ``v5.sync`` span around a host read of a device value on the
    wave's path (it waits for the work queued before it): ``site``
    names the read, ``step`` its iteration."""
    return span("v5.sync", site=site, step=step)


def _stage_ck(*xs):
    """Per-row checksum of a stage's live outputs (``jaxw5._stage_ck``
    over each row): the float32 sum of every given tensor's row."""
    total = torch.zeros(xs[0].shape[0], dtype=torch.float32,
                        device=xs[0].device)
    for x in xs:
        x = x.to(torch.float32)
        total = total + (x.sum(dim=1) if x.dim() > 1 else x)
    return total


def _v5_ab(hi, lo, cci, vclass, seg, sg_min_hi, sg_min_lo, sg_max_hi,
           sg_max_lo, sg_len, sg_lane0, sg_dense, sg_tail_special, sg_valid,
           sg_vsum, u_max: int, stage=None):
    """Phases A and B: what both the v5 kernel and the fused v5f pipeline
    (``torchw5f``) take from them — the presort tokens ``t_*``, the
    ``token_of_lane`` resolver, ``overflow_u``, and the coverage inputs
    ``survive`` / ``inv_s`` of phase F (``jaxw5``'s ``stage="_AB"``
    handoff). ``stage="A"``/``"B"`` (the parity hook) return that
    prefix's per-row checksum instead. Each phase runs under its span,
    ``v5.A`` and ``v5.B``."""
    B, N = hi.shape
    S = sg_len.shape[1]
    dev = hi.device
    sidx = _iota(B, S, dev)
    take = take1d

    # ================= A. segment ordering + explode/dedupe =========
    with span("v5.A", on=hi):
        kh = torch.where(sg_valid, sg_min_hi, BIG)
        kl = torch.where(sg_valid, sg_min_lo, BIG)
        s_mh, s_ml, s_src = sort_pairs((kh, kl, sidx), num_keys=2)
        (s_va, s_len, s_lane0, s_tsp, grp, grp_start, explode,
         survive) = seg_order(hi, lo, cci, vclass, s_mh, s_ml, s_src,
                              sg_max_hi, sg_max_lo, sg_len, sg_lane0,
                              sg_dense, sg_tail_special, sg_valid, sg_vsum)
        if stage == "A":
            return _stage_ck(explode, survive, grp)

    # ================= B. token construction ========================
    with span("v5.B", on=hi):
        tok_cnt = torch.where(survive, 1,
                              torch.where(s_va & explode, s_len, 0)).to(I32)
        tc_cum = _cumsum(tok_cnt)
        tb = tc_cum - tok_cnt  # exclusive: first token slot per sorted seg
        n_tok = tc_cum[:, -1:]
        U = u_max
        uidx = _iota(B, U, dev)
        u_ok = uidx < torch.clamp(n_tok, max=U)
        overflow_u = n_tok[:, 0] > U

        owner = searchsorted_iota_right(tc_cum, U)
        oc = owner.clamp(0, S - 1)
        off = uidx - take(tb, oc)
        o_expl = take(s_va, oc) & ~take(survive, oc)
        t_lane = (take(s_lane0, oc)
                  + torch.where(o_expl, off, 0)).clamp(0, N - 1)
        t_hi = torch.where(u_ok, take(hi, t_lane), BIG)
        t_lo = torch.where(u_ok, take(lo, t_lane), BIG)
        t_len = torch.where(u_ok, torch.where(o_expl, 1, take(s_len, oc)), 0)
        t_vc = torch.where(u_ok, take(vclass, t_lane), 0)
        t_tsp = torch.where(o_expl, t_vc > 0, take(s_tsp, oc)) & u_ok
        if stage == "B":
            return _stage_ck(t_hi, t_lo, t_len, t_tsp)

        # token_of_lane machinery (PRESORT token ids). A cause lane inside a
        # twin-DROPPED segment copy resolves to the KEPT twin's token.
        inv_s = at_set(torch.zeros((B, S), dtype=I32, device=dev), s_src, sidx)
        seg_expl_sorted = s_va & explode
        gsp = _cummax(torch.where(grp_start, sidx, -1))

        def token_of_lane(p):
            pc = p.clamp(0, N - 1)
            m = take(seg, pc).clamp(0, S - 1)
            ss2 = take(inv_s, m)
            ex = take(seg_expl_sorted, ss2)
            owner_ss = torch.where(ex, ss2, take(gsp, ss2))
            return (take(tb, owner_ss)
                    + torch.where(ex, pc - take(sg_lane0, m), 0)).to(I32)

        return SimpleNamespace(
            t_hi=t_hi, t_lo=t_lo, t_len=t_len, t_vc=t_vc, t_tsp=t_tsp,
            t_lane=t_lane, token_of_lane=token_of_lane, overflow_u=overflow_u,
            survive=survive, inv_s=inv_s, uidx=uidx)


def _v5(*lanes, u_max: int, k_max: int, stage=None):
    """The v5 kernel on prepared lanes (``_prepare``), under the ``v5``
    span: phases A-F, each under its own (``v5.A`` ... ``v5.F``)."""
    B, N = lanes[0].shape
    with span("v5", on=lanes[0], rows=B, lanes=N, u_max=u_max,
              k_max=k_max):
        return _v5_phases(*lanes, u_max=u_max, k_max=k_max, stage=stage)


def _v5_phases(hi, lo, cci, vclass, valid, seg, sg_min_hi, sg_min_lo,
               sg_max_hi, sg_max_lo, sg_len, sg_lane0, sg_dense,
               sg_tail_special, sg_valid, sg_vsum, u_max: int, k_max: int,
               stage=None):
    B, N = hi.shape
    dev = hi.device
    take = take1d
    ab = _v5_ab(hi, lo, cci, vclass, seg, sg_min_hi, sg_min_lo, sg_max_hi,
                sg_max_lo, sg_len, sg_lane0, sg_dense, sg_tail_special,
                sg_valid, sg_vsum, u_max, stage=stage)
    if stage in ("A", "B"):
        return ab
    (t_hi, t_lo, t_len, t_vc, t_tsp, t_lane) = (
        ab.t_hi, ab.t_lo, ab.t_len, ab.t_vc, ab.t_tsp, ab.t_lane)
    token_of_lane, uidx, U = ab.token_of_lane, ab.uidx, u_max

    # ================= C. sort tokens, dedupe =======================
    with span("v5.C", on=hi):
        # the payloads ride the sort (one kernel, no permutation gathers)
        (st_hi, st_lo, t_src, sv_len, sv_vc, sv_tsp_i, sv_lane) = sort_pairs(
            (t_hi, t_lo, uidx, t_len.to(I32), t_vc.to(I32), t_tsp.to(I32),
             t_lane.to(I32)), num_keys=2)
        sv_tsp = sv_tsp_i.bool()
        sv_tail_lane = sv_lane + sv_len - 1
        inv_t = at_set(torch.zeros((B, U), dtype=I32, device=dev), t_src, uidx)

        tva = ~((st_hi == BIG) & (st_lo == BIG))
        sdup = (_eq(st_hi, st_lo, _shift1(st_hi, -1), _shift1(st_lo, -1))
                & (uidx > 0) & tva)
        keep_t = tva & ~sdup
        if stage == "C":
            return _stage_ck(st_hi, keep_t, sv_lane, inv_t)

    # ================= D. token cause resolution ====================
    with span("v5.D", on=hi):
        cl = torch.where(tva, take(cci, sv_lane.clamp(0, N - 1)), -1)
        cause_u = token_of_lane(cl)
        cause_su_raw = take(inv_t, cause_u.clamp(0, U - 1))
        # redirect to the kept head of a duplicate token group
        thead = _cummax(torch.where(keep_t, uidx, -1))
        cause_su = torch.where(
            cl >= 0, take(thead, cause_su_raw.clamp(0, U - 1)), 0).to(I32)

        special_t = keep_t & (sv_vc > 0)
        is_root_t = keep_t & (uidx == 0)
        rel_t = keep_t & ~is_root_t

        # host walk (lane-level, at token width): first non-special lane on
        # the cause chain. Rows step together until no row has a lane left
        # to move, exactly as the JAX batched while_loop does.
        host_lane = cl
        walk_on = rel_t & ~special_t
        for step in range(N):
            pc = host_lane.clamp(0, N - 1)
            on = walk_on & (host_lane >= 0) & (take(vclass, pc) > 0)
            with host_wait("v5.walk", step):
                moving = bool(on.any())
            if not moving:
                break
            host_lane = torch.where(on, take(cci, pc), host_lane)
        host_su = torch.where(
            host_lane >= 0,
            take(thead, take(inv_t, token_of_lane(host_lane).clamp(0, U - 1))
                 .clamp(0, U - 1)),
            0).to(I32)
        parent_su = torch.where(special_t, cause_su, host_su)

        conflict = (sdup & (
            (sv_vc != _shift1(sv_vc, 0))
            | (cause_su != _shift1(cause_su, 0))
            | (sv_len != _shift1(sv_len, 0))
        )).any(dim=1)
        if stage == "D":
            return _stage_ck(parent_su, cause_su, conflict)

    # ================= E. chain runs + ranking at token width =======
    with span("v5.E", on=hi):
        kept_len = torch.where(keep_t, sv_len, 0)
        wcum = _cumsum(kept_len)
        wstart = wcum - kept_len
        n_kept_nodes = wcum[:, -1:]

        sp_pack = _cummax(torch.where(keep_t, uidx * 2 + sv_tsp.to(I32), -1))
        sp_prev = _shift1(sp_pack, -1)
        prev_kept = torch.where(sp_prev >= 0, sp_prev >> 1, -1)
        prev_kept_tsp = (sp_prev >= 0) & ((sp_prev & 1) == 1)

        adj = rel_t & (cause_su == prev_kept) & (prev_kept >= 0)
        host_case = adj & ~special_t & prev_kept_tsp
        irregular = rel_t & (~adj | host_case)

        extra = at_add(torch.zeros((B, U), dtype=I32, device=dev),
                       torch.where(irregular, parent_su, U - 1), 1)
        extra[:, U - 1] = (irregular & (parent_su == U - 1)).sum(
            dim=1, dtype=I32)
        ec_pack = _cummax(
            torch.where(keep_t, uidx * 2 + (extra > 0).to(I32), -1))
        ec_prev = _shift1(ec_pack, -1)
        prev_contested = (ec_prev >= 0) & ((ec_prev & 1) == 1)
        glued = adj & ~host_case & ~prev_contested

        run_start = keep_t & ~glued
        rs_cum = _cumsum(run_start)
        run_id = rs_cum - 1
        n_runs = rs_cum[:, -1:]
        overflow_k = n_runs[:, 0] > k_max

        targets = _iota(B, k_max, dev) + 1
        head_tok = searchsorted_targets_left(rs_cum, k_max)
        r_valid = targets <= torch.clamp(n_runs, max=k_max)
        hc = head_tok.clamp(0, U - 1)

        h_parent = torch.where(
            take(irregular, hc), take(parent_su, hc),
            torch.where(take(adj, hc), take(prev_kept, hc), -1))
        h_parent = torch.where(r_valid & ~take(is_root_t, hc), h_parent, -1)
        parent_run = torch.where(h_parent >= 0,
                                 take(run_id, h_parent.clamp(0, U - 1)),
                                 -1).to(I32)

        h_special = take(special_t, hc)
        h_w = take(wstart, hc)
        nxt_w = torch.roll(h_w, -1, dims=1)
        run_w = torch.where(
            r_valid,
            torch.where(targets == n_runs, n_kept_nodes - h_w, nxt_w - h_w),
            0).to(I32)

        has_parent = r_valid & (parent_run >= 0)
        parent_sort = torch.where(has_parent, parent_run, k_max).to(I32)
        packed = (parent_sort * 2 + (~h_special).to(I32)).to(I32)
        kidx_r = _iota(B, k_max, dev)
        sord = sort_pairs((packed, (-hc).to(I32), kidx_r), num_keys=2)[2]
        fc, ns = link_children(sord, parent_sort)
        parent_up = torch.where(has_parent, parent_run, -1).to(I32)
        base_run = euler_walk(fc, ns, parent_up, run_w)

        # expand run bases to token bases (node units): delta-scatter at
        # run-head tokens (valid targets are a prefix with strictly
        # increasing head tokens; the rest dump past U) + one cumsum over U
        delta = torch.where(r_valid, base_run - _shift1(base_run, 0),
                            0).to(I32)
        scat_du = torch.where(r_valid, hc, U + kidx_r)
        delta_u = at_set(torch.zeros((B, U + k_max), dtype=I32, device=dev),
                         scat_du, delta)[:, :U]
        base_ff = _cumsum(delta_u)
        ffw = _cummax(torch.where(run_start, wstart, -1))
        rank_tok = torch.where(keep_t, base_ff + (wstart - ffw), N).to(I32)

        # -------- token-level kills (victims as lanes) ------------------
        hideish = (sv_vc == VCLASS_HIDE) | (sv_vc == VCLASS_H_HIDE)
        kg = glued & hideish
        vict_inrun = torch.where(
            kg, take(sv_tail_lane, prev_kept.clamp(0, U - 1)), N)

        # preorder-successor run: the run with the next-larger base
        bkey = torch.where(r_valid, base_run, BIG).to(I32)
        b_sorted, b_src = sort_pairs((bkey, kidx_r), num_keys=1)
        neg1 = torch.full((B, 1), -1, dtype=I32, device=dev)
        succ_in_sorted = torch.cat([b_src[:, 1:], neg1], dim=1)
        succ_valid = torch.cat(
            [b_sorted[:, 1:] != BIG,
             torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1)
        succ_of = at_set(torch.full((B, k_max), -1, dtype=I32, device=dev),
                         b_src, torch.where(succ_valid, succ_in_sorted, -1))
        succ_run = torch.where(r_valid, succ_of, -1)
        s_c = torch.where(succ_run >= 0,
                          take(hc, succ_run.clamp(0, k_max - 1)),
                          0).clamp(0, U - 1)
        s_is_hide = (succ_run >= 0) & take(hideish, s_c)
        nxt_head = torch.roll(hc, -1, dims=1)
        tail_tok = torch.where(
            targets == n_runs,
            (sp_pack[:, -1:] >> 1).clamp(min=0),
            take(prev_kept, nxt_head.clamp(0, U - 1))).to(I32)
        t_cc = tail_tok.clamp(0, U - 1)
        # the successor head's cause must BE the run's tail node
        kill_tail = r_valid & s_is_hide & (take(cause_su, s_c) == tail_tok)
        vict_tail = torch.where(kill_tail, take(sv_tail_lane, t_cc), N)
        if stage == "E":
            # conflict included so prefix increments stay strictly
            # cumulative over stage D's reduction
            return _stage_ck(rank_tok, vict_inrun, vict_tail, kill_tail,
                             conflict)

    # ================= F. expansion to concat lanes =================
    with span("v5.F", on=hi):
        lane_key = torch.where(keep_t & (rank_tok < N), sv_lane, N).to(I32)
        lk, _tok_at, tb_l = sort_pairs((lane_key, uidx, rank_tok), num_keys=1)

        seg_cov = sg_valid & take(ab.survive, ab.inv_s)
        killed_sc = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
        killed_sc = at_set(killed_sc, torch.where(kg, vict_inrun, N), True)
        killed_sc = at_set(killed_sc, torch.where(kill_tail, vict_tail, N),
                           True)
        root_lane = at_set(torch.zeros((B, N), dtype=torch.bool, device=dev),
                           sv_lane[:, :1].clamp(0, N - 1), keep_t[:, :1])

        cov_start = torch.where(seg_cov, sg_lane0, N).to(I32)
        cov_end = torch.where(seg_cov, sg_lane0 + sg_len, 0).to(I32)
        cs, ce = sort_pairs((cov_start, cov_end), num_keys=1)
        killed_ext = killed_sc[:, :N] | root_lane
        flags = (valid.to(I32) | (killed_ext.to(I32) << 1)).contiguous()
        rank_lane, visible = fphase_expand(lk, tb_l, cs, ce, vclass, seg,
                                           flags)
        return rank_lane, visible, conflict, ab.overflow_u | overflow_k


def _prepare(args, device):
    """Move the 16 v5 inputs to ``device`` with the kernel's dtypes
    (int32 lanes and tables, bool flags), contiguous."""
    dev = resolve_device(device)
    out = []
    for key, x in zip(LANE_KEYS5, args):
        dt = torch.bool if key in V5_BOOL_KEYS else I32
        out.append(torch.as_tensor(x).to(device=dev, dtype=dt).contiguous())
    return out


def batched_merge_weave_v5(hi, lo, cci, vclass, valid, seg,
                           sg_min_hi, sg_min_lo, sg_max_hi, sg_max_lo,
                           sg_len, sg_lane0, sg_dense, sg_tail_special,
                           sg_valid, sg_vsum, u_max: int, k_max: int,
                           device="cuda", stage=None):
    """Segment-union batch: ``[B, N]`` node lanes + ``[B, S]`` segment
    tables (``benchgen.LANE_KEYS5`` order) -> per-replica ``(rank,
    visible, conflict, overflow)``, rank/visible indexed by concat lane
    (rank N for dropped, duplicate and padding lanes). Runs on
    ``device``; on the card the sorts, the forest walk and the lane
    expansion are the B1, B2 and B3 kernels.

    ``stage`` (the parity hook: tests hold each prefix to the JAX
    package's; not a profiler, whose work the phase spans ``v5.A`` ...
    ``v5.F`` do) stops after a prefix of the pipeline and returns one
    float32 checksum per row of that phase's live outputs, as
    ``jaxw5``'s ``stage=`` does: ``"A"``
    segment ordering + explode/dedupe, ``"B"`` token construction,
    ``"C"`` token sort + dedupe, ``"D"`` cause resolution, ``"E"``
    token-width ranking + kills. ``None`` (every other caller) runs
    the full kernel."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    args = _prepare((hi, lo, cci, vclass, valid, seg, sg_min_hi, sg_min_lo,
                     sg_max_hi, sg_max_lo, sg_len, sg_lane0, sg_dense,
                     sg_tail_special, sg_valid, sg_vsum), device)
    return _v5(*args, u_max=int(u_max), k_max=int(k_max), stage=stage)


def merge_weave_kernel_v5(hi, lo, cci, vclass, valid, seg,
                          sg_min_hi, sg_min_lo, sg_max_hi, sg_max_lo,
                          sg_len, sg_lane0, sg_dense, sg_tail_special,
                          sg_valid, sg_vsum, u_max: int, k_max: int,
                          device="cuda"):
    """``batched_merge_weave_v5`` for one replica set's ``[N]`` lanes and
    ``[S]`` segment tables."""
    out = batched_merge_weave_v5(
        *_row((hi, lo, cci, vclass, valid, seg, sg_min_hi, sg_min_lo,
               sg_max_hi, sg_max_lo, sg_len, sg_lane0, sg_dense,
               sg_tail_special, sg_valid, sg_vsum)),
        u_max=u_max, k_max=k_max, device=device)
    return tuple(x[0] for x in out)
