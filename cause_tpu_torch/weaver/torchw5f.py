"""v5f: the v5 merge with its token pipeline fused into three kernels.

Port of ``cause_tpu.weaver.jaxw5f``. Per batch of replica rows:

1. phases A and B of the v5 kernel (``torchw5._v5_ab``): segment
   ordering, explode/dedupe, token construction — the phase-A segment
   sort is B1;
2. the phase-D prep, hoisted before the token sort: each presort token's
   cause token and its host walk (the cause chain through specials is
   sort-independent), as presort token links;
3. padding of the tokens to ``P = next_pow2(max(u_max, 128))``;
4. K1 ``k1_sort_redirect`` (token sort, dedupe, redirection), K2
   ``k2_runs`` (runs and the contracted forest at ``Kp =
   next_pow2(max(k_max, 128))``), the B2 walk ``euler_walk`` over Kp,
   and K4 ``k4_rank_kills`` (run bases to tokens, kills, the lane sort);
5. the F glue: the kill scatters, the root lane, the coverage table
   sorted by B1, and the B3 expansion ``fphase_expand``.

On the card that is six kernels' worth of launches (sort 2, and one
each of the walk, the expansion, K1, K2 and K4) around the A/B glue; on
the CPU every call takes its plain version. Outputs are those of
``batched_merge_weave_v5`` bit for bit (rank, visible, conflict,
overflow; tests/test_torch_befuse.py), for any N: unlike the JAX module,
which falls back to v5 where its Pallas F kernel cannot take the width
(N % 128 != 0 or N >= 2**24), the port's B3 takes every N.
"""

from __future__ import annotations

import torch

from .arrays import I32_MAX
from .befuse import k1_sort_redirect, k2_runs, k4_rank_kills, next_pow2
from .bitonic import sort_pairs
from .euler import euler_walk
from .fphase import fphase_expand
from .gatherops import at_set, take1d
from .torchw5 import _prepare, _v5_ab

__all__ = ["batched_merge_weave_v5f"]

BIG = int(I32_MAX)
I32 = torch.int32


def _v5f(hi, lo, cci, vclass, valid, seg, sg_min_hi, sg_min_lo, sg_max_hi,
         sg_max_lo, sg_len, sg_lane0, sg_dense, sg_tail_special, sg_valid,
         sg_vsum, u_max: int, k_max: int):
    B, N = hi.shape
    dev = hi.device
    U = u_max
    P = next_pow2(max(U, 128))
    Kp = next_pow2(max(k_max, 128))
    if Kp > P:
        raise ValueError(
            f"v5f needs k_max <= u_max after rounding (Kp {Kp} > P {P}): "
            f"K2 takes the head tables from a sort of width P")
    ab = _v5_ab(hi, lo, cci, vclass, seg, sg_min_hi, sg_min_lo, sg_max_hi,
                sg_max_lo, sg_len, sg_lane0, sg_dense, sg_tail_special,
                sg_valid, sg_vsum, u_max)

    # ---- phase-D prep, presort ------------------------------------
    tva0 = ~((ab.t_hi == BIG) & (ab.t_lo == BIG))
    cl0 = torch.where(tva0, take1d(cci, ab.t_lane.clamp(0, N - 1)), -1)
    cu0m = torch.where(cl0 >= 0, ab.token_of_lane(cl0), -1)
    # host walk: the first non-special lane on the cause chain. Rows step
    # together until no row has a lane left to move, as the JAX batched
    # while_loop does.
    chase = tva0 & (ab.t_vc == 0)
    host_lane = cl0
    for _ in range(N):
        pc = host_lane.clamp(0, N - 1)
        on = chase & (host_lane >= 0) & (take1d(vclass, pc) > 0)
        if not bool(on.any()):
            break
        host_lane = torch.where(on, take1d(cci, pc), host_lane)
    hu0m = torch.where(host_lane >= 0, ab.token_of_lane(host_lane), -1)

    def pad_p(x, fill):
        x = x.to(I32)
        if P == U:
            return x.contiguous()
        return torch.cat(
            [x, torch.full((B, P - U), fill, dtype=I32, device=dev)], dim=1)

    # ---- the fused token pipeline ---------------------------------
    (sv_len, sv_vc, sv_tsp, sv_lane, keep_i, cause_su, parent_su,
     scal1) = k1_sort_redirect(
        pad_p(ab.t_hi, BIG), pad_p(ab.t_lo, BIG), pad_p(ab.t_vc, 0),
        pad_p(ab.t_len, 0), pad_p(ab.t_tsp, 0), pad_p(ab.t_lane, 0),
        pad_p(cu0m, -1), pad_p(hu0m, -1), U=U)
    conflict = scal1[:, 0] != 0

    (fc, ns, parent_up, run_w, hc, h_w, run_id, glued_i, prev_kept,
     scal2) = k2_runs(sv_len, sv_vc, sv_tsp, keep_i, cause_su, parent_su,
                      U=U, k_max=k_max, Kp=Kp)

    base_run = euler_walk(fc, ns, parent_up, run_w)

    lk, tb_l, vict_in, vict_tail, scal4 = k4_rank_kills(
        base_run, hc, h_w, run_id, keep_i, sv_len, sv_vc, sv_lane, glued_i,
        prev_kept, cause_su, scal2, U=U, k_max=k_max, N=N)
    root_val = scal4[:, :1]
    overflow_k = scal4[:, 1] != 0

    # ---- F glue ----------------------------------------------------
    killed_sc = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    killed_sc = at_set(killed_sc, vict_in, True)
    killed_sc = at_set(killed_sc, vict_tail, True)
    root_lane = at_set(torch.zeros((B, N), dtype=torch.bool, device=dev),
                       root_val.clamp(0, N - 1), root_val < N)
    killed_ext = killed_sc[:, :N] | root_lane

    seg_cov = sg_valid & take1d(ab.survive, ab.inv_s)
    cov_start = torch.where(seg_cov, sg_lane0, N).to(I32)
    cov_end = torch.where(seg_cov, sg_lane0 + sg_len, 0).to(I32)
    cs, ce = sort_pairs((cov_start, cov_end), num_keys=1)
    flags = (valid.to(I32) | (killed_ext.to(I32) << 1)).contiguous()
    rank_lane, visible = fphase_expand(lk, tb_l, cs, ce, vclass, seg, flags)
    return rank_lane, visible, conflict, ab.overflow_u | overflow_k


def batched_merge_weave_v5f(hi, lo, cci, vclass, valid, seg,
                            sg_min_hi, sg_min_lo, sg_max_hi, sg_max_lo,
                            sg_len, sg_lane0, sg_dense, sg_tail_special,
                            sg_valid, sg_vsum, u_max: int, k_max: int,
                            device="cuda"):
    """The fused-pipeline v5 over a batch: ``[B, N]`` node lanes + ``[B,
    S]`` segment tables (``benchgen.LANE_KEYS5`` order) -> per-replica
    ``(rank, visible, conflict, overflow)``, identical to
    ``batched_merge_weave_v5``. Runs on ``device``; on the card the token
    pipeline is the K1, K2 and K4 kernels with the B1 sorts, the B2 walk
    and the B3 expansion. Raises ``ValueError`` when the rounded run
    budget exceeds the rounded token budget (``Kp > P``)."""
    args = _prepare((hi, lo, cci, vclass, valid, seg, sg_min_hi, sg_min_lo,
                     sg_max_hi, sg_max_lo, sg_len, sg_lane0, sg_dense,
                     sg_tail_special, sg_valid, sg_vsum), device)
    return _v5f(*args, u_max=int(u_max), k_max=int(k_max))
