"""B4-B6: the fused v5 token pipeline (phases C-E) as three kernels.

Counterpart of ``cause_tpu.weaver.pallas_befuse``: the kernels that
``torchw5f`` composes with the B1 sort, the B2 walk and the B3
expansion. Each runs one replica row per CTA with the row's working
arrays in shared memory:

- **K1 ``k1_sort_redirect``** (phases C and D without the host walk,
  which ``torchw5f`` resolves before the sort): the token sort on
  ``(hi, lo)``, the inverse permutation, duplicate detection, the
  redirection of cause and host links to the kept head of a duplicate
  group, and the conflict count.
- **K2 ``k2_runs``** (phase E, front): weighted positions, the
  adjacency / host-case / contested classification, run numbering, the
  per-run head tables and the contracted forest (``fc``, ``ns``).
- **K4 ``k4_rank_kills``** (phase E, back): run bases expanded to
  tokens, the in-run and tail kills, the preorder successor, and the
  lane sort that hands ``(lk, tb_l)`` to B3.

Calling convention: batched ``[B, P]`` / ``[B, Kp]`` int32 rows, outputs
in the JAX kernels' order, with their ``[B, 8]`` ``scal`` rows (K1:
``[conflict count]``; K2: ``[n_runs, n_kept, sp_last]``; K4:
``[root_val, overflow_k]``), so each output compares one to one.

Each function has a ``*_plain`` version, a batched line-for-line port of
``row_k1`` / ``row_k2`` / ``row_k4`` whose sorts are ``sort_pairs_plain``
(so the reference is plain on the card too), and a ``*_cuda`` version
that launches ``csrc/befuse_k{1,2,4}.cu``. The dispatcher takes the plain
version for CPU tensors and the kernel for CUDA tensors. Every output is
exact in every position, padding included; on overflow rows (``n_tok >
u_max`` or ``n_runs > k_max``) only the flags are specified
(``pallas_befuse.py:45-47``).
"""

from __future__ import annotations

import torch

from .. import kernels
from .arrays import I32_MAX, VCLASS_H_HIDE, VCLASS_HIDE
from .bitonic import sort_pairs_plain
from .gatherops import at_add, take1d

__all__ = [
    "next_pow2",
    "k1_sort_redirect", "k1_sort_redirect_plain", "k1_sort_redirect_cuda",
    "k2_runs", "k2_runs_plain", "k2_runs_cuda",
    "k4_rank_kills", "k4_rank_kills_plain", "k4_rank_kills_cuda",
]

BIG = int(I32_MAX)
I32 = torch.int32
LANE = 128  # the JAX kernels' chunk width; K2's histogram ranges use it


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _iota(B, n, dev):
    return torch.arange(n, dtype=I32, device=dev).expand(B, n).contiguous()


def _shiftr(x, fill):
    """The previous lane's value, ``fill`` at lane 0."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _rolln(x):
    """The next lane's value, wrapping."""
    return torch.roll(x, -1, dims=1)


def _cumsum(x):
    return torch.cumsum(x, dim=1, dtype=I32)


def _cummax(x):
    return torch.cummax(x, dim=1).values


def _scal(*cols):
    """``[B, 8]`` int32 rows holding ``cols`` (each ``[B]``) first."""
    B = cols[0].shape[0]
    out = torch.zeros((B, 8), dtype=I32, device=cols[0].device)
    for i, c in enumerate(cols):
        out[:, i] = c.to(I32)
    return out


# ---------------------------------------------------------------------
# plain versions (row_k1 / row_k2 / row_k4, batched)
# ---------------------------------------------------------------------


def k1_sort_redirect_plain(t_hi, t_lo, t_vc, t_len, t_tsp, t_lane, cu0m,
                           hu0m, U: int):
    B, P = t_hi.shape
    uidx = _iota(B, P, t_hi.device)
    (st_hi, st_lo, t_src, sv_len, sv_vc, sv_tsp, sv_lane, sv_cu,
     sv_hu) = sort_pairs_plain(
        (t_hi, t_lo, uidx, t_len, t_vc, t_tsp, t_lane, cu0m, hu0m),
        num_keys=2)
    inv_t = sort_pairs_plain((t_src, uidx), num_keys=1)[1]

    tva = ~((st_hi == BIG) & (st_lo == BIG))
    sdup = ((st_hi == _shiftr(st_hi, -1)) & (st_lo == _shiftr(st_lo, -1))
            & (uidx > 0) & tva)
    keep_t = tva & ~sdup

    thead = _cummax(torch.where(keep_t, uidx, -1))
    raw_c = take1d(inv_t, sv_cu.clamp(0, U - 1))
    red_c = take1d(thead, raw_c.clamp(0, U - 1))
    cause_su = torch.where(sv_cu >= 0, red_c, 0)
    raw_h = take1d(inv_t, sv_hu.clamp(0, U - 1))
    red_h = take1d(thead, raw_h.clamp(0, U - 1))
    host_su = torch.where(sv_hu >= 0, red_h, 0)

    special_t = keep_t & (sv_vc > 0)
    parent_su = torch.where(special_t, cause_su, host_su)

    conflict = (sdup & ((sv_vc != _shiftr(sv_vc, 0))
                        | (cause_su != _shiftr(cause_su, 0))
                        | (sv_len != _shiftr(sv_len, 0)))).sum(
        dim=1, dtype=I32)
    return (sv_len, sv_vc, sv_tsp, sv_lane, keep_t.to(I32), cause_su.to(I32),
            parent_su.to(I32), _scal(conflict))


def k2_runs_plain(sv_len, sv_vc, sv_tsp, keep_i, cause_su, parent_su,
                  U: int, k_max: int, Kp: int):
    B, P = sv_len.shape
    dev = sv_len.device
    uidx = _iota(B, P, dev)
    kidx = _iota(B, Kp, dev)
    targets = kidx + 1
    keep_t = keep_i != 0
    special_t = keep_t & (sv_vc > 0)
    is_root_t = keep_t & (uidx == 0)
    rel_t = keep_t & ~is_root_t

    kept_len = torch.where(keep_t, sv_len, 0)
    wcum = _cumsum(kept_len)
    wstart = wcum - kept_len
    n_kept = wcum[:, P - 1:P]

    sp_pack = _cummax(torch.where(keep_t, uidx * 2 + (sv_tsp != 0).to(I32),
                                  -1))
    sp_prev = _shiftr(sp_pack, -1)
    prev_kept = torch.where(sp_prev >= 0, sp_prev >> 1, -1)
    prev_kept_tsp = (sp_prev >= 0) & (sp_prev % 2 == 1)

    adj = rel_t & (cause_su == prev_kept) & (prev_kept >= 0)
    host_case = adj & ~special_t & prev_kept_tsp
    irregular = rel_t & (~adj | host_case)

    # contested parents: irregular tokens per parent token, counted over
    # the chunks below the budget (the reference's one-hot chunk sums)
    psrc = torch.where(irregular, parent_su, -1)
    u_ceil = LANE * ((U + LANE - 1) // LANE)
    lim = min(P, u_ceil)
    contested_i = at_add(torch.zeros((B, P), dtype=I32, device=dev),
                         torch.where((psrc >= 0) & (psrc < lim), psrc, P), 1)
    contested = contested_i > 0

    ec_pack = _cummax(torch.where(keep_t, uidx * 2 + contested.to(I32), -1))
    ec_prev = _shiftr(ec_pack, -1)
    prev_contested = (ec_prev >= 0) & (ec_prev % 2 == 1)
    glued = adj & ~host_case & ~prev_contested

    run_start = keep_t & ~glued
    rs_cum = _cumsum(run_start)
    run_id = rs_cum - 1
    n_runs = rs_cum[:, P - 1:P]

    # token->run compaction: every per-run head field in one sort
    h_parent_tok = torch.where(irregular, parent_su,
                               torch.where(adj, prev_kept, -1))
    ckey = torch.where(run_start, run_id, BIG)
    comp = sort_pairs_plain(
        (ckey, uidx, h_parent_tok.to(I32), wstart, special_t.to(I32),
         is_root_t.to(I32)), num_keys=1)
    hc = comp[1][:, :Kp].contiguous()
    h_parent_k = comp[2][:, :Kp]
    h_w = comp[3][:, :Kp].contiguous()
    h_special = comp[4][:, :Kp] != 0
    h_root = comp[5][:, :Kp] != 0

    r_valid = targets <= torch.clamp(n_runs, max=k_max)
    h_parent = torch.where(r_valid & ~h_root, h_parent_k, -1)
    parent_run = torch.where(h_parent >= 0,
                             take1d(run_id, h_parent.clamp(0, U - 1)), -1)

    nxt_w = _rolln(h_w)
    run_w = torch.where(
        r_valid,
        torch.where(targets == n_runs, n_kept - h_w, nxt_w - h_w), 0)

    parent_sort = torch.where(r_valid & (parent_run >= 0), parent_run,
                              k_max).to(I32)
    packed = (parent_sort * 2 + (~h_special).to(I32)).to(I32)
    _s = sort_pairs_plain((packed, (-hc).to(I32), kidx, parent_sort),
                          num_keys=2)
    sord, p_sorted = _s[2], _s[3]
    is_start = (kidx == 0) | (p_sorted != _shiftr(p_sorted, -7))
    same_parent_next = (_rolln(p_sorted) == p_sorted) & (kidx < Kp - 1)
    ns_sorted = torch.where(same_parent_next, _rolln(sord), -1)
    ns = sort_pairs_plain((sord, ns_sorted.to(I32)), num_keys=1)[1]
    # first_child: the reference's chunk sums over the chunks below
    # k_max (one start per parent value, so the sum is the scatter)
    fc_target = torch.where(
        is_start & (p_sorted >= 0) & (p_sorted < k_max), p_sorted, -1)
    k_ceil = LANE * ((k_max + LANE - 1) // LANE)
    in_range = (fc_target >= 0) & (fc_target < min(Kp, k_ceil))
    slot = torch.where(in_range, fc_target, Kp)
    zeros = torch.zeros((B, Kp), dtype=I32, device=dev)
    hit = at_add(zeros, slot, 1)
    val = at_add(zeros, slot, sord)
    fc = torch.where(hit > 0, val + 1, 0) - 1

    parent_up = torch.where(r_valid & (parent_run >= 0), parent_run, -1)
    sp_last = sp_pack[:, P - 1]
    return (fc.to(I32), ns, parent_up.to(I32), run_w.to(I32), hc, h_w,
            run_id, glued.to(I32), prev_kept.to(I32),
            _scal(n_runs[:, 0], n_kept[:, 0], sp_last))


def k4_rank_kills_plain(base_run, hc, h_w, run_id, keep_i, sv_len, sv_vc,
                        sv_lane, glued_i, prev_kept, cause_su, scal2,
                        U: int, k_max: int, N: int):
    B, P = keep_i.shape
    Kp = base_run.shape[1]
    dev = keep_i.device
    kidx = _iota(B, Kp, dev)
    targets = kidx + 1
    n_runs = scal2[:, 0:1]
    sp_last = scal2[:, 2:3]
    keep_t = keep_i != 0
    glued = glued_i != 0
    sv_tail_lane = sv_lane + sv_len - 1

    kept_len = torch.where(keep_t, sv_len, 0)
    wcum = _cumsum(kept_len)
    wstart = wcum - kept_len
    r_valid = targets <= torch.clamp(n_runs, max=k_max)

    # run->token expansion: each token reads its run's base and head
    # weight (what jaxw5's delta scatter + cumsum telescopes to)
    rid_c = run_id.clamp(0, Kp - 1)
    base_ff = take1d(base_run, rid_c)
    hw_ff = take1d(h_w, rid_c)
    rank_tok = torch.where(keep_t, base_ff + (wstart - hw_ff), N).to(I32)

    hideish = (sv_vc == VCLASS_HIDE) | (sv_vc == VCLASS_H_HIDE)
    kg = glued & hideish
    vict_inrun = torch.where(
        kg, take1d(sv_tail_lane, prev_kept.clamp(0, U - 1)), N)

    bkey = torch.where(r_valid, base_run, BIG).to(I32)
    b_sorted, b_src = sort_pairs_plain((bkey, kidx), num_keys=1)
    succ_valid = (_rolln(b_sorted) != BIG) & (kidx < Kp - 1)
    succ_entry = torch.where(succ_valid, _rolln(b_src), -1).to(I32)
    succ_of = sort_pairs_plain((b_src, succ_entry), num_keys=1)[1]
    succ_run = torch.where(r_valid, succ_of, -1)
    s_c = torch.where(succ_run >= 0,
                      take1d(hc, succ_run.clamp(0, Kp - 1)),
                      0).clamp(0, U - 1)
    g_hide = take1d(hideish.to(I32), s_c)
    g_cause = take1d(cause_su, s_c)
    s_is_hide = (succ_run >= 0) & (g_hide != 0)
    nxt_head = _rolln(hc)
    tail_tok = torch.where(
        targets == n_runs,
        (sp_last >> 1).clamp(min=0),
        take1d(prev_kept, nxt_head.clamp(0, U - 1))).to(I32)
    kill_tail = r_valid & s_is_hide & (g_cause == tail_tok)
    vict_tail = torch.where(
        kill_tail, take1d(sv_tail_lane, tail_tok.clamp(0, U - 1)), N)

    lane_key = torch.where(keep_t & (rank_tok < N), sv_lane, N).to(I32)
    lk, tb_l = sort_pairs_plain((lane_key, rank_tok), num_keys=1)

    root_val = torch.where(keep_i[:, 0] != 0, sv_lane[:, 0], N)
    overflow_k = n_runs[:, 0] > k_max
    return (lk, tb_l, vict_inrun.to(I32), vict_tail.to(I32),
            _scal(root_val, overflow_k))


# ---------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------


def _check(name, tensors, widths):
    """int32, contiguous, 2-D, one device, the same batch, and the
    expected widths (None: any)."""
    dev = tensors[0].device
    B = tensors[0].shape[0]
    for x, w in zip(tensors, widths):
        if x.dtype != I32:
            raise TypeError(f"{name} is int32-only, got {x.dtype}")
        if x.dim() != 2 or x.device != dev or x.shape[0] != B:
            raise ValueError(f"{name} takes [B, width] tensors on one device")
        if w is not None and x.shape[1] != w:
            raise ValueError(f"{name}: width {x.shape[1]}, expected {w}: "
                             f"{[tuple(t.shape) for t in tensors]}")
        if not x.is_contiguous():
            raise ValueError(f"{name} inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")


def _pow2_width(name, n):
    if n < 1 or n & (n - 1):
        raise ValueError(f"{name}: row width {n} is not a power of two")


def _scratch(lib, fn_words, B, *dims, device):
    """Global-memory scratch rows for a row too wide for shared memory
    (None when the row fits)."""
    words = getattr(lib, fn_words)(*dims)
    if words < 0:
        raise RuntimeError(f"{fn_words}: CUDA device query failed")
    if words == 0:
        return None
    return torch.empty((B, words), dtype=I32, device=device)


def _ptr(x):
    return None if x is None else x.data_ptr()


def k1_sort_redirect_cuda(t_hi, t_lo, t_vc, t_len, t_tsp, t_lane, cu0m,
                          hu0m, U: int):
    """Launch the K1 kernel (``csrc/befuse_k1.cu``)."""
    ins = (t_hi, t_lo, t_vc, t_len, t_tsp, t_lane, cu0m, hu0m)
    B, P = t_hi.shape
    _check("k1_sort_redirect", ins, [P] * 8)
    _pow2_width("k1_sort_redirect", P)
    if not 1 <= U <= P:
        raise ValueError(f"k1_sort_redirect: U {U} outside 1..{P}")
    dev = t_hi.device
    outs = tuple(torch.empty((B, P), dtype=I32, device=dev) for _ in range(7))
    scal = torch.zeros((B, 8), dtype=I32, device=dev)
    lib = kernels.library("k1_sort_redirect")
    scratch = _scratch(lib, "cause_k1_scratch_words", B, P, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cause_k1_sort_redirect(
            *[x.data_ptr() for x in ins], *[o.data_ptr() for o in outs],
            scal.data_ptr(), B, P, U, _ptr(scratch),
            kernels.stream_handle(dev))
    kernels.check(rc, "k1_sort_redirect")
    kernels.launches["k1_sort_redirect"] += 1
    return outs + (scal,)


def k2_runs_cuda(sv_len, sv_vc, sv_tsp, keep_i, cause_su, parent_su,
                 U: int, k_max: int, Kp: int):
    """Launch the K2 kernel (``csrc/befuse_k2.cu``)."""
    ins = (sv_len, sv_vc, sv_tsp, keep_i, cause_su, parent_su)
    B, P = sv_len.shape
    _check("k2_runs", ins, [P] * 6)
    _pow2_width("k2_runs", P)
    _pow2_width("k2_runs", Kp)
    if Kp > P or not 1 <= U <= P or not 1 <= k_max <= Kp:
        raise ValueError(f"k2_runs needs k_max <= Kp <= P and U <= P; got "
                         f"U={U} k_max={k_max} Kp={Kp} P={P}")
    dev = sv_len.device
    widths = [Kp] * 6 + [P] * 3
    outs = tuple(torch.empty((B, w), dtype=I32, device=dev) for w in widths)
    scal = torch.zeros((B, 8), dtype=I32, device=dev)
    lib = kernels.library("k2_runs")
    scratch = _scratch(lib, "cause_k2_scratch_words", B, P, Kp, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cause_k2_runs(
            *[x.data_ptr() for x in ins], *[o.data_ptr() for o in outs],
            scal.data_ptr(), B, P, Kp, U, k_max, _ptr(scratch),
            kernels.stream_handle(dev))
    kernels.check(rc, "k2_runs")
    kernels.launches["k2_runs"] += 1
    return outs + (scal,)


def k4_rank_kills_cuda(base_run, hc, h_w, run_id, keep_i, sv_len, sv_vc,
                       sv_lane, glued_i, prev_kept, cause_su, scal2,
                       U: int, k_max: int, N: int):
    """Launch the K4 kernel (``csrc/befuse_k4.cu``)."""
    ins = (base_run, hc, h_w, run_id, keep_i, sv_len, sv_vc, sv_lane,
           glued_i, prev_kept, cause_su, scal2)
    B, Kp = base_run.shape
    P = run_id.shape[1]
    _check("k4_rank_kills", ins, [Kp] * 3 + [P] * 8 + [8])
    _pow2_width("k4_rank_kills", P)
    _pow2_width("k4_rank_kills", Kp)
    if Kp > P or not 1 <= U <= P or not 1 <= k_max <= Kp or N < 1:
        raise ValueError(f"k4_rank_kills needs k_max <= Kp <= P, U <= P "
                         f"and N >= 1; got U={U} k_max={k_max} Kp={Kp} "
                         f"P={P} N={N}")
    dev = base_run.device
    widths = [P, P, P, Kp]
    outs = tuple(torch.empty((B, w), dtype=I32, device=dev) for w in widths)
    scal = torch.zeros((B, 8), dtype=I32, device=dev)
    lib = kernels.library("k4_rank_kills")
    scratch = _scratch(lib, "cause_k4_scratch_words", B, P, Kp, device=dev)
    with torch.cuda.device(dev):
        rc = lib.cause_k4_rank_kills(
            *[x.data_ptr() for x in ins], *[o.data_ptr() for o in outs],
            scal.data_ptr(), B, P, Kp, U, k_max, N, _ptr(scratch),
            kernels.stream_handle(dev))
    kernels.check(rc, "k4_rank_kills")
    kernels.launches["k4_rank_kills"] += 1
    return outs + (scal,)


# ---------------------------------------------------------------------
# dispatchers
# ---------------------------------------------------------------------


def _route(plain, cuda, x):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"no fused token kernel for device {x.device}")


def k1_sort_redirect(t_hi, t_lo, t_vc, t_len, t_tsp, t_lane, cu0m, hu0m,
                     U: int):
    """K1 over ``[B, P]`` presort tokens (``P`` a power of two, padding
    tokens with keys int32-max) and their presort cause / host token links
    (-1: none). Returns ``(sv_len, sv_vc, sv_tsp, sv_lane, keep_i,
    cause_su, parent_su, scal)``; ``scal[:, 0]`` is the conflict count.
    The plain version on the CPU, the kernel on the card."""
    fn = _route(k1_sort_redirect_plain, k1_sort_redirect_cuda, t_hi)
    return fn(t_hi, t_lo, t_vc, t_len, t_tsp, t_lane, cu0m, hu0m, U=U)


def k2_runs(sv_len, sv_vc, sv_tsp, keep_i, cause_su, parent_su, U: int,
            k_max: int, Kp: int):
    """K2 over K1's sorted tokens. Returns ``(fc, ns, parent_up, run_w,
    hc, h_w)`` at width ``Kp``, ``(run_id, glued_i, prev_kept)`` at width
    ``P`` and ``scal = [n_runs, n_kept, sp_last, 0, ...]``."""
    fn = _route(k2_runs_plain, k2_runs_cuda, sv_len)
    return fn(sv_len, sv_vc, sv_tsp, keep_i, cause_su, parent_su, U=U,
              k_max=k_max, Kp=Kp)


def k4_rank_kills(base_run, hc, h_w, run_id, keep_i, sv_len, sv_vc,
                  sv_lane, glued_i, prev_kept, cause_su, scal2, U: int,
                  k_max: int, N: int):
    """K4 over the walk's run bases and K1/K2's token tables. Returns
    ``(lk, tb_l, vict_inrun, vict_tail, scal)``; ``scal = [root_val,
    overflow_k, 0, ...]``."""
    fn = _route(k4_rank_kills_plain, k4_rank_kills_cuda, base_run)
    return fn(base_run, hc, h_w, run_id, keep_i, sv_len, sv_vc, sv_lane,
              glued_i, prev_kept, cause_su, scal2, U=U, k_max=k_max, N=N)
