"""The radix form of the port's K1 and the row walk of its B3, modelled
in numpy.

On the card, K1 (``csrc/befuse_k1.cu``) sorts its tokens with
``csrc/radix.cuh`` at 256 <= P <= 8192 and B3 (``csrc/fphase.cu``) walks
each row in one CTA, tile by tile. Those kernels run only on the card,
so their algorithms are modelled here step by step:

- K1: the (hi, lo) range compression and composite (``_radix_row``,
  tests/test_torch_kernels.py), dedupe by equality of neighbouring
  composites, the payload gather by sorted position, the ``inv_t``
  scatter, the warp-striped ``thead`` max-scan (items in registers, a
  carry across a warp's items, the warps' totals), and the conflict
  test's neighbour exchange (a shuffle within an item, lane 31 of the
  item before, one word triple per warp across warps);
- B3: the tile walk with its carry (last token's lane and base, last
  segment's end), the pointers that load 256-entry chunks of tokens and
  segment starts and scatter those in the tile into slot tables, the
  max-scan over a thread's four slots, its warp and the warps' maxima,
  and the lane + 1 exchange, whose last lane of a tile waits for the next
  tile's first; the tile width is a parameter (1024 as on the card, and
  64 so that small rows cross tiles).

Both models are held against ``cause_tpu``'s Pallas kernels in interpret
mode (K1 at P <= 1024; B3 where N is a multiple of 128) and against the
port's plain versions, on recorded pipeline inputs, on
``_synthetic_f_inputs`` and on the edge rows that ``chip_smoke.py``
gives the kernels. Every value is an integer or a flag, so every
comparison is EXACT.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cause_tpu.weaver import pallas_befuse as pb
from cause_tpu.weaver import pallas_fphase

from cause_tpu_torch import benchgen as tbench
from cause_tpu_torch.weaver import befuse, fphase

from chip_smoke import fphase_inputs, k1_inputs, tile_edge_killed
from test_torch_befuse import _v5_case, record_kernel_inputs
from test_torch_kernels import (_pipeline_f_inputs, _radix_code,
                                _radix_range, _radix_row,
                                _synthetic_f_inputs)

I32_MAX = int(np.iinfo(np.int32).max)
I32_MIN = int(np.iinfo(np.int32).min)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ K1


def _ipt(P):
    """Items a thread of the radix forms (radix.cuh's radix_ipt)."""
    return 16 if P > 4096 else 8


def _ws_excl_max(x, ipt):
    """The kernel's exclusive max-scan of a warp-striped row (befuse.cuh
    ``ws_scan``): element (w * ipt + i) * 32 + l is thread (w, l)'s item
    i; each item's 32 lanes scan by shuffles, a warp's items one after
    another with a carry, then the earlier warps' totals are folded in."""
    P = len(x)
    W = P // (32 * ipt)
    v = np.asarray(x, np.int64).reshape(W, ipt, 32)
    out = np.empty_like(v)
    tot = np.empty(W, np.int64)
    for w in range(W):
        carry = I32_MIN
        for i in range(ipt):
            incl = np.maximum.accumulate(v[w, i])
            out[w, i] = np.maximum(carry, np.r_[I32_MIN, incl[:-1]])
            carry = max(carry, int(incl[-1]))
        tot[w] = carry
    off = np.r_[I32_MIN, np.maximum.accumulate(tot)[:-1]]
    return np.maximum(out, off[:, None, None]).reshape(P)


def _ws_prev(P, ipt):
    """The element whose class, length and cause K1's conflict test reads
    as the one before each element, by the kernel's route: a shuffle
    within the item (lane > 0), lane 31 of the item before (lane 0), the
    word triple the warp before left in shared memory (lane 0 of item 0).
    -1 for the row's first element."""
    prev = np.full(P, -1, np.int64)
    for j in range(1, P):
        w, rest = divmod(j, 32 * ipt)
        i, lane = divmod(rest, 32)
        if lane > 0:
            src = (w, i, lane - 1)
        elif i > 0:
            src = (w, i - 1, 31)
        else:
            src = (w - 1, ipt - 1, 31)
        prev[j] = (src[0] * ipt + src[1]) * 32 + src[2]
    return prev


def _k1_model_row(ins, U):
    """K1's radix form on one row: its eight outputs (the conflict count
    last) and the sort's (composite bits, passes)."""
    hi, lo, vc, ln, tsp, lane, cu, hu = (np.asarray(x) for x in ins)
    P = len(hi)
    ipt = _ipt(P)
    keys = np.stack([hi, lo])
    (s_hi, s_lo), pos, passes, bits = _radix_row(keys, ipt)
    rngs = [_radix_range(keys[q]) for q in range(2)]
    comp = ((_radix_code(hi, rngs[0]) << np.uint64(rngs[1][2]))
            | _radix_code(lo, rngs[1]))[pos]
    tva = ~((s_hi == I32_MAX) & (s_lo == I32_MAX))
    dup = np.zeros(P, bool)
    dup[1:] = tva[1:] & (comp[1:] == comp[:-1])
    keep = tva & ~dup

    sv_vc, sv_len, sv_cu, sv_hu = vc[pos], ln[pos], cu[pos], hu[pos]
    inv = np.empty(P, np.int64)
    inv[pos] = np.arange(P)
    own = np.where(keep, np.arange(P), -1)
    thead = np.maximum(_ws_excl_max(own, ipt), own)

    def redirect(link):
        got = thead[np.clip(inv[np.clip(link, 0, U - 1)], 0, U - 1)]
        return np.where(link >= 0, got, 0)

    cause = redirect(sv_cu)
    parent = np.where(keep & (sv_vc > 0), cause, redirect(sv_hu))
    prev = _ws_prev(P, ipt)
    assert np.array_equal(prev[1:], np.arange(P - 1))
    p = np.maximum(prev, 0)
    conflict = int((dup & ((sv_vc != sv_vc[p]) | (cause != cause[p])
                           | (sv_len != sv_len[p]))).sum())
    outs = (sv_len, sv_vc, tsp[pos], lane[pos], keep.astype(np.int32),
            cause, parent, conflict)
    return outs, (bits, passes)


def _check_k1(ins, U, pallas=True):
    """Model, plain version and (P <= 1024) the Pallas kernel agree on
    every row; returns the model's (bits, passes) per row."""
    B, P = ins[0].shape
    plain = befuse.k1_sort_redirect_plain(*(_t(x) for x in ins), U=U)
    ref = None
    if pallas:
        ref = jax.vmap(lambda *a: pb.k1_sort_redirect(*a, U=U))(
            *(jnp.asarray(x) for x in ins))
    widths = []
    for r in range(B):
        got, wp = _k1_model_row([x[r] for x in ins], U)
        widths.append(wp)
        for j, g in enumerate(got):
            want = [plain[j][r].numpy()] + (
                [np.asarray(ref[j])[r]] if ref is not None else [])
            for w in want:
                w = w[0] if j == 7 else w
                assert np.array_equal(g, w), (P, U, r, j)
    return widths, plain


K1_CASES = {
    "P=256": (4, 256, 256, "tokens"),
    "a row of only padding": (3, 512, 512, "padding row"),
    "composite > 32 bits": (3, 256, 256, "wide"),
    "INT32_MIN beside INT32_MAX": (3, 1024, 1024, "extremes"),
    "duplicate runs": (4, 512, 512, "dups"),
    "U<P": (3, 512, 300, "tokens"),
    "B=1": (1, 256, 256, "dups"),
}


@pytest.mark.parametrize("tag", list(K1_CASES))
def test_k1_radix_form_on_edge_rows(tag):
    B, P, U, kind = K1_CASES[tag]
    rng = np.random.default_rng(P + U + len(tag))
    ins = k1_inputs(rng, B, P, U, kind)
    widths, plain = _check_k1(ins, U)
    conflicts = plain[7][:, 0].numpy()
    if kind == "wide":
        assert all(b > 32 for b, _ in widths)
    if kind == "dups":
        assert (conflicts > 0).all()
    if kind == "padding row":  # no key, no pass, nothing kept
        assert widths[1] == (0, 0) and plain[4][1].sum() == 0
    for bits, passes in widths:
        assert passes == -(-bits // 8)


def test_k1_radix_form_at_the_doubled_budget_width():
    """P = 8192: 16 items a thread (plain version only; the Pallas
    kernel in interpret mode is slow at this width)."""
    rng = np.random.default_rng(8192)
    ins = k1_inputs(rng, 1, 8192, 8192, "tokens")
    _check_k1(ins, 8192, pallas=False)


@pytest.mark.parametrize("B,nb,nd,cap,he,du", [
    (3, 120, 40, 256, 8, 0),    # P = 256
    (4, 100, 60, 192, 4, 160),  # U < P = 512
])
def test_k1_radix_form_on_pipeline_inputs(monkeypatch, B, nb, nd, cap, he,
                                          du):
    v5, u = _v5_case(B, nb, nd, cap, he)
    seen, out = record_kernel_inputs(monkeypatch, v5, u + du, u)
    assert not out[3].any()
    args, kw = seen["k1_sort_redirect"]
    _check_k1(tuple(x.numpy() for x in args), kw["U"])


def test_k1_key_widths_at_a_north_star_row(monkeypatch):
    """One row of the north-star batch (10k-node lists, P = 4096): the
    (hi, lo) composite takes 29-39 bits (four or five passes, as site C
    of v5), and the model equals the plain version."""
    batch = tbench.batched_pair_lanes(1, 9000, 1000, 10240, hide_every=8)
    v5 = tbench.batched_v5_inputs(batch, 10240)
    u = befuse.next_pow2(tbench.v5_token_budget(v5))
    assert u == 4096
    seen, out = record_kernel_inputs(monkeypatch, v5, u, u)
    assert not out[3].any()
    args, kw = seen["k1_sort_redirect"]
    [(bits, passes)], _ = _check_k1(tuple(x.numpy() for x in args),
                                    kw["U"], pallas=False)
    assert 29 <= bits <= 39 and passes in (4, 5)


# ------------------------------------------------------------------ B3


def _slot_scan(marks, threads):
    """B3's max-scan over a tile's marked slots: each thread's four
    slots in registers (inclusive), an exclusive shuffle scan of the
    threads' maxima within each warp, the warps' maxima folded in after
    one barrier. Returns each slot's last marked slot at or before it
    (-1: none in the tile) and the tile's last marked slot."""
    own = np.where(marks, np.arange(len(marks)), -1).reshape(threads, 4)
    local = np.maximum.accumulate(own, axis=1)
    out = np.empty_like(local)
    warp_max = []
    for w0 in range(0, threads, 32):
        incl = np.maximum.accumulate(local[w0:w0 + 32, -1])
        out[w0:w0 + 32] = np.r_[-1, incl[:-1]][:, None]
        warp_max.append(int(incl[-1]))
    for w, w0 in enumerate(range(0, threads, 32)):
        out[w0:w0 + 32] = np.maximum(out[w0:w0 + 32],
                                     max([-1] + warp_max[:w]))
    return np.maximum(out, local).reshape(-1), max(warp_max)


def _chunks(keys, vals, ptr, t0, tend, threads, slot_val, mark):
    """A tile's chunk loop over one sorted table: load ``threads`` entries
    at the pointer, scatter those in [t0, tend) into the slots, advance
    by the block's count of entries before tend; again while a whole
    chunk fell in the tile. Returns the new pointer."""
    n = len(keys)
    while True:
        i = ptr + np.arange(threads)
        ok = i < n
        k = np.where(ok, keys[np.minimum(i, n - 1)], I32_MAX)
        v = np.where(ok, vals[np.minimum(i, n - 1)], 0)
        inside = k < tend
        cnt = int(inside.sum())
        assert inside[:cnt].all()  # the keys ascend: a prefix of the chunk
        sel = inside & (k >= t0)
        assert not mark[k[sel] - t0].any()  # distinct lanes, distinct starts
        slot_val[k[sel] - t0] = v[sel]
        mark[k[sel] - t0] = True
        ptr += cnt
        if cnt < threads:
            return ptr


def _fphase_model_row(ins, tile):
    """B3's row walk on one row with tiles of ``tile`` lanes (four a
    thread): (rank, vis) and the number of tiles."""
    lk, tb, cs, ce, vc, seg, fl = (np.asarray(x, np.int64) for x in ins)
    N = len(vc)
    threads = tile // 4
    rank = np.full(N, -7, np.int64)
    vis = np.zeros(N, bool)
    done = np.zeros(N, bool)
    carry_lane = carry_base = carry_end = 0
    p = q = 0
    held = None  # (lane, its flag without the next lane, covered)
    T = -(-N // tile)
    for t in range(T):
        t0, tend = t * tile, min(t * tile + tile, N)
        tbase = np.zeros(tile, np.int64)
        cend = np.zeros(tile, np.int64)
        tmark = np.zeros(tile, bool)
        cmark = np.zeros(tile, bool)
        p = _chunks(lk, tb, p, t0, tend, threads, tbase, tmark)
        q = _chunks(cs, ce, q, t0, tend, threads, cend, cmark)
        st, tot_t = _slot_scan(tmark, threads)
        sc, tot_c = _slot_scan(cmark, threads)

        def kill_by_next(ln, covered):
            return (covered and ln + 1 < N and seg[ln] >= 0
                    and seg[ln + 1] == seg[ln] and vc[ln + 1] in (1, 2))

        if held is not None:  # the tile before's last lane: its next lane
            ln, flag, covered = held  # is this tile's first, now staged
            vis[ln] = flag and not kill_by_next(ln, covered)
            done[ln] = True
            held = None
        for o in range(tend - t0):
            ln = t0 + o
            tid, k = divmod(o, 4)
            if st[o] >= 0:
                lane_f, base_f = t0 + st[o], tbase[st[o]]
            else:
                lane_f, base_f = carry_lane, carry_base
            has_tok = st[o] == o
            end = cend[sc[o]] if sc[o] >= 0 else carry_end
            in_surv = end > ln
            valid, killed = bool(fl[ln] & 1), bool(fl[ln] & 2)
            rank[ln] = (base_f + (ln - lane_f) if valid and (in_surv or has_tok)
                        else N)
            flag = valid and rank[ln] < N and vc[ln] == 0 and not killed
            # lane + 1: own item (k < 3), a shuffle, the next warp's edge
            # word, or (the tile's last thread) the next tile's first lane
            if k == 3 and tid == threads - 1 and t + 1 < T:
                held = (ln, flag, in_surv)
                continue
            vis[ln] = flag and not kill_by_next(ln, in_surv)
            done[ln] = True
        if tot_t >= 0:
            carry_lane, carry_base = t0 + tot_t, tbase[tot_t]
        if tot_c >= 0:
            carry_end = cend[tot_c]
    assert held is None and done.all()
    return rank.astype(np.int32), vis, T


def _check_fphase(ins, tile):
    """Model, plain version and (N a multiple of 128) the Pallas kernel
    agree on every row."""
    ins = tuple(np.asarray(x) for x in ins)
    B, N = ins[4].shape
    rank, vis = fphase.fphase_expand_plain(*(_t(x) for x in ins))
    refs = [(rank.numpy(), vis.numpy())]
    if N % 128 == 0:
        r, v = jax.vmap(pallas_fphase.fphase_expand)(
            *(jnp.asarray(x) for x in ins))
        refs.append((np.asarray(r), np.asarray(v)))
    for row in range(B):
        m_rank, m_vis, _ = _fphase_model_row([x[row] for x in ins], tile)
        for want_r, want_v in refs:
            assert np.array_equal(m_rank, want_r[row]), (N, tile, row)
            assert np.array_equal(m_vis, want_v[row]), (N, tile, row)


TILES = [1024, 64]
F_CASES = {
    "N<1024, ragged": (3, 1000, 64, 16, "random"),
    "N % 4 != 0": (2, 3001, 700, 40, "random"),
    "several tiles": (2, 2560, 300, 40, "random"),
    "no tokens": (3, 2048, 256, 8, "no tokens"),
    "lanes 0 and N - 1": (2, 2000, 300, 20, "ends"),
    "a tile of tokens": (2, 2304, 1280, 30, "full tile"),
    "segments over tiles": (2, 4096, 200, 4, "long segments"),
    "tile-edge kill": (2, 3072, 100, 10, "tile-edge kill"),
    "S=1": (2, 1280, 50, 1, "random"),
    "B=1": (1, 1536, 400, 60, "random"),
}


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("tag", list(F_CASES))
def test_fphase_row_walk_on_edge_rows(tag, tile):
    B, N, U, S, kind = F_CASES[tag]
    if kind == "full tile":
        U = max(U, tile + 64)
    rng = np.random.default_rng(N + U + S + tile)
    ins = fphase_inputs(rng, B, N, U, S, kind, tile)
    _check_fphase(ins, tile)
    if kind == "tile-edge kill":  # the case reaches the held flag word
        assert tile_edge_killed(torch, ins, tile)
    if kind == "ends":
        assert (ins[0][:, 0] == 0).all()
        assert (ins[0] == N - 1).any(axis=1).all()


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("B,nb,nd,cap,he", [
    (3, 120, 40, 256, 8),
    (2, 30, 10, 64, 3),
])
def test_fphase_row_walk_on_pipeline_inputs(monkeypatch, B, nb, nd, cap, he,
                                            tile):
    ins = _pipeline_f_inputs(monkeypatch, B, nb, nd, cap, he)
    _check_fphase(tuple(x.numpy() for x in ins), tile)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("N,U,S", [(256, 64, 16), (384, 200, 150),
                                   (2176, 600, 90)])
def test_fphase_row_walk_on_random_inputs(N, U, S, tile):
    rng = np.random.default_rng(N + U + S)
    ins = _synthetic_f_inputs(rng, 3, N, U, S)
    _check_fphase(tuple(x.numpy() for x in ins), tile)
