"""The split form of B2 and the chunk form of B3, modelled in numpy.

Both kernels have a second form for calls with few wide rows, which
leave most SMs idle at one CTA a row (the fleet row, the merge tree's
narrow levels, the one-row entry points). Those forms run only on the
card, so their algorithms are modelled here step by step:

- B2's split form (``csrc/euler_walk.cu``): (a) the tour's successors
  and the row's total as a wrapping sum of per-CTA partials, added in
  any order; (b) each splitter's sublist weight and next splitter, the
  bases set to the total; (c) the splitter chain ranked by pointer
  jumping over ``ceil(log2(NS)) + 1`` rounds with ping-pong buffers (a
  splitter whose sublist ends the tour links to itself and counts its
  own weight nowhere), a splitter reached when it has splitter 0's
  terminal and is no farther from it; (d) the reached sublists stamped.
  The splitters are the split form's own (``split_hash``: a bijection
  that mixes a slot's bits both ways, so that a tour stepping by a power
  of two still meets one every few dozen slots), and their stride is a
  parameter, so that small rows have many splitters and many blocks of
  them;
- B3's chunk form (``csrc/fphase.cu``): per (row, chunk) the block's
  256-ary search for the counts of kept tokens and segment starts
  before the chunk (``threads``-ary here, the tile's threads), the carry
  seeded from the entries before them, the row walk's tile loop over
  the chunk alone, and the chunk's last lane reading lane + 1 from
  global memory; tile widths 1024 and 64 and chunks of 1-3 tiles, so
  that small rows cross many chunks.

The models are held exact against ``cause_tpu``'s Pallas kernels in
interpret mode and against the port's plain versions, on the shaped
forests and B3's edge rows of the row forms' own models, on recorded
pipeline inputs, on rows whose chunk edges carry a token, a segment and
a kill, and (B2) on rows with a cycle, which must terminate. The rules
``walk_form`` and ``fphase_form`` are checked against a table and
their constants against the ones the ``.cu`` files compile with. Every value is an
integer or a flag, so every comparison is EXACT.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cause_tpu.weaver import pallas_fphase, pallas_ops

from cause_tpu_torch import kernels
from cause_tpu_torch.weaver import euler, fphase

from chip_smoke import fphase_inputs, tile_edge_killed
from test_torch_k1_fphase_models import F_CASES, _chunks, _slot_scan
from test_torch_kernels import (_forest, _pipeline_f_inputs,
                                _shaped_forest, _synthetic_f_inputs,
                                _tour_succ, _walk_hash)

H100_SMS = 132


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------------ B2


def _walk_rounds(NS):
    """The jumping's rounds: ceil(log2(NS)) + 1."""
    r = 0
    while (1 << r) < NS:
        r += 1
    return r + 1


def _split_hash(K, log_stride):
    """The split form's splitter hash (``euler_walk.cu``'s ``split_hash``):
    the id of slot s is A(C(A s ^ (A s >> r)) ^ ...) mod M, a bijection
    of [0, M) that mixes a slot's bits both ways (multiply by A, xor the
    top half into the bottom, multiply by C, again, multiply by A); a
    slot is a splitter when its id is below NS. Returns (id, slot, NS):
    the hash and its inverse as functions, and the splitter count."""
    M, a, a_inv, NS = _walk_hash(K, log_stride)
    mask = M - 1
    r = (M.bit_length() - 1 + 1) // 2
    c = (0x85EBCA6B & mask) | 1
    c_inv = pow(c, -1, M) if M > 1 else 0

    def ident(s):
        x = (s * a) & mask
        x ^= x >> r
        x = (x * c) & mask
        x ^= x >> r
        return (x * a) & mask

    def slot(j):
        x = (j * a_inv) & mask
        x ^= x >> r
        x = (x * c_inv) & mask
        x ^= x >> r
        return (x * a_inv) & mask

    return ident, slot, NS


@pytest.mark.parametrize("K", [1, 2, 3, 1000, 1 << 20, 1_025_536])
def test_split_hash_is_a_bijection(K):
    """``split_slot`` inverts ``split_id`` on every slot of [0, M)."""
    ident, slot, NS = _split_hash(K, 5)
    M = 1 << (2 * K - 1).bit_length()
    s = np.arange(M, dtype=np.int64)
    ids = ident(s)
    assert np.array_equal(np.sort(ids), s)
    assert np.array_equal(slot(ids), s)
    assert ident(0) == 0  # d(0) is splitter 0


def test_split_hash_on_a_strided_tour():
    """A tour that steps 1,024 slots at a time (the fleet row's replicas
    interleave their runs so) finds a splitter every few hundred slots
    with the split form's hash, where the row form's multiplicative one
    goes more than a thousand without one."""
    K = 1_025_536
    M, a, _, NS = _walk_hash(K, 5)
    ident, _, _ = _split_hash(K, 5)
    walks = [s0 + 1024 * np.arange(2 * K // 1024, dtype=np.int64)
             for s0 in (0, 1, 7, 513, 1000)]

    def longest_gap(walk, is_splitter):
        idx = np.flatnonzero(is_splitter)
        return int(np.diff(np.r_[-1, idx, len(walk)]).max()) - 1

    assert max(longest_gap(x, (x * a) % M < NS) for x in walks) > 1000
    assert max(longest_gap(x, ident(x) < NS) for x in walks) < 400


def _split_walk_model(fc, ns, parent, w, log_stride=2, per=4, seed=0):
    """B2's split form on each row: (a) successors and per-CTA partial
    sums of ``per`` runs, totalled in a shuffled order; (b) each
    splitter's sublist (walks capped at 2K steps) as the jumping's first
    state, every base at the total; (c) the rounds of pointer jumping,
    buffer ``r & 1`` into the other; (d) the reached sublists stamped.
    Returns the bases and, per row, the rounds run and whether the last
    round changed nothing."""
    B, K = fc.shape
    two_k = 2 * K
    ident, slot, NS = _split_hash(K, log_stride)
    rounds = _walk_rounds(NS)
    shuffle = np.random.default_rng(seed)
    base = np.empty((B, K), np.int32)
    settled = []
    for r in range(B):
        succ = _tour_succ(fc[r], ns[r], parent[r])
        wgt = w[r].astype(np.uint32)
        # a. the CTAs' partials, added in any order (uint32 wraps)
        parts = [np.uint32(wgt[i:i + per].sum(dtype=np.uint64) & 0xFFFFFFFF)
                 for i in range(0, K, per)]
        total = np.uint32(0)
        for i in shuffle.permutation(len(parts)):
            total = np.uint32(total + parts[i])
        out = np.full(K, total, np.uint32)
        # b. sublists: weight, steps and link of each splitter
        val = np.zeros((2, NS), np.uint32)
        dist = np.zeros((2, NS), np.int64)
        nx = np.zeros((2, NS), np.int64)
        for j in range(NS):
            cur, s, nxt = slot(j), np.uint32(0), -1
            for steps in range(1, two_k + 1):
                if cur >= two_k:  # an id past the tour: empty
                    break
                if cur < K:
                    s = np.uint32(s + wgt[cur])
                cur = int(succ[cur])
                if cur >= two_k:
                    break
                if ident(cur) < NS:
                    nxt = ident(cur)
                    break
            val[0, j] = s if nxt >= 0 else 0
            dist[0, j] = 1 if nxt >= 0 else 0
            nx[0, j] = nxt if nxt >= 0 else j
        # c. the rounds, each reading one buffer and writing the other
        for rd in range(rounds):
            src, dst = rd & 1, 1 - (rd & 1)
            n = nx[src]
            val[dst] = val[src] + val[src][n]
            dist[dst] = dist[src] + dist[src][n]
            nx[dst] = nx[src][n]
        fin = rounds & 1
        n = nx[fin]
        settled.append(bool((val[fin][n] == 0).all() and (nx[fin][n] == n).all()))
        # d. stamps of the splitters on splitter 0's path to its terminal
        reach = (nx[fin] == nx[fin][0]) & (dist[fin] <= dist[fin][0])
        for j in np.flatnonzero(reach):
            cur = slot(j)
            before = np.uint32(val[fin][0] - val[fin][j])
            for steps in range(1, two_k + 1):
                if cur < K:
                    out[cur] = before
                    before = np.uint32(before + wgt[cur])
                cur = int(succ[cur])
                if cur >= two_k or ident(cur) < NS:
                    break
        base[r] = out.view(np.int32)
    return base, rounds, settled


def _check_split(fc, ns, parent, w, log_stride, per=4):
    K = fc.shape[1]
    got, rounds, settled = _split_walk_model(fc, ns, parent, w, log_stride,
                                             per, seed=K + log_stride)
    args = tuple(jnp.asarray(x) for x in (fc, ns, parent, w))
    want = jax.vmap(
        lambda a, b, c, d: pallas_ops.euler_walk(a, b, c, d, K))(*args)
    assert np.array_equal(got, np.asarray(want))
    plain = euler.euler_walk(*(_t(x) for x in (fc, ns, parent, w)))
    assert np.array_equal(got, plain.numpy())
    # on an acyclic row every chain has reached its terminal: the rounds
    # leave each splitter's terminal a self-loop of weight 0
    assert all(settled)
    NS = _walk_hash(K, log_stride)[3]
    assert rounds == int(np.ceil(np.log2(NS))) + 1 if NS > 1 else rounds == 1


@pytest.mark.parametrize("shape,K,log_stride", [
    ("chain", 64, 2), ("star", 64, 2), ("two_chains", 96, 2),
    ("root_only", 32, 1), ("chain", 1, 5), ("star", 48, 1),
    ("two_chains", 200, 3), ("chain", 130, 0)])
def test_split_model_on_shaped_forests(shape, K, log_stride):
    """Chains (the deepest tour), stars, two interleaved chains, a row of
    one valid run, K = 1, and a splitter at every slot (stride 1)."""
    rng = np.random.default_rng(K + 3 * len(shape))
    _check_split(*_shaped_forest(rng, shape, 2, K), log_stride)


@pytest.mark.parametrize("K,n_valid,log_stride,per", [
    (8, 8, 1, 1), (64, 40, 2, 4), (128, 1, 3, 8), (256, 200, 2, 16),
    (300, 300, 4, 7)])
def test_split_model_on_random_forests(K, n_valid, log_stride, per):
    """The v5 kernel's run tables: reachable runs and invalid slots,
    sibling order special-first; K not a power of two; partials over
    blocks of 1-16 runs."""
    rng = np.random.default_rng(K * 11 + n_valid)
    order, parent_sort, parent_up, w = _forest(rng, 3, K, n_valid)
    fc, ns = euler.link_children(_t(order), _t(parent_sort))
    _check_split(fc.numpy(), ns.numpy(), parent_up, w, log_stride, per)


def _chain_with_cycle(K, n, on_list):
    """One row: a chain of runs 0 .. n - 1 (run 0 the root) and runs n ..
    K - 1 detached, weighing 0 as the v5 kernel's invalid slots do; two
    detached runs each other's first child (a cycle off d(0)'s list),
    or, ``on_list``, the chain's last run's first child run 0 (d(0)'s
    list a cycle)."""
    fc = np.full((1, K), -1, np.int32)
    ns = np.full((1, K), -1, np.int32)
    parent = np.full((1, K), -1, np.int32)
    fc[0, :n - 1] = np.arange(1, n)
    parent[0, 1:n] = np.arange(n - 1)
    if on_list:
        fc[0, n - 1] = 0
    else:
        fc[0, n], fc[0, n + 1] = n + 1, n
    w = np.random.default_rng(K + n).integers(0, 6, size=(1, K))
    w[0, n:] = 0
    return fc, ns, parent, w.astype(np.int32)


@pytest.mark.parametrize("K,n,log_stride", [(64, 40, 2), (48, 20, 0),
                                            (256, 100, 3)])
def test_split_model_on_a_cycle_off_the_list(K, n, log_stride):
    """A cycle that d(0)'s list never enters: the walk terminates, and
    every version leaves the cycle's runs (and the other detached runs)
    at the total."""
    fc, ns, parent, w = _chain_with_cycle(K, n, on_list=False)
    got, _, _ = _split_walk_model(fc, ns, parent, w, log_stride)
    args = tuple(jnp.asarray(x) for x in (fc, ns, parent, w))
    want = jax.vmap(
        lambda a, b, c, d: pallas_ops.euler_walk(a, b, c, d, K))(*args)
    assert np.array_equal(got, np.asarray(want))
    plain = euler.euler_walk(*(_t(x) for x in (fc, ns, parent, w)))
    assert np.array_equal(got, plain.numpy())
    assert (got[0, n:] == w.sum()).all()


@pytest.mark.parametrize("log_stride", [0, 2])
def test_split_model_terminates_on_a_cyclic_list(log_stride):
    """d(0)'s list a cycle (a malformed row, whose values are
    unspecified): every walk is capped and the rounds are fixed, so the
    model, like the kernel, ends."""
    fc, ns, parent, w = _chain_with_cycle(64, 40, on_list=True)
    got, rounds, settled = _split_walk_model(fc, ns, parent, w, log_stride)
    assert got.shape == (1, 64) and got.dtype == np.int32
    assert not settled[0]  # no terminal: the chain never settles
    assert rounds == _walk_rounds(_walk_hash(64, log_stride)[3])


# ------------------------------------------------------------------ B3


def _count_below(a, x, threads):
    """The kernel's block search: ``threads`` evenly spaced samples of
    what is left a round, narrowed by the count of those below x.
    Returns the count of a's entries below x and the rounds taken."""
    lo, hi, rounds = 0, len(a), 0
    while lo < hi:
        step = -(-(hi - lo) // threads)
        idx = lo + np.arange(threads) * step
        ok = idx < hi
        c = int((ok & (a[np.minimum(idx, len(a) - 1)] < x)).sum())
        top = min(lo + c * step, hi)
        lo, hi = (lo + (c - 1) * step + 1, top) if c else (lo, lo)
        rounds += 1
    return lo, rounds


def _fphase_chunk_model_row(ins, tile, chunk_tiles):
    """B3's chunk form on one row: per chunk of ``chunk_tiles`` tiles of
    ``tile`` lanes, the searched pointers and the seeded carry, then the
    row walk's tile loop over the chunk, its last lane's next lane read
    from the row. Returns (rank, vis) and the lanes that read their next
    lane across a chunk edge."""
    lk, tb, cs, ce, vc, seg, fl = (np.asarray(x, np.int64) for x in ins)
    N = len(vc)
    threads = tile // 4
    rank = np.full(N, -7, np.int64)
    vis = np.zeros(N, bool)
    done = np.zeros(N, bool)
    T = -(-N // tile)
    edge_lanes = []

    def kill_by_next(ln, covered):
        return (covered and ln + 1 < N and seg[ln] >= 0
                and seg[ln + 1] == seg[ln] and vc[ln + 1] in (1, 2))

    for t_first in range(0, T, chunk_tiles):
        t_end = min(T, t_first + chunk_tiles)
        carry_lane = carry_base = carry_end = 0
        p = q = 0
        if t_first:
            x = t_first * tile
            p, _ = _count_below(lk, x, threads)
            q, _ = _count_below(cs, x, threads)
            assert p == np.searchsorted(lk, x) and q == np.searchsorted(cs, x)
            if p:
                carry_lane, carry_base = lk[p - 1], tb[p - 1]
            if q:
                carry_end = ce[q - 1]
        held = None
        for t in range(t_first, t_end):
            t0, tend = t * tile, min(t * tile + tile, N)
            tbase = np.zeros(tile, np.int64)
            cend = np.zeros(tile, np.int64)
            tmark = np.zeros(tile, bool)
            cmark = np.zeros(tile, bool)
            p = _chunks(lk, tb, p, t0, tend, threads, tbase, tmark)
            q = _chunks(cs, ce, q, t0, tend, threads, cend, cmark)
            st, tot_t = _slot_scan(tmark, threads)
            sc, tot_c = _slot_scan(cmark, threads)
            if held is not None:  # the tile before's last lane, in-chunk
                ln, flag, covered = held
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
                rank[ln] = (base_f + (ln - lane_f)
                            if valid and (in_surv or has_tok) else N)
                flag = valid and rank[ln] < N and vc[ln] == 0 and not killed
                last = k == 3 and tid == threads - 1
                if last and t + 1 < t_end:  # held for the chunk's next tile
                    held = (ln, flag, in_surv)
                    continue
                if last and t + 1 == t_end < T:  # lane + 1 from the row
                    edge_lanes.append(ln)
                vis[ln] = flag and not kill_by_next(ln, in_surv)
                done[ln] = True
            if tot_t >= 0:
                carry_lane, carry_base = t0 + tot_t, tbase[tot_t]
            if tot_c >= 0:
                carry_end = cend[tot_c]
        assert held is None
    assert done.all()
    return rank.astype(np.int32), vis, edge_lanes


def _check_chunks(ins, tile, chunk_tiles):
    """Model, plain version and (N a multiple of 128) the Pallas kernel
    agree on every row; returns the model's chunk-edge lanes of row 0."""
    ins = tuple(np.asarray(x) for x in ins)
    B, N = ins[4].shape
    rank, vis = fphase.fphase_expand_plain(*(_t(x) for x in ins))
    refs = [(rank.numpy(), vis.numpy())]
    if N % 128 == 0:
        r, v = jax.vmap(pallas_fphase.fphase_expand)(
            *(jnp.asarray(x) for x in ins))
        refs.append((np.asarray(r), np.asarray(v)))
    edges = None
    for row in range(B):
        m_rank, m_vis, e = _fphase_chunk_model_row([x[row] for x in ins],
                                                   tile, chunk_tiles)
        edges = e if edges is None else edges
        for want_r, want_v in refs:
            assert np.array_equal(m_rank, want_r[row]), (N, tile, row)
            assert np.array_equal(m_vis, want_v[row]), (N, tile, row)
    return edges


@pytest.mark.parametrize("chunk_tiles", [1, 3])
@pytest.mark.parametrize("tag", list(F_CASES))
def test_chunk_model_on_edge_rows(tag, chunk_tiles):
    """The row walk's edge rows at tiles of 64 lanes: ragged rows, no
    tokens, lanes 0 and N - 1, a tile of tokens, segments over tiles (and
    chunks), a kill across a tile edge (at chunks of one tile, a chunk
    edge), S = 1, B = 1."""
    tile = 64
    B, N, U, S, kind = F_CASES[tag]
    if kind == "full tile":
        U = max(U, tile + 64)
    rng = np.random.default_rng(N + U + S + tile)
    ins = fphase_inputs(rng, B, N, U, S, kind, tile)
    edges = _check_chunks(ins, tile, chunk_tiles)
    T = -(-N // tile)
    assert len(edges) == (T - 1) // chunk_tiles
    if kind == "tile-edge kill" and chunk_tiles == 1:
        assert tile_edge_killed(torch, ins, tile)  # across chunk edges
        assert {tile - 1, 2 * tile - 1} <= set(edges)


@pytest.mark.parametrize("tile,chunk_tiles,B,N", [
    (64, 1, 3, 700), (64, 2, 1, 1000), (64, 3, 2, 1601),
    (1024, 1, 1, 3 * 1024 + 3), (1024, 2, 2, 7 * 1024)])
def test_chunk_model_at_chunk_edges(tile, chunk_tiles, B, N):
    """A token on every chunk's first lane, a segment over the first two
    chunk edges, and the lane before each of those edges visible but for
    a tombstone on the chunk's first lane: the kill comes out as across
    a tile edge."""
    chunk = tile * chunk_tiles
    U = -(-N // chunk) + 40
    rng = np.random.default_rng(N + chunk)
    ins = fphase_inputs(rng, B, N, U, 6, "chunk edges", chunk)
    for row in ins[0]:
        assert np.isin(np.arange(0, N, chunk), row).all()
    assert tile_edge_killed(torch, ins, chunk)
    edges = _check_chunks(ins, tile, chunk_tiles)
    assert {chunk - 1, 2 * chunk - 1} <= set(edges)


@pytest.mark.parametrize("chunk_tiles", [1, 2])
@pytest.mark.parametrize("B,nb,nd,cap,he", [
    (3, 120, 40, 256, 8),
    (2, 30, 10, 64, 3),
])
def test_chunk_model_on_pipeline_inputs(monkeypatch, B, nb, nd, cap, he,
                                        chunk_tiles):
    ins = _pipeline_f_inputs(monkeypatch, B, nb, nd, cap, he)
    _check_chunks(tuple(x.numpy() for x in ins), 64, chunk_tiles)


@pytest.mark.parametrize("N,U,S,chunk_tiles", [
    (256, 64, 16, 1), (384, 200, 150, 2), (2176, 600, 90, 3),
    (2176, 2000, 500, 1)])
def test_chunk_model_on_random_inputs(N, U, S, chunk_tiles):
    rng = np.random.default_rng(N + U + S + chunk_tiles)
    ins = _synthetic_f_inputs(rng, 3, N, U, S)
    _check_chunks(tuple(x.numpy() for x in ins), 64, chunk_tiles)


@pytest.mark.parametrize("n,threads", [(1, 256), (300, 256), (1 << 20, 256),
                                       (1000, 16), (17, 16)])
def test_block_search_counts_in_few_rounds(n, threads):
    """The search gives searchsorted's count for every x (sentinels at
    the end included), in ceil(log_threads(n)) + 1 rounds at most: three
    for a million entries at 256 threads."""
    rng = np.random.default_rng(n)
    a = np.sort(rng.integers(0, 4 * n, size=n))
    a[-max(1, n // 10):] = 4 * n  # the N sentinels past the kept prefix
    most = 0
    for x in np.r_[0, 1, a[:50], a[-1], 4 * n + 1, rng.integers(0, 4 * n,
                                                                   40)]:
        got, rounds = _count_below(a, x, threads)
        assert got == np.searchsorted(a, x)
        most = max(most, rounds)
    assert most <= int(np.ceil(np.log(max(n, 2)) / np.log(threads))) + 1


# ---------------------------------------------------------------- rules


# K -> walk_form on an H100 (227 KB of shared memory a block)
H100_SMEM = 232448
WALK_FORMS = {
    1_152_002: "split", 1_025_536: "split", 32768: "split", 32767: "split",
    17000: "split", 16600: "row", 16384: "row", 8192: "row", 4096: "row",
    1: "row",
}


@pytest.mark.parametrize("K", list(WALK_FORMS))
def test_walk_form_rule(K):
    assert euler.walk_form(K, H100_SMEM) == WALK_FORMS[K]


# (B, N) -> fphase_form on an H100
FPHASE_FORMS = {
    (1, 10_485_760): "chunk", (1, 131072): "chunk", (66, 131072): "chunk",
    (67, 131072): "row", (1, 8192): "chunk", (1, 7169): "chunk",
    (1, 7168): "row", (1, 1000): "row", (1024, 20480): "row",
    (32, 20480): "chunk", (4096, 40960): "row",
}


@pytest.mark.parametrize("B,N", list(FPHASE_FORMS))
def test_fphase_form_rule(B, N):
    assert fphase.fphase_form(B, N, H100_SMS) == FPHASE_FORMS[(B, N)]


def _define(name, src):
    text = (kernels.CSRC / src).read_text()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


def test_form_constants_match_the_kernels():
    """The rules' constants are the ones the ``.cu`` files compile with:
    the row form's shared memory (``walk_row_bytes``) is what the kernel
    asks at its launch, and a chunk is as wide as the kernel's."""
    assert _define("CAUSE_WALK_THREADS", "euler_walk.cu") == \
        euler.WALK_THREADS
    assert _define("CAUSE_WALK_LOG_STRIDE", "euler_walk.cu") == \
        euler.WALK_LOG_STRIDE
    assert _define("CAUSE_F_CHUNK_TILES", "fphase.cu") == fphase.F_CHUNK_TILES
    assert (_define("CAUSE_F_THREADS", "fphase.cu")
            * _define("CAUSE_F_ITEMS", "fphase.cu")) == fphase.F_TILE
    # walk_words(K, NS) int32 + 2K uint16 + the static reduction buffer
    for K, ns in ((1, 1), (4096, 256), (16384, 1024), (16385, 2048)):
        assert euler.walk_row_bytes(K) == \
            (2 * K + 4 * ns) * 4 + 2 * K * 2 + 256 // 32 * 4


def test_form_arguments_on_cpu_tensors():
    """On CPU tensors the forms' wrappers refuse (they launch or raise)
    and the dispatching wrappers take the plain versions, whatever the
    shape."""
    x = torch.zeros((1, 16384), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        euler.euler_walk_cuda(x, x, x, x, form="split")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fphase.fphase_expand_cuda(x, x, x, x, x, x, x, form="chunk")
    kernels.reset_launches()
    m1 = torch.full_like(x, -1)
    base = euler.euler_walk(m1, m1, m1, x)
    assert (base == 0).all()
    assert kernels.launches["euler_walk"] == 0
