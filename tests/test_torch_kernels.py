"""The port's three kernel modules against the JAX package.

B1 (the row sort), B2 (the contracted-forest walk) and B3 (the F-phase
lane expansion): on the CPU each port wrapper takes its plain PyTorch
version, which is held against the JAX package's Pallas kernel (run in
interpret mode, as the JAX package's own tests run it here) and
against the XLA reference the Pallas kernel replaces. The algorithms of
the B1 and B2 CUDA kernels, which run only on the card, are modelled
here in numpy step for step (``_radix_model``: range compression,
composite packing, per-row pass count, stable 8-bit LSD passes with the
kernel's per-warp ranking; ``_ruling_set_model``: the Euler tour's
successors, splitters, sublist walks, the splitter chain, the reached
sublists' stamps) and held against the same references. Inputs are made
with numpy from fixed seeds. Every value is an integer or a flag, so
every comparison is EXACT (``np.array_equal``), no tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

import torch

from cause_tpu.weaver import jaxw, pallas_fphase, pallas_ops
from cause_tpu.weaver.pallas_sort import pallas_bitonic_sort

from cause_tpu_torch import benchgen as tbench
from cause_tpu_torch.weaver import euler, fphase
from cause_tpu_torch.weaver.bitonic import sort_pairs, sort_pairs_plain
from cause_tpu_torch.weaver import torchw5
from cause_tpu_torch.weaver.torchw5 import batched_merge_weave_v5

I32_MAX = np.iinfo(np.int32).max


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------------------------- B1


def _sort_operands(rng, B, n, n_ops, num_keys):
    ops = []
    for i in range(n_ops):
        if i < num_keys:
            # narrow ranges force duplicate keys; negatives (the -hc
            # key of the v5 sibling sort) and I32_MAX sentinels mixed in
            x = rng.integers(-4, 5, size=(B, n)).astype(np.int32)
            x[rng.random((B, n)) < 0.15] = I32_MAX
        else:
            x = rng.integers(-(2 ** 31), 2 ** 31 - 1, size=(B, n),
                             dtype=np.int64).astype(np.int32)
        ops.append(x)
    return ops


# (n_ops, num_keys) of every v5 sort site (jaxw5.py:197, 370, 503, 546,
# 587, 616: 3/2, 7/2, 3/2, 2/1, 3/1, 2/1) plus the interface's extremes
SORT_SITES = [(3, 2), (7, 2), (2, 1), (3, 1), (1, 1), (9, 3)]


def _sort_case(n_ops, num_keys, n, B=3):
    rng = np.random.default_rng(1000 * n_ops + 10 * num_keys + n)
    ops = _sort_operands(rng, B, n, n_ops, num_keys)
    got = sort_pairs([_t(x) for x in ops], num_keys=num_keys)
    for g in got:
        assert g.dtype == torch.int32
    return ops, got


@pytest.mark.parametrize("n_ops,num_keys", SORT_SITES)
@pytest.mark.parametrize("n", [5, 100, 128, 300])
def test_sort_matches_stable_lax_sort(n_ops, num_keys, n):
    ops, got = _sort_case(n_ops, num_keys, n)
    want = lax.sort(tuple(jnp.asarray(x) for x in ops),
                    num_keys=num_keys, is_stable=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


# the Pallas kernel in interpret mode compiles once per shape: one
# width per site, non-powers of two among them (padded rows)
@pytest.mark.parametrize("n_ops,num_keys,n", [
    (3, 2, 300), (7, 2, 100), (2, 1, 128), (3, 1, 300), (1, 1, 5),
    (9, 3, 100),
])
def test_sort_matches_pallas(n_ops, num_keys, n):
    ops, got = _sort_case(n_ops, num_keys, n)
    want = pallas_bitonic_sort(tuple(jnp.asarray(x) for x in ops),
                               num_keys=num_keys)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_sort_all_sentinel_keys_keep_original_order():
    """Rows whose keys are all I32_MAX (padding-like) keep their
    payloads in input order: the position key breaks every tie."""
    B, n = 2, 37
    keys = np.full((B, n), I32_MAX, np.int32)
    pay = np.arange(B * n, dtype=np.int32).reshape(B, n)
    k_out, p_out = sort_pairs((_t(keys), _t(pay)), num_keys=1)
    assert np.array_equal(p_out.numpy(), pay)
    assert np.array_equal(k_out.numpy(), keys)


def test_sort_wrapper_is_plain_on_cpu():
    rng = np.random.default_rng(7)
    ops = [_t(x) for x in _sort_operands(rng, 2, 50, 3, 2)]
    for a, b in zip(sort_pairs(ops, 2), sort_pairs_plain(ops, 2)):
        assert torch.equal(a, b)


# ------------------------------------------------- B1: the radix model

I32_MIN = np.iinfo(np.int32).min


def _radix_range(k):
    """(mn, mx1, bits) of one key of a row, padding included: codes are
    ``k - mn`` with INT32_MAX at ``mx1 = mx + 1`` (mx the largest other
    key); ``bits`` is the bit length of the largest code."""
    k = k.astype(np.int64)
    other = k[k != I32_MAX]
    if other.size == 0:  # every key INT32_MAX: one code, no bits
        return int(I32_MAX), int(I32_MAX), 0
    mn, mx = int(k.min()), int(other.max())
    top = (mx + 1 if (k == I32_MAX).any() else mx) - mn
    return mn, mx + 1, top.bit_length()


def _radix_code(k, rng_):
    mn, mx1, _ = rng_
    k = k.astype(np.int64)
    return (np.where(k == I32_MAX, mx1, k) - mn).astype(np.uint64)


def _radix_decode(c, rng_):
    mn, mx1, _ = rng_
    v = c.astype(np.int64) + mn
    return np.where(v == mx1, I32_MAX, v).astype(np.int32)


def _radix_row(keys, ipt=8):
    """One row through the kernel's steps: ``keys`` is [num_keys, P]
    (padding included). Returns (sorted keys, positions, passes,
    composite bits)."""
    nk, P = keys.shape
    ranges = [_radix_range(keys[q]) for q in range(nk)]
    bits1 = ranges[-1][2] if nk == 2 else 0
    bits = sum(r[2] for r in ranges)
    key = _radix_code(keys[0], ranges[0])
    if nk == 2:
        key = (key << np.uint64(bits1)) | _radix_code(keys[1], ranges[1])
    pos = np.arange(P)
    chunk = 32 * ipt            # a warp's elements, warp-striped
    warp = np.arange(P) // chunk
    W = int(warp[-1]) + 1
    passes = 0
    for shift in range(0, bits, 8):
        d = ((key >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
        # rank among the warp's earlier elements of the same digit
        hist = np.zeros((W, 256), np.int64)
        rank = np.empty(P, np.int64)
        for p in range(P):
            rank[p] = hist[warp[p], d[p]]
            hist[warp[p], d[p]] += 1
        warp_excl = np.cumsum(hist, axis=0) - hist
        tot = hist.sum(axis=0)
        digit_excl = np.cumsum(tot) - tot
        dst = digit_excl[d] + warp_excl[warp, d] + rank
        assert sorted(dst.tolist()) == list(range(P))
        key2, pos2 = np.empty_like(key), np.empty_like(pos)
        key2[dst], pos2[dst] = key, pos
        key, pos = key2, pos2
        passes += 1
    if nk == 2:
        mask = np.uint64((1 << bits1) - 1)
        codes = [key >> np.uint64(bits1), key & mask]
    else:
        codes = [key]
    out = [_radix_decode(codes[q], ranges[q]) for q in range(nk)]
    return out, pos, passes, bits


def _radix_model(ops, num_keys):
    """The radix path of ``csrc/sort.cu`` in numpy: rows padded to
    P = next_pow2(n) with INT32_MAX keys, sorted by ``_radix_row``, the
    payloads gathered by final position. Returns (outputs, passes per
    row, composite bits per row)."""
    B, n = ops[0].shape
    P = 1 << max(0, (n - 1).bit_length())
    outs = [np.empty_like(x) for x in ops]
    passes, bits = [], []
    for r in range(B):
        keys = np.full((num_keys, P), I32_MAX, np.int32)
        for q in range(num_keys):
            keys[q, :n] = ops[q][r]
        ks, pos, npass, nbits = _radix_row(keys, 16 if P > 4096 else 8)
        assert (pos[:n] < n).all()  # padding sorts last
        for q in range(num_keys):
            outs[q][r] = ks[q][:n]
        for q in range(num_keys, len(ops)):
            outs[q][r] = ops[q][r][pos[:n]]
        passes.append(npass)
        bits.append(nbits)
    return outs, passes, bits


def _radix_keys(rng, kind, B, n):
    """Key columns that reach the radix path's corners."""
    if kind == "lane":        # a lane key: [0, N] or the BIG sentinel
        x = rng.integers(0, 20481, size=(B, n))
        x[rng.random((B, n)) < 0.2] = I32_MAX
        return [x.astype(np.int32)]
    if kind == "sibling":     # (parent * 2 + special, -hc)
        par = rng.integers(0, 2 * 64 + 2, size=(B, n))
        hc = -rng.integers(0, 256, size=(B, n))
        return [par.astype(np.int32), hc.astype(np.int32)]
    if kind == "extremes":    # INT32_MIN beside INT32_MAX: 32-bit codes
        x = rng.choice(np.array([I32_MIN, I32_MIN + 1, -1, 0, 1,
                                 I32_MAX - 1, I32_MAX], np.int64),
                       size=(B, n))
        return [x.astype(np.int32)]
    if kind == "wide":        # two full-range keys: a 64-bit composite
        return [rng.integers(I32_MIN, I32_MAX, size=(B, n), dtype=np.int64,
                             endpoint=True).astype(np.int32),
                rng.integers(-3, 3, size=(B, n)).astype(np.int32) * (1 << 29)]
    if kind == "equal":       # every key equal: zero passes
        return [np.full((B, n), 7, np.int32), np.full((B, n), -5, np.int32)]
    if kind == "all_max":     # every key INT32_MAX, as padding
        return [np.full((B, n), I32_MAX, np.int32)]
    raise ValueError(kind)


RADIX_CASES = [("lane", 300), ("lane", 256), ("sibling", 200),
               ("extremes", 257), ("wide", 300), ("equal", 256),
               ("equal", 100), ("all_max", 37)]


@pytest.mark.parametrize("kind,n", RADIX_CASES)
def test_radix_model_matches_pallas_and_lax_sort(kind, n):
    rng = np.random.default_rng(len(kind) * 1000 + n)
    B = 3
    keys = _radix_keys(rng, kind, B, n)
    pay = rng.integers(I32_MIN, I32_MAX, size=(B, n), dtype=np.int64,
                       endpoint=True).astype(np.int32)
    ops = keys + [pay, np.broadcast_to(np.arange(n, dtype=np.int32),
                                       (B, n)).copy()]
    nk = len(keys)
    got, passes, bits = _radix_model(ops, nk)
    want_lax = lax.sort(tuple(jnp.asarray(x) for x in ops), num_keys=nk,
                        is_stable=True)
    want_pal = pallas_bitonic_sort(tuple(jnp.asarray(x) for x in ops),
                                   num_keys=nk)
    for g, wl, wp in zip(got, want_lax, want_pal):
        assert np.array_equal(g, np.asarray(wl))
        assert np.array_equal(g, np.asarray(wp))
    # the per-row pass count follows the data
    assert passes == [-(-b // 8) for b in bits]
    if kind == "all_max" or (kind == "equal" and n == 256):
        assert passes == [0] * B  # no padding: every key equal
    if kind == "lane":
        assert max(bits) <= 16 and max(passes) <= 2
    if kind == "sibling":
        assert max(bits) <= 17 and max(passes) <= 3
    if kind == "extremes":
        assert bits == [32] * B and passes == [4] * B
    if kind == "wide":
        assert min(bits) > 32 and max(passes) == 8


def test_radix_model_at_the_doubled_budget_width():
    """P = 8192 (the retry's rows): 16 items a thread, two keys."""
    rng = np.random.default_rng(8192)
    B, n = 1, 5000
    keys = _radix_keys(rng, "sibling", B, n)
    ops = keys + [rng.integers(0, 9, size=(B, n)).astype(np.int32)]
    got, passes, bits = _radix_model(ops, 2)
    want = lax.sort(tuple(jnp.asarray(x) for x in ops), num_keys=2,
                    is_stable=True)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    assert bits == [17] and passes == [3]  # 8 + 9 bits (padding's code)


# ----------------------------------------------------------------- B2


def _forest(rng, B, K, n_valid):
    """Run tables shaped as the v5 kernel builds them: ``n_valid``
    reachable runs (run 0 the root, each later run parented to an
    earlier one, sibling order special-first then by descending head),
    and ``K - n_valid`` invalid slots (parent -1, weight 0) that the walk
    never reaches."""
    parent_sort = np.full((B, K), K, np.int32)
    special = rng.random((B, K)) < 0.3
    w = np.zeros((B, K), np.int32)
    for r in range(B):
        for i in range(1, n_valid):
            parent_sort[r, i] = rng.integers(0, i)
        w[r, :n_valid] = rng.integers(0, 6, size=n_valid)
    packed = parent_sort * 2 + (~special).astype(np.int32)
    head = np.broadcast_to(np.arange(K, dtype=np.int32), (B, K))
    order = np.stack([np.lexsort((-head[r], packed[r])) for r in range(B)])
    parent_up = np.where(parent_sort < K, parent_sort, -1).astype(np.int32)
    return order.astype(np.int32), parent_sort, parent_up, w


@pytest.mark.parametrize("K,n_valid", [(8, 8), (64, 40), (128, 1),
                                       (256, 200)])
def test_walk_matches_pallas_and_doubling(K, n_valid):
    rng = np.random.default_rng(K * 7 + n_valid)
    B = 4
    order, parent_sort, parent_up, w = _forest(rng, B, K, n_valid)

    fc, ns = euler.link_children(_t(order), _t(parent_sort))
    fc_j, ns_j = jax.vmap(jaxw._link_children)(jnp.asarray(order),
                                               jnp.asarray(parent_sort))
    assert np.array_equal(fc.numpy(), np.asarray(fc_j))
    assert np.array_equal(ns.numpy(), np.asarray(ns_j))

    got = euler.euler_walk(fc, ns, _t(parent_up), _t(w))
    args = tuple(jnp.asarray(x) for x in
                 (fc.numpy(), ns.numpy(), parent_up, w))
    want_walk = jax.vmap(
        lambda a, b, c, d: pallas_ops.euler_walk(a, b, c, d, K))(*args)
    want_dbl = jax.vmap(lambda a, b, c, d: jaxw._euler_rank(a, b, c, d)[0])(
        *args)
    assert np.array_equal(got.numpy(), np.asarray(want_walk))
    # the doubling agrees on every reached run; unreached (invalid) runs
    # keep the row's total weight, as the walk leaves them
    assert np.array_equal(got.numpy()[:, :n_valid],
                          np.asarray(want_dbl)[:, :n_valid])
    total = w.sum(axis=1, keepdims=True)
    assert np.array_equal(got.numpy()[:, n_valid:],
                          np.broadcast_to(total, (B, K - n_valid)))


def _walk_hash(K, log_stride):
    """The kernel's splitters: slot s is splitter ``s * A mod M`` when
    that is below NS (M = next_pow2(2K), A odd, about M / golden ratio);
    splitter j sits at slot ``j * A^-1 mod M``."""
    M = 1 << (2 * K - 1).bit_length()
    a = ((M * 0x9E3779B9) >> 32) | 1
    a_inv = pow(a, -1, M) if M > 1 else 0
    return M, a, a_inv, max(1, M >> log_stride)


def _ruling_set_model(fc, ns, parent, w, log_stride=2):
    """The list ranking of ``csrc/euler_walk.cu`` in numpy, one row at a
    time: the tour's successors (>= 2K is END), one slot in
    ``2 ** log_stride`` a splitter (``_walk_hash``), each sublist's
    weight and next splitter (walks capped at 2K steps), the serial
    splitter chain from d(0), and the reached sublists walked again to
    stamp their d-slots. Sums wrap as uint32."""
    B, K = fc.shape
    two_k = 2 * K
    M, a, a_inv, NS = _walk_hash(K, log_stride)
    assert (a * a_inv) % M == 1 % M

    def splitter(slot):
        return (slot * a) % M

    base = np.empty((B, K), np.int32)
    for r in range(B):
        succ = np.empty(two_k, np.int64)
        for i in range(K):
            f, s, p = int(fc[r, i]), int(ns[r, i]), int(parent[r, i])
            succ[i] = K + i if f < 0 else (f if f < K else two_k)
            succ[K + i] = ((s if s < K else two_k) if s >= 0 else
                           (K + p if 0 <= p < K else two_k))
        wgt = w[r].astype(np.uint32)
        total = np.uint32(wgt.sum(dtype=np.uint64) & 0xFFFFFFFF)
        out = np.full(K, total, np.uint32)
        sums = np.zeros(NS, np.uint32)
        nxt = np.full(NS, -1, np.int64)
        for j in range(NS):
            cur, acc = (j * a_inv) % M, np.uint32(0)
            for steps in range(1, two_k + 1):
                if cur >= two_k:  # an id past the tour: empty
                    break
                if cur < K:
                    acc = np.uint32(acc + wgt[cur])
                cur = int(succ[cur])
                if cur >= two_k:
                    break
                if splitter(cur) < NS:
                    nxt[j] = splitter(cur)
                    break
            sums[j] = acc
        pref = np.zeros(NS, np.uint32)
        reach = np.zeros(NS, bool)
        j, before = 0, np.uint32(0)
        for _ in range(NS):
            if j < 0:
                break
            pref[j], reach[j] = before, True
            before = np.uint32(before + sums[j])
            j = int(nxt[j])
        for j in np.flatnonzero(reach):
            cur, acc = (j * a_inv) % M, pref[j]
            for steps in range(1, two_k + 1):
                if cur < K:
                    out[cur] = acc
                    acc = np.uint32(acc + wgt[cur])
                cur = int(succ[cur])
                if cur >= two_k or splitter(cur) < NS:
                    break
        base[r] = out.view(np.int32)
    return base


def _parent_forest(parent_of, w):
    """Run tables of a forest given each run's parent (-1 for the root
    and invalid runs), children in index order, as ``link_children``
    builds them."""
    B, K = parent_of.shape
    parent_sort = np.where(parent_of >= 0, parent_of, K).astype(np.int32)
    order = np.stack([np.lexsort((np.arange(K), parent_sort[r]))
                      for r in range(B)]).astype(np.int32)
    fc, ns = euler.link_children(_t(order), _t(parent_sort))
    return fc.numpy(), ns.numpy(), parent_of.astype(np.int32), w


def _shaped_forest(rng, shape, B, K):
    w = rng.integers(0, 6, size=(B, K)).astype(np.int32)
    par = np.full((B, K), -1, np.int64)
    if shape == "chain":        # parent i - 1: the deepest tour
        par[:, 1:] = np.arange(K - 1)
    elif shape == "star":       # every run a child of the root
        par[:, 1:] = 0
    elif shape == "two_chains":  # one chain on even ids, one on odd
        par[:, 1:] = np.maximum(np.arange(1, K) - 2, 0)
    elif shape == "root_only":  # only run 0 valid
        w[:, 1:] = 0
    return _parent_forest(par, w)


def _check_ruling_set(fc, ns, parent, w, log_stride):
    K = fc.shape[1]
    got = _ruling_set_model(fc, ns, parent, w, log_stride)
    args = tuple(jnp.asarray(x) for x in (fc, ns, parent, w))
    want = jax.vmap(
        lambda a, b, c, d: pallas_ops.euler_walk(a, b, c, d, K))(*args)
    assert np.array_equal(got, np.asarray(want))
    # and the port's plain version, the CPU path
    plain = euler.euler_walk(*(_t(x) for x in (fc, ns, parent, w)))
    assert np.array_equal(got, plain.numpy())


@pytest.mark.parametrize("K,n_valid,log_stride", [
    (8, 8, 1), (64, 40, 2), (128, 1, 3), (256, 200, 4)])
def test_ruling_set_model_matches_pallas_walk(K, n_valid, log_stride):
    rng = np.random.default_rng(K * 13 + n_valid)
    order, parent_sort, parent_up, w = _forest(rng, 3, K, n_valid)
    fc, ns = euler.link_children(_t(order), _t(parent_sort))
    _check_ruling_set(fc.numpy(), ns.numpy(), parent_up, w, log_stride)


@pytest.mark.parametrize("shape,K,log_stride", [
    ("chain", 64, 2), ("star", 64, 2), ("root_only", 32, 1),
    ("chain", 1, 5), ("star", 48, 4), ("two_chains", 96, 3)])
def test_ruling_set_model_on_shaped_forests(shape, K, log_stride):
    rng = np.random.default_rng(K + len(shape))
    _check_ruling_set(*_shaped_forest(rng, shape, 2, K), log_stride)


def _tour_succ(fc, ns, parent):
    """One row's tour successors, as the kernel builds them (>= 2K is
    END)."""
    K = fc.shape[0]
    i = np.arange(K)
    d = np.where(fc < 0, K + i, np.where(fc < K, fc, 2 * K))
    u = np.where(ns >= 0, np.where(ns < K, ns, 2 * K),
                 np.where((parent >= 0) & (parent < K), K + parent, 2 * K))
    return np.concatenate([d, u])


def _longest_sublist(succ, is_splitter):
    """The most slots between two splitters on the list from d(0)."""
    cur, run, longest = 0, 0, 0
    while cur < len(succ):
        if is_splitter(cur):
            run = 0
        run += 1
        longest = max(longest, run)
        cur = int(succ[cur])
    return longest


def test_hashed_splitters_cut_the_north_stars_interleaved_chains(
        monkeypatch):
    """The north star's forests interleave two replicas' run chains, one
    on even and one on odd run ids, and the odd chain's tour slots hold
    no multiple of any power of two: splitters at every 32nd slot index
    leave that chain in one sublist, the kernel's hashed splitters
    (``_walk_hash``) cut it into sublists of a few strides."""
    seen = []

    def record(*args):
        seen.append([x.numpy() for x in args])
        return euler.euler_walk_plain(*args)

    monkeypatch.setattr(torchw5, "euler_walk", record)
    batch = tbench.batched_pair_lanes(2, 9000, 1000, 10240, hide_every=8)
    v5 = tbench.batched_v5_inputs(batch, 10240)
    u = 1 << (tbench.v5_token_budget(v5) - 1).bit_length()
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    batched_merge_weave_v5(*(lanes[k] for k in tbench.LANE_KEYS5),
                           u_max=u, k_max=u, device="cpu")
    fc, ns, parent, _ = seen[0]
    K = fc.shape[1]
    assert K == 4096
    M, a, _, NS = _walk_hash(K, 5)
    for r in range(fc.shape[0]):
        succ = _tour_succ(fc[r], ns[r], parent[r])
        assert _longest_sublist(succ, lambda s: s % 32 == 0) > 1000
        assert _longest_sublist(succ, lambda s: (s * a) % M < NS) <= 128


def test_euler_rank_subtree_sizes_match_jax():
    rng = np.random.default_rng(11)
    order, parent_sort, parent_up, w = _forest(rng, 3, 32, 20)
    fc, ns = euler.link_children(_t(order), _t(parent_sort))
    rank, size = euler.euler_rank(fc, ns, _t(parent_up), _t(w))
    rj, sj = jax.vmap(jaxw._euler_rank)(
        *(jnp.asarray(x) for x in (fc.numpy(), ns.numpy(), parent_up, w)))
    assert np.array_equal(rank.numpy(), np.asarray(rj))
    assert np.array_equal(size.numpy(), np.asarray(sj))


# ----------------------------------------------------------------- B3


def _pipeline_f_inputs(monkeypatch, B, nb, nd, cap, he):
    """Phase F's inputs as the port's v5 pipeline builds them, recorded
    at its call of ``fphase_expand``."""
    seen = []

    def record(*args):
        seen.append(args)
        return fphase.fphase_expand_plain(*args)

    monkeypatch.setattr(torchw5, "fphase_expand", record)
    batch = tbench.batched_pair_lanes(B, nb, nd, cap, hide_every=he)
    v5 = tbench.batched_v5_inputs(batch, cap)
    u = tbench.v5_token_budget(v5)
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    out = batched_merge_weave_v5(*(lanes[k] for k in tbench.LANE_KEYS5),
                                 u_max=u, k_max=u, device="cpu")
    assert not out[3].any() and len(seen) == 1
    return seen[0]


def _synthetic_f_inputs(rng, B, N, U, S):
    """Random inputs meeting phase F's invariants: kept-token lanes
    distinct and ascending (N sentinels after), coverage segments
    disjoint with sorted starts (sentinel start N, end 0)."""
    lk = np.full((B, U), N, np.int32)
    tb = np.zeros((B, U), np.int32)
    cs = np.full((B, S), N, np.int32)
    ce = np.zeros((B, S), np.int32)
    for r in range(B):
        k = int(rng.integers(0, min(U, N) + 1))
        lk[r, :k] = np.sort(rng.choice(N, size=k, replace=False))
        tb[r, :k] = rng.integers(0, N, size=k)
        cuts = np.sort(rng.choice(np.arange(1, N), size=2 * min(S, N // 4),
                                  replace=False))
        segs = cuts.reshape(-1, 2)
        keep = segs[rng.random(len(segs)) < 0.6][:S]
        cs[r, :len(keep)] = keep[:, 0]
        ce[r, :len(keep)] = keep[:, 1]
    vc = rng.choice(np.array([0, 0, 0, 1, 2, 3], np.int32), size=(B, N))
    seg = np.sort(rng.integers(-1, N // 8, size=(B, N)), axis=1).astype(
        np.int32)
    flags = rng.integers(0, 4, size=(B, N)).astype(np.int32)
    return tuple(_t(x) for x in (lk, tb, cs, ce, vc, seg, flags))


def _check_fphase(inputs):
    rank, vis = fphase.fphase_expand(*inputs)
    want_r, want_v = jax.vmap(pallas_fphase.fphase_expand)(
        *(jnp.asarray(x.numpy()) for x in inputs))
    assert np.array_equal(rank.numpy(), np.asarray(want_r))
    assert np.array_equal(vis.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("B,nb,nd,cap,he", [
    (3, 120, 40, 256, 8),
    (2, 30, 10, 64, 3),     # N = 128: one tile
])
def test_fphase_matches_pallas_on_pipeline_inputs(monkeypatch, B, nb, nd,
                                                  cap, he):
    _check_fphase(_pipeline_f_inputs(monkeypatch, B, nb, nd, cap, he))


@pytest.mark.parametrize("N,U,S", [(256, 64, 16), (384, 200, 150),
                                   (128, 300, 8)])
def test_fphase_matches_pallas_on_random_inputs(N, U, S):
    rng = np.random.default_rng(N + U + S)
    _check_fphase(_synthetic_f_inputs(rng, 3, N, U, S))
