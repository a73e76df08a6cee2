"""B1's wide form (``csrc/radix_wide.cuh``) modelled in numpy.

The wide form sorts the rows B1's cluster form cannot hold (past the
lanes a thread-block cluster keeps in shared memory) by stable LSD radix
passes spread over (row, tile) CTAs; it runs only on the card.
``_wide_model`` repeats its steps here: per-tile partial ranges (the
minimum, the largest key below INT32_MAX, whether INT32_MAX occurs)
reduced per row; the per-row plan (each key's code ``k - min`` with
INT32_MAX coded just above the largest other key, and its bit length;
keys packed greedily into words of at most 32 bits for one key and 64
for more, least significant key last; groups sorted least significant
first; a group's word carrying the row position in its low bits where
the group's bits and a position's fit, its digits then starting above
it); every launch of the host's fixed loop, a pass beyond the row's
plan a no-op; the row's digit totals of a group's first pass at its
start, and of each later pass from the pass before it as it writes out;
per pass each tile's digit counts and the look-back's sum over the row's
earlier tiles (equal to the exclusive scan over (digit, tile) that makes
the pass stable), the stable in-tile rank of warp-striped items (lanes
past the row's end ranked last under digit 255) and the coalesced
scatter from the staged tile; the ping-pong buffers' parity counted from
the plan; the final gather of the payloads by position and the last
group's keys decoded from its words. The model is held bit-equal to
``jax.lax.sort(..., is_stable=True)`` and to the port's
``sort_pairs_plain``, at small widths over 1-20 tiles and at real width,
and at small widths to the Pallas kernel in interpret mode.
The form rule (``b1_form``) is checked beside it, against a table, and
the form codes and bounds the wrapper passes against the ``#define``s
the library compiles with. Every value is an integer, so every
comparison is exact.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
from jax import lax

import torch

from cause_tpu.weaver.pallas_sort import pallas_bitonic_sort
from cause_tpu_torch import kernels
from cause_tpu_torch.weaver import bitonic, euler, fphase
from cause_tpu_torch.weaver.bitonic import (b1_form, sort_pairs,
                                            sort_pairs_plain)

I32_MAX = int(np.iinfo(np.int32).max)
I32_MIN = int(np.iinfo(np.int32).min)
THREADS, BINS = 256, 256
H100_SMEM = 232448  # the opt-in shared memory of an H100 block
WIDE_TILE = 4096    # csrc/radix_wide.cuh: CAUSE_WIDE_IPT x CAUSE_WIDE_THREADS


def _bits(top: int) -> int:
    return int(top).bit_length()


def _ranges(keys, starts):
    """Per key (row of ``keys``) the minimum, the largest key below
    INT32_MAX and whether INT32_MAX occurs, reduced over the slices that
    begin at ``starts`` and then over the slices: the partial ranges a
    tile (or a cluster's CTA) publishes and their reduction."""
    is_max = keys == I32_MAX
    part_mn = np.minimum.reduceat(keys, starts, axis=1)
    part_mx = np.maximum.reduceat(np.where(is_max, I32_MIN, keys), starts,
                                  axis=1)
    part_any = np.logical_or.reduceat(is_max, starts, axis=1)
    return (part_mn.min(axis=1).astype(np.int64),
            part_mx.max(axis=1).astype(np.int64), part_any.any(axis=1))


def _plan(keys, starts, limit):
    """One row's plan from its partial ranges (``wide_range`` and
    ``wide_groups_of``): per key the minimum, INT32_MAX's code point and
    the bit length; the bits of a row position; the groups (least
    significant first) as (first key, last key, passes, passes before,
    packed)."""
    nk, n = keys.shape
    mn, mx, any_max = _ranges(keys, starts)
    mx1, bits = [], []
    for q in range(nk):
        if mx[q] < mn[q]:              # every key INT32_MAX
            mn[q] = I32_MAX
            mx1.append(I32_MAX)
            bits.append(0)
            continue
        mx1.append(int(mx[q]) + 1)
        bits.append(_bits((mx[q] + 1 if any_max[q] else mx[q]) - mn[q]))
    pbits = _bits(n - 1)
    groups, total, q = [], 0, nk - 1
    while q >= 0:
        last, b = q, 0
        while q >= 0 and b + bits[q] <= limit:
            b += bits[q]
            q -= 1
        passes = -(-b // 8)
        groups.append((q + 1, last, passes, total, b + pbits <= limit))
        total += passes
    return {"mn": mn, "mx1": mx1, "bits": bits, "pbits": pbits,
            "groups": groups, "total": total}


def _wide_plan(keys, tile):
    return _plan(keys, np.arange(0, keys.shape[1], tile),
                 32 if keys.shape[0] == 1 else 64)


def _code(keys, plan, q, p):
    k = keys[q][p].astype(np.int64)
    k = np.where(k == I32_MAX, plan["mx1"][q], k)
    return (k - plan["mn"][q]).astype(np.uint64)


def _compose(keys, plan, group, p):
    """A group's words of the lanes at row positions ``p``: the codes
    of its keys, the position below them where the group is packed."""
    first, last, packed = group[0], group[1], group[4]
    x = np.zeros(p.shape, np.uint64)
    for q in range(first, last + 1):
        x = (x << np.uint64(plan["bits"][q])) | _code(keys, plan, q, p)
    if packed:
        x = (x << np.uint64(plan["pbits"])) | p.astype(np.uint64)
    return x


def _shift(plan, group):
    return plan["pbits"] if group[4] else 0


def _word_pos(w, plan):
    return (w & np.uint64((1 << plan["pbits"]) - 1)).astype(np.int64)


def _decode(plan, group, q, w):
    """Key q of ``group`` decoded from its words (``wide_key_of``)."""
    c = w >> np.uint64(_shift(plan, group))
    for q2 in range(group[1], q, -1):
        c = c >> np.uint64(plan["bits"][q2])
    code = (c & np.uint64((1 << plan["bits"][q]) - 1)).astype(np.int64)
    v = code + plan["mn"][q]
    v = np.where(v == plan["mx1"][q], I32_MAX, v)
    return v.astype(np.int32)


def _outputs(ops, num_keys, plan, final, word):
    """Every output of a sorted row (``wide_out_kind``): a payload or a
    key of an earlier group gathered at the ``final`` positions, a key
    of the last group decoded from its ``word``s, a key of no bits its
    one value."""
    g = plan["groups"][-1]
    outs = []
    for k, x in enumerate(ops):
        if k < num_keys and plan["bits"][k] == 0:
            outs.append(np.full(x.shape, plan["mn"][k], np.int32))
        elif k < num_keys and plan["total"] and g[0] <= k <= g[1]:
            outs.append(_decode(plan, g, k, word))
        else:
            outs.append(x[final])
    return outs


def _digit(c, bit):
    return ((c >> np.uint64(bit)) & np.uint64(255)).astype(np.int64)


def _scatter(c, p, bit, n, tile, total):
    """One digit pass of the row, given the row's digit ``total``s from
    its group's start: (a) each tile's digit counts and the look-back's
    sum of the earlier tiles' counts, so a (digit, tile)'s offset is the
    row's count of lower digits plus that sum, which is the exclusive
    scan over (digit, tile); (b) each tile's stable warp-level rank, its
    staging in local sorted order and the coalesced write-out. The digit
    starts at ``bit`` of the word. Returns the row's (words, positions)
    after the pass."""
    tiles = -(-n // tile)
    ipt = tile // THREADS
    dig = _digit(c, bit)
    t_of = np.arange(n) // tile
    cnt_t = np.bincount(t_of * BINS + dig,
                        minlength=tiles * BINS).reshape(tiles, BINS)
    assert np.array_equal(cnt_t.sum(axis=0), total)   # (a)
    dex = np.cumsum(total) - total
    prev = np.cumsum(cnt_t, axis=0) - cnt_t           # the look-back
    goff = dex[:, None] + prev.T                      # [digit, tile]
    flat = cnt_t.T.ravel()                            # digit-major
    assert np.array_equal(goff.ravel(), np.cumsum(flat) - flat)

    # (b) the tiles padded to `tile` lanes: past the row, digit 255
    pad = tiles * tile
    dpad = np.full(pad, 255, np.int64)
    dpad[:n] = dig
    e = np.arange(pad) % tile
    tpad = np.arange(pad) // tile
    warp = e // (32 * ipt)             # warp w holds a chunk of 32 * ipt
    W = tile // (32 * ipt)
    gid = (tpad * W + warp) * BINS + dpad
    order = np.argsort(gid, kind="stable")
    sg = gid[order]
    rank = np.empty(pad, np.int64)
    rank[order] = np.arange(pad) - np.searchsorted(sg, sg, side="left")
    cnt = np.bincount(gid, minlength=tiles * W * BINS).reshape(tiles, W, BINS)
    wpref = np.cumsum(cnt, axis=1) - cnt
    tot = cnt.sum(axis=1)
    loc = np.cumsum(tot, axis=1) - tot
    s = loc[tpad, dpad] + wpref[tpad, warp, dpad] + rank
    assert (np.sort(s.reshape(tiles, tile), axis=1) == np.arange(tile)).all()
    assert (s[:n] < np.minimum(tile, n - t_of * tile)).all()

    # staged in local sorted order, written out from there
    sc = np.zeros(pad, np.uint64)
    sp = np.zeros(pad, np.int64)
    sd = np.zeros(pad, np.int64)
    at = tpad * tile + s
    sc[at[:n]], sp[at[:n]], sd[at[:n]] = c, p, dig
    src = np.arange(n)                 # staged lane e of tile t, e < valid
    ts, es = src // tile, src % tile
    dst = goff[sd[src], ts] + es - loc[ts, sd[src]]
    assert np.array_equal(np.sort(dst), np.arange(n))
    out_c = np.empty(n, np.uint64)
    out_p = np.empty(n, np.int64)
    out_c[dst], out_p[dst] = sc[src], sp[src]
    return out_c, out_p


def _wide_row(keys, tile):
    """One row through every launch of the host's loop. Returns (final
    positions, plan, the positions each ping-pong buffer holds, the
    final words): a packed group's passes write words only, and its
    positions are the words' low bits."""
    nk, n = keys.shape
    plan = _wide_plan(keys, tile)
    comp = [np.zeros(n, np.uint64), np.zeros(n, np.uint64)]
    pos = [np.full(n, -1, np.int64), np.full(n, -1, np.int64)]
    n_groups = 1 if nk == 1 else -(-nk // 2)
    n_digits = 4 if nk == 1 else 8
    assert len(plan["groups"]) <= n_groups
    for g in range(n_groups):
        for d in range(n_digits):
            if g >= len(plan["groups"]) or d >= plan["groups"][g][2]:
                continue               # beyond the row's plan: a no-op
            group = plan["groups"][g]
            packed = group[4]
            bit = _shift(plan, group) + 8 * d
            pb = group[3] + d
            par = pb % 2
            if d == 0:                 # the group's first pass composes
                if pb == 0:
                    p = np.arange(n)
                elif plan["groups"][g - 1][4]:
                    p = _word_pos(comp[par], plan)
                else:
                    p = pos[par]
                c = _compose(keys, plan, group, p)
                total = np.bincount(_digit(c, bit), minlength=BINS)
            else:
                c = comp[par]
                p = np.zeros(n, np.int64) if packed else pos[par]
            comp[1 - par], out_p = _scatter(c, p, bit, n, tile, total)
            if not packed:
                pos[1 - par] = out_p
            if d + 1 < group[2]:       # counted as the pass writes out
                total = np.bincount(_digit(comp[1 - par], bit + 8),
                                    minlength=BINS)
    passes = plan["total"]
    last = plan["groups"][-1]
    held = [_word_pos(comp[b], plan) if last[4] else pos[b] for b in (0, 1)]
    final = np.arange(n) if passes == 0 else held[passes % 2]
    return final, plan, held, comp[passes % 2]


def _wide_model(ops, num_keys, tile):
    """The wide form over ``[B, n]`` operands: each row sorted by
    ``_wide_row``, then its outputs (``_outputs``: payloads gathered by
    final position, the last group's keys decoded). Returns (outputs,
    plans, the positions each row's buffers hold)."""
    B, n = ops[0].shape
    outs = [np.empty_like(x) for x in ops]
    plans, bufs = [], []
    for r in range(B):
        keys = np.stack([ops[q][r] for q in range(num_keys)])
        final, plan, held, word = _wide_row(keys, tile)
        for k, o in enumerate(_outputs([x[r] for x in ops], num_keys, plan,
                                       final, word)):
            outs[k][r] = o
        plans.append(plan)
        bufs.append(held)
    return outs, plans, bufs


def _key(rng, kind, B, n):
    """One key column of a kind ``chip_smoke.py``'s edge cases use."""
    if kind == "narrow":      # duplicates, INT32_MAX sentinels
        x = rng.integers(-4, 5, size=(B, n))
        x[rng.random((B, n)) < 0.15] = I32_MAX
    elif kind == "full":      # two of these: a 64-bit composite
        x = rng.integers(I32_MIN, I32_MAX, size=(B, n), dtype=np.int64,
                         endpoint=True)
    elif kind == "extremes":  # INT32_MIN beside INT32_MAX
        x = rng.choice(np.array([I32_MIN, I32_MIN + 1, -1, 0, 1,
                                 I32_MAX - 1, I32_MAX]), size=(B, n))
    elif kind == "equal":     # no bits: no pass
        x = np.full((B, n), -77)
    elif kind == "all_max":   # every key INT32_MAX
        x = np.full((B, n), I32_MAX)
    else:                     # a sibling key: 15 bits of parent
        x = rng.integers(0, 2 * 8192 + 2, size=(B, n))
    return x.astype(np.int32)


def _child_keys(rng, B, n):
    """``_child_sort``'s three keys (torchw.py): parent * 2 + not
    special, -hi, -lo; 9-18 + 25 + 31 bits, past one 64-bit composite."""
    parent = rng.integers(0, n + 1, size=(B, n))
    packed = parent * 2 + (rng.random((B, n)) >= 0.3)
    hi = rng.integers(0, 1 << 25, size=(B, n))
    lo = rng.integers(0, I32_MAX, size=(B, n))
    return [x.astype(np.int32) for x in (packed, -hi, -lo)]


def _operands(kind, num_keys, B, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "child":
        keys = _child_keys(rng, B, n)
    else:
        keys = [_key(rng, kind, B, n) for _ in range(num_keys)]
    pay = rng.integers(I32_MIN, I32_MAX, size=(B, n), dtype=np.int64,
                       endpoint=True).astype(np.int32)
    return keys + [pay, np.broadcast_to(np.arange(n, dtype=np.int32),
                                        (B, n)).copy()]


def _assert_sorted_like_references(ops, num_keys, got):
    want_lax = lax.sort(tuple(jnp.asarray(x) for x in ops),
                        num_keys=num_keys, is_stable=True)
    want_plain = sort_pairs_plain([torch.from_numpy(x) for x in ops],
                                  num_keys)
    for g, wl, wp in zip(got, want_lax, want_plain):
        assert np.array_equal(g, np.asarray(wl))
        assert np.array_equal(g, wp.numpy())


WIDE_CASES = [
    ("narrow", 1), ("narrow", 2), ("narrow", 3), ("narrow", 9),
    ("full", 1), ("full", 2), ("full", 3), ("full", 9),
    ("extremes", 1), ("extremes", 2), ("extremes", 9),
    ("equal", 1), ("equal", 2), ("equal", 3),
    ("all_max", 1), ("all_max", 3),
    ("sibling", 2), ("child", 3),
]


@pytest.mark.parametrize("n", [200, 1000, 5000])
@pytest.mark.parametrize("kind,num_keys", WIDE_CASES)
def test_wide_model_matches_lax_sort_and_plain(kind, num_keys, n):
    """1, 4 and 20 tiles of 256 lanes (one lane a thread), the last one
    ragged but at n = 1000 and 5000's ends."""
    ops = _operands(kind, num_keys, 2, n, seed=n * 100 + num_keys)
    got, plans, _ = _wide_model(ops, num_keys, tile=256)
    _assert_sorted_like_references(ops, num_keys, got)
    for plan in plans:
        assert plan["total"] == sum(g[2] for g in plan["groups"])
        if kind in ("equal", "all_max"):
            assert plan["total"] == 0 and plan["bits"] == [0] * num_keys
        if kind == "extremes":
            assert plan["bits"] == [32] * num_keys
        if kind == "full" and num_keys == 9:
            assert len(plan["groups"]) == 5  # the most the host launches
        if kind == "child":  # two groups, the first key on its own
            assert sum(plan["bits"]) > 64
            assert [g[:2] for g in plan["groups"]] == [(1, 2), (0, 0)]


@pytest.mark.parametrize("kind,num_keys,n", [
    ("narrow", 2, 900), ("extremes", 1, 777), ("child", 3, 600),
])
def test_wide_model_matches_the_pallas_kernel(kind, num_keys, n):
    """At small widths, against the TPU kernel itself in interpret mode
    (as ``tests/test_pallas_sort.py`` runs it): rows of 3-4 tiles of 256
    lanes, a packed group, a 32-bit one, and two groups."""
    ops = _operands(kind, num_keys, 2, n, seed=3 * n + num_keys)
    got, _, _ = _wide_model(ops, num_keys, tile=256)
    want = pallas_bitonic_sort(tuple(jnp.asarray(x) for x in ops),
                               num_keys=num_keys)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    _assert_sorted_like_references(ops, num_keys, got)


@pytest.mark.parametrize("tile", [256, 512, 1024])
def test_wide_model_tile_widths(tile):
    """Several warps' items a thread (512: two, 1024: four), ragged last
    tile, two keys whose composite needs 8 passes."""
    n = 3 * tile + 77
    ops = _operands("full", 2, 2, n, seed=tile)
    got, plans, _ = _wide_model(ops, 2, tile=tile)
    _assert_sorted_like_references(ops, 2, got)
    assert [p["total"] for p in plans] == [8, 8]


def test_wide_model_reads_the_buffer_its_plan_names():
    """A row of an odd number of passes ends in buffer 1, one of an even
    number in buffer 0; the other buffer holds the pass before the last
    one, which is not the sorted order. Reading by parity is what makes
    the result right."""
    rng = np.random.default_rng(3)
    n = 3000
    odd = rng.integers(0, 1 << 20, size=(1, n)).astype(np.int32)  # 3
    even = rng.integers(0, 1 << 16, size=(1, n)).astype(np.int32)  # 2
    for key, total in ((odd, 3), (even, 2)):
        final, plan, pos, _ = _wide_row(key, 256)
        assert plan["total"] == total
        assert np.array_equal(final, pos[total % 2])
        want = np.argsort(key[0], kind="stable")
        assert np.array_equal(final, want)
        assert not np.array_equal(pos[1 - total % 2], want)


@pytest.mark.parametrize("n,num_keys,kind", [
    (40960, 2, "full"), (131072, 1, "narrow"), (131072, 2, "sibling"),
    (40960, 3, "child"),
])
def test_wide_model_at_real_width(n, num_keys, kind):
    """Rows of the v1 sort-join's width (40,960) and of the tree's upper
    levels (131,072), at the card's tile, against np.lexsort."""
    ops = _operands(kind, num_keys, 1, n, seed=n + num_keys)
    got, plans, _ = _wide_model(ops, num_keys, tile=WIDE_TILE)
    order = np.lexsort(tuple(ops[q][0] for q in reversed(range(num_keys))))
    for g, x in zip(got, ops):
        assert np.array_equal(g[0], x[0][order])
    assert plans[0]["total"] <= (4 if num_keys == 1 else
                                 8 * -(-num_keys // 2))


def test_wide_model_codes_intmax_above_the_largest_key():
    """The v4 id sort's keys at the fleet row: hi up to 10,000 and lo up
    to 2^24, both padded with INT32_MAX. INT32_MAX is coded just above
    the largest other key, so the keys take 14 and 25 bits (5 passes,
    not the 8 of two 31-bit codes), and with a position of 24 bits
    (10,485,760 lanes) the word still holds all three: the passes carry
    8 bytes a lane. The model sorts such a row exactly."""
    rng = np.random.default_rng(11)
    n = 3000
    hi = rng.integers(0, 10001, size=(1, n))
    lo = rng.integers(0, 1 << 24, size=(1, n))
    pad = rng.random((1, n)) < 0.1
    hi[pad], lo[pad] = I32_MAX, I32_MAX
    hi[0, :2], lo[0, :2] = (10000, 0), ((1 << 24) - 1, 0)
    ops = [hi.astype(np.int32), lo.astype(np.int32),
           np.arange(n, dtype=np.int32)[None]]
    got, plans, _ = _wide_model(ops, 2, tile=256)
    _assert_sorted_like_references(ops, 2, got)
    plan = plans[0]
    assert plan["bits"] == [14, 25] and plan["total"] == 5
    assert plan["groups"][0][4]                     # packed at n = 3000
    assert sum(plan["bits"]) + _bits(10_485_760 - 1) <= 64


@pytest.mark.parametrize("n,num_keys,kind,packed", [
    (5000, 2, "sibling", True), (5000, 1, "narrow", True),
    (5000, 2, "full", False), (3000, 3, "child", False),
])
def test_wide_model_packs_the_position_where_it_fits(n, num_keys, kind,
                                                     packed):
    """A group's words carry the row position where its bits and a
    position's fit 32 bits (one key) or 64; else the positions travel in
    their own buffers. Both sort exactly, and the decoded keys are the
    keys."""
    ops = _operands(kind, num_keys, 2, n, seed=n + 3 * num_keys)
    got, plans, _ = _wide_model(ops, num_keys, tile=512)
    _assert_sorted_like_references(ops, num_keys, got)
    for plan in plans:
        assert plan["groups"][0][4] == packed
        assert plan["pbits"] == _bits(n - 1)


# b1_form on an H100 (its limits as bitonic.b1_limits reads them on the
# card, NVIDIA H100 80GB HBM3: clusters of 16 at both CTA widths), by P
# and key count
H100 = bitonic.B1Limits(H100_SMEM, ((4096, 16), (8192, 16)))
FORMS = {
    128: ("network", "network", "network", "network"),
    256: ("radix", "radix", "network", "network"),
    8192: ("radix", "radix", "network", "cluster"),   # 9 keys: 10 x 32 KB
    16384: ("cluster",) * 4,
    131072: ("cluster",) * 4,
    262144: ("wide",) * 4,
}


@pytest.mark.parametrize("num_keys", [1, 2, 3, 9])
@pytest.mark.parametrize("P", [128, 256, 8192, 16384, 131072, 262144])
def test_b1_form_rule(P, num_keys):
    """Radix at one or two keys and 256 <= P <= 8192; the network at P
    <= 8192 where its keys and positions fit a block's shared memory;
    the cluster form where a cluster the card co-schedules holds the row
    (16 CTAs of 8,192 lanes on an H100); wide past it. A ragged row
    takes its P's form."""
    want = FORMS[P][(1, 2, 3, 9).index(num_keys)]
    assert b1_form(P, num_keys, H100) == want
    assert b1_form(P - P // 4 + 1, num_keys, H100) == want
    assert bitonic.b1_forms(P, num_keys, H100)[0] == want
    assert bitonic.b1_forms(P, num_keys, H100)[-1] == "wide"


@pytest.mark.parametrize("n,clusters,lanes", [
    (16384, ((4096, 16), (8192, 16)), 4096),
    (65536, ((4096, 16), (8192, 16)), 4096),
    (65537, ((4096, 16), (8192, 16)), 8192),
    (131072, ((4096, 16), (8192, 16)), 8192),
    (131073, ((4096, 16), (8192, 16)), 0),
    (65536, ((4096, 8), (8192, 8)), 8192),     # a card of smaller clusters
    (65537, ((4096, 8), (8192, 8)), 0),
    (40960, ((4096, 0), (8192, 5)), 8192),     # no cluster at 4096 lanes
    (8192, ((4096, 0), (8192, 0)), 0),         # no cluster at all
])
def test_cluster_lanes_never_exceed_the_cards_clusters(n, clusters, lanes):
    """The cluster form's CTA width: the first width at which the row's
    CTAs make a cluster the card co-schedules (never more CTAs than
    ``cudaOccupancyMaxActiveClusters`` allows, nor than 16); a row no
    such cluster holds goes wide."""
    limits = bitonic.B1Limits(H100_SMEM, clusters)
    assert bitonic.cluster_lanes(n, limits) == lanes
    form = bitonic.b1_form(n, 9, limits)
    assert form == ("cluster" if lanes else "wide")
    if lanes:
        most = dict(clusters)[lanes]
        assert -(-n // lanes) <= min(most, bitonic.CLUSTER_MAX)


@pytest.mark.parametrize("n,num_keys,forms", [
    (16, 2, ("network", "cluster", "wide")),
    (64, 1, ("network", "cluster", "wide")),
    (128, 3, ("network", "cluster", "wide")),
    (2048, 3, ("network", "cluster", "wide")),
    (4096, 2, ("radix", "network", "cluster", "wide")),
])
def test_b1_forms_beside_the_network(n, num_keys, forms):
    """Every form a call the rule sends to the network (or to radix) can
    take, as the smoke times them: the cluster form holds each such row
    too, and the wide form every row."""
    assert bitonic.b1_forms(n, num_keys, H100) == forms


@pytest.mark.parametrize("smem,sms,walk,chunk", [
    (H100_SMEM, 132, "row", "chunk"),     # NVIDIA H100 80GB HBM3
    (H100_SMEM, 114, "row", "chunk"),     # an H100 PCIe
    (101376, 84, "split", "chunk"),       # a card of sm_86's shared memory
])
def test_device_limits_read_torch_properties(monkeypatch, smem, sms, walk,
                                             chunk):
    """The limits B2's and B3's rules share come from PyTorch's device
    properties (no kernel library is built for them), cached per
    device, and feed ``euler._smem_limit`` and ``fphase._sms``."""
    asked = []

    def props(index):
        asked.append(index)
        return SimpleNamespace(shared_memory_per_block_optin=smem,
                               multi_processor_count=sms)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(kernels, "library", None)  # never called
    kernels.device_limits.cache_clear()
    try:
        assert kernels.device_limits(0) == kernels.DeviceLimits(smem, sms)
        assert euler._smem_limit(0) == smem and fphase._sms(0) == sms
        assert asked == [0]
        # B2 at a row of 16,000 runs: in shared memory where its 208 KB
        # fit; B3 at one fleet row: chunks
        assert euler.walk_form(16000, euler._smem_limit(0)) == walk
        assert fphase.fphase_form(1, 10_485_760, fphase._sms(0)) == chunk
    finally:
        kernels.device_limits.cache_clear()


def test_b1_form_codes_match_the_library():
    """The form codes and bounds the wrapper passes to
    ``cause_sort_rows`` are the ones ``sort.cu``, ``radix.cuh``,
    ``radix_cluster.cuh`` and ``radix_wide.cuh`` compile with: the code
    of each form, the radix form's widths, the operand limit, the
    largest cluster, and CTA widths that are whole multiples of the
    kernels' threads at the items a thread the library instantiates."""
    def define(name, src):
        text = (kernels.CSRC / src).read_text()
        return int(re.search(rf"#define {name} (\d+)", text).group(1))

    for code, form in enumerate(bitonic.B1_FORMS):
        assert define(f"CAUSE_SORT_FORM_{form.upper()}", "sort.cu") == code
    assert define("CAUSE_RADIX_MIN_P", "radix.cuh") == bitonic.RADIX_MIN_P
    assert define("CAUSE_RADIX_MAX_P", "radix.cuh") == bitonic.RADIX_MAX_P
    assert define("CAUSE_SORT_MAX_OPS", "sort.cu") == bitonic.MAX_OPS
    assert define("CAUSE_CLUSTER_MAX", "radix_cluster.cuh") == \
        bitonic.CLUSTER_MAX
    threads = define("CAUSE_CLUSTER_THREADS", "radix_cluster.cuh")
    assert bitonic.CLUSTER_LANES == (threads * 8, threads * 16)
    assert define("CAUSE_WIDE_IPT", "radix_wide.cuh") * define(
        "CAUSE_WIDE_THREADS", "radix_wide.cuh") == WIDE_TILE


def test_sort_pairs_cuda_refuses_cpu_tensors_in_every_form():
    """On CPU tensors the kernel wrapper raises whatever the form; the
    dispatching wrapper takes the plain version and launches nothing."""
    x = torch.zeros((1, 16385), dtype=torch.int32)
    for form in bitonic.B1_FORMS:
        with pytest.raises(ValueError, match="CUDA tensors"):
            bitonic.sort_pairs_cuda((x, x), 1, form=form)
    kernels.reset_launches()
    sort_pairs((x, x), 1)
    assert kernels.launches["sort"] == 0


@pytest.mark.parametrize("n,num_keys", [(16385, 1), (16385, 2), (8192, 9)])
def test_sort_pairs_on_cpu_at_wide_widths(n, num_keys):
    """The wrapper on CPU tensors of wide-form rows takes the plain
    version, which is lax.sort's order."""
    ops = _operands("narrow", num_keys, 2, n, seed=n + 7 * num_keys)
    got = sort_pairs([torch.from_numpy(x) for x in ops], num_keys)
    want = lax.sort(tuple(jnp.asarray(x) for x in ops), num_keys=num_keys,
                    is_stable=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
