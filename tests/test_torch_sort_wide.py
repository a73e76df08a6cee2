"""B1's wide form (``csrc/radix_wide.cuh``) modelled in numpy.

The wide form sorts rows past 8,192 lanes, and rows whose keys would not
fit a block's shared memory, by stable LSD radix passes spread over
(row, tile) CTAs; it runs only on the card. ``_wide_model`` repeats its
steps here: per-tile partial ranges reduced per row; the per-row plan
(each key's code ``k - min`` and bit length, keys packed greedily into
composites of at most 32 bits for one key and 64 for more, least
significant key last; groups sorted least significant first); every
launch of the host's fixed loop, a pass beyond the row's plan a no-op;
the row's digit totals of a group's first pass at its start, and of
each later pass from the pass before it as it writes out; per pass
each tile's digit counts and the look-back's sum over the row's earlier
tiles (equal to the exclusive scan over (digit, tile) that makes the
pass stable), the stable in-tile rank of warp-striped items (lanes past
the row's end ranked last under digit 255) and the coalesced scatter
from the staged tile; the ping-pong buffers' parity counted from the
plan; the final gather of every operand by position. The model is held
bit-equal to ``jax.lax.sort(..., is_stable=True)`` and to the port's
``sort_pairs_plain``, at small widths over 1-20 tiles and at real width.
The form rule (``b1_form``) is checked beside it, against a table and
against the constants of the headers it shares with ``sort.cu``. Every
value is an integer, so every comparison is exact.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
from jax import lax

import torch

from cause_tpu_torch import kernels
from cause_tpu_torch.weaver import bitonic
from cause_tpu_torch.weaver.bitonic import (b1_form, sort_pairs,
                                            sort_pairs_plain)

I32_MAX = int(np.iinfo(np.int32).max)
I32_MIN = int(np.iinfo(np.int32).min)
THREADS, BINS = 256, 256
H100_SMEM = 232448  # the opt-in shared memory of an H100 block


def _bits(top: int) -> int:
    return int(top).bit_length()


def _wide_plan(keys, tile):
    """One row's plan from its per-tile partial ranges: per key the
    minimum and bit length; the groups (least significant first) as
    (first key, last key, passes, passes before)."""
    nk, n = keys.shape
    starts = np.arange(0, n, tile)
    part_mn = np.minimum.reduceat(keys, starts, axis=1)
    part_mx = np.maximum.reduceat(keys, starts, axis=1)
    mn = part_mn.min(axis=1).astype(np.int64)
    mx = part_mx.max(axis=1).astype(np.int64)
    bits = [_bits(mx[q] - mn[q]) for q in range(nk)]
    limit = 32 if nk == 1 else 64
    groups, total, q = [], 0, nk - 1
    while q >= 0:
        last, b = q, 0
        while q >= 0 and b + bits[q] <= limit:
            b += bits[q]
            q -= 1
        passes = -(-b // 8)
        groups.append((q + 1, last, passes, total))
        total += passes
    return {"mn": mn, "bits": bits, "groups": groups, "total": total}


def _compose(keys, plan, group, p):
    first, last = group[0], group[1]
    x = np.zeros(p.shape, np.uint64)
    for q in range(first, last + 1):
        code = (keys[q][p].astype(np.int64) - plan["mn"][q]).astype(np.uint64)
        x = (x << np.uint64(plan["bits"][q])) | code
    return x


def _digit(c, d):
    return ((c >> np.uint64(8 * d)) & np.uint64(255)).astype(np.int64)


def _scatter(c, p, d, n, tile, total):
    """One digit pass of the row, given the row's digit ``total``s from
    its group's start: (a) each tile's digit counts and the look-back's
    sum of the earlier tiles' counts, so a (digit, tile)'s offset is the
    row's count of lower digits plus that sum, which is the exclusive
    scan over (digit, tile); (b) each tile's stable warp-level rank, its
    staging in local sorted order and the coalesced write-out. Returns
    the row's (composites, positions) after the pass."""
    tiles = -(-n // tile)
    ipt = tile // THREADS
    dig = _digit(c, d)
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
    positions, plan, both position buffers)."""
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
            pb = group[3] + d
            par = pb % 2
            if d == 0:                 # the group's first pass composes
                p = np.arange(n) if pb == 0 else pos[par]
                c = _compose(keys, plan, group, p)
                total = np.bincount(_digit(c, 0), minlength=BINS)
            else:
                c, p = comp[par], pos[par]
            comp[1 - par], pos[1 - par] = _scatter(c, p, d, n, tile, total)
            if d + 1 < group[2]:       # counted as the pass writes out
                total = np.bincount(_digit(comp[1 - par], d + 1),
                                    minlength=BINS)
    passes = plan["total"]
    final = np.arange(n) if passes == 0 else pos[passes % 2]
    return final, plan, pos


def _wide_model(ops, num_keys, tile):
    """The wide form over ``[B, n]`` operands: each row sorted by
    ``_wide_row``, every operand gathered by final position. Returns
    (outputs, plans, position buffers)."""
    B, n = ops[0].shape
    outs = [np.empty_like(x) for x in ops]
    plans, bufs = [], []
    for r in range(B):
        keys = np.stack([ops[q][r] for q in range(num_keys)])
        final, plan, pos = _wide_row(keys, tile)
        for k, x in enumerate(ops):
            outs[k][r] = x[r][final]
        plans.append(plan)
        bufs.append(pos)
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
        final, plan, pos = _wide_row(key, 256)
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
    levels (131,072), at the card's widest tile, against np.lexsort."""
    ops = _operands(kind, num_keys, 1, n, seed=n + num_keys)
    tile = 4096
    got, plans, _ = _wide_model(ops, num_keys, tile=tile)
    order = np.lexsort(tuple(ops[q][0] for q in reversed(range(num_keys))))
    for g, x in zip(got, ops):
        assert np.array_equal(g[0], x[0][order])
    assert plans[0]["total"] <= (4 if num_keys == 1 else
                                 8 * -(-num_keys // 2))


# b1_form on an H100, by P and key count
FORMS = {
    128: ("network", "network", "network", "network"),
    256: ("radix", "radix", "network", "network"),
    8192: ("radix", "radix", "network", "wide"),   # 9 keys: 10 x 32 KB
    16384: ("wide",) * 4,
    131072: ("wide",) * 4,
}


@pytest.mark.parametrize("num_keys", [1, 2, 3, 9])
@pytest.mark.parametrize("P", [128, 256, 8192, 16384, 131072])
def test_b1_form_rule(P, num_keys):
    """Radix at one or two keys and 256 <= P <= 8192; wide past 8,192
    lanes or where the network's keys and positions overflow a block's
    shared memory; the network else. A ragged row takes its P's form."""
    want = FORMS[P][(1, 2, 3, 9).index(num_keys)]
    assert b1_form(P, num_keys, H100_SMEM) == want
    assert b1_form(P - P // 4 + 1, num_keys, H100_SMEM) == want


def test_b1_form_constants_match_the_headers():
    """The rule's bounds and the operand limit are the ones ``sort.cu``
    and ``radix.cuh`` compile with, so the C mirror of ``b1_form``
    (``sort_form``) decides alike."""
    def define(name, src):
        text = (kernels.CSRC / src).read_text()
        return int(re.search(rf"#define {name} (\d+)", text).group(1))

    assert define("CAUSE_RADIX_MIN_P", "radix.cuh") == bitonic.RADIX_MIN_P
    assert define("CAUSE_RADIX_MAX_P", "radix.cuh") == bitonic.RADIX_MAX_P
    assert define("CAUSE_SORT_MAX_OPS", "sort.cu") == bitonic.MAX_OPS
    rule = (kernels.CSRC / "sort.cu").read_text()
    assert ("P > CAUSE_RADIX_MAX_P ||\n        (size_t)(num_keys + 1) * "
            "(size_t)P * sizeof(int32_t) > (size_t)smem_limit") in rule


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
