"""B1's cluster form (``csrc/radix_cluster.cuh``) modelled in numpy.

The cluster form sorts one row in the distributed shared memory of a
thread-block cluster: C CTAs of L lanes each (C = ceil(n / L)), rank r
holding the row's lanes [r L, (r + 1) L). It runs only on the card.
``_cluster_row`` repeats its steps here, CTA by CTA: each rank's range
of its slice (the minimum, the largest key below INT32_MAX, whether
INT32_MAX occurs) and the cluster's reduction of them into the plan
every rank computes alike (the wide form's plan, ``radix_wide.cuh``'s
``wide_range`` and ``wide_groups_of``: codes, groups, the position
packed into the word where it fits); per pass each rank's items in slot
order (composed from the keys, gathered by position, at a group's first
pass), their warp-striped stable rank (slots past the row ranked last
under digit 255), each rank's 256 published counts, a digit's offset as
the row's count of lower digits plus the count of that digit in the
lower ranks plus the item's rank within its CTA, the items staged in the
rank's own sorted order and written out from there, each into its
owner's slot (rank dst // L, slot dst % L); the final
gather of the payloads by position with the last group's keys decoded
from the words. Small L (256-1,024 lanes, 1-8 items a thread) lets rows
of a few thousand lanes cross 1 to 16 ranks. The model is held bit-equal
to ``jax.lax.sort(..., is_stable=True)``, to the port's
``sort_pairs_plain`` and, at small widths, to the Pallas kernel
``pallas_bitonic_sort`` in interpret mode (as ``tests/test_pallas_sort.py``
runs it), over one, two, three and nine keys, ragged rows and every key
kind of ``chip_smoke.py``'s edge cases. Every value is an integer, so
every comparison is exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from jax import lax

import torch

from cause_tpu.weaver.pallas_sort import pallas_bitonic_sort
from cause_tpu_torch.weaver.bitonic import sort_pairs_plain

from test_torch_sort_wide import (  # noqa: E402  the wide form's plan
    I32_MAX, _compose, _digit, _operands, _outputs, _plan, _ranges, _shift,
    _word_pos)

BINS = 256


def _cluster_plan(keys, L):
    """Every rank's plan: the ranks' slice ranges, reduced over the
    cluster, then the groups (words of 32 bits for one key, else 64)."""
    n = keys.shape[1]
    starts = np.arange(0, n, L)
    assert len(starts) == -(-n // L)       # C ranks, one slice each
    return _plan(keys, starts, 32 if keys.shape[0] == 1 else 64)


def _rank_in_cta(dig, L, ipt):
    """Each slot's stable rank among its CTA's slots of the same digit:
    thread (warp w, lane l) holds slots (w * ipt + i) * 32 + l, so a warp
    holds the chunk [w * 32 * ipt, (w + 1) * 32 * ipt) and (warp, item,
    lane) is slot order. Returns (the per-warp exclusive prefix of the
    digit's count plus the rank within the warp, the CTA's counts)."""
    W = L // (32 * ipt)
    warp = np.arange(L) // (32 * ipt)
    gid = warp * BINS + dig
    order = np.argsort(gid, kind="stable")
    sg = gid[order]
    rank = np.empty(L, np.int64)
    rank[order] = np.arange(L) - np.searchsorted(sg, sg, side="left")
    cnt = np.bincount(gid, minlength=W * BINS).reshape(W, BINS)
    wpref = np.cumsum(cnt, axis=0) - cnt   # the warps before, per digit
    return wpref[warp, dig] + rank, cnt.sum(axis=0)


def _cluster_row(keys, L, ipt):
    """One row through the cluster form. Returns (final positions, the
    final words, plan, passes run)."""
    nk, n = keys.shape
    C = -(-n // L)
    plan = _cluster_plan(keys, L)
    # each rank's shared memory: words and positions, slot by slot
    s_w = np.zeros((C, L), np.uint64)
    s_p = np.zeros((C, L), np.int64)
    valid = np.minimum(L, n - np.arange(C) * L)
    real = np.arange(L)[None, :] < valid[:, None]         # [C, L]
    lane_of = np.arange(C)[:, None] * L + np.arange(L)[None, :]
    passes = 0
    for g, group in enumerate(plan["groups"]):
        packed = group[4]
        for d in range(group[2]):
            bit = _shift(plan, group) + 8 * d
            # the items every rank holds in registers before the barrier
            if d == 0:
                if g == 0:
                    p = lane_of.copy()
                elif plan["groups"][g - 1][4]:
                    p = _word_pos(s_w, plan)
                else:
                    p = s_p.copy()
                p = np.where(real, p, 0)
                c = _compose(keys, plan, group, p.ravel()).reshape(C, L)
            else:
                c = s_w.copy()
                p = np.zeros((C, L), np.int64) if packed else s_p.copy()
            c = np.where(real, c, np.uint64(0))
            dig = np.where(real, _digit(c, bit), 255)
            local = np.empty((C, L), np.int64)
            cnt = np.empty((C, BINS), np.int64)            # published
            for r in range(C):
                local[r], cnt[r] = _rank_in_cta(dig[r], L, ipt)
            # after the barrier: every rank's counts
            tot = cnt.sum(axis=0)
            dex = np.cumsum(tot) - tot                     # lower digits
            below = np.cumsum(cnt, axis=0) - cnt           # lower ranks
            loc = np.cumsum(cnt, axis=1) - cnt             # this rank's
            rows = np.arange(C)[:, None]
            dst = (dex[None, :] + below)[rows, dig] + local
            assert np.array_equal(np.sort(dst[real]), np.arange(n))
            assert (dst[~real] >= n).all()                 # dropped
            # staged in the rank's own sorted order: the real items fill
            # slots [0, valid), the slots past the row come after them
            st = loc[rows, dig] + local
            assert (np.sort(st, axis=1) == np.arange(L)).all()
            assert (np.where(real, st, L) < valid[:, None]).sum() == n
            t_w = np.zeros((C, L), np.uint64)
            t_p = np.zeros((C, L), np.int64)
            t_w[rows, st], t_p[rows, st] = c, p
            # written out from the stage: staged slot e of a rank goes to
            # the row's offset of its digit, less the rank's own, plus e
            e = np.arange(L)[None, :]
            t_dig = np.where(e < valid[:, None], _digit(t_w, bit), 255)
            base = dex[None, :] + below - loc
            t_dst = base[rows, t_dig] + e
            assert np.array_equal(np.sort(t_dst[real]), np.sort(dst[real]))
            # each item into its owner's slot; every rank read its items
            # before any store, so one receiving buffer serves
            s_w = np.zeros((C, L), np.uint64)
            if not packed:
                s_p = np.zeros((C, L), np.int64)
            owner, slot = t_dst[real] // L, t_dst[real] % L
            s_w[owner, slot] = t_w[real]
            if not packed:
                s_p[owner, slot] = t_p[real]
            passes += 1
    assert passes == plan["total"]
    w = s_w.ravel()[:n]
    if plan["total"] == 0:
        final = np.arange(n)
    elif plan["groups"][-1][4]:
        final = _word_pos(w, plan)
    else:
        final = s_p.ravel()[:n]
    return final, w, plan, passes


def _cluster_model(ops, num_keys, L, ipt):
    """The cluster form over ``[B, n]`` operands, one cluster a row.
    Returns (outputs, plans)."""
    B, n = ops[0].shape
    outs = [np.empty_like(x) for x in ops]
    plans = []
    for r in range(B):
        keys = np.stack([ops[q][r] for q in range(num_keys)])
        final, word, plan, _ = _cluster_row(keys, L, ipt)
        for k, o in enumerate(_outputs([x[r] for x in ops], num_keys, plan,
                                       final, word)):
            outs[k][r] = o
        plans.append(plan)
    return outs, plans


def _assert_like_references(ops, num_keys, got, pallas=False):
    want_lax = lax.sort(tuple(jnp.asarray(x) for x in ops),
                        num_keys=num_keys, is_stable=True)
    want_plain = sort_pairs_plain([torch.from_numpy(x) for x in ops],
                                  num_keys)
    for g, wl, wp in zip(got, want_lax, want_plain):
        assert np.array_equal(g, np.asarray(wl))
        assert np.array_equal(g, wp.numpy())
    if pallas:
        want_pl = pallas_bitonic_sort(tuple(jnp.asarray(x) for x in ops),
                                      num_keys=num_keys)
        for g, w in zip(got, want_pl):
            assert np.array_equal(g, np.asarray(w))


KINDS = [
    ("narrow", 1), ("narrow", 2), ("narrow", 3), ("narrow", 9),
    ("full", 1), ("full", 2), ("full", 3), ("full", 9),
    ("extremes", 1), ("extremes", 2), ("extremes", 9),
    ("equal", 1), ("equal", 3), ("all_max", 1), ("all_max", 2),
    ("sibling", 2), ("child", 3),
]


@pytest.mark.parametrize("n,L,ipt", [
    (200, 256, 1), (1000, 256, 2), (3001, 512, 4), (4096, 256, 8),
])
@pytest.mark.parametrize("kind,num_keys", KINDS)
def test_cluster_model_matches_lax_sort_and_plain(kind, num_keys, n, L, ipt):
    """1 rank (a ragged one), 4 ranks (the last ragged), 6 ranks of
    512 (the last ragged) and 16 full ranks of 256: the most CTAs a
    cluster has."""
    ops = _operands(kind, num_keys, 2, n, seed=7 * n + num_keys)
    got, plans = _cluster_model(ops, num_keys, L, ipt)
    _assert_like_references(ops, num_keys, got)
    for plan in plans:
        if kind in ("equal", "all_max"):
            assert plan["total"] == 0 and plan["bits"] == [0] * num_keys
        if kind == "extremes":
            assert plan["bits"] == [32] * num_keys
        if kind == "child":  # two groups, the first key on its own
            assert [g[:2] for g in plan["groups"]] == [(1, 2), (0, 0)]


@pytest.mark.parametrize("kind,num_keys,n", [
    ("narrow", 2, 700), ("extremes", 1, 513), ("child", 3, 600),
    ("sibling", 2, 1000),
])
def test_cluster_model_matches_the_pallas_kernel(kind, num_keys, n):
    """At small widths, against the TPU kernel itself in interpret mode:
    rows of 3-4 ranks of 256 lanes."""
    ops = _operands(kind, num_keys, 2, n, seed=n + num_keys)
    got, _ = _cluster_model(ops, num_keys, 256, 2)
    _assert_like_references(ops, num_keys, got, pallas=True)


@pytest.mark.parametrize("C", [1, 2, 3, 5, 8, 9, 16])
def test_cluster_model_over_every_cluster_size(C):
    """Clusters of 1 to 16 ranks of 256 lanes, two keys whose word needs
    every pass of a 64-bit composite, the last rank one lane short."""
    n = C * 256 - 1
    ops = _operands("full", 2, 1, n, seed=C)
    got, plans = _cluster_model(ops, 2, 256, 1)
    _assert_like_references(ops, 2, got)
    assert plans[0]["total"] == 8 and not plans[0]["groups"][0][4]


def test_cluster_model_ranges_are_the_slices_reduced():
    """Each rank's published range covers its own slice only, and the
    cluster's reduction of them is the row's: INT32_MAX in one rank
    alone still moves the key's code point for every rank."""
    n, L = 1000, 256
    key = np.arange(n, dtype=np.int32)[None].copy()
    key[0, 999] = I32_MAX                       # in the last rank only
    mn, mx, any_max = _ranges(key, np.arange(0, n, L))
    assert (mn[0], mx[0], bool(any_max[0])) == (0, 998, True)
    for r in range(4):
        part = key[:, r * L:(r + 1) * L]
        pmn, pmx, pany = _ranges(part, np.array([0]))
        assert bool(pany[0]) == (r == 3)
    plan = _cluster_plan(key, L)
    assert plan["mx1"] == [999] and plan["bits"] == [10]
    got, _ = _cluster_model([key, key.copy()], 1, L, 1)
    assert np.array_equal(got[0][0], np.sort(key[0]))


@pytest.mark.parametrize("n,num_keys,kind", [
    (16385, 2, "sibling"), (40960, 3, "child"), (131072, 1, "narrow"),
])
def test_cluster_model_at_real_width(n, num_keys, kind):
    """The kernel's own CTA: 512 threads of 16 items (8,192 lanes), rows
    of the tree's upper levels and of v1's sort-join: 3, 5 and 16
    ranks, against np.lexsort."""
    ops = _operands(kind, num_keys, 1, n, seed=n + num_keys)
    got, _ = _cluster_model(ops, num_keys, 8192, 16)
    order = np.lexsort(tuple(ops[q][0] for q in reversed(range(num_keys))))
    for g, x in zip(got, ops):
        assert np.array_equal(g[0], x[0][order])
