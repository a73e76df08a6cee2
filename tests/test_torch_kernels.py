"""The port's three kernel modules against the JAX package.

B1 (the row sort), B2 (the contracted-forest walk) and B3 (the F-phase
lane expansion): on the CPU each port wrapper takes its plain PyTorch
version, which is held against the JAX package's Pallas kernel (run in
interpret mode, as the JAX package's own tests run it here) and
against the XLA reference the Pallas kernel replaces. Inputs are made
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
