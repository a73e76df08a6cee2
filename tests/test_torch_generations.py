"""The port's older weaver generations against the JAX package's.

``cause_tpu_torch``'s v1 and v2 (``torchw``), v3 (``torchw3``) and v4
with both Euler arms (``torchw4``) against ``cause_tpu``'s ``jaxw``,
``jaxw3`` and ``jaxw4``, each pair fed the same numpy lanes: the
regression corpus, fuzz and hypothesis trees built through the API, two
API replicas concatenated, and the ``benchgen`` pairs and fleets at the
reference tests' own shapes. On the CPU every port sort and walk takes
its plain version; the reference runs its XLA forms, and its v4 walk arm
its Pallas kernel in interpret mode, as ``tests/test_jax_v4.py`` does.
Outputs are integers and flags, so ``order``, ``rank``, ``visible``,
``conflict`` and ``overflow`` compare EXACTLY, row by row; a row that
overflows is compared on its flag only (its other outputs are
unspecified in both packages).

Mirrors the v1/v2 cases of ``tests/test_jax_weaver.py``, all of
``tests/test_jax_v3.py`` and ``tests/test_jax_v4.py``, the v2-v4 cases
of ``tests/test_jax_smoke.py`` and the generators of
``tests/test_benchgen.py`` the v4 kernel reads.
"""

import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import cause_tpu as c
from cause_tpu import benchgen as jb
from cause_tpu.collections import clist as j_clist
from cause_tpu.collections import shared as j_shared
from cause_tpu.ids import new_site_id
from cause_tpu.weaver import jaxw, jaxw3, jaxw4
from cause_tpu.weaver.arrays import NodeArrays, SiteInterner

from cause_tpu_torch import benchgen as tb
from cause_tpu_torch.weaver import torchw, torchw3, torchw4

from test_jax_weaver import build_batch, decode_device_weave, pair_lane_nodes
from test_list import EDGE_CASES, rand_node

LANE_KEYS, LANE_KEYS4 = jb.LANE_KEYS, jb.LANE_KEYS4
GRID = [(40, 12, 64, 3), (100, 40, 256, 5), (5, 3, 16, 2), (0, 4, 16, 0),
        (31, 1, 64, 1)]

_jv1 = jax.jit(jaxw.merge_weave_kernel)
_jv2 = jax.jit(jaxw.merge_weave_kernel_v2, static_argnames="k_max")


def host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_same(got, want, what=""):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = host(g), host(w)
        assert g.shape == w.shape, (what, i)
        assert np.array_equal(g, w), (what, i)


def tree_lanes(cl):
    """Numpy lanes of one API tree: ``(hi, lo, chi, clo, cci, vc,
    valid)`` and its ``NodeArrays`` (within-tree cause indices ARE
    concat indices)."""
    na = NodeArrays.from_nodes_map(cl.ct.nodes)
    hi, lo = na.id_lanes()
    chi, clo = na.cause_lanes()
    return (hi, lo, chi, clo, na.cause_idx, na.vclass, na.valid), na


def fuzz_trees(seed, count, n_ops=(3, 25), sites=3, seed_word="ab"):
    rng = random.Random(seed)
    for _ in range(count):
        cl = c.clist(*seed_word)
        ss = [new_site_id() for _ in range(sites)]
        for _ in range(rng.randrange(*n_ops)):
            cl = cl.insert(rand_node(rng, cl, site_id=rng.choice(ss)))
        yield cl


def port_kernel(version):
    """A port merge kernel over one row: ``fn(lanes dict, k_max)``."""
    def run(row, k_max):
        if version == "v1":
            return torchw.merge_weave_kernel(
                *(row[k] for k in LANE_KEYS), device="cpu")
        if version == "v2":
            return torchw.merge_weave_kernel_v2(
                *(row[k] for k in LANE_KEYS), k_max=k_max, device="cpu")
        if version == "v3":
            return torchw3.merge_weave_kernel_v3(
                *(row[k] for k in LANE_KEYS), k_max=k_max, device="cpu")
        return torchw4.merge_weave_kernel_v4(
            *(row[k] for k in LANE_KEYS4), k_max=k_max, device="cpu")
    return run


def ref_kernel(version, row, k_max):
    a1 = tuple(jnp.asarray(row[k]) for k in LANE_KEYS)
    if version == "v1":
        return _jv1(*a1)
    if version == "v2":
        return _jv2(*a1, k_max=k_max)
    if version == "v3":
        return jaxw3.merge_weave_kernel_v3_jit(*a1, k_max=k_max)
    return jaxw4.merge_weave_kernel_v4_jit(
        *(jnp.asarray(row[k]) for k in LANE_KEYS4), k_max=k_max)


def row_of(lanes7):
    hi, lo, chi, clo, cci, vc, valid = lanes7
    return {"hi": hi, "lo": lo, "chi": chi, "clo": clo, "cci": cci,
            "vc": vc, "valid": valid}


def match_all(row, version, k_max):
    """The port's ``version`` equals the reference's and the reference's
    v1 on one row, with no overflow."""
    got = port_kernel(version)(row, k_max)
    want = ref_kernel(version, row, k_max)
    assert_same(got, want, version)
    if version != "v1":
        assert not bool(host(got[4]))
        assert_same(got[:4], ref_kernel("v1", row, 0), f"{version} vs v1")


# ------------------------------------------------ v1 / v2 (test_jax_weaver)


@pytest.mark.parametrize("nodes", EDGE_CASES, ids=range(len(EDGE_CASES)))
def test_regression_corpus_parity(nodes):
    """``linearize`` and ``linearize_v2`` on the regression corpus equal
    the reference's, and their weave equals the pure weaver's."""
    cl = c.clist()
    for n in nodes:
        cl = cl.insert(n)
    (hi, lo, _, _, cci, vc, valid), na = tree_lanes(cl)
    rank, visible = torchw.linearize(hi, lo, cci, vc, valid, device="cpu")
    assert_same((rank, visible), jaxw._linearize_jit(hi, lo, cci, vc, valid))
    r2, v2, ovf = torchw.linearize_v2(hi, lo, cci, vc, valid,
                                      k_max=na.capacity, device="cpu")
    assert not bool(ovf)
    assert_same((r2, v2), (rank, visible))
    order = np.argsort(host(rank)[: na.capacity], kind="stable")
    pure = j_clist.weave(cl.ct.evolve(weaver="pure")).weave
    assert [na.nodes[i][0] for i in order[: na.n]] == [n[0] for n in pure]


def test_empty_and_tiny_trees():
    for cl in (c.clist(), c.clist("a")):
        (hi, lo, _, _, cci, vc, valid), na = tree_lanes(cl)
        got = torchw.linearize(hi, lo, cci, vc, valid, device="cpu")
        assert_same(got, jaxw._linearize_jit(hi, lo, cci, vc, valid))
        got2 = torchw.linearize_v2(hi, lo, cci, vc, valid, k_max=16,
                                   device="cpu")
        assert_same(got2, jaxw._linearize_v2_jit(hi, lo, cci, vc, valid,
                                                 k_max=16))


def test_linearize_v1_v2_fuzz_parity():
    """v1 and v2 on fuzz trees and an append-only typing run equal the
    reference's v1 and v2 (``test_linearize_v2_parity``)."""
    trees = list(fuzz_trees(0xD00D, 8, n_ops=(1, 16), sites=4,
                            seed_word=""))
    trees.append(c.clist(*"a long append only typing run"))
    for ti, cl in enumerate(trees):
        (hi, lo, _, _, cci, vc, valid), na = tree_lanes(cl)
        want = jaxw._linearize_jit(hi, lo, cci, vc, valid)
        assert_same(torchw.linearize(hi, lo, cci, vc, valid, device="cpu"),
                    want, f"v1 tree {ti}")
        got2 = torchw.linearize_v2(hi, lo, cci, vc, valid,
                                   k_max=na.capacity, device="cpu")
        assert_same(got2, jaxw._linearize_v2_jit(hi, lo, cci, vc, valid,
                                                 k_max=na.capacity))
        assert_same(got2[:2], want, f"v2 tree {ti}")


def test_linearize_v2_overflow_flag():
    """A run budget below the real run count raises the flag; above it
    v2 equals v1 (a star: every node its own run)."""
    cl = c.clist()
    for i in range(1, 9):
        cl = cl.insert(((i, "siteA________", 0), c.root_id, f"v{i}"))
    (hi, lo, _, _, cci, vc, valid), _ = tree_lanes(cl)
    *_, small = torchw.linearize_v2(hi, lo, cci, vc, valid, k_max=4,
                                    device="cpu")
    assert bool(small)
    assert bool(jaxw._linearize_v2_jit(hi, lo, cci, vc, valid, k_max=4)[2])
    r2, v2, big = torchw.linearize_v2(hi, lo, cci, vc, valid, k_max=16,
                                      device="cpu")
    assert not bool(big)
    assert_same((r2, v2), torchw.linearize(hi, lo, cci, vc, valid,
                                           device="cpu"))


def test_estimate_runs_equals_the_device_run_count():
    """The host estimator equals the reference's, and the device run
    count of v2 AND v4 EXACTLY: at ``k_max = estimate`` neither
    overflows, one below it both do. So a tree that fits v2's budget but
    not v4's cannot occur, and the ladder's v2 rung (tried only after v4
    overflowed at the same budget) is never reached on the trees the
    API builds."""
    for ti, cl in enumerate(fuzz_trees(0x5EED, 15, n_ops=(1, 16), sites=4)):
        (hi, lo, _, _, cci, vc, valid), _ = tree_lanes(cl)
        est = torchw.estimate_runs(cci, vc, valid)
        assert est == jaxw.estimate_runs(cci, vc, valid)
        for k, want in ((est, False), (est - 1, True)):
            if k < 1:
                continue
            ov2 = torchw.linearize_v2(hi, lo, cci, vc, valid, k_max=k,
                                      device="cpu")[2]
            ov4 = torchw4.merge_weave_kernel_v4(hi, lo, cci, vc, valid,
                                                k_max=k, device="cpu")[4]
            assert bool(ov2) == want and bool(ov4) == want, (ti, k)


def test_merge_weave_kernel_row_parity():
    """One replica pair through ``merge_weave_kernel`` and its v2."""
    row = jb.divergent_pair_lanes(n_base=20, n_div=6, capacity=64,
                                  hide_every=3)
    match_all(row, "v1", 0)
    match_all(row, "v2", 48)


def test_batched_merge_kernel_parity():
    """The batched v1 union kernel equals the reference's and, decoded,
    the pure pairwise merge (``test_batched_merge_kernel_parity``)."""
    pairs, stack, _ = build_batch(random.Random(2024), 4, 32)
    args = [stack[k] for k in LANE_KEYS]
    got = torchw.batched_merge_weave(*args, device="cpu")
    assert_same(got, jaxw.batched_merge_weave(*map(jnp.asarray, args)))
    order, rank, visible, conflict = map(host, got)
    assert not conflict.any()
    for b, (a_ct, b_ct) in enumerate(pairs):
        weave, vis = decode_device_weave(order[b], rank[b],
                                         pair_lane_nodes(a_ct, b_ct, 32),
                                         visible[b])
        pure = j_shared.merge_trees(j_clist.weave, a_ct, b_ct)
        assert weave == pure.weave, b
        assert vis == j_clist.causal_list_to_list(pure), b


def test_batched_merge_v2_parity():
    """The compressed batch equals the reference's and the v1 batch."""
    _, stack, _ = build_batch(random.Random(77), 3, 32)
    args = [stack[k] for k in LANE_KEYS]
    got = torchw.batched_merge_weave_v2(*args, k_max=64, device="cpu")
    assert_same(got, jaxw.batched_merge_weave_v2(*map(jnp.asarray, args),
                                                 k_max=64))
    assert not host(got[4]).any()
    assert_same(got[:4], torchw.batched_merge_weave(*args, device="cpu"))


def test_pair_run_budget_derived_from_lanes():
    """``estimate_pair_runs`` equals the reference's and the v2 kernel's
    run count; ``pair_run_budget`` equals the reference's and never
    overflows the batch (``test_pair_run_budget_derived_from_lanes``)."""
    row = tb.divergent_pair_lanes(n_base=40, n_div=12, capacity=64,
                                  hide_every=3)
    est = tb.estimate_pair_runs(row)
    assert est == jb.estimate_pair_runs(row)
    a1 = [row[k] for k in LANE_KEYS]
    assert not bool(torchw.merge_weave_kernel_v2(*a1, k_max=est,
                                                 device="cpu")[4])
    assert bool(torchw.merge_weave_kernel_v2(*a1, k_max=est - 1,
                                             device="cpu")[4])
    batch = tb.batched_pair_lanes(n_replicas=6, n_base=40, n_div=12,
                                  capacity=64, hide_every=3)
    k_max = tb.pair_run_budget(batch)
    assert k_max == jb.pair_run_budget(batch)
    out = torchw.batched_merge_weave_v2(*(batch[k] for k in LANE_KEYS),
                                        k_max=k_max, device="cpu")
    assert not host(out[4]).any()


# ------------------------------------------ v3 and v4 (test_jax_v3/_v4)


@pytest.mark.parametrize("version", ["v3", "v4"])
@pytest.mark.parametrize("nb,nd,cap,he", GRID)
def test_pair_merge_parity(version, nb, nd, cap, he):
    row = tb.divergent_pair_lanes(n_base=nb, n_div=nd, capacity=cap,
                                  hide_every=he)
    match_all(row, version, tb.estimate_pair_runs(row) + 8)


@pytest.mark.parametrize("version", ["v3", "v4"])
def test_fuzz_tree_parity(version):
    """Random trees with chained specials, multi-site interleaving and
    dangling-adjacent shapes."""
    seed = 0xF00D if version == "v3" else 0xBEEF
    for cl in fuzz_trees(seed, 8):
        lanes, na = tree_lanes(cl)
        match_all(row_of(lanes), version, max(8, na.capacity))


@pytest.mark.parametrize("version", ["v3", "v4"])
def test_concat_of_two_api_trees(version):
    """Two API replicas' lanes concatenated, their causes offset into
    concat coordinates: the shared base dedupes and causes resolve
    through the kept copies (``test_v4_concat_of_two_api_trees``)."""
    rng = random.Random(7)
    base = c.clist(*"abcdef")
    ra, rb = base, base
    sa, sb = new_site_id(), new_site_id()
    for _ in range(10):
        ra = ra.insert(rand_node(rng, ra, site_id=sa))
        rb = rb.insert(rand_node(rng, rb, site_id=sb))
    cap = 64
    it = SiteInterner({i[1] for i in ra.ct.nodes}
                      | {i[1] for i in rb.ct.nodes})
    naa = NodeArrays.from_nodes_map(ra.ct.nodes, capacity=cap, interner=it)
    nab = NodeArrays.from_nodes_map(rb.ct.nodes, capacity=cap, interner=it)
    row = {}
    for k, fa, fb in (("hi", naa.id_lanes()[0], nab.id_lanes()[0]),
                      ("lo", naa.id_lanes()[1], nab.id_lanes()[1]),
                      ("chi", naa.cause_lanes()[0], nab.cause_lanes()[0]),
                      ("clo", naa.cause_lanes()[1], nab.cause_lanes()[1]),
                      ("vc", naa.vclass, nab.vclass),
                      ("valid", naa.valid, nab.valid)):
        row[k] = np.concatenate([fa, fb])
    row["cci"] = np.concatenate([
        naa.cause_idx,
        np.where(nab.cause_idx >= 0, nab.cause_idx + cap, -1).astype(
            np.int32)])
    match_all(row, version, 2 * cap)


@pytest.mark.parametrize("version", ["v3", "v4"])
def test_batched_parity_and_overflow(version):
    batch = tb.batched_pair_lanes(n_replicas=6, n_base=40, n_div=12,
                                  capacity=64, hide_every=3)
    k_max = tb.pair_run_budget(batch)
    if version == "v3":
        args = [batch[k] for k in LANE_KEYS]
        port, ref = torchw3.batched_merge_weave_v3, \
            jaxw3.batched_merge_weave_v3
    else:
        args = [batch[k] for k in LANE_KEYS4]
        port, ref = torchw4.batched_merge_weave_v4, \
            jaxw4.batched_merge_weave_v4
    got = port(*args, k_max=k_max, device="cpu")
    assert_same(got, ref(*map(jnp.asarray, args), k_max=k_max))
    assert not host(got[4]).any()
    assert_same(got[:4], jaxw.batched_merge_weave(
        *(jnp.asarray(batch[k]) for k in LANE_KEYS)))
    # a busted budget flags every row, in both packages
    ovf = host(port(*args, k_max=4, device="cpu")[4])
    assert ovf.all()
    assert np.array_equal(ovf, np.asarray(ref(*map(jnp.asarray, args),
                                              k_max=4)[4]))


@pytest.mark.parametrize("version", ["v3", "v4"])
def test_hypothesis_random_interactions(version):
    """Any tree the public API reaches (random conj/insert/hide/h.show
    interleavings across three sites) linearizes identically under the
    port's v3/v4, the reference's and its v1."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=8, deadline=None, derandomize=True)
    @given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 6),
                              st.integers(0, 2)), min_size=1, max_size=18))
    def prop(ops):
        cl = c.clist("s")
        sites = ["hypSiteA_____", "hypSiteB_____", "hypSiteC_____"]
        for kind, target, site_i in ops:
            nodes = sorted(cl.ct.nodes)
            value = ("v", c.hide, c.h_show)[kind]
            cl = cl.insert(((cl.get_ts() + 1, sites[site_i], 0),
                            nodes[target % len(nodes)], value))
        lanes, na = tree_lanes(cl)
        match_all(row_of(lanes), version, max(8, na.capacity))

    prop()


def test_v4_euler_walk_parity():
    """Both of the port's Euler arms equal both of the reference's (its
    pointer doubling and its Pallas walk, interpret mode) on a pair
    merge, fuzz trees and a batch (``test_v4_euler_walk_parity``)."""
    def both(port_fn, ref_fn):
        want = [ref_fn("doubling"), ref_fn("walk")]
        assert_same(want[0], want[1])
        for arm in torchw4.EULER:
            assert_same(port_fn(arm), want[0], arm)

    row = tb.divergent_pair_lanes(n_base=40, n_div=12, capacity=64,
                                  hide_every=3)
    k = tb.estimate_pair_runs(row) + 8
    a4 = [row[x] for x in LANE_KEYS4]
    both(lambda e: torchw4.merge_weave_kernel_v4(*a4, k_max=k, euler=e,
                                                 device="cpu"),
         lambda e: jaxw4.merge_weave_kernel_v4_jit(
             *map(jnp.asarray, a4), k_max=k, euler=e))
    for cl in fuzz_trees(0xA11CE, 2, n_ops=(3, 20)):
        (hi, lo, _, _, cci, vc, valid), na = tree_lanes(cl)
        t4 = (hi, lo, cci, vc, valid)
        k = max(8, na.capacity)
        both(lambda e: torchw4.merge_weave_kernel_v4(*t4, k_max=k, euler=e,
                                                     device="cpu"),
             lambda e: jaxw4.merge_weave_kernel_v4_jit(
                 *map(jnp.asarray, t4), k_max=k, euler=e))
    batch = tb.batched_pair_lanes(n_replicas=5, n_base=30, n_div=9,
                                  capacity=64, hide_every=2)
    b4 = [batch[x] for x in LANE_KEYS4]
    km = tb.pair_run_budget(batch)
    both(lambda e: torchw4.batched_merge_weave_v4(*b4, k_max=km, euler=e,
                                                  device="cpu"),
         lambda e: jaxw4.batched_merge_weave_v4(*map(jnp.asarray, b4),
                                                k_max=km, euler=e))


def test_v4_unknown_euler_arm_raises():
    row = tb.divergent_pair_lanes(n_base=4, n_div=2, capacity=16)
    with pytest.raises(ValueError, match="euler"):
        torchw4.merge_weave_kernel_v4(*(row[k] for k in LANE_KEYS4),
                                      k_max=16, euler="pallas", device="cpu")


@pytest.mark.parametrize("version", ["v1", "v2", "v3", "v4"])
def test_conflict_flag(version):
    """Two lanes sharing an id with different bodies raise the conflict
    flag in every generation, as in the reference."""
    row = tb.divergent_pair_lanes(n_base=10, n_div=4, capacity=32,
                                  hide_every=0)
    row["vc"] = row["vc"].copy()
    row["vc"][len(row["vc"]) // 2 + 5] = 1  # a shared base node's body
    got = port_kernel(version)(row, 64)
    want = ref_kernel(version, row, 64)
    assert bool(host(got[3])) and bool(np.asarray(want[3]))
    assert_same(got, want)


# ----------------------------------- the smoke shapes (test_jax_smoke.py)


def _concat_ranks(order, rank, visible):
    o, r, v = host(order), host(rank), host(visible)
    n = o.shape[0]
    rank_c = np.full(n, n, np.int32)
    vis_c = np.zeros(n, bool)
    rank_c[o] = r
    vis_c[o] = v
    return rank_c, vis_c


@pytest.mark.parametrize("version", ["v2", "v3", "v4"])
def test_tiny_pair_parity(version):
    """``test_v2_v3_tiny_pair_parity`` and ``test_v4_tiny_pair_parity``:
    concat-lane ranks and visibility equal the reference's v1."""
    row = tb.divergent_pair_lanes(n_base=20, n_div=6, capacity=64,
                                  hide_every=3)
    o, r, v, _, ov = port_kernel(version)(row, 48)
    assert not bool(ov)
    want = _concat_ranks(*jaxw.merge_weave_kernel(
        *(jnp.asarray(row[k]) for k in LANE_KEYS))[:3])
    got = _concat_ranks(o, r, v)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])


# ------------------------------------------ benchgen (test_benchgen.py)


def test_cci_lanes_and_fleet_lanes_match_the_reference():
    """The port's generators equal the reference's array for array, and
    their cci lanes point at each lane's cause (the id at cci equals the
    cause id lanes; ``test_v4_cci_lane_generation``)."""
    for gen in (lambda m: m.divergent_pair_lanes(n_base=12, n_div=5,
                                                 capacity=32, hide_every=2),
                lambda m: m.batched_pair_lanes(n_replicas=4, n_base=12,
                                               n_div=5, capacity=32,
                                               hide_every=2),
                lambda m: m.fleet_lanes(n_replicas=3, n_base=12, n_div=5,
                                        capacity=32, hide_every=2),
                lambda m: m.fleet_lanes(n_replicas=5, n_base=0, n_div=7,
                                        capacity=16)):
        got, want = gen(tb), gen(jb)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
        flat = {k: v.reshape(-1) for k, v in got.items()}
        cci = got["cci"]
        if cci.ndim == 2:  # per-row cci is row-local
            cci = cci + (np.arange(cci.shape[0]) * cci.shape[1])[:, None]
        cci = cci.reshape(-1)
        has = flat["cci"] >= 0
        assert np.array_equal(flat["hi"][cci[has]], flat["chi"][has])
        assert np.array_equal(flat["lo"][cci[has]], flat["clo"][has])


def test_fleet_converges_to_one_tree():
    """A whole fleet's flattened lanes through the K-ary v1 and v4 union
    equal the reference's v1."""
    fleet = tb.fleet_lanes(n_replicas=4, n_base=10, n_div=4, capacity=16,
                           hide_every=3)
    want = _jv1(*(jnp.asarray(fleet[k]) for k in LANE_KEYS))
    assert_same(torchw.merge_weave_kernel(*(fleet[k] for k in LANE_KEYS),
                                          device="cpu"), want)
    got4 = torchw4.merge_weave_kernel_v4(*(fleet[k] for k in LANE_KEYS4),
                                         k_max=64, device="cpu")
    assert not bool(got4[4])
    assert_same(got4[:4], want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_union_lanes_np_matches_the_reference(seed):
    pairs, stack, _ = build_batch(random.Random(seed), 2, 32)
    for b in range(2):
        row = [stack[k][b] for k in LANE_KEYS]
        assert_same(tb._union_lanes_np(*row), jb._union_lanes_np(*row))
