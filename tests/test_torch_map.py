"""The port's maps against the JAX package's: the map collection, the
device map reweave and merge, the batched map-fleet wave and map serde.

Each fleet is built in both packages from the same op script with the
same site ids and uuids, so both mint the same nodes, intern the same
key and site ranks and marshal the same forest lanes: lanes, ranks,
visibility and uint32 digests compare across packages bit for bit. The
reference runs its v5 kernel on the CPU as its own tests do; the port's
kernels run through their plain versions. Merged weaves are also held
against the port's pure weaver.

Mirrors ``tests/test_mapw.py`` (the v5 and v4 routes; the sharded routes
raise until ROADMAP A.15), all of ``tests/test_map.py`` (over the pure
and torch weavers) and the map cases of ``tests/test_serde.py``.
"""

import json
import random

import numpy as np
import pytest
import torch

import cause_tpu as c
from cause_tpu import serde as j_serde
from cause_tpu.collections import cmap as j_cmap
from cause_tpu.weaver import jaxw as j_jaxw
from cause_tpu.weaver import mapw as j_mapw

import cause_tpu_torch as ct
from cause_tpu_torch import serde as t_serde
from cause_tpu_torch.collections import cmap as t_cmap
from cause_tpu_torch.collections import shared as t_shared
from cause_tpu_torch.weaver import mapw as t_mapw
from cause_tpu_torch.weaver import torchw
from cause_tpu_torch.weaver.arrays import OutsideDomain, SiteInterner


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's device paths on the CPU for each test."""
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def site(tag: str, i: int = 0) -> str:
    """A fixed 13-character site id."""
    return f"s{tag}{i:0{12 - len(tag)}d}"


def fork(cm, tag, i):
    return type(cm)(cm.ct.evolve(site_id=site(tag, i)))


def make_pairs(pkg, n_pairs, n_keys=6, edits=4, seed=7, weaver="pure"):
    """``tests/test_mapw.py``'s ``make_pairs`` with fixed site ids and
    uuid, in package ``pkg`` (``c`` or ``ct``)."""
    rng = random.Random(seed)
    base = pkg.cmap(weaver=weaver)
    base = type(base)(base.ct.evolve(site_id=site("BASE"),
                                     uuid="mapTwinFleetUuid00000"))
    for i in range(n_keys):
        base = base.append(pkg.K(f"k{i}"), f"v{i}")
    pairs = []
    for p in range(n_pairs):
        a, b = fork(base, "A", p), fork(base, "B", p)
        for e in range(edits):
            ka = pkg.K(f"k{rng.randrange(n_keys + 2)}")
            a = a.append(ka, f"a{p}.{e}")
            kb = pkg.K(f"k{rng.randrange(n_keys + 2)}")
            if rng.random() < 0.3:
                b = b.dissoc(kb)
            else:
                b = b.append(kb, f"b{p}.{e}")
        if rng.random() < 0.5:
            # id-caused undo of a's last write to ka (map.cljc:33-43)
            target = a.ct.weave[ka][1][0]
            a = a.append(target, pkg.hide)
        pairs.append((a, b))
    return pairs


def twin_pairs(*args, **kw):
    return make_pairs(c, *args, **kw), make_pairs(ct, *args, **kw)


def data(x, serde):
    """A package's value as plain JSON-able data (its serde encoding):
    Keywords and Specials of the two packages compare equal this way."""
    return json.loads(json.dumps(serde.to_data(x)))


def weave_data(weave, serde):
    """A map weave as ``{encoded key: encoded list-weave}``, blind to the
    dict's insertion order."""
    return {json.dumps(data(k, serde)): data(w, serde)
            for k, w in weave.items()}


def pure_merge(a, b):
    cls = type(a)
    return cls(a.ct.evolve(weaver="pure")).merge(
        cls(b.ct.evolve(weaver="pure")))


def assert_row_matches_pure(pairs, lanes, meta, rank, i):
    a, b = pairs[i]
    got = t_mapw.merged_map_weave(lanes, meta, None, rank, i)
    ref = pure_merge(a, b).ct.weave
    assert set(got) == set(ref), i
    for k in ref:
        assert got[k] == ref[k], (i, k)


def pair_nodes(pairs):
    return [(a.ct.nodes, b.ct.nodes) for a, b in pairs]


# ------------------------------------------- the wave (tests/test_mapw.py)


@pytest.mark.parametrize("n_pairs, n_keys, edits, seed", [
    (6, 6, 4, 7), (5, 4, 3, 33), (8, 5, 5, 21), (4, 2, 8, 3)])
def test_v5_route_batched_kernel_direct(n_pairs, n_keys, edits, seed):
    """The raw v5 forest dispatch (lane-coordinate contract): the port's
    forest lanes, ranks and visibility equal the reference's, and each
    row's merged weave equals the pure merge (``test_mapw.py``'s
    ``test_batched_map_merge_matches_pure`` and
    ``test_v5_route_batched_kernel_direct``)."""
    jp, tp = twin_pairs(n_pairs, n_keys, edits, seed)
    j_lanes, j_meta = j_mapw.pair_rows(pair_nodes(jp))
    t_lanes, t_meta = t_mapw.pair_rows(pair_nodes(tp))
    assert t_meta["capacity"] == j_meta["capacity"]
    for k in j_lanes:
        assert np.array_equal(t_lanes[k], j_lanes[k]), k
    cap = t_meta["capacity"]
    (j_rank, j_vis, _jc, j_ov), j_u = j_mapw.batched_merge_map_weave_v5(
        j_lanes, cap)
    (t_rank, t_vis, _tc, t_ov), t_u = t_mapw.batched_merge_map_weave_v5(
        t_lanes, cap, device="cpu")
    assert t_u == j_u
    assert not t_ov.any() and not np.asarray(j_ov).any()
    t_rank, t_vis = t_rank.numpy(), t_vis.numpy()
    assert np.array_equal(t_rank, np.asarray(j_rank))
    assert np.array_equal(t_vis, np.asarray(j_vis))
    for i in range(n_pairs):
        assert_row_matches_pure(tp, t_lanes, t_meta, t_rank, i)
    assert np.array_equal(
        t_mapw.map_row_digest(t_lanes, None, t_rank, t_vis),
        j_mapw.map_row_digest(j_lanes, None, j_rank, j_vis))


def test_map_digests_detect_convergence():
    """Distinct pairs digest differently, an identical pair twice digests
    equal, and every digest equals the reference's."""
    jp, tp = twin_pairs(4)
    res = t_mapw.merge_map_wave(tp)
    assert np.array_equal(res.digest, j_mapw.merge_map_wave(jp).digest)
    assert len(set(res.digest.tolist())) == len(tp)
    two = t_mapw.merge_map_wave([tp[0], tp[0]])
    assert two.digest[0] == two.digest[1]


def test_forest_lanes_domain_guards():
    """A well-formed tree marshals to the reference's lanes; a dangling
    id cause is off-domain."""
    trees = []
    for pkg in (c, ct):
        cm = pkg.cmap()
        cm = type(cm)(cm.ct.evolve(site_id=site("GUARD")))
        trees.append(cm.append(pkg.K("a"), 1).append(pkg.K("b"), 2)
                     .append(pkg.K("a"), 3))
    (j_cm, t_cm) = trees
    krank = t_mapw.key_table([t_cm.ct.nodes])
    interner = SiteInterner(nid[1] for nid in t_cm.ct.nodes)
    got = t_mapw.forest_lanes(t_cm.ct.nodes, krank, interner, 16)
    from cause_tpu.weaver.arrays import SiteInterner as JInterner

    want = j_mapw.forest_lanes(
        j_cm.ct.nodes, j_mapw.key_table([j_cm.ct.nodes]),
        JInterner(nid[1] for nid in j_cm.ct.nodes), 16)
    for g, w in zip(got[:5], want[:5]):
        assert np.array_equal(g, w)
    assert data(got[5], t_serde) == data(want[5], j_serde)
    bad = dict(t_cm.ct.nodes)
    bad[(9, t_cm.get_site_id(), 0)] = ((5, "nowhere______", 0), "x")
    with pytest.raises(OutsideDomain):
        t_mapw.forest_lanes(bad, krank, interner, 16)
    with pytest.raises(OverflowError):
        t_mapw.forest_lanes(t_cm.ct.nodes, krank, interner, 4)


def test_merge_map_wave_api():
    """One dispatch, digests equal to the reference's, lazy handles
    identical to pairwise merges; list handles are rejected, conflicting
    bodies raise at merged()."""
    jp, tp = twin_pairs(5)
    res = t_mapw.merge_map_wave(tp)
    j_res = j_mapw.merge_map_wave(jp)
    assert np.array_equal(res.digest, j_res.digest)
    assert res.digest_valid.all() and res.fallback == []
    assert len(set(res.digest.tolist())) == len(tp)
    for i, (a, b) in enumerate(tp):
        got = res.merged(i)
        ref = pure_merge(a, b)
        assert got.causal_to_edn() == ref.causal_to_edn(), i
        assert got.ct.weave == ref.ct.weave
        assert got.get_nodes() == ref.get_nodes()
        assert weave_data(got.ct.weave, t_serde) == weave_data(
            j_res.merged(i).ct.weave, j_serde)
    with pytest.raises(t_shared.CausalError):
        t_mapw.merge_map_wave([(ct.clist("x"), ct.clist("x"))])
    with pytest.raises(t_shared.CausalError) as ei:
        t_mapw.merge_map_wave([])
    assert "empty-fleet" in ei.value.info["causes"]
    a, b = tp[0]
    evil = (99, a.get_site_id(), 0)
    a2 = a.insert((evil, ct.K("k0"), "mine"))
    b2 = b.insert((evil, ct.K("k0"), "theirs"))
    res2 = t_mapw.merge_map_wave([(a2, b2)])
    with pytest.raises(t_shared.CausalError) as ei:
        res2.merged(0)
    assert "append-only" in ei.value.info["causes"]


def test_merge_map_wave_edge_cases():
    """Empty maps materialize; out-of-domain pairs (h.show targeting a
    hide) fall back per pair; PackSpec overflow falls back rather than
    wrapping packed ids — as in the reference, whose digests and
    fallback rows the port's equal."""
    def build(pkg):
        m = pkg.cmap()
        m = type(m)(m.ct.evolve(site_id=site("EDGE"), uuid="mapEdgeCaseUuid000000"))
        empty = (m, fork(m, "E", 1))
        a = m.append(pkg.K("k"), "v1")
        target = a.ct.weave[pkg.K("k")][1][0]
        a = a.append(target, pkg.hide)
        hide_id = next(nid for nid, (_cz, v) in a.ct.nodes.items()
                       if v is pkg.hide)
        a = a.insert(((a.get_ts() + 1, a.get_site_id(), 0), hide_id,
                      pkg.h_show))
        b = fork(a, "E", 2).append(pkg.K("x"), 1)
        good = fork(a, "E", 3).append(pkg.K("y"), 2)
        o1 = m.append(pkg.K("t"), 1)
        o1b = fork(o1, "E", 4)
        big = ((1 << 31) - 1, a.get_site_id(), 0)
        o1 = o1.insert((big, pkg.K("t"), "huge"))
        o1b = o1b.insert((big, pkg.K("t"), "huge"))
        return [empty], [(a, b), (good, fork(good, "E", 5))], [(o1, o1b)]

    for j_fleet, t_fleet in zip(build(c), build(ct)):
        res = t_mapw.merge_map_wave(t_fleet)
        j_res = j_mapw.merge_map_wave(j_fleet)
        assert res.fallback == j_res.fallback
        assert np.array_equal(res.digest, j_res.digest)
        assert np.array_equal(res.digest_valid, j_res.digest_valid)
        for i, (x, y) in enumerate(t_fleet):
            got, want = res.merged(i), pure_merge(x, y)
            assert got.causal_to_edn() == want.causal_to_edn()
            assert got.ct.weave == want.ct.weave
    assert 0 in t_mapw.merge_map_wave(build(ct)[1]).fallback
    assert t_mapw.merge_map_wave(build(ct)[2]).fallback == [0]


def test_merge_map_wave_overflow_retry_and_host_rows(monkeypatch):
    """A starved token budget overflows: the wave doubles it and
    re-dispatches (at most three dispatches), and rows that still
    overflow take the host merge — results equal the pure merge."""
    from cause_tpu_torch import benchgen

    # small rows fit a budget of 32 tokens, large rows need 45-48
    tp = (make_pairs(ct, 2, n_keys=2, edits=1, seed=5)
          + make_pairs(ct, 2, n_keys=10, edits=12, seed=5))
    budgets = []
    real = t_mapw.batched_merge_map_weave_v5

    def spy(lanes, cap, u_max=0, v5b=None, device="cuda"):
        budgets.append(u_max)
        return real(lanes, cap, u_max=u_max, v5b=v5b, device=device)

    monkeypatch.setattr(t_mapw, "batched_merge_map_weave_v5", spy)
    monkeypatch.setattr(benchgen, "v5_token_budget", lambda v5b: 8)
    res = t_mapw.merge_map_wave(tp)
    assert budgets == [8, 16, 32]
    assert res.fallback == [2, 3]  # past 32 tokens: the host merge
    for i, (a, b) in enumerate(tp):
        assert res.merged(i).ct.weave == pure_merge(a, b).ct.weave
        assert res.digest_valid[i] == (i not in res.fallback)


def test_v5_route_matches_pure():
    """The segment-union route's merged per-key weaves equal the pure
    merge's (the v5-vs-pure half of ``test_v5_route_matches_pure_and_v4``;
    the v4 route is ROADMAP A.14)."""
    jp, tp = twin_pairs(8, n_keys=5, edits=5, seed=21)
    res = t_mapw.merge_map_wave(tp)
    assert np.array_equal(res.digest, j_mapw.merge_map_wave(jp).digest)
    for i, (a, b) in enumerate(tp):
        ref = pure_merge(a, b)
        assert res.merged(i).ct.weave == ref.ct.weave, i
        assert res.merged(i).causal_to_edn() == ref.causal_to_edn()


def test_v5_route_digest_convergence():
    """Converged twin rows digest EQUAL, rows of different content
    DIFFERENT (within one wave = one key/site interner domain), equal
    to the reference's digests."""
    digests = []
    for pkg, mod in ((c, j_mapw), (ct, t_mapw)):
        pairs = make_pairs(pkg, 3, n_keys=4, edits=3, seed=55)
        m0, m1, m2 = (pure_merge(a, b) for a, b in pairs)
        res = mod.merge_map_wave([(m0, m0), (m0, m0), (m1, m1), (m2, m2)])
        assert res.digest_valid.all()
        assert res.digest[0] == res.digest[1]
        assert len({int(d) for d in res.digest}) >= 3
        digests.append(res.digest)
    assert np.array_equal(*digests)


@pytest.mark.parametrize("n_pairs, n_keys, edits, seed, call", [
    (8, 5, 5, 21, "positional"), (5, 4, 3, 33, "keyword"),
    (6, 6, 4, 7, "keyword"), (5, 3, 6, 11, "batched"),
    (4, 2, 8, 3, "batched")])
def test_v4_route_matches_reference_and_v5_route(n_pairs, n_keys, edits,
                                                 seed, call):
    """The full-width v4 forest route: ``merge_map_wave(kernel="v4")``
    (positional or keyword) and ``batched_merge_map_weave`` give the
    reference's order, ranks, visibility and digests, and the v5 route's
    merged weaves and digests (``test_mapw.py``'s
    ``test_map_fuzz_batched_parity`` and the v4 half of
    ``test_v5_route_matches_pure_and_v4``)."""
    tp = make_pairs(ct, n_pairs, n_keys=n_keys, edits=edits, seed=seed)
    jp = make_pairs(c, n_pairs, n_keys=n_keys, edits=edits, seed=seed)
    if call == "batched":
        lanes, meta = t_mapw.pair_rows(pair_nodes(tp))
        jlanes, _ = j_mapw.pair_rows(pair_nodes(jp))
        got = t_mapw.batched_merge_map_weave(lanes)
        want = j_mapw.batched_merge_map_weave(jlanes)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
        assert not got[4].any()
        order, rank = got[0].numpy(), got[1].numpy()
        for i, (a, b) in enumerate(tp):
            weave = t_mapw.merged_map_weave(lanes, meta, order, rank, i)
            assert weave == pure_merge(a, b).ct.weave, i
        return
    res4 = (t_mapw.merge_map_wave(tp, "v4") if call == "positional"
            else t_mapw.merge_map_wave(tp, kernel="v4"))
    res5 = t_mapw.merge_map_wave(tp)
    ref4 = j_mapw.merge_map_wave(jp, kernel="v4")
    assert res4.fallback == [] and res4.digest_valid.all()
    assert np.array_equal(res4.digest, ref4.digest)
    assert np.array_equal(res4.digest, res5.digest)
    for i, (a, b) in enumerate(tp):
        ref = pure_merge(a, b)
        assert res4.merged(i).ct.weave == ref.ct.weave, i
        assert res4.merged(i).ct.weave == res5.merged(i).ct.weave, i
        assert res4.merged(i).causal_to_edn() == ref.causal_to_edn()


@pytest.mark.parametrize("call, item", [
    (lambda p: t_mapw.sharded_merge_map_weave(
        None, t_mapw.pair_rows(pair_nodes(p))[0]), "A.15"),
    (lambda p: t_mapw.sharded_merge_map_weave_v5(
        None, *t_mapw.pair_rows(pair_nodes(p))[0:1], 64), "A.15"),
])
def test_unported_routes_raise_naming_their_roadmap_item(call, item):
    tp = make_pairs(ct, 2)
    with pytest.raises(NotImplementedError, match=item):
        call(tp)
    with pytest.raises(ValueError):
        t_mapw.merge_map_wave(tp, kernel="v6")


# --------------------------------- the device reweave and merge (jaxw)


def lin_inputs(kind, seed):
    """``linearize_map_forest`` inputs: N lanes (n real, the rest padding)
    and k_cap key-root slots."""
    rng = np.random.default_rng(seed)
    if kind == "only key roots":
        N, n, n_keys, k_cap = 8, 0, 4, 4
    else:
        N, n, n_keys, k_cap = 64, 50, 5, 8
    cause = np.full(N, -1, np.int32)
    key = np.full(N, -1, np.int32)
    vclass = np.zeros(N, np.int32)
    for i in range(n):
        if i == 0 or rng.random() < 0.6:
            key[i] = rng.integers(0, n_keys)
        else:
            cause[i] = rng.integers(0, i)
            vclass[i] = rng.integers(0, 4)
    if kind == "hide chain":
        # key 0 written at lane 0, then hide -> h.hide -> h.show -> hide,
        # each caused by the one before: a four-link special chain
        for i in range(1, 5):
            key[i], cause[i], vclass[i] = -1, i - 1, 1 + (i % 3)
    valid = np.arange(N) < n
    return cause, key, vclass, valid, n_keys, k_cap


@pytest.mark.parametrize("kind, seed", [
    ("random", 1), ("random", 2), ("hide chain", 3), ("hide chain", 4),
    ("only key roots", 5)])
def test_linearize_map_forest_matches_reference(kind, seed):
    """s_down (and so the per-key order) equals the reference's jitted
    forest linearization, including a chain of specials (the host jump's
    rounds) and a forest of key roots alone."""
    cause, key, vclass, valid, n_keys, k_cap = lin_inputs(kind, seed)
    want = np.asarray(j_jaxw._linearize_map_jit(
        cause, key, vclass, valid, n_keys, k_cap=k_cap))
    got = torchw.linearize_map_forest(
        *(torch.from_numpy(a) for a in (cause, key, vclass, valid)),
        n_keys, k_cap)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def rand_map_node(rng, cm, site_id, pkg):
    """``tests/test_map.py``'s generator in package ``pkg``: key- or
    id-caused nodes, special or plain values in every combination."""
    keys = [pkg.K("a"), pkg.K("b"), "plain", 7]
    ts = cm.get_ts() + 1
    value = (rng.choice([pkg.hide, pkg.h_hide, pkg.h_show])
             if rng.random() < 0.4 else rng.randrange(100))
    if rng.random() < 0.4 and len(cm.ct.nodes) > 0:
        cause = rng.choice(sorted(cm.ct.nodes))
    else:
        cause = rng.choice(keys)
    return ((ts, site_id, 0), cause, value)


def fuzz_replicas(pkg, weaver, seed):
    """Two replicas of a seeded map, each with random foreign nodes."""
    rng = random.Random(seed)
    base = pkg.cmap(weaver=weaver)
    base = type(base)(base.ct.evolve(site_id=site("FZ"),
                                     uuid="mapFuzzTwinUuid000000"))
    base = base.assoc(pkg.K("seed"), 0)
    reps = []
    for r in range(2):
        h = fork(base, "FZ", r + 1)
        for _ in range(rng.randrange(1, 9)):
            h = h.insert(rand_map_node(rng, h, h.ct.site_id, pkg))
        reps.append(h)
    return reps


@pytest.mark.parametrize("seed", range(6))
def test_torch_map_reweave_and_merge_match_reference(seed):
    """``weaver="torch"`` maps: the full reweave and the merge equal the
    pure weaver's and the reference's ``weaver="jax"`` (nodes, yarns,
    clock, weave), off-domain fuzz trees included."""
    j_reps = fuzz_replicas(c, "jax", seed)
    t_reps = fuzz_replicas(ct, "torch", seed)
    for jr, tr in zip(j_reps, t_reps):
        got = torchw.refresh_map_weave(tr.ct)
        assert got.weave == t_cmap.weave(tr.ct.evolve(weaver="pure")).weave
        assert weave_data(got.weave, t_serde) == weave_data(
            j_cmap.weave(jr.ct).weave, j_serde)
    merged = t_reps[0].merge(t_reps[1])
    pure = pure_merge(*t_reps)
    j_merged = j_reps[0].merge(j_reps[1])
    assert merged.ct.weaver == "torch"
    for attr in ("nodes", "yarns", "lamport_ts", "weave"):
        assert getattr(merged.ct, attr) == getattr(pure.ct, attr), attr
    assert weave_data(merged.ct.weave, t_serde) == weave_data(
        j_merged.ct.weave, j_serde)
    assert data(merged.causal_to_edn(), t_serde) == data(
        j_merged.causal_to_edn(), j_serde)


def test_torch_map_end_to_end():
    """weaver="torch" maps through the public API: undo by id, refresh
    of the caches, empty maps, merge_many, and merge_all (maps take
    the flat path, never the list tree)."""
    cm = ct.cmap(weaver="torch").assoc(ct.K("a"), 1).assoc(ct.K("b"), 2)
    cm = cm.assoc(ct.K("a"), 3).dissoc(ct.K("b"))
    overwrite_id = list(cm)[0][0]
    cm = cm.append(overwrite_id, ct.h_hide).append(overwrite_id, ct.h_show)
    refreshed = t_shared.refresh_caches(t_cmap.weave, cm.ct)
    assert refreshed.weave == cm.ct.weave
    assert ct.cmap(weaver="torch").causal_to_edn() == {}
    fleet = [fork(cm, "F", i).assoc(ct.K(f"f{i}"), i) for i in range(5)]
    flat = fleet[0].merge_many(fleet[1:])
    folded = fleet[0]
    for r in fleet[1:]:
        folded = folded.merge(r)
    assert ct.merge_all(fleet[0], *fleet[1:]).ct.weave == flat.ct.weave
    assert flat.ct.weave == folded.ct.weave
    assert flat.causal_to_edn() == {ct.K("a"): 3, **{
        ct.K(f"f{i}"): i for i in range(5)}}


# ------------------------------------------------ tests/test_map.py


WEAVERS = ["pure", "torch"]


@pytest.mark.parametrize("weaver", WEAVERS)
def test_basic_map(weaver):
    """(map_test.cljc:5-15)"""
    cm = (
        ct.cmap(weaver=weaver)
        .assoc("foo", "bar")
        .assoc("fizz", "buzz")
        .assoc("fizz", "bang")
        .dissoc("foo")
        .assoc("list", ct.clist("a", "b", "c"))
    )
    assert cm.causal_to_edn() == {"fizz": "bang", "list": ["a", "b", "c"]}


@pytest.mark.parametrize("weaver", WEAVERS)
def test_hide_and_show_and_hide_and_show(weaver):
    """(map_test.cljc:17-31)"""
    cm = ct.cmap("foo", "bar", "fizz", "buzz", weaver=weaver)
    assert cm.causal_to_edn() == {"foo": "bar", "fizz": "buzz"}
    cm = cm.append("foo", ct.hide)
    assert cm.causal_to_edn() == {"fizz": "buzz"}
    cm = cm.append("foo", ct.h_show)
    assert cm.causal_to_edn() == {"foo": "bar", "fizz": "buzz"}
    cm = cm.append("foo", ct.hide)
    assert cm.causal_to_edn() == {"fizz": "buzz"}
    cm = cm.append("foo", ct.h_show)
    assert cm.causal_to_edn() == {"foo": "bar", "fizz": "buzz"}
    cm = cm.append("foo", "boo")
    cm = cm.append("foo", ct.h_show)
    cm = cm.append("foo", ct.h_show)
    assert cm.causal_to_edn() == {"foo": "boo", "fizz": "buzz"}


@pytest.mark.parametrize("weaver", WEAVERS)
def test_hide_and_show_by_node_id(weaver):
    """(map_test.cljc:33-43) — id-caused undo of an LWW overwrite."""
    cm = ct.cmap("foo", "bar", weaver=weaver)
    assert cm.causal_to_edn() == {"foo": "bar"}
    cm = cm.append("foo", "boo")
    assert cm.causal_to_edn() == {"foo": "boo"}
    boo_id = list(cm)[0][0]
    cm = cm.append(boo_id, ct.hide)
    assert cm.causal_to_edn() == {"foo": "bar"}
    cm = cm.append(boo_id, ct.h_show)
    assert cm.causal_to_edn() == {"foo": "boo"}
    # the device reweave of the same nodes agrees
    assert torchw.refresh_map_weave(cm.ct).weave == cm.ct.weave


@pytest.mark.parametrize("weaver", WEAVERS)
def test_core_map_protocol(weaver):
    """(map_test.cljc:45-89)"""
    def cmap(*kv):
        return ct.cmap(*kv, weaver=weaver)

    assert len(cmap()) == 0
    assert list(cmap("foo", "bar"))
    assert len(cmap("foo", "bar").dissoc("foo")) == 0
    assert list(cmap("foo", "bar").dissoc("foo").assoc("foo", ct.h_show))
    assert cmap("foo", "bar")["foo"] == "bar"
    assert cmap("foo", "bar").get("foo") == "bar"
    nested = cmap("foo", cmap("foo", "bar"))
    assert nested["foo"]["foo"] == "bar"
    assert len(cmap("foo", "bar")) == 1
    assert len(cmap("foo", "bar").dissoc("foo").assoc("foo", ct.h_show)) == 1

    node = ((1, "site-id", 0), "fizz", "buzz")
    inserted = cmap().insert(node)
    assert list(inserted)[0] == node
    assert list(inserted)[-1] == node
    assert list(inserted)[1:] == []
    two = inserted.assoc("foo", "bar")
    assert list(two)[1:] == [node]  # newest key first
    # a re-inserted node shows through a hidden sibling key
    assert list(cmap("foo", "bar").dissoc("foo").insert(node)) == [node]

    assert cmap().conj({"foo": "bar"})["foo"] == "bar"
    assert isinstance(hash(cmap("foo", "bar")), int)
    assert str(cmap("foo", "bar")) == "{'foo': 'bar'}"
    assert cmap("foo", "bar").dissoc("foo").get("foo") is None
    assert (
        cmap("foo", "bar").dissoc("foo").assoc("foo", ct.h_show).get("foo")
        == "bar"
    )


def test_map_get_in_update_in():
    """Nested access/update through CausalMap values
    (map_test.cljc:56-64)."""
    CausalMap = ct.CausalMap

    nested = ct.cmap("foo", ct.cmap("foo", "bar"))
    assert nested.get_in(["foo", "foo"]) == "bar"
    assert nested.get_in(["foo", "nope"]) is None
    assert nested.get_in(["nope", "foo"], "dflt") == "dflt"

    updated = nested.update("foo", CausalMap.assoc, "foo", "boo")
    assert updated.get_in(["foo", "foo"]) == "boo"

    counts = ct.cmap("foo", ct.cmap("foo", 1))
    bumped = counts.update_in(["foo", "foo"], lambda v: v + 1)
    assert bumped.get_in(["foo", "foo"]) == 2
    with pytest.raises(ValueError):
        counts.update_in([], lambda v: v)

    mixed = ct.cmap("d", {"x": 1}, "l", [10, 20])
    assert mixed.get_in(["d", "x"]) == 1
    assert mixed.get_in(["l", 0]) == 10
    assert mixed.get_in(["l", 9], "dflt") == "dflt"
    assert mixed.update_in(["d", "x"], lambda v: v + 1).get_in(["d", "x"]) == 2
    with pytest.raises(t_shared.CausalError) as ei:
        mixed.update_in(["nope", "x"], lambda v: v)
    assert "missing-path-segment" in ei.value.info["causes"]
    with pytest.raises(t_shared.CausalError) as ei:
        mixed.update_in(["l", 0, "deep"], lambda v: v)
    assert "not-associative" in ei.value.info["causes"]
    with pytest.raises(t_shared.CausalError) as ei:
        ct.cmap("d", {"l": [1]}).update_in(["d", "l", 0], lambda v: v)
    assert "not-associative" in ei.value.info["causes"]
    assert ct.cmap("d", {"x": None}).get_in(["d", "x"], "dflt") is None
    with pytest.raises(t_shared.CausalError) as ei:
        ct.cmap("d", {"x": None}).update_in(["d", "x", "deep"], lambda v: v)
    assert "not-associative" in ei.value.info["causes"]


def test_map_reduce_kv():
    """IKVReduce analogue over the rendered map (map.cljc:141-143)."""
    cm = ct.cmap("a", 1, "b", 2, "c", 3)
    assert cm.reduce_kv(lambda acc, k, v: acc + v, 0) == 6
    keys = cm.reduce_kv(lambda acc, k, v: acc | {k}, set())
    assert keys == {"a", "b", "c"}
    assert ct.cmap().reduce_kv(lambda acc, k, v: acc + 1, 0) == 0


def test_map_meta():
    """IObj/IMeta analogue (map.cljc:159-163)."""
    cm = ct.cmap("k", "v")
    assert cm.meta() is None
    tagged = cm.with_meta({"src": "test"})
    assert tagged.meta() == {"src": "test"}
    assert tagged == cm
    assert tagged.assoc("k2", "v2").ct.meta == {"src": "test"}


def test_assoc_skips_equal_value_and_dissoc_of_missing_key():
    """map.cljc:75-89: setting a key to its current value writes no
    node; only existing keys get tombstoned."""
    cm = ct.cmap("k", 1)
    assert cm.assoc("k", 1) == cm
    assert cm.assoc("k", 2) != cm
    assert cm.dissoc("nope") == cm


@pytest.mark.parametrize("weaver", WEAVERS)
def test_map_merge_lww(weaver):
    """Concurrent writers converge; higher id wins the register."""
    base = ct.cmap("k", "v0", weaver=weaver)
    a = fork(base, "LWW", 1).append("k", "a-wins")
    b = fork(base, "LWW", 2).append("k", "b-wins")
    ab = a.merge(b)
    ba = b.merge(a)
    assert ab.causal_to_edn() == ba.causal_to_edn()
    a_node = list(a)[0]
    b_node = list(b)[0]
    winner = a_node if a_node[0] > b_node[0] else b_node
    assert ab["k"] == winner[2]


def test_map_kwargs_constructor():
    assert ct.cmap(foo="bar").causal_to_edn() == {"foo": "bar"}
    assert ct.cmap(weaver="torch", foo="bar").ct.weaver == "torch"


# ------------------------------------------- serde (tests/test_serde.py)


def assert_tree_equal(a_ct, b_ct):
    for attr in ("type", "uuid", "site_id", "lamport_ts", "weaver", "nodes",
                 "yarns", "weave"):
        assert getattr(a_ct, attr) == getattr(b_ct, attr), attr


@pytest.mark.parametrize("weaver", WEAVERS)
def test_map_round_trip(weaver):
    cm = ct.cmap(weaver=weaver).append(ct.K("a"), "x").append(
        ct.K("a"), "y").append("plain", 7)
    first_id = list(cm)[0][0]
    cm = cm.append(first_id, ct.hide)
    out = t_serde.loads(t_serde.dumps(cm))
    assert isinstance(out, ct.CausalMap)
    assert_tree_equal(out.ct, cm.ct)
    assert out.causal_to_edn() == cm.causal_to_edn()


def test_map_serde_bytes_match_reference():
    """A map with keyword, string and int keys, specials, an undo by id
    and nested values encodes to the reference's data and JSON, and
    each package decodes the other's bytes to an equal map."""
    def build(pkg):
        cm = pkg.cmap()
        cm = type(cm)(cm.ct.evolve(site_id=site("SERDE"),
                                   uuid="mapSerdeTwinUuid00000"))
        cm = cm.assoc(pkg.K("a"), (1, "t"), "s", {"k": [1, 2]}, 7,
                      frozenset({3}))
        cm = cm.assoc(pkg.K("a"), float("inf")).dissoc("s")
        return cm.append(list(cm)[-1][0], pkg.h_hide)

    jm, tm = build(c), build(ct)
    assert t_serde.to_data(tm) == j_serde.to_data(jm)
    assert t_serde.dumps(tm) == j_serde.dumps(jm)
    back = t_serde.loads(j_serde.dumps(jm))
    assert isinstance(back, ct.CausalMap)
    assert_tree_equal(back.ct, tm.ct)
    assert j_serde.dumps(j_serde.loads(t_serde.dumps(tm))) == j_serde.dumps(jm)
