"""The port's native host weaver against its pure weaver and the JAX
package's native weaver.

Mirrors ``tests/test_native_weaver.py`` (every case; the regression
corpus of ``tests/test_list.py`` converted to the port's specials):
``weaver="native"`` in the port builds ``native/weaver.cpp`` with g++
into ``_build/`` and must weave exactly as the pure weaver does, and as
the reference's native weaver does on the same nodes (compared as plain
data: ids, causes, and values with specials and keywords by name).
"""

import random

import pytest

import cause_tpu as c
from cause_tpu.collections import clist as j_clist
from cause_tpu.collections import cmap as j_cmap
from cause_tpu.weaver import nativew as j_nativew

import cause_tpu_torch as ct
from cause_tpu_torch import native
from cause_tpu_torch import ids as t_ids
from cause_tpu_torch.collections import clist as c_list
from cause_tpu_torch.collections import cmap as c_map
from cause_tpu_torch.collections import shared as s
from cause_tpu_torch.ids import K
from cause_tpu_torch.weaver import nativew

from test_list import EDGE_CASES


@pytest.fixture(autouse=True)
def on_cpu():
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


_TO_PORT = {c.hide: ct.hide, c.h_hide: ct.h_hide, c.h_show: ct.h_show}
_TO_REF = {v: k for k, v in _TO_PORT.items()}


def to_port(x):
    """A reference node (or value) in the port's terms."""
    if isinstance(x, tuple):
        return tuple(to_port(v) for v in x)
    if x in _TO_PORT:
        return _TO_PORT[x]
    if type(x).__name__ == "Keyword":
        return K(x.name)
    return x


def to_ref(x):
    """A port node (or value) in the reference's terms."""
    if isinstance(x, tuple):
        return tuple(to_ref(v) for v in x)
    if x in _TO_REF:
        return _TO_REF[x]
    if isinstance(x, t_ids.Keyword):
        return c.K(x.name)
    return x


def plain(w):
    """A weave as package-free data."""
    def val(v):
        if hasattr(v, "name") and not isinstance(v, str):
            return (type(v).__name__, v.name)
        if isinstance(v, tuple):
            return tuple(val(x) for x in v)
        return v
    if isinstance(w, dict):
        return {val(k): plain(v) for k, v in w.items()}
    return [tuple(val(x) for x in n) for n in w]


def pure_list_weave(ct_):
    return c_list.weave(ct_.evolve(weaver="pure")).weave


def pure_map_weave(ct_):
    return c_map.weave(ct_.evolve(weaver="pure")).weave


SIMPLE_VALUES = ([ct.hide, ct.hide, ct.h_hide, ct.h_hide, ct.h_show,
                  ct.h_show, " ", " ", " ", " ", "\n"]
                 + [chr(ch) for ch in range(97, 97 + 26)])


def rand_node(rng, h, site_id):
    """``tests/test_list.py``'s fuzzer node in the port's terms: a
    random existing cause, ts one past the cause's and the yarn tip."""
    cause = rng.choice(list(h.ct.nodes.keys()))
    yarn = h.ct.yarns.get(site_id)
    yarn_ts = yarn[-1][0][0] if yarn else 0
    return ct.node(1 + max(cause[0], yarn_ts), site_id, cause,
                   rng.choice(SIMPLE_VALUES))


def rand_map_node(rng, cm, site_id):
    """``tests/test_map.py``'s map fuzzer node in the port's terms."""
    keys = [K("a"), K("b"), "plain", 7]
    ts = cm.get_ts() + 1
    value = (rng.choice([ct.hide, ct.h_hide, ct.h_show])
             if rng.random() < 0.4 else rng.randrange(100))
    if rng.random() < 0.4 and len(cm.ct.nodes) > 0:
        cause = rng.choice(sorted(cm.ct.nodes))
    else:
        cause = rng.choice(keys)
    return ((ts, site_id, 0), cause, value)


def site(i):
    return f"sNAT{i:09d}"


def test_native_builds_into_the_port_build_dir():
    assert native.available()
    so = native._so_path()
    assert "/_build/" in so and so.endswith(".so")
    assert nativew.available()


@pytest.mark.parametrize("nodes", EDGE_CASES, ids=range(len(EDGE_CASES)))
def test_list_regression_corpus_parity(nodes):
    cl = ct.clist()
    ref = c.clist()
    for n in nodes:
        cl = cl.insert(to_port(n))
        ref = ref.insert(n)
    got = nativew.refresh_list_weave(cl.ct).weave
    assert got == pure_list_weave(cl.ct)
    assert plain(got) == plain(j_nativew.refresh_list_weave(ref.ct).weave)


def test_list_fuzz_parity():
    rng = random.Random(0xC0FFEE)
    for round_ in range(80):
        sites = [site(round_ * 5 + k) for k in range(5)]
        cl = ct.clist()
        ref = c.clist()
        for _ in range(rng.randrange(1, 18)):
            n = rand_node(rng, cl, rng.choice(sites))
            cl = cl.insert(n)
            ref = ref.insert(to_ref(n))
        got = nativew.refresh_list_weave(cl.ct).weave
        assert got == pure_list_weave(cl.ct), \
            f"divergence in round {round_}: nodes={sorted(cl.ct.nodes)}"
        assert plain(got) == plain(
            j_nativew.refresh_list_weave(ref.ct).weave)


def test_map_parity_basic():
    cm = ct.cmap().assoc(K("a"), 1).assoc(K("b"), 2).assoc(K("a"), 3)
    cm = cm.dissoc(K("b"))
    got = nativew.refresh_map_weave(cm.ct).weave
    assert got == pure_map_weave(cm.ct)


def test_map_parity_id_caused_undo():
    cm = ct.cmap().assoc(K("k"), "v1").assoc(K("k"), "v2")
    overwrite_id = list(cm)[0][0]
    cm = cm.append(overwrite_id, ct.h_hide)
    assert nativew.refresh_map_weave(cm.ct).weave == pure_map_weave(cm.ct)
    cm2 = cm.append(overwrite_id, ct.h_show)
    assert nativew.refresh_map_weave(cm2.ct).weave == \
        pure_map_weave(cm2.ct)


def test_map_fuzz_parity():
    rng = random.Random(0xFACADE)
    for round_ in range(60):
        sites = [site(1000 + round_ * 3 + k) for k in range(3)]
        cm = ct.cmap()
        ref = c.cmap()
        for _ in range(rng.randrange(1, 15)):
            n = rand_map_node(rng, cm, rng.choice(sites))
            cm = cm.insert(n)
            ref = ref.insert(to_ref(n))
        got = nativew.refresh_map_weave(cm.ct).weave
        assert got == pure_map_weave(cm.ct), (
            f"divergence in round {round_}: nodes={sorted(cm.ct.nodes)}")
        assert plain(got) == plain(
            j_nativew.refresh_map_weave(ref.ct).weave)


def test_native_end_to_end():
    cl = ct.clist("h", "e", "y", weaver="native")
    assert cl.causal_to_edn() == ["h", "e", "y"]
    refreshed = s.refresh_caches(c_list.weave, cl.ct)
    assert refreshed.weave == cl.ct.weave
    cm = ct.cmap(weaver="native").assoc(K("x"), 1)
    refreshed_m = s.refresh_caches(c_map.weave, cm.ct)
    assert refreshed_m.weave == cm.ct.weave


def test_native_merge_matches_pure():
    rng = random.Random(31337)
    for k in range(15):
        b = c_list.CausalList(ct.clist(*"seed", weaver="native").ct.evolve(
            site_id=site(2000 + k)))
        replicas = []
        for j in range(2):
            r = c_list.CausalList(b.ct.evolve(site_id=site(3000 + 2 * k + j)))
            for _ in range(rng.randrange(1, 8)):
                r = r.insert(rand_node(rng, r, r.ct.site_id))
            replicas.append(r)
        nat = nativew.merge_trees(replicas[0].ct, replicas[1].ct)
        pure = s.merge_trees(
            c_list.weave, replicas[0].ct.evolve(weaver="pure"),
            replicas[1].ct.evolve(weaver="pure"))
        assert nat.nodes == pure.nodes
        assert nat.weave == pure.weave
        assert nat.lamport_ts == pure.lamport_ts
        # the handle route: merge of two native handles is this merge
        via_handle = replicas[0].merge(replicas[1])
        assert via_handle.ct.weave == nat.weave


def test_native_map_merge_matches_pure():
    b = ct.cmap(weaver="native").assoc(K("k"), "v0")
    a = c_map.CausalMap(b.ct.evolve(site_id=site(1))).assoc(K("k"), "va")
    r = c_map.CausalMap(b.ct.evolve(site_id=site(2))).assoc(K("j"), "vb")
    nat = a.merge(r)
    pure = s.merge_trees(c_map.weave, a.ct.evolve(weaver="pure"),
                         r.ct.evolve(weaver="pure"))
    assert nat.ct.nodes == pure.nodes
    assert nat.ct.weave == pure.weave


def test_base_with_native_weaver():
    cb = ct.base(weaver="native")
    cb = ct.transact(cb, [[None, None, [K("div"), {K("t"): "x"}, "hi"]]])
    edn = ct.causal_to_edn(cb)
    cb = ct.undo(cb)
    cb = ct.redo(cb)
    assert ct.causal_to_edn(cb) == edn


def test_off_domain_falls_back():
    cm = ct.cmap().assoc(K("k"), "v")
    write_id = list(cm)[0][0]
    cm = cm.append(write_id, ct.hide)
    hide_id = [nid for nid in sorted(cm.ct.nodes) if nid != write_id][-1]
    cm = cm.insert(((cm.get_ts() + 1, cm.get_site_id(), 0), hide_id,
                    ct.h_show))
    assert nativew.refresh_map_weave(cm.ct).weave == pure_map_weave(cm.ct)


def test_native_handles_out_of_packspec_ids():
    """Ids beyond the PackSpec (tx >= 2^13) still weave natively; the
    device marshal refuses them, and the torch weaver's full rebuild
    falls back to pure, as the reference's jax rebuild does."""
    from cause_tpu_torch.ids import ROOT_ID
    from cause_tpu_torch.weaver import torchw
    from cause_tpu_torch.weaver.arrays import NodeArrays

    cl = ct.clist("a", weaver="native")
    big_tx = ((cl.get_ts() + 1, cl.get_site_id(), 10_000), ROOT_ID, "x")
    cl = cl.insert(big_tx)
    assert cl.ct.weave == pure_list_weave(cl.ct)
    assert "x" in cl.causal_to_edn()
    na = NodeArrays.from_nodes_map(cl.ct.nodes)
    assert not na.spec_ok
    with pytest.raises(OverflowError):
        na.id_lanes()
    with pytest.raises(OverflowError):
        na.cause_lanes()
    tx = ct.clist("a", weaver="torch").insert(
        ((2, cl.get_site_id(), 10_000), ROOT_ID, "x"))
    rebuilt = torchw.refresh_list_weave(tx.ct)
    assert rebuilt.weave == pure_list_weave(tx.ct)
    assert rebuilt.weaver == "torch"
    b = ct.clist("a", weaver="torch")
    nid = (b.get_ts() + 1, b.get_site_id(), 0)
    fleet_tree = b.insert((nid, ROOT_ID, "y")).ct
    ghost = dict(fleet_tree.nodes)
    ghost[(nid[0] + 1, nid[1], 0)] = ((1, "zz_ghost______", 20_000), "z")
    na2 = NodeArrays.from_nodes_map(fleet_tree.evolve(nodes=ghost).nodes)
    assert not na2.spec_ok
    with pytest.raises(OverflowError):
        na2.id_lanes()


def test_cause_lanes_spec_mismatch_raises():
    from cause_tpu_torch.weaver.arrays import NodeArrays, PackSpec

    cl = ct.clist("a", "b")
    na = NodeArrays.from_nodes_map(cl.ct.nodes)
    assert na.cause_lanes() == (pytest.approx(na.cause_hi),
                                pytest.approx(na.cause_lo))
    with pytest.raises(ValueError):
        na.cause_lanes(PackSpec(site_bits=20, tx_bits=11))


def test_weft_gibberish_falls_back():
    cl = ct.clist(*"abcd", weaver="native")
    nodes = list(cl)
    w = cl.weft([nodes[1][0]])
    assert w.causal_to_edn() == ["a", "b"]
    assert w.ct.weave == pure_list_weave(w.ct)
    broken = cl.ct.evolve(nodes={k: v for k, v in cl.ct.nodes.items()
                                 if k != nodes[2][0]})
    assert nativew.refresh_list_weave(broken).weave == \
        pure_list_weave(broken)


def test_native_route_replaces_the_pure_fallthrough(monkeypatch):
    """``weaver="native"`` reaches the linearizer from every handle
    route the reference routes there (``clist.weave``, the list
    handles' merge, ``cmap.weave`` and ``CausalMap.merge``), and a
    10k-node merge equals the pure merge."""
    calls = {"list": 0, "map": 0}
    real_l, real_m = native.weave_list_ranks, native.weave_map_ranks

    def count_l(*a):
        calls["list"] += 1
        return real_l(*a)

    def count_m(*a):
        calls["map"] += 1
        return real_m(*a)

    monkeypatch.setattr(native, "weave_list_ranks", count_l)
    monkeypatch.setattr(native, "weave_map_ranks", count_m)
    b = c_list.CausalList(ct.clist(weaver="native").ct.evolve(
        site_id=site(7)))
    for k in range(10):
        b = b.extend([f"v{k}.{i}" for i in range(1000)])
    a = c_list.CausalList(b.ct.evolve(site_id=site(8))).conj("A")
    r = c_list.CausalList(b.ct.evolve(site_id=site(9))).conj("B")
    n0 = calls["list"]
    m = a.merge(r)
    assert calls["list"] == n0 + 1
    assert len(m.ct.nodes) == 10_003
    pure = s.merge_trees(c_list.weave, a.ct.evolve(weaver="pure"),
                         r.ct.evolve(weaver="pure"))
    assert m.ct.weave == pure.weave
    c_list.weave(a.ct)
    assert calls["list"] == n0 + 2
    cm = ct.cmap(weaver="native").assoc(K("x"), 1)
    c_map.weave(cm.ct)
    cm.merge(c_map.CausalMap(cm.ct.evolve(site_id=site(10))).assoc(
        K("y"), 2))
    assert calls["map"] >= 2
