"""The port's CausalSet (OR-set) and CausalCounter against the JAX
package's: semantics, convergence across sites and weavers, undo, serde.

Mirrors ``tests/test_set_counter.py`` with the weaver parametrised over
``pure``, ``native`` (the pure path until the native weaver is ported)
and ``torch`` (the device list route, on the CPU through the kernels'
plain versions). Twin fleets, built in both packages with the same site
ids and uuids, hold the port's ``weaver="torch"`` merges, ``merge_many``
and ``merge_all`` to the reference's ``weaver="jax"`` and to the pure
fold, and the port's serde bytes to the reference's. The base cases of
the reference file (``:163``, ``:228``) and its spec checks are in
``tests/test_torch_base.py``.
"""

import pytest

import cause_tpu as c
from cause_tpu import serde as j_serde

import cause_tpu_torch as ct
from cause_tpu_torch import serde as t_serde
from cause_tpu_torch.collections import shared as t_shared
from cause_tpu_torch.collections.ccounter import CausalCounter
from cause_tpu_torch.collections.cset import CausalSet

WEAVERS = ["pure", "native", "torch"]


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


_forks = iter(range(10 ** 9))


def fork(handle, cls=None, tag="F", i=None):
    """A replica of ``handle`` at a site of its own."""
    cls = cls or type(handle)
    return cls(handle.ct.evolve(site_id=site(tag, next(_forks) if i is None
                                             else i)))


def twin(pkg, make, tag, weaver="pure"):
    """A fresh collection of package ``pkg`` at a fixed site and uuid."""
    h = make(pkg)(weaver=weaver)
    return type(h)(h.ct.evolve(site_id=site(tag),
                               uuid=f"{tag:_<8}TwinUuid00000"[:21]))


# ---------------------------- CausalSet ----------------------------


@pytest.mark.parametrize("weaver", WEAVERS)
def test_set_basics(weaver):
    cs = ct.cset("a", "b", weaver=weaver)
    assert len(cs) == 2 and "a" in cs and "b" in cs and "z" not in cs
    assert cs.causal_to_edn() == {"a", "b"}
    again = cs.add("a")
    assert again.causal_to_edn() == {"a", "b"}
    assert len(again.get_nodes()) == len(cs.get_nodes()) + 1
    cs2 = cs.discard("a")
    assert cs2.causal_to_edn() == {"b"}
    assert cs2.discard("zzz") is cs2        # absent -> no-op
    assert set(cs2) == {"b"}
    assert cs2.add("a").causal_to_edn() == {"a", "b"}
    with pytest.raises(t_shared.CausalError):
        cs.add([1, 2])


@pytest.mark.parametrize("weaver", WEAVERS)
def test_set_add_of_present_element_still_protects_against_remove(weaver):
    base = ct.cset("x", weaver=weaver)
    remover = fork(base).discard("x")
    adder = fork(base).add("x")   # "x" already visible here
    ab = remover.merge(adder)
    ba = adder.merge(remover)
    assert ab.causal_to_edn() == ba.causal_to_edn() == {"x"}


@pytest.mark.parametrize("weaver", WEAVERS)
def test_set_add_wins_over_concurrent_remove(weaver):
    base = ct.cset("x", weaver=weaver)
    remover = fork(base).discard("x")
    readder = fork(base).discard("x").add("x")
    ab = remover.merge(readder)
    ba = readder.merge(remover)
    assert ab.causal_to_edn() == ba.causal_to_edn() == {"x"}
    assert ab.get_nodes() == ba.get_nodes()


@pytest.mark.parametrize("weaver", WEAVERS)
def test_set_observed_remove_covers_all_observed_adds(weaver):
    base = ct.cset(weaver=weaver)
    a = fork(base).add("v")
    b = fork(base).add("v")
    both = a.merge(b)
    removed = both.discard("v")
    assert removed.causal_to_edn() == set()
    assert removed.merge(a).merge(b).causal_to_edn() == set()


@pytest.mark.parametrize("weaver", WEAVERS)
def test_set_converges_across_backends(weaver):
    base = ct.cset("s", weaver=weaver)
    a = fork(base).add("a1").discard("s")
    b = fork(base).add("b1")
    ab, ba = a.merge(b), b.merge(a)
    assert ab.causal_to_edn() == ba.causal_to_edn() == {"a1", "b1"}
    fleet = [fork(base).add(f"e{i}") for i in range(4)]
    conv = fleet[0].merge_many(fleet[1:])
    folded = fleet[0]
    for r in fleet[1:]:
        folded = folded.merge(r)
    assert conv.causal_to_edn() == folded.causal_to_edn()
    assert type(conv) is CausalSet and conv.ct.weaver == weaver


@pytest.mark.parametrize("weaver", WEAVERS)
def test_set_serde_round_trip(weaver):
    cs = ct.cset("a", "b", weaver=weaver).discard("a")
    back = t_serde.loads(t_serde.dumps(cs))
    assert isinstance(back, CausalSet)
    assert back.causal_to_edn() == {"b"}
    assert back.get_nodes() == cs.get_nodes()
    assert back.ct.weave == cs.ct.weave and back.ct.weaver == weaver
    other = fork(cs).add("c")
    assert back.merge(other).causal_to_edn() == {"b", "c"}


def test_set_type_guard():
    with pytest.raises(t_shared.CausalError):
        ct.cset("x").merge(ct.clist("x"))
    with pytest.raises(t_shared.CausalError):
        ct.cset("x", weaver="torch").merge(ct.ccounter(1, weaver="torch"))


# -------------------------- CausalCounter --------------------------


@pytest.mark.parametrize("weaver", WEAVERS)
def test_counter_basics(weaver):
    cc = ct.ccounter(weaver=weaver)
    assert cc.value() == 0
    cc = cc.increment(5).decrement(2).increment(0.5)
    assert cc.value() == 3.5
    assert int(cc.increment(0.5)) == 4
    for bad in (lambda: cc.increment("nope"), lambda: cc.increment(True),
                lambda: cc.decrement(True), lambda: cc.decrement("nope")):
        with pytest.raises(t_shared.CausalError):
            bad()


@pytest.mark.parametrize("weaver", WEAVERS)
def test_counter_concurrent_increments_converge(weaver):
    base = ct.ccounter(10, weaver=weaver)
    a = fork(base).increment(7)
    b = fork(base).decrement(3)
    ab, ba = a.merge(b), b.merge(a)
    assert ab.value() == ba.value() == 14
    assert ab.get_nodes() == ba.get_nodes()


@pytest.mark.parametrize("weaver", WEAVERS)
def test_counter_undo_delta(weaver):
    cc = ct.ccounter(weaver=weaver).increment(4).increment(6)
    deltas = cc.deltas()
    assert [d[2] for d in deltas] == [4, 6]
    undone = cc.undo_delta(deltas[0][0])
    assert undone.value() == 6
    assert str(undone) == "6" and repr(undone) == "#causal/counter 6"


@pytest.mark.parametrize("weaver", WEAVERS)
def test_counter_fleet_converges(weaver):
    base = ct.ccounter(weaver=weaver)
    fleet = [fork(base).increment(i + 1) for i in range(5)]
    conv = fleet[0].merge_many(fleet[1:])
    assert conv.value() == 1 + 2 + 3 + 4 + 5
    assert ct.merge_all(fleet[0], *fleet[1:]).value() == 15


@pytest.mark.parametrize("weaver", WEAVERS)
def test_counter_serde_round_trip(weaver):
    cc = ct.ccounter(3, weaver=weaver).increment(2)
    back = t_serde.loads(t_serde.dumps(cc))
    assert isinstance(back, CausalCounter)
    assert back.value() == 5
    assert back.merge(fork(cc).increment(1)).value() == 6


# --------------------------- against the reference (twin fleets)


def set_fleet(pkg, weaver, n=8):
    base = twin(pkg, lambda p: p.cset, "SET", weaver)
    base = base.add("s0").add("s1").add(("t", 1))
    fleet = []
    for i in range(n):
        r = type(base)(base.ct.evolve(site_id=site("SR", i)))
        r = r.add(f"e{i}").add(frozenset({i}))
        if i % 3 == 0:
            r = r.discard("s0")
        if i % 4 == 1:
            r = r.discard(f"e{i}").add(f"e{i}")  # re-add survives
        fleet.append(r)
    return fleet


def counter_fleet(pkg, weaver, n=8):
    base = twin(pkg, lambda p: p.ccounter, "CNT", weaver).increment(10)
    fleet = []
    for i in range(n):
        r = type(base)(base.ct.evolve(site_id=site("CR", i)))
        r = r.increment(i + 1).decrement(0.5)
        if i % 2:
            r = r.undo_delta(r.deltas()[-1][0])
        fleet.append(r)
    return fleet


@pytest.mark.parametrize("make", [set_fleet, counter_fleet],
                         ids=["set", "counter"])
def test_torch_fleet_matches_reference_and_pure(make):
    """Under ``weaver="torch"`` a pairwise merge, ``merge_many`` and
    ``merge_all`` (the merge tree at 8 replicas) give the same weave,
    node set and value as the reference's ``weaver="jax"`` and as the
    pure fold."""
    tf, jf, pf = make(ct, "torch"), make(c, "jax"), make(ct, "pure")
    pure = pf[0]
    for r in pf[1:]:
        pure = pure.merge(r)
    j_all = c.merge_all(jf[0], *jf[1:])
    for got in (tf[0].merge(tf[1]).merge_many(tf[2:]),
                tf[0].merge_many(tf[1:]), ct.merge_all(tf[0], *tf[1:])):
        assert type(got) is type(tf[0]) and got.ct.weaver == "torch"
        assert got.ct.nodes == pure.ct.nodes
        assert got.ct.weave == pure.ct.weave
        assert got.causal_to_edn() == pure.causal_to_edn()
        assert t_serde.dumps(got.ct.weave) == j_serde.dumps(j_all.ct.weave)
        assert t_serde.dumps(got) == j_serde.dumps(j_all).replace(
            '"weaver": "jax"', '"weaver": "torch"')
    assert type(j_all).__name__ == type(tf[0]).__name__


@pytest.mark.parametrize("make", [set_fleet, counter_fleet],
                         ids=["set", "counter"])
def test_serde_bytes_match_reference(make):
    """A set's and a counter's encoding equals the reference's, and each
    package decodes the other's bytes to an equal collection."""
    t_h, j_h = make(ct, "pure")[3], make(c, "pure")[3]
    assert t_serde.to_data(t_h) == j_serde.to_data(j_h)
    assert t_serde.dumps(t_h) == j_serde.dumps(j_h)
    back = t_serde.loads(j_serde.dumps(j_h))
    assert type(back) is type(t_h)
    assert back.ct.nodes == t_h.ct.nodes and back.ct.weave == t_h.ct.weave
    assert back.causal_to_edn() == t_h.causal_to_edn()
    assert j_serde.dumps(j_serde.loads(t_serde.dumps(t_h))) == \
        j_serde.dumps(j_h)
