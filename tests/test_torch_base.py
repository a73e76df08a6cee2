"""The port's CausalBase and facade against the JAX package's.

Mirrors ``tests/test_base.py``, ``test_core.py``, ``test_util.py``,
``test_lazy.py``, ``test_spec.py`` and ``test_serde.py``, and the base
cases of ``tests/test_set_counter.py`` (``:163``, ``:228``) with the spec
checks its port left out. Each scenario runs as twins: the same script
in both packages, with both uid generators seeded alike, so both mint
the same uuids and site ids — under ``weaver="pure"`` and ``"torch"`` in
the port and ``"pure"`` and ``"jax"`` in the reference. The twins'
results are compared through each package's serde encoding (the
``weaver`` field aside), so bases, collections, refs and keywords
compare exactly across packages; the reference test's own assertions
run on the port's result. On the CPU the port's kernels run through
their plain versions.
"""

import contextlib
import json
import math
import random

import pytest

import cause_tpu as c
from cause_tpu import cbase as j_cbase
from cause_tpu import serde as j_serde
from cause_tpu import spec as j_spec
from cause_tpu import util as j_util

import cause_tpu_torch as ct
from cause_tpu_torch import cbase as t_cbase
from cause_tpu_torch import serde as t_serde
from cause_tpu_torch import spec as t_spec
from cause_tpu_torch import util as t_util
from cause_tpu_torch.collections import shared as t_shared
from cause_tpu_torch.collections.ccounter import CausalCounter
from cause_tpu_torch.collections.clist import CausalList
from cause_tpu_torch.collections.cset import CausalSet

CB = {c: j_cbase, ct: t_cbase}
SERDE = {c: j_serde, ct: t_serde}
SPEC = {c: j_spec, ct: t_spec}
DEVICE = {c: "jax", ct: "torch"}


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's device paths on the CPU for each test."""
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


@contextlib.contextmanager
def seeded(seed: int):
    """Both packages' uid generators seeded alike: the same calls mint
    the same uuids and site ids. Reseeded at random afterwards."""
    for pkg in (c, ct):
        pkg.ids._rng.seed(seed)
    try:
        yield
    finally:
        for pkg in (c, ct):
            pkg.ids._rng.seed()


def _norm(d, erase: bool):
    """Serde data with every ``weaver`` field read as pure or device
    (``erase``: as nothing)."""
    if isinstance(d, dict):
        out = {k: _norm(v, erase) for k, v in d.items()}
        if "~causal" in d and "weaver" in d:
            out["weaver"] = "*" if erase else (
                "pure" if d["weaver"] == "pure" else "device")
        return out
    if isinstance(d, list):
        return [_norm(v, erase) for v in d]
    return d


def canon(pkg, x, erase: bool = False) -> str:
    """A value of package ``pkg`` as comparable JSON (serde data)."""
    return json.dumps(_norm(SERDE[pkg].to_data(x), erase), sort_keys=True)


def twin(run, seed: int = 0, weavers=("pure", "device")):
    """Run ``run(pkg, weaver)`` in both packages under each weaver, from
    the same uid seed, and require one result: the same in both
    packages under one weaver, and the same under every weaver but for
    the ``weaver`` fields. Returns the port's results by weaver."""
    got, port = [], {}
    for w in weavers:
        outs = {}
        for pkg in (c, ct):
            weaver = DEVICE[pkg] if w == "device" else w
            with seeded(seed):
                outs[pkg] = run(pkg, weaver)
        assert canon(ct, outs[ct]) == canon(c, outs[c]), w
        got.append(canon(ct, outs[ct], erase=True))
        port[w] = outs[ct]
    assert all(g == got[0] for g in got)
    return port


def rand_node(pkg, rng, causal_list, site_id):
    """A random foreign node of package ``pkg``, minted as
    ``tests/test_list.py``'s ``rand_node`` mints them: a random existing
    cause, ts one past the max of the cause's ts and the site's tip."""
    values = ([pkg.hide, pkg.h_hide, pkg.h_show] * 2 + [" "] * 4 + ["\n"]
              + [chr(ch) for ch in range(97, 97 + 26)])
    ct_ = causal_list.ct
    value = rng.choice(values)
    cause = rng.choice(list(ct_.nodes.keys()))
    yarn = ct_.yarns.get(site_id)
    yarn_ts = yarn[-1][0][0] if yarn else 0
    return pkg.node(1 + max(cause[0], yarn_ts), site_id, cause, value)


def weavers_of(cb) -> set:
    return {h.ct.weaver for h in cb.collections.values()}


# ------------------------------------------------- tests/test_base.py


def test_cb_to_edn():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        cb = b.transact_(b.new_cb(w), [[None, None, [
            K("div"), {K("foo"): "bar"}, "wat", [K("p"), "baz"]]]])
        return b.cb_to_edn(cb), cb

    out = twin(run)
    K = ct.K
    for w in out:
        assert out[w][0] == [K("div"), {K("foo"): "bar"}, "w", "a", "t",
                             [K("p"), "b", "a", "z"]]
    assert weavers_of(out["device"][1]) == {"torch"}


def test_string_explosion_is_grapheme_aware():
    family = "\U0001F468‍\U0001F469‍\U0001F467"
    acc_e = "é"

    def run(pkg, w):
        b = CB[pkg]
        cb = b.transact_(b.new_cb(w), [[None, None, ["hi" + family + acc_e]]])
        return b.cb_to_edn(cb)

    out = twin(run)
    assert out["pure"] == ["h", "i", family, acc_e]


def test_cb_to_edn_cyclic_ref():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        cb = b.transact_(b.new_cb(w), [[None, None, {K("a"): 1}]])
        cb = b.transact_(cb, [[cb.root_uuid, K("self"), b.Ref(cb.root_uuid)]])
        got = b.cb_to_edn(cb)
        cb2 = b.transact_(b.new_cb(w), [[None, None, {K("x"): [1]}]])
        inner_uuid = next(u for u in cb2.collections if u != cb2.root_uuid)
        cb2 = b.transact_(cb2, [[inner_uuid, pkg.root_id,
                                 b.Ref(cb2.root_uuid)]])
        return got, b.cb_to_edn(cb2), cb.root_uuid

    got, got2, root = twin(run)["pure"]
    K = ct.K
    assert got[K("a")] == 1
    assert got[K("self")][K("a")] == 1
    assert got[K("self")][K("self")] == t_cbase.Ref(root)
    assert K("x") in got2


def test_map_to_nodes():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        cb = b.new_cb(w)
        _, tx_index, nodes = b.map_to_nodes(cb, 0, {K("a"): 1, K("b"): 2})
        return tx_index, nodes, cb.site_id

    tx_index, nodes, site = twin(run)["pure"]
    assert tx_index == 2
    assert nodes == [((1, site, 0), ct.K("a"), 1),
                     ((1, site, 1), ct.K("b"), 2)]


def test_list_to_nodes():
    def run(pkg, w):
        b = CB[pkg]
        cb, tx_index, nodes, last = b.list_to_nodes(b.new_cb(w), 0, [1, 2, 3])
        return tx_index, nodes, last, cb.site_id

    tx_index, nodes, last, site = twin(run)["pure"]
    assert tx_index == 3
    assert nodes == [((1, site, 0), (0, "0", 0), 1),
                     ((1, site, 1), (1, site, 0), 2),
                     ((1, site, 2), (1, site, 1), 3)]
    assert last == (1, site, 2)


def test_flatten_value():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        out = []
        for v in ({K("a"): {K("aa"): 1, K("bb"): 2, K("cc"): 3}},
                  {K("a"): {K("b"): {K("c"): K("d")}}},
                  [1, [2, [3]]], [1, "hello", "world"],
                  [K("div"), {K("title"): "don't break"},
                   [K("span"), "break"]]):
            cb, tx_i, ref = b.flatten_value(b.new_cb(w), 0, v)
            out.append((tx_i, b.is_ref(ref), len(cb.collections), cb))
        return out

    got = twin(run)["device"]
    assert [(t, r, n) for t, r, n, _ in got] == [
        (4, True, 2), (3, True, 3), (5, True, 3), (11, True, 1),
        (10, True, 3)]


def test_transact():
    def run(pkg, w):
        b, K, hide, rid = CB[pkg], pkg.K, pkg.hide, pkg.root_id
        out = [b.cb_to_edn(b.new_cb(w))]
        cb = b.transact_(b.new_cb(w), [[None, None, {K("a"): 1}]])
        r = cb.root_uuid
        out.append(b.cb_to_edn(cb))
        out += [b.cb_to_edn(b.transact_(cb, tx)) for tx in (
            [[r, K("a"), "hi"]],
            [[r, None, {K("a"): 2, K("b"): 3}]],
            [[r, K("b"), {K("c"): 2}]],
            [[r, K("a"), hide], [r, None, {K("b"): 2, K("c"): "hi"}],
             [r, None, {K("b"): hide}]])]
        cb = b.transact_(b.new_cb(w), [[None, None, [1, 2]]])
        r = cb.root_uuid
        out += [b.cb_to_edn(cb)] + [b.cb_to_edn(b.transact_(cb, [[r, rid, v]]))
                                    for v in (0, [0], [-2, -1, 0], "hi",
                                              ["hi"], [["hi"]])]
        return out

    K = ct.K
    got = twin(run)["device"]
    assert got == [None, {K("a"): 1}, {K("a"): "hi"}, {K("a"): 2, K("b"): 3},
                   {K("a"): 1, K("b"): {K("c"): 2}}, {K("c"): "hi"},
                   [1, 2], [0, 1, 2], [0, 1, 2], [-2, -1, 0, 1, 2],
                   ["h", "i", 1, 2], ["h", "i", 1, 2], [["h", "i"], 1, 2]]


def test_site_id_shared_across_nested_collections():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        return b.transact_(b.new_cb(w), [[None, None, [
            K("div"), {K("a"): 1}, [K("span"), {K("b"): 2}, "abc"]]]])

    cb = twin(run)["device"]
    assert cb.history
    assert all(nid[1] == cb.site_id for nid, _u in cb.history)


def test_causal_base_api():
    def run(pkg, w):
        assert pkg.get_collection(pkg.base(weaver=w)) is None
        cb = pkg.transact(pkg.base(weaver=w), [[None, None, [1, 2, 3]]])
        return [n[2] for n in pkg.get_collection(cb)], cb

    vals, cb = twin(run)["device"]
    assert vals == [1, 2, 3] and len(ct.get_collection(cb)) == 3


def test_expand_and_reverse_path():
    def run(pkg, w):
        b = CB[pkg]
        cb = b.transact_(b.new_cb(w), [[None, None, [1, 2, 3]]])
        node, coll = b.expand_reverse_path(cb, cb.history[0])
        path = b.reverse_path_to_path(cb, cb.history[0])
        return node, coll, path.uuid, path.node

    node, coll, uuid, pnode = twin(run)["device"]
    assert node[2] == 1 and coll.get_uuid() == uuid and pnode == node


def _history_base(b, K, w, extra=()):
    cb = b.transact_(b.new_cb(w), [[None, None, {K("a"): 1, K("b"): 2}]])
    r = cb.root_uuid
    return b.transact_(cb, [[r, K("a"), 3], [r, K("c"), 4], [r, K("e"), 5]]
                       + [[r, k, v] for k, v in extra])


def test_tx_id_indexes():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        cb = _history_base(b, K, w)
        last = cb.history[-1][0][:2]
        return (b.tx_id_indexes(cb, last),
                b.tx_id_indexes(cb, (1, "bad site-id")),
                [rp[0][0] for rp in cb.history[2:5]])

    idx, bad, ts = twin(run)["device"]
    assert idx == (2, 4) and bad == (None, None) and ts == [2, 2, 2]


def test_subhis():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        cb = _history_base(b, K, w, extra=[(K("f"), 6)])
        last, first = cb.history[-1][0][:2], cb.history[0][0][:2]
        return [b.subhis(cb, *a) for a in (
            (last,), (last, None), (None, first), (first, last),
            (None, None), (None, (0, cb.site_id)), ((5, cb.site_id), None))]

    got = twin(run)["device"]
    assert [len(h) for h in got] == [4, 4, 2, 6, 6, 0, 0]


def test_invert_path():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        return b.invert_path(b.Path(
            uuid="yVqwAa8ypPGRC_p3wdKhS",
            node=((1, "QeVBlHoQFZSx0", 0), K("a"), 1)))

    assert twin(run)["pure"] == ("yVqwAa8ypPGRC_p3wdKhS",
                                 (1, "QeVBlHoQFZSx0", 0), ct.h_hide)


def test_invert():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        cb = b.transact_(b.new_cb(w), [[None, None, {K("a"): 1, K("b"): 2}]])
        r = cb.root_uuid
        for tx in ([[r, K("a"), 3]], [[r, K("c"), [1, 2, 3]]],
                   [[r, K("c"), pkg.hide]]):
            cb = b.transact_(cb, tx)
        before = (b.get_collection_(cb)[K("a")], len(cb.history))
        cb = b.invert_(cb, cb.history)
        return before, b.get_collection_(cb)[K("a")], len(cb.history), cb

    before, a, n, _cb = twin(run)["device"]
    assert before == (3, 8) and a is None and n == 13


def test_get_next_tx_id():
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        cb = b.transact_(b.new_cb(w), [[None, None, {K("a"): 1, K("b"): 2}]])
        cb = b.transact_(cb, [[cb.root_uuid, K("a"), 3]])
        out = []
        for cur in (None, 2, 1, None):
            nxt = b.get_next_tx_id(cb.evolve(last_undo_lamport_ts=cur), cur)
            out.append(nxt and nxt[0])
        return out

    assert twin(run)["pure"] == [2, 1, None, 2]


def test_undo_and_redo():
    def run(pkg, w):
        b, K, rid = CB[pkg], pkg.K, pkg.root_id
        seen = []
        cb = b.transact_(b.new_cb(w), [[None, None, {K("a"): 1, K("b"): 2}]])
        cb = b.transact_(cb, [[cb.root_uuid, K("a"), 3]])
        for step in (None, b.undo_, b.undo_, b.redo_, b.redo_):
            cb = step(cb) if step else cb
            root = b.get_collection_(cb)
            seen.append((root[K("a")], root[K("b")]))
        cb = b.transact_(b.new_cb(w), [[None, None, [1]]])
        cb = b.transact_(cb, [[cb.root_uuid, rid, [2]]])
        cb = b.transact_(cb, [[cb.root_uuid, rid, [3]]])
        for step in (None, b.undo_, b.undo_, b.undo_, b.redo_, b.redo_,
                     b.redo_, b.redo_):
            cb = step(cb) if step else cb
            nodes = list(b.get_collection_(cb))
            seen.append(nodes[0][2] if nodes else None)
        return seen, cb

    seen, _ = twin(run)["device"]
    assert seen == [(3, 2), (1, 2), (None, None), (1, 2), (3, 2),
                    3, 2, 1, None, 1, 2, 3, 3]


def test_set_site_id():
    def run(pkg, w):
        cb = pkg.base(weaver=w).set_site_id("my-site-id").transact(
            [[None, None, [1]]])
        return list(pkg.get_collection(cb))[0][0]

    assert twin(run)["device"][1] == "my-site-id"


@pytest.mark.parametrize("tx", [
    [["nonexistent-uuid", None, {"a": 1}]],
    [[None, None, 42]],
])
def test_validate_tx_part_errors(tx):
    for pkg, err in ((c, c.CausalError), (ct, ct.CausalError)):
        with pytest.raises(err):
            CB[pkg].transact_(CB[pkg].new_cb(), tx)
    cb = t_cbase.transact_(t_cbase.new_cb(), [[None, None, [1]]])
    with pytest.raises(ct.CausalError):
        t_cbase.transact_(cb, [["missing", None, 1]])


# ------------------------------------------------- tests/test_core.py


def test_core_api():
    def run(pkg, w):
        K = pkg.K
        one = pkg.causal_to_edn(pkg.transact(pkg.base(weaver=w), [[
            None, None, [K("tag"), {K("a"): 1, K("b"): "together"},
                         "split"]]]))
        cb = pkg.transact(pkg.base(weaver=w), [[None, None, [2, 3]]])
        cb = pkg.transact(cb, [[pkg.get_uuid(pkg.get_collection(cb)),
                                pkg.root_id, 1]])
        return one, pkg.causal_to_edn(cb)

    K = ct.K
    assert twin(run)["device"] == (
        [K("tag"), {K("a"): 1, K("b"): "together"}, "s", "p", "l", "i",
         "t"], [1, 2, 3])


def test_specials_and_node_constructor():
    assert ct.hide is ct.HIDE and ct.hide is not ct.h_show
    assert ct.SPECIALS == frozenset((ct.HIDE, ct.H_HIDE, ct.H_SHOW))
    assert t_serde.to_data(sorted(ct.SPECIALS, key=repr)) == \
        j_serde.to_data(sorted(c.SPECIALS, key=repr))
    for pkg in (c, ct):
        assert pkg.node(1, "site", (0, "0", 0), "v") == (
            (1, "site", 0), (0, "0", 0), "v")
        assert pkg.node(1, "site", 2, (0, "0", 0), "v") == (
            (1, "site", 2), (0, "0", 0), "v")


def test_meta_accessors():
    def run(pkg, w):
        cl = pkg.clist("x", weaver=w)
        return pkg.get_uuid(cl), pkg.get_site_id(cl), pkg.get_ts(cl)

    uuid, site, ts = twin(run)["device"]
    assert len(uuid) == 21 and len(site) == 13 and ts == 1


def test_facade_holds_every_reference_name():
    """Every name of the reference's ``__all__`` is in the port's, and
    resolves."""
    assert set(c.__all__) <= set(ct.__all__)
    for name in ct.__all__:
        assert getattr(ct, name) is not None, name


def test_blame_projects_authorship():
    def run(pkg, w):
        K = pkg.K
        base = pkg.clist(*"ab", weaver=w)
        other = type(base)(base.ct.evolve(site_id=pkg.new_site_id()))
        merged = pkg.merge(base, other.conj("X"))
        cm = pkg.cmap(weaver=w).append(K("t"), "v1")
        cm2 = pkg.CausalMap(cm.ct.evolve(site_id=pkg.new_site_id()))
        m = pkg.merge(cm, cm2.append(K("t"), "v2"))
        cb = pkg.transact(pkg.base(weaver=w), [[None, None, {K("k"): 1}]])
        return (pkg.blame(merged), pkg.causal_to_edn(merged), pkg.blame(m),
                pkg.blame(cb), base.get_site_id(), other.get_site_id(),
                pkg.get_uuid(pkg.get_collection(cb)))

    bl, edn, bm, bb, s_base, s_other, root = twin(run)["device"]
    assert [v for v, _, _ in bl] == edn
    by_val = {v: site for v, site, _ in bl}
    assert by_val["X"] == s_other and by_val["a"] == s_base
    assert bm[ct.K("t")][0] == "v2"
    assert bb[root][ct.K("k")][0] == 1


def test_content_digest_canonical():
    def run(pkg, w):
        a = pkg.clist("x", "y", weaver=w)
        r1 = type(a)(a.ct.evolve(site_id=pkg.new_site_id())).conj("1")
        r2 = type(a)(a.ct.evolve(site_id=pkg.new_site_id())).conj("2")
        m12, m21 = r1.merge(r2), r2.merge(r1)
        return (pkg.content_digest(m12), pkg.content_digest(m21),
                pkg.content_digest(r1),
                pkg.content_digest(pkg.loads(pkg.dumps(m12))))

    d12, d21, d1, back = twin(run)["device"]
    assert d12 == d21 == back != d1


# ------------------------------------------------- tests/test_util.py


@pytest.mark.parametrize("text", [
    "abc", "a\U0001F600b", "éx", "a\U0001F469‍\U0001F692b", "",
    "hi\U0001F468‍\U0001F469‍\U0001F467é",
])
def test_char_seq(text):
    assert t_util.char_seq(text) == j_util.char_seq(text)
    assert "".join(t_util.char_seq(text)) == text


def test_char_seq_cases():
    assert t_util.char_seq("abc") == ["a", "b", "c"]
    assert t_util.char_seq("a\U0001F600b") == ["a", "\U0001F600", "b"]
    assert t_util.char_seq("éx") == ["é", "x"]
    woman_fire = "\U0001F469‍\U0001F692"
    assert t_util.char_seq("a" + woman_fire + "b") == ["a", woman_fire, "b"]


def test_sorted_insertion_and_binary_search():
    for u in (t_util, j_util):
        assert u.sorted_insertion_index([], 5) == 0
        assert u.sorted_insertion_index([1, 3, 5], 4) == 2
        assert u.sorted_insertion_index([1, 3, 5], 3, uniq=True) is None
        assert u.insert_sorted([1, 5], 2, next_vals=[3, 4]) == [1, 2, 3, 4, 5]
        assert u.insert_sorted([1, 3, 5], 3) == [1, 3, 5]
        assert u.binary_search([1, 3, 5], 3) == 1
        assert u.binary_search([1, 3, 5], 4) is None
        assert u.binary_search([1, 3, 5], 5) == 2
        assert u.lt((1, "a", 0), (1, "b", 0)) and not u.lt(2, 2)
    history = [((1, "a", 0), "u"), ((1, "a", 1), "u"), ((2, "b", 0), "u")]
    assert t_util.binary_search(
        history, (2, "b", 0), match_fn=lambda rp, t: rp[0] == t,
        less_than_fn=lambda rp, t: rp[0] < t) == 2


@pytest.mark.parametrize("seed", range(3))
def test_binary_search_matches_reference(seed):
    rng = random.Random(seed)
    xs = sorted(rng.sample(range(200), 40))
    for x in range(-2, 202):
        assert t_util.binary_search(xs, x) == j_util.binary_search(xs, x)


def test_ids_and_specials():
    from cause_tpu_torch.ids import Special

    assert Special("hide") is ct.HIDE
    assert ct.is_special(ct.H_HIDE) and not ct.is_special(":causal/hide")
    assert repr(ct.HIDE) == ":causal/hide" and repr(ct.K("div")) == ":div"
    assert ct.K("a") is ct.Keyword("a")
    with pytest.raises(ValueError):
        ct.node(1, "s", (1, "s", 0), "v")


# ------------------------------------------------- tests/test_lazy.py


def test_lazy_conj_extend_and_cons():
    def run(pkg, w):
        cl = pkg.clist("a", "b", lazy=True, weaver=w).conj("c", "d")
        stale = (cl.ct.weave is None, cl.ct.weave_tail is not None)
        edn = cl.causal_to_edn()
        lz = pkg.clist(lazy=True, weaver=w).extend(["x", "y", "z"])
        cons = pkg.clist("a", lazy=True, weaver=w).cons(">")
        killed = cons.ct.weave_tail is None
        return stale, edn, lz.causal_to_edn(), killed, cons.conj("b")

    stale, edn, ext, killed, cons = twin(run)["device"]
    assert stale == (True, True) and edn == ["a", "b", "c", "d"]
    assert ext == ["x", "y", "z"] and killed
    assert cons.causal_to_edn() == [">", "a", "b"]


def test_lazy_hide_at_tail_and_non_chaining_run():
    def run(pkg, w):
        cl_mod = pkg.collections.clist
        eg = pkg.clist("a", "b", "c", weaver=w)
        lz = type(eg)(eg.ct.evolve(lazy_weave=True))
        tail = [n[0] for n in list(eg)][-1]
        s = pkg.collections.shared
        eg1 = type(eg)(s.append(cl_mod.weave, eg.ct, tail, pkg.hide)).conj("d")
        lz1 = type(eg)(s.append(cl_mod.weave, lz.ct, tail, pkg.hide)).conj("d")
        ids = [n[0] for n in list(eg)]
        ts = eg.ct.lamport_ts + 1
        n1 = ((ts, eg.ct.site_id, 0), ids[-1], "R1")
        n2 = ((ts, eg.ct.site_id, 1), ids[0], "R2")
        eg2 = type(eg)(s.insert(cl_mod.weave, eg.ct, n1, [n2]))
        lz2 = type(eg)(s.insert(cl_mod.weave, lz.ct, n1, [n2]))
        assert lz1 == eg1 and lz2 == eg2
        return eg1.causal_to_edn(), lz2.causal_to_edn(), eg2

    a, b, _ = twin(run)["device"]
    assert a == ["a", "b", "d"] and b == ["a", "b", "c", "R1", "R2"]


def test_lazy_serde_empty_and_weft():
    def run(pkg, w):
        lz = pkg.clist("a", lazy=True, weaver=w).conj("b", "c")
        back = pkg.loads(pkg.dumps(lz))
        lz2 = pkg.clist("a", "b", lazy=True, weaver=w)
        ids = [n[0] for n in list(lz2)]
        return (back, lz2.empty().ct.lazy_weave,
                lz2.weft([ids[0]]).ct.lazy_weave)

    back, empty_lazy, weft_lazy = twin(run)["device"]
    assert back.causal_to_edn() == ["a", "b", "c"]
    assert empty_lazy and weft_lazy


@pytest.mark.parametrize("weaver", ["pure", "device"])
def test_differential_fuzz_lazy_vs_eager(weaver):
    """The random op soup of the reference's fuzz, replayed in both
    packages: the lazy twin tracks the eager tree at every checkpoint,
    and both packages end on the same nodes and weave."""
    def run(pkg, w):
        s, cl_mod = pkg.collections.shared, pkg.collections.clist
        rng = random.Random(13)
        eg = pkg.clist("s", weaver=w)
        lz = type(eg)(eg.ct.evolve(lazy_weave=True))
        foreign = pkg.new_site_id()
        for step in range(40):
            op = rng.randrange(6)
            if op == 0:
                eg, lz = eg.conj(f"v{step}"), lz.conj(f"v{step}")
            elif op == 1:
                eg, lz = eg.cons(f"c{step}"), lz.cons(f"c{step}")
            elif op == 2:
                vs = [f"e{step}_{i}" for i in range(rng.randrange(1, 4))]
                eg, lz = eg.extend(vs), lz.extend(vs)
            elif op == 3:
                nodes = sorted(eg.ct.nodes)
                nid = nodes[rng.randrange(len(nodes))]
                if nid != (0, "0", 0):
                    n = ((eg.ct.lamport_ts + 1, eg.ct.site_id, 0), nid,
                         pkg.hide)
                    eg = type(eg)(s.insert(cl_mod.weave, eg.ct.evolve(
                        lamport_ts=n[0][0]), n))
                    lz = type(eg)(s.insert(cl_mod.weave, lz.ct.evolve(
                        lamport_ts=n[0][0]), n))
            elif op == 4:
                nodes = sorted(eg.ct.nodes)
                cause = nodes[rng.randrange(len(nodes))]
                n = ((eg.ct.lamport_ts + 1, foreign, 0), cause, f"f{step}")
                eg = type(eg)(s.insert(cl_mod.weave, eg.ct, n))
                lz = type(eg)(s.insert(cl_mod.weave, lz.ct, n))
            else:
                rep = type(eg)(eg.ct.evolve(site_id=foreign)).conj(f"m{step}")
                eg, lz = eg.merge(rep), lz.merge(rep)
            if step % 7 == 0:
                assert lz.causal_to_edn() == eg.causal_to_edn(), step
        assert lz.get_weave() == eg.get_weave()
        assert lz.ct.nodes == eg.ct.nodes
        return eg

    got = twin(run, weavers=(weaver,))[weaver]
    assert got.ct.weaver == ("pure" if weaver == "pure" else "torch")


# ------------------------------------------------- tests/test_spec.py


@pytest.mark.parametrize("x", [
    (1, "s" * 13, 0), (0, "0", 0), (1, "short", 0), (-1, "s" * 13, 0),
    (1, 5, 0), (1, "s" * 13), "key", None,
])
def test_id_and_node_predicates_match_reference(x):
    for fn in ("valid_id", "valid_tx_id", "valid_site_id", "valid_value"):
        arg = x[:2] if fn == "valid_tx_id" and isinstance(x, tuple) else x
        assert getattr(t_spec, fn)(arg) == getattr(j_spec, fn)(arg), fn
    node = (x, (0, "0", 0), "v")
    assert t_spec.valid_node(node) == j_spec.valid_node(node)


def test_spec_properties_match_reference():
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    import string

    alphabet = string.digits + string.ascii_letters + "_"
    ids = st.tuples(st.integers(0, 2**31 - 2), st.text(alphabet, min_size=13,
                                                       max_size=13),
                    st.integers(0, 2**13 - 1))

    @settings(max_examples=60, deadline=None)
    @given(ids, ids)
    def prop(i, cause):
        if tuple(cause) == tuple(i):
            return
        n = ct.node(i[0], i[1], i[2], tuple(cause), "v")
        assert t_spec.valid_node(n) and j_spec.valid_node(n)
        assert t_spec.valid_id(tuple(i)) and t_spec.valid_tx_id(tuple(i)[:2])

    prop()


@pytest.mark.parametrize("seed", range(4))
def test_list_and_map_interactions_keep_tree_valid(seed):
    def run(pkg, w):
        rng = random.Random(seed)
        spec = SPEC[pkg]
        sites = [pkg.new_site_id() for _ in range(rng.randrange(4))]
        cl = pkg.clist(weaver=w)
        cm = pkg.cmap(weaver=w)
        for _ in range(12):
            kind = rng.choice("ach")
            value = rng.choice([None, True, 3, "t", pkg.hide, pkg.K("k")])
            if kind == "a":
                cl = cl.conj(value)
            elif kind == "c":
                cl = cl.cons(value)
            else:
                nodes = cl.get_weave()
                target = nodes[len(nodes) // 2][0]
                site = sites[0] if sites else cl.get_site_id()
                cl = cl.insert(((cl.get_ts() + 1, site, 0), target, pkg.hide))
            cm = cm.append(rng.choice(["a", "b", pkg.K("c")]), value)
        back = pkg.loads(pkg.dumps(cl))
        return (spec.explain_tree(cl.ct), spec.explain_tree(back.ct),
                spec.explain_tree(cm.ct), back.ct == cl.ct, cl, cm)

    p1, p2, p3, same, _cl, _cm = twin(run)["device"]
    assert p1 == p2 == p3 == [] and same


def test_explain_flags_corruption_like_reference():
    def run(pkg, w):
        spec = SPEC[pkg]
        ct_ = pkg.clist(*"abc", weaver=w).ct
        victim = sorted(ct_.nodes)[2]
        return (spec.explain_tree(ct_.evolve(nodes={
                    k: v for k, v in ct_.nodes.items() if k != victim})),
                spec.explain_tree(ct_.evolve(lamport_ts=0)),
                spec.explain_tree(ct_.evolve(weave=ct_.weave[:-1])))

    got = twin(run)["device"]
    assert all(got), got


def test_merge_preserves_validity():
    def run(pkg, w):
        base = pkg.clist(*"xy", weaver=w)
        a = type(base)(base.ct.evolve(site_id=pkg.new_site_id())).conj("A")
        b = type(base)(base.ct.evolve(site_id=pkg.new_site_id())).conj("B")
        m = pkg.merge(a, b)
        return SPEC[pkg].explain_tree(m.ct), m

    problems, m = twin(run)["device"]
    assert problems == [] and m.ct.weaver == "torch"


def test_set_and_counter_trees_are_valid():
    """The spec checks of the reference's set and counter tests."""
    def run(pkg, w):
        spec = SPEC[pkg]
        cs = pkg.cset("a", "b", weaver=w).discard("a")
        cc = pkg.ccounter(weaver=w).increment(5).decrement(2)
        undone = pkg.ccounter(weaver=w).increment(4).increment(6)
        undone = undone.undo_delta(undone.deltas()[0][0])
        return ([spec.explain_tree(h.ct) for h in (cs, cc, undone)],
                cs, cc, undone)

    problems, cs, cc, undone = twin(run)["device"]
    assert problems == [[], [], []]
    assert cs.causal_to_edn() == {"b"} and cc.value() == 3
    assert undone.value() == 6
    broken = cs.ct.evolve(weave=cs.ct.weave[:-1])
    assert t_spec.explain_tree(broken) == j_spec.explain_tree(
        c.cset("a", "b").discard("a").ct.evolve(weave=c.cset(
            "a", "b").discard("a").ct.weave[:-1])) != []


# ------------------------------------------------ tests/test_serde.py


def assert_tree_equal(a_ct, b_ct):
    for f in ("type", "uuid", "site_id", "lamport_ts", "weaver", "nodes",
              "yarns", "weave"):
        assert getattr(a_ct, f) == getattr(b_ct, f), f


def _cross(pkg_val_port, pkg_val_ref):
    """Each package decodes the other's bytes to its own value."""
    t_text, j_text = t_serde.dumps(pkg_val_port), j_serde.dumps(pkg_val_ref)
    return t_serde.loads(j_text), j_serde.loads(t_text)


def test_list_round_trip():
    def run(pkg, w):
        cl = pkg.clist(*"hello", weaver=w).conj("!", 42, None, True, 1.5)
        cl = cl.append(list(cl)[0][0], pkg.hide)
        return cl, SERDE[pkg].loads(SERDE[pkg].dumps(cl))

    for w, (cl, out) in twin(run).items():
        assert isinstance(out, ct.CausalList)
        assert_tree_equal(out.ct, cl.ct)


def test_list_round_trip_fuzz():
    def run(pkg, w):
        rng = random.Random(7)
        sites = [pkg.new_site_id() for _ in range(4)]
        cl = pkg.clist(weaver=w)
        for _ in range(40):
            cl = cl.insert(rand_node(pkg, rng, cl, rng.choice(sites)))
        return cl, SERDE[pkg].loads(SERDE[pkg].dumps(cl))

    for cl, out in twin(run).values():
        assert_tree_equal(out.ct, cl.ct)


def test_map_round_trip():
    def run(pkg, w):
        K = pkg.K
        cm = pkg.cmap(weaver=w).append(K("a"), "x").append(K("a"), "y")
        cm = cm.append("plain", 7)
        cm = cm.append(list(cm)[0][0], pkg.hide)
        return cm, SERDE[pkg].loads(SERDE[pkg].dumps(cm))

    for cm, out in twin(run).values():
        assert isinstance(out, ct.CausalMap)
        assert_tree_equal(out.ct, cm.ct)


def test_base_round_trip_with_nesting_and_undo():
    """``tests/test_serde.py:58``: a base round trip with nesting and
    undo, in both packages and across them."""
    def run(pkg, w):
        K = pkg.K
        cb = pkg.base(weaver=w)
        cb = pkg.transact(cb, [[None, None, [K("div"), {K("title"): "hi"},
                                             "ab"]]])
        refs = [n[2] for n in pkg.get_collection(cb) if pkg.is_ref(n[2])]
        cb = pkg.transact(cb, [[refs[0].uuid, None, {K("title"): "yo"}]])
        cb = pkg.undo(cb)
        out = SERDE[pkg].loads(SERDE[pkg].dumps(cb))
        return cb, out, pkg.redo(cb), pkg.redo(out)

    got = twin(run)
    for w, (cb, out, r1, r2) in got.items():
        assert isinstance(out, ct.CausalBase)
        assert out.causal_to_edn() == cb.causal_to_edn()
        for f in ("history", "lamport_ts", "root_uuid",
                  "first_undo_lamport_ts", "last_undo_lamport_ts"):
            assert getattr(out.cb, f) == getattr(cb.cb, f), f
        assert set(out.cb.collections) == set(cb.cb.collections)
        for uuid in cb.cb.collections:
            assert_tree_equal(out.cb.collections[uuid].ct,
                              cb.cb.collections[uuid].ct)
        assert r1.causal_to_edn() == r2.causal_to_edn()
    with seeded(0):
        j_cb = run(c, "pure")[0]
    t_back, j_back = _cross(got["pure"][0], j_cb)
    assert t_serde.dumps(t_back) == j_serde.dumps(j_cb)
    assert j_serde.dumps(j_back) == t_serde.dumps(got["pure"][0])


def test_serialized_nodes_only_and_plain_values():
    data = t_serde.to_data(ct.clist(*"xyz"))
    assert set(data) == {"~causal", "uuid", "site_id", "lamport_ts",
                         "weaver", "nodes"}
    K = ct.K
    v = {K("a"): [1, "two", (3, 4)], "s": {5, 6}, K("sp"): ct.hide}
    assert t_serde.loads(t_serde.dumps(v)) == v
    jv = {c.K("a"): [1, "two", (3, 4)], "s": {5, 6}, c.K("sp"): c.hide}
    assert t_serde.dumps(v) == j_serde.dumps(jv)
    fs = frozenset({1, 2})
    out = t_serde.loads(t_serde.dumps(fs))
    assert out == fs and isinstance(out, frozenset)
    keyed = {frozenset({"a"}): "x"}
    assert t_serde.loads(t_serde.dumps(keyed)) == keyed
    with pytest.raises(ct.CausalError):
        t_serde.dumps(object())


def test_merge_after_round_trip():
    def run(pkg, w):
        base = pkg.clist(*"seed", weaver=w)
        a = type(base)(base.ct.evolve(site_id=pkg.new_site_id())).conj("A")
        b = type(base)(base.ct.evolve(site_id=pkg.new_site_id())).conj("B")
        shipped = SERDE[pkg].loads(SERDE[pkg].dumps(b))
        return a.merge(shipped), shipped.merge(a)

    for m1, m2 in twin(run).values():
        assert m1.causal_to_edn() == m2.causal_to_edn()


def test_nonfinite_floats_round_trip_strict_json():
    cl = ct.clist(float("nan"), float("inf"), float("-inf"), 1.5)
    text = t_serde.dumps(cl)
    json.loads(text, parse_constant=lambda s: pytest.fail(
        f"non-strict constant {s}"))
    vals = ct.causal_to_edn(t_serde.loads(text))
    assert math.isnan(vals[0]) and vals[1:] == [float("inf"),
                                                float("-inf"), 1.5]


# ----------------------------------------- the weaver field across packages


def test_reference_device_checkpoint_loads_onto_the_torch_weaver():
    """The reference writes its device weaver as ``"jax"``. A port that
    kept the name would hold a tree whose handles send it to the pure
    path without a word; the port maps ``"jax"`` to ``"torch"`` on load,
    for trees and for bases, and leaves every other name alone. The
    bytes of pure collections and bases are untouched."""
    with seeded(3):
        j_list = c.clist(*"abc", weaver="jax").conj("d")
        j_cb = c.transact(c.base(weaver="jax"), [[None, None, {
            c.K("l"): [1, 2], c.K("s"): {"x"}, c.K("n"): c.ccounter(2)}]])
    back = t_serde.loads(j_serde.dumps(j_list))
    assert back.ct.weaver == "torch"
    assert back.ct.weave == t_serde.loads(j_serde.dumps(j_list).replace(
        '"weaver": "jax"', '"weaver": "pure"')).ct.weave
    # the device route really runs: a merge of the loaded tree goes
    # through the port's device reweave
    from cause_tpu_torch.weaver import torchw

    calls = []
    real = torchw.merge_list_trees
    try:
        torchw.merge_list_trees = lambda *a: calls.append(1) or real(*a)
        back.merge(back.conj("e"))
    finally:
        torchw.merge_list_trees = real
    assert calls == [1]
    base = t_serde.loads(j_serde.dumps(j_cb))
    assert base.cb.weaver == "torch" and weavers_of(base.cb) == {"torch"}
    assert t_serde.dumps(base) == j_serde.dumps(j_cb).replace(
        '"weaver": "jax"', '"weaver": "torch"')
    for name in ("pure", "native"):
        d = j_serde.to_data(j_list)
        d["weaver"] = name
        assert t_serde.from_data(d).ct.weaver == name
    with seeded(4):
        jp = c.transact(c.base(), [[None, None, [1, {c.K("a"): "b"}]]])
    with seeded(4):
        tp = ct.transact(ct.base(), [[None, None, [1, {ct.K("a"): "b"}]]])
    assert t_serde.dumps(tp) == j_serde.dumps(jp)
    assert t_serde.dumps(t_serde.loads(j_serde.dumps(jp))) == \
        j_serde.dumps(jp)


# ----------------------------------- tests/test_set_counter.py, the base


def test_set_and_counter_first_class_in_base():
    """``tests/test_set_counter.py:163``: a base holding a set and a
    counter, edited through the base, undone, redone, round-tripped and
    synced between two replicas."""
    def run(pkg, w):
        b, K, rid = CB[pkg], pkg.K, pkg.root_id
        cb = b.transact_(b.new_cb(w), [[None, None, {
            K("tags"): {"a", "b"}, K("votes"): pkg.ccounter(3),
            K("title"): "doc"}]])
        kinds = {type(h).__name__ for h in cb.collections.values()}
        set_uuid = next(u for u, h in cb.collections.items()
                        if type(h).__name__ == "CausalSet")
        ctr_uuid = next(u for u, h in cb.collections.items()
                        if type(h).__name__ == "CausalCounter")
        cb2 = b.transact_(cb, [[set_uuid, None, {"c"}], [ctr_uuid, rid, 4]])
        cb3 = b.undo_(cb2)
        cb4 = b.redo_(cb3)
        back = SERDE[pkg].loads(SERDE[pkg].dumps(b.CausalBase(cb4)))
        ra = b.CausalBase(cb4.evolve(site_id="siteA________"))
        rb = b.CausalBase(cb4.evolve(site_id="siteB________"))
        ra = b.CausalBase(b.transact_(ra.cb, [[set_uuid, None, {"x"}]]))
        rb = b.CausalBase(b.transact_(rb.cb, [[ctr_uuid, rid, -2]]))
        sa, sb = pkg.sync_base_pair(ra, rb)
        return ([b.cb_to_edn(x) for x in (cb, cb2, cb3, cb4)], kinds,
                back, sa, sb)

    edns, kinds, back, sa, sb = twin(run)["device"]
    K = ct.K
    assert [(e[K("tags")], e[K("votes")]) for e in edns] == [
        ({"a", "b"}, 3), ({"a", "b", "c"}, 7), ({"a", "b"}, 3),
        ({"a", "b", "c"}, 7)]
    assert {"CausalSet", "CausalCounter", "CausalMap"} <= kinds
    assert back.causal_to_edn() == edns[3]
    assert weavers_of(back.cb) == {"torch"}
    ea, eb = sa.causal_to_edn(), sb.causal_to_edn()
    assert ea == eb and ea[K("tags")] == {"a", "b", "c", "x"}
    assert ea[K("votes")] == 5


def test_base_set_counter_edge_cases():
    """``tests/test_set_counter.py:228``."""
    def run(pkg, w):
        b, K = CB[pkg], pkg.K
        cb = b.transact_(b.new_cb(w), [[None, None, pkg.ccounter(5)]])
        n_ctr = sum(type(h).__name__ == "CausalCounter"
                    for h in cb.collections.values())
        cb2 = b.transact_(b.new_cb(w), [[None, None, {K("tags"): {"a"}}]])
        set_uuid = next(u for u, h in cb2.collections.items()
                        if type(h).__name__ == "CausalSet")
        errs = []
        for tx in ([[set_uuid, None, {"k": 1}]],
                   [[set_uuid, None, [[1, 2], [3]]]],
                   [[set_uuid, None, {frozenset({1, 2})}]]):
            try:
                b.transact_(cb2, tx)
                errs.append(None)
            except pkg.CausalError as e:
                errs.append(sorted(e.info.get("causes", ())))
        cb3 = b.transact_(cb2, [[set_uuid, None, "abc"]])
        return (b.cb_to_edn(cb), n_ctr, errs, b.cb_to_edn(cb3),
                b.cb_to_edn(b.undo_(cb3)))

    edn, n_ctr, errs, e3, undone = twin(run)["device"]
    assert edn == 5 and n_ctr == 1
    assert errs[0] == ["unhashable-set-member"] and None not in errs
    assert e3[ct.K("tags")] == {"a", "abc"}
    assert undone[ct.K("tags")] == {"a"}


def test_base_collections_carry_the_weaver():
    """A ``weaver="torch"`` base hands its weaver to every collection it
    creates, as the reference's ``"jax"`` does."""
    cb = ct.transact(ct.base(weaver="torch"), [[None, None, {
        ct.K("l"): [1, [2]], ct.K("s"): {"x"}, ct.K("n"): ct.ccounter(1),
        ct.K("m"): {ct.K("k"): "v"}}]])
    assert weavers_of(cb.cb) == {"torch"}
    kinds = {type(h) for h in cb.cb.collections.values()}
    assert {CausalList, CausalSet, CausalCounter, ct.CausalMap} <= kinds
    with pytest.raises(t_shared.CausalError):
        ct.compact(cb)
