"""The port's merge reduction tree, ``flat_fold`` and ``merge_all``
against the JAX package.

Fleets are replayed in both packages with the same site ids (see
``test_torch_session``). The port's tree root must equal, node for node
and weave for weave, the reference's pairwise fold of the twin fleet
(its pure weaver, the oracle) and the port's own fold; where the
reference's tree runs too, the per-level reports (path, window, pairs,
byes, divergent ops, digest agreement) are equal. Mirrors
``tests/test_merge_tree.py`` (bit identity for n = 1, 2, 3 and larger,
rounds, degenerate trees, duplicates, the flat fold, ``merge_all``
routing, small and pure fleets staying flat, the mid-tree bounce, the
session's ``converge``) and the list cases of ``tests/test_fleet.py``.
"""

import functools
import random

import pytest

from cause_tpu.collections import clist as j_clist
from cause_tpu.parallel import tree as j_tree

import cause_tpu_torch as ct
from cause_tpu_torch.collections import shared as t_shared
from cause_tpu_torch.parallel import tree as t_tree
from cause_tpu_torch.parallel.session import FleetSession
from cause_tpu_torch.weaver import torchw

# on_cpu is the autouse fixture that runs the port on the CPU
from test_torch_session import (JAX, PORT, make_base, on_cpu,  # noqa: F401
                                replica, weave_ids)


def make_fleet(tw, base, n, n_div=4, hide_every=0):
    fleet = []
    for r in range(n):
        h = replica(tw, base, "R", r)
        for i in range(n_div):
            h = h.conj(f"r{r}.{i}")
            if hide_every and i and i % hide_every == 0:
                h = h.conj(tw.pkg.hide)
        fleet.append(h)
    return fleet


def fold(handles):
    return functools.reduce(lambda a, b: a.merge(b), handles)


def pure(h):
    """A reference handle on the pure host weaver (the oracle)."""
    return j_clist.CausalList(h.ct.evolve(weaver="pure"))


def assert_identical(got, want):
    """Same nodes, same weave (ids in order), same clock, same values,
    across packages: nodes and weave entries are plain tuples, and
    specials compare through their names."""
    assert sorted(got.ct.nodes) == sorted(want.ct.nodes)
    assert weave_ids(got) == weave_ids(want)
    assert got.ct.lamport_ts == want.ct.lamport_ts
    assert got.causal_to_edn() == want.causal_to_edn()


def untimed(rep):
    """The port's report without the level times the reference's report
    does not carry; every level must have one."""
    assert all(lv["ms"] >= 0 for lv in rep["levels"])
    return dict(rep, levels=[{k: v for k, v in lv.items() if k != "ms"}
                             for lv in rep["levels"]])


def twin_fleets(n, n_div, hide_every=0, n_base=40):
    """The twin fleet in both packages: (reference, port)."""
    return tuple(make_fleet(tw, make_base(tw, n_base), n, n_div=n_div,
                            hide_every=hide_every) for tw in (JAX, PORT))


# ------------------------------------------------------- bit identity


@pytest.mark.parametrize("n,n_div,hide_every", [
    (4, 3, 0),
    (5, 4, 0),    # odd: a bye at level 0
    (7, 2, 2),    # odd twice (7 -> 4 -> 2 -> 1), tombstoned suffixes
    (8, 5, 3),
])
def test_tree_bit_identical_to_fold(n, n_div, hide_every):
    jf, tf = twin_fleets(n, n_div, hide_every)
    root, rep = t_tree.merge_tree_report(tf)
    assert root.ct.weaver == "torch"
    assert_identical(root, fold([pure(h) for h in jf]))
    assert_identical(root, fold(tf))
    assert len(rep["levels"]) == rep["rounds"] == t_tree.tree_rounds(n)
    assert rep["levels"][0]["path"] == "full"
    assert all(lv["path"] == "delta" for lv in rep["levels"][1:])
    _jroot, jrep = j_tree.merge_tree_report(jf)
    assert untimed(rep) == jrep


def test_tree_rounds_arithmetic():
    for n, want in ((1, 0), (2, 1), (3, 2), (5, 3), (64, 6), (1024, 10)):
        assert t_tree.tree_rounds(n) == j_tree.tree_rounds(n) == want


def test_degenerate_trees():
    jf, tf = twin_fleets(2, 3)
    (ja, jb), (a, b) = jf, tf
    root, rep = t_tree.merge_tree_report([a])
    assert root is a and rep["rounds"] == 0 and rep["levels"] == []
    root, rep = t_tree.merge_tree_report([a, b])
    assert_identical(root, pure(ja).merge(pure(jb)))
    assert [lv["path"] for lv in rep["levels"]] == ["full"]
    root, rep = t_tree.merge_tree_report([a, b, a])
    assert_identical(root, pure(ja).merge(pure(jb)))
    assert rep["levels"][0]["byes"] == 1
    assert len(rep["levels"]) == 2


def test_duplicated_replicas_dedupe_in_windows():
    jf, tf = twin_fleets(2, 3)
    root, rep = t_tree.merge_tree_report(tf * 8)
    assert_identical(root, pure(jf[0]).merge(pure(jf[1])))
    assert all(lv["agreed"] for lv in rep["levels"])
    assert len(rep["levels"]) == 4


def test_flat_fold_equals_merge_fold():
    jf, tf = twin_fleets(5, 3)
    assert_identical(t_tree.flat_fold(tf), fold([pure(h) for h in jf]))


# ------------------------------------------------------ merge_all API


@pytest.fixture
def tree_calls(monkeypatch):
    """Counts the port's merge_tree calls (merge_all's tree route)."""
    calls = []
    real = t_tree.merge_tree

    def counted(handles, **kw):
        calls.append(len(handles))
        return real(handles, **kw)

    monkeypatch.setattr(t_tree, "merge_tree", counted)
    return calls


def test_merge_all_routes_through_tree(tree_calls):
    jf, tf = twin_fleets(6, 3, hide_every=2)
    want = fold([pure(h) for h in jf])
    assert_identical(ct.merge_all(tf[0], *tf[1:]), want)
    assert tree_calls == [6]
    via_flat = ct.merge_all(tf[0], *tf[1:], tree=False)
    assert tree_calls == [6], "tree=False must not route through the tree"
    assert_identical(via_flat, want)


def test_merge_all_small_and_pure_fleets_stay_flat(tree_calls):
    jf, tf = twin_fleets(3, 2)
    out = ct.merge_all(*tf)  # < 4 inputs: merge_many
    assert tree_calls == []
    assert_identical(out, fold([pure(h) for h in jf]))
    # pure-weaver handles never touch the device path
    before = torchw.pure_fallbacks
    pf = [ct.CausalList(h.ct.evolve(weaver="pure")).conj(f"x{r}")
          for r, h in enumerate(make_fleet(PORT, make_base(PORT, 12), 5,
                                           n_div=0))]
    out = ct.merge_all(pf[0], *pf[1:])
    assert tree_calls == [] and torchw.pure_fallbacks == before
    assert out.ct.nodes == fold(pf).ct.nodes
    assert out.ct.weave == fold(pf).ct.weave


# ------------------------------------------------- mid-tree full bounce


def test_mid_tree_bounce_does_not_corrupt_later_levels():
    jf, tf = twin_fleets(16, 2)
    want = fold([pure(h) for h in jf])
    root, rep = t_tree.merge_tree_report(tf, w_budget=9)
    assert_identical(root, want)
    paths = [lv["path"] for lv in rep["levels"]]
    assert len(paths) == 4
    assert "delta" in paths[1:], paths   # delta engaged before the
    assert "full" in paths[1:], paths    # bounce, full after it
    root2, rep2 = t_tree.merge_tree_report(tf, w_budget=2)
    assert_identical(root2, want)
    assert all(lv["path"] == "full" for lv in rep2["levels"])
    assert untimed(rep) == j_tree.merge_tree_report(jf, w_budget=9)[1]


# -------------------------------------------------- session converge


def test_session_converge_tree_and_fold(tree_calls):
    jf, tf = twin_fleets(4, 3)
    sess = FleetSession([(tf[0], tf[1]), (tf[2], tf[3])])
    sess.wave()
    want = fold([pure(h) for h in jf])
    assert_identical(sess.converge(), want)
    assert tree_calls == [4]
    assert_identical(sess.converge(tree=False), want)
    assert tree_calls == [4]
    # the resident wave state survives convergence
    d = sess.wave()
    assert d.shape == (2,)


def test_tree_fleet_handles_generator():
    from cause_tpu_torch import benchgen

    fleet = benchgen.tree_fleet_handles(5, 30, 4, hide_every=2)
    assert len(fleet) == 5
    assert all(h.ct.weaver == "torch" for h in fleet)
    root, rep = t_tree.merge_tree_report(fleet)
    pure_fold = fold([ct.CausalList(h.ct.evolve(weaver="pure"))
                      for h in fleet])
    assert root.ct.nodes == pure_fold.ct.nodes
    assert root.ct.weave == pure_fold.ct.weave
    assert len(rep["levels"]) == t_tree.tree_rounds(5)


def test_tree_refuses_an_empty_fleet():
    for fn in (t_tree.merge_tree_report, t_tree.flat_fold):
        with pytest.raises(t_shared.CausalError):
            fn([])


# ------------------------------------- tests/test_fleet.py list cases


def random_fleet(tw, weaver, n_replicas=6, n_edits=5, seed=11):
    """Replicas of one "seed" list, each with random inserts at random
    causes from its own site (the reference fuzzer's shape, replayed
    with the same choices in both packages)."""
    rng = random.Random(seed)
    base = tw.handle(tw.pkg.clist(weaver=weaver).ct.evolve(
        site_id="sFLEETBASE000")).extend(list("seed"))
    fleet = []
    for r in range(n_replicas):
        h = replica(tw, base, "F", r)
        for k in range(n_edits):
            cause = rng.choice(sorted(h.ct.nodes))
            yarn = h.ct.yarns.get(h.ct.site_id)
            tip = yarn[-1][0][0] if yarn else 0
            h = h.insert(tw.pkg.node(1 + max(cause[0], tip), h.ct.site_id,
                                     cause, f"v{r}.{k}"))
        fleet.append(h)
    return fleet


@pytest.mark.parametrize("weaver", ["pure", "torch"])
def test_merge_all_equals_fold(weaver):
    want = fold(random_fleet(JAX, "pure"))
    fleet = random_fleet(PORT, weaver)
    folded = fold(fleet)
    converged = ct.merge_all(fleet[0], *fleet[1:])
    for got in (folded, converged):
        assert_identical(got, want)
    assert converged.ct.nodes == folded.ct.nodes
    assert converged.ct.yarns == folded.ct.yarns
    assert converged.ct.weave == folded.ct.weave


def test_merge_all_order_invariant():
    fleet = random_fleet(PORT, "torch", seed=23)
    a = ct.merge_all(fleet[0], *fleet[1:])
    b = ct.merge_all(fleet[-1], *reversed(fleet[:-1]))
    assert a.causal_to_edn() == b.causal_to_edn()
    assert a.ct.nodes == b.ct.nodes


def test_merge_all_guards():
    with pytest.raises(ct.CausalError):
        ct.merge_all(ct.clist("a"), ct.clist("b"))


def test_merge_all_validates_dangling_cause():
    """A foreign node whose cause is nowhere in the union raises, as the
    pairwise fold does, on both fleet routes."""
    for weaver in ("pure", "torch"):
        a = ct.CausalList(ct.clist("a").ct.evolve(weaver=weaver))
        b = ct.CausalList(a.ct.evolve(site_id=ct.new_site_id()))
        bad_nodes = dict(b.ct.nodes)
        bad_nodes[(9, b.ct.site_id, 0)] = ((7, "ghost________", 0), "X")
        bad = ct.CausalList(b.ct.evolve(nodes=bad_nodes))
        with pytest.raises(ct.CausalError):
            ct.merge_all(a, bad)
    with pytest.raises(ct.CausalError):
        t_shared.union_nodes_many([])


# ------------------------------------------------ the telemetry halves


def _tree_obs_run(tw, fleet, obs_mod):
    from test_torch_obs import reset_all

    reset_all()
    obs_mod.configure(enabled=True)
    root, rep = tw.pkg.merge_tree_report(fleet) if tw is PORT else \
        j_tree.merge_tree_report(fleet)
    evs = obs_mod.events()
    obs_mod.configure(enabled=False)
    return root, rep, evs


def test_tree_level_events_and_gap_join():
    """``tests/test_merge_tree.py``'s case on an 8-replica twin fleet:
    one ``tree.level``, ``wave.digest(source="tree")`` and ``wave.cost``
    per level, no divergence incident, level 0 full and the rest delta,
    the gap report's per-level decomposition; the port's stream equals
    the reference's record for record."""
    from cause_tpu import obs as j_obs
    from cause_tpu_torch import obs as t_obs
    from cause_tpu_torch.obs import costmodel
    from test_torch_obs import normalize, reset_all

    jf, tf = (make_fleet(tw, make_base(tw, 40, uuid="tree-obs-doc"), 8,
                         n_div=3) for tw in (JAX, PORT))
    _jr, _jrep, j_evs = _tree_obs_run(JAX, jf, j_obs)
    root, rep, evs = _tree_obs_run(PORT, tf, t_obs)
    reset_all()
    assert_identical(root, fold([pure(h) for h in jf]))
    assert normalize(evs) == normalize(j_evs)

    def fields(name):
        return [e["fields"] for e in evs if e.get("ev") == "event"
                and e.get("name") == name
                and e["fields"].get("source", "tree") == "tree"]

    tl, wd, wc = fields("tree.level"), fields("wave.digest"), \
        fields("wave.cost")
    assert not fields("divergence")
    rounds = t_tree.tree_rounds(8)
    assert len(tl) == len(wd) == len(wc) == rounds
    assert [f["level"] for f in wc] == list(range(rounds))
    assert wc[0]["path"] == "full"
    assert all(f["path"] == "delta" for f in wc[1:])
    assert all(f["dispatches"] == 1 for f in wc)
    assert all(f["delta_ops"] > 0 for f in wc[1:])
    assert tl[-1]["final"] is True
    dec = costmodel.tree_decomposition(evs)
    assert dec["rounds"] == rounds and dec["post_level0_delta_share"] == 1.0
    rendered = costmodel.render_gap(costmodel.gap_report([], evs))
    assert "merge tree" in rendered and "level 0" in rendered


def test_tree_obs_off_invariance():
    """``tests/test_merge_tree.py``'s ``test_obs_off_invariance``: obs
    off records nothing and keeps no monitor or cost state; obs on
    takes the same route to the same root."""
    from cause_tpu_torch import obs as t_obs
    from cause_tpu_torch.obs import costmodel, lag, semantic
    from test_torch_obs import reset_all

    reset_all()
    _jf, tf = twin_fleets(6, 3)
    root, rep = t_tree.merge_tree_report(tf)
    assert t_obs.events() == []
    assert costmodel._PROGRAMS == {} and costmodel._PENDING_OPS == {}
    assert semantic._MON == {} and lag._DOCS == {}
    t_obs.configure(enabled=True)
    root_on, rep_on = t_tree.merge_tree_report(tf)
    reset_all()
    assert_identical(root, root_on)
    assert [lv["path"] for lv in rep["levels"]] == \
        [lv["path"] for lv in rep_on["levels"]]
