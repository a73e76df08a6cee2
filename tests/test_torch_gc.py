"""The port's tombstone compaction (``gc``) against the JAX package's.

Mirrors ``tests/test_gc.py`` — semantics preserved, the right shapes
reclaim, the sync-soundness rule (no interior yarn holes), the
compacted tree as a first-class citizen (serde, merge, sync's full-bag
fallback), the stability frontier — and ``tests/test_delta_weave.py:293``
(compaction under a session's resident weave). Each scenario runs as
twins in both packages (uid generators seeded alike) under
``weaver="pure"`` and ``"torch"`` in the port and ``"pure"`` and ``"jax"``
in the reference, compared through each package's serde encoding. A
``weaver="torch"`` compaction reweaves the surviving bag on the device
(on the CPU through the kernels' plain versions).
"""

import random

import numpy as np
import pytest

import cause_tpu as c
from cause_tpu import gc as j_gc
from cause_tpu import sync as j_sync
from cause_tpu.parallel import merge_wave as j_merge_wave
from cause_tpu.parallel.session import FleetSession as JSession

import cause_tpu_torch as ct
from cause_tpu_torch import gc as t_gc
from cause_tpu_torch import serde as t_serde
from cause_tpu_torch import sync as t_sync
from cause_tpu_torch.collections import clist as t_clist
from cause_tpu_torch.parallel.session import FleetSession as TSession
from cause_tpu_torch.weaver import torchw

from test_torch_base import rand_node, seeded, twin

GC = {c: j_gc, ct: t_gc}
SYNC = {c: j_sync, ct: t_sync}


@pytest.fixture(autouse=True)
def on_cpu():
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def hide_tail(pkg, cl, n):
    for _ in range(n):
        cl = cl.append(list(cl)[-1][0], pkg.hide)
    return cl


def test_noop_when_nothing_hidden():
    for pkg, w in ((c, "jax"), (ct, "torch")):
        cl = pkg.clist(*"abc", weaver=w)
        assert GC[pkg].compact(cl) is cl


def test_tail_delete_reclaims_and_preserves_edn():
    def run(pkg, w):
        cl = hide_tail(pkg, pkg.clist(*[str(i) for i in range(40)],
                                      weaver=w), 15)
        out = GC[pkg].compact(cl)
        return cl, out, GC[pkg].compact_stats(cl, out), \
            GC[pkg].compact(out) is out

    for w, (cl, out, st, idem) in twin(run).items():
        assert out.causal_to_edn() == cl.causal_to_edn()
        assert st["dropped"] >= 30 and ct.root_id in out.ct.nodes and idem
        assert out.ct.weaver == ("pure" if w == "pure" else "torch")


def test_interior_tombstones_stay_as_skeleton():
    def run(pkg, w):
        cl = pkg.clist(*[str(i) for i in range(20)], weaver=w)
        ids = [nd[0] for nd in list(cl)]
        cl = cl.append(ids[5], pkg.hide)
        return cl, GC[pkg].compact(cl), ids[5]

    cl, out, victim = twin(run)["device"]
    assert out.causal_to_edn() == cl.causal_to_edn()
    assert victim in out.ct.nodes


def test_undone_branch_reclaims():
    def run(pkg, w):
        cl = pkg.clist(*"abcdef", weaver=w)
        ids = [nd[0] for nd in list(cl)]
        na, nb = (100, "siteZZZZZZZZZ", 0), (101, "siteZZZZZZZZZ", 0)
        cl = cl.insert((na, ids[3], "X")).insert((nb, na, "Y"))
        cl = cl.append(nb, pkg.hide).append(na, pkg.hide)
        out = GC[pkg].compact(cl)
        return cl, out, GC[pkg].compact_stats(cl, out)

    cl, out, st = twin(run)["device"]
    assert out.causal_to_edn() == cl.causal_to_edn()
    assert st["dropped"] >= 4 and (100, "siteZZZZZZZZZ", 0) not in out.ct.nodes


def test_map_single_site_churn_declines_soundly():
    def run(pkg, w):
        K = pkg.K
        cm = pkg.cmap(weaver=w)
        for j in range(6):
            for o in range(10):
                cm = cm.assoc(K(f"k{j}"), f"v{o}")
        cm = cm.dissoc(K("k0"))
        out = GC[pkg].compact(cm)
        return cm, out, GC[pkg].compact_stats(cm, out)

    cm, out, st = twin(run)["device"]
    assert out.causal_to_edn() == cm.causal_to_edn() and st["dropped"] == 0


def test_map_superseded_writer_reclaims_wholesale():
    def run(pkg, w):
        K = pkg.K
        cm = pkg.cmap(weaver=w)
        for j in range(4):
            cm = cm.append(K(f"k{j}"), f"old{j}")
        w2 = pkg.CausalMap(cm.ct.evolve(site_id=pkg.new_site_id()))
        for j in range(4):
            w2 = w2.append(K(f"k{j}"), f"new{j}")
        out = GC[pkg].compact(w2)
        out2 = out.append(out.ct.weave[K("k1")][1][0], pkg.hide)
        return w2, out, GC[pkg].compact_stats(w2, out), out2

    w2, out, st, out2 = twin(run)["device"]
    assert out.causal_to_edn() == w2.causal_to_edn() and st["dropped"] == 4
    assert ct.K("k1") not in out2.causal_to_edn()


def test_no_interior_yarn_holes_ever():
    def run(pkg, w):
        rng = random.Random(700216)
        outs = []
        for case in range(8):
            cl = pkg.clist(*[str(i) for i in range(rng.randrange(1, 12))],
                           weaver=w)
            sites = [pkg.new_site_id() for _ in range(2)]
            for _ in range(rng.randrange(5, 25)):
                cl = cl.insert(rand_node(pkg, rng, cl, rng.choice(sites)))
            outs.append((cl, GC[pkg].compact(cl)))
        return outs

    for cl, out in twin(run)["device"]:
        dropped = set(cl.ct.nodes) - set(out.ct.nodes)
        for nid in dropped:
            assert not [k for k in out.ct.nodes if k != (0, "0", 0)
                        and k[1] == nid[1] and k > nid], nid


def test_compacted_tree_is_first_class():
    def run(pkg, w):
        serde = pkg.serde
        cl = hide_tail(pkg, pkg.clist(*[str(i) for i in range(30)],
                                      weaver=w), 10)
        out = GC[pkg].compact(cl)
        back = serde.from_data(serde.to_data(out))
        pid = [nd[0] for nd in list(out)][5]
        m1 = pkg.insert(out, pkg.node(9000, "siteYYYYYYYYY", pid, "Z"))
        m2 = pkg.insert(back, pkg.node(9001, "siteXXXXXXXXX", pid, "W"))
        return (back, pkg.merge(m1, m2), pkg.merge(m2, m1),
                out.conj("new"))

    back, m12, m21, grown = twin(run)["device"]
    assert back.ct.weaver == "torch"
    assert m12.causal_to_edn() == m21.causal_to_edn()
    assert grown.causal_to_edn()[-1] == "new"


def test_merge_into_peer_is_plain_idempotent_merge():
    def run(pkg, w):
        cl = hide_tail(pkg, pkg.clist(*[str(i) for i in range(25)],
                                      weaver=w), 8)
        peer = pkg.CausalList(cl.ct)
        return peer, peer.merge(GC[pkg].compact(cl))

    peer, merged = twin(run)["device"]
    assert merged.causal_to_edn() == peer.causal_to_edn()


def test_sync_full_bag_fallback_reimports_dropped_region():
    """A peer whose delta names a compacted-away cause takes sync's
    full-bag path; both sides converge (``tests/test_gc.py:156``)."""
    def run(pkg, w):
        cl = pkg.clist(*[str(i) for i in range(20)], weaver=w)
        peer = pkg.CausalList(cl.ct.evolve(site_id="sitePPPPPPPPP"))
        tail = list(peer)[-1]
        peer = peer.insert(((50, "sitePPPPPPPPP", 0), tail[0], "P"))
        ours = GC[pkg].compact(hide_tail(pkg, cl, 5))
        assert tail[0] not in ours.ct.nodes
        return SYNC[pkg].sync_pair(ours, peer)

    a, b = twin(run)["device"]
    assert a.causal_to_edn() == b.causal_to_edn()
    assert "P" in a.causal_to_edn()


def test_sync_after_compaction_resends_the_dropped_suffix():
    """Compaction drops only per-site yarn suffixes, so the uncompacted
    peer's delta (everything above the compacted side's version vector)
    carries every dropped node with the peer's new edit, and no cause is
    missing: the round takes the delta path, not the full bag, in both
    packages — the same delta sizes, one way and the other."""
    def run(pkg, w):
        sync = SYNC[pkg]
        cl = pkg.clist(*[str(i) for i in range(20)], weaver=w)
        peer = pkg.CausalList(cl.ct.evolve(site_id="sitePPPPPPPPP"))
        tail = list(peer)[-1]
        peer = peer.insert(((50, "sitePPPPPPPPP", 0), tail[0], "P"))
        ours = GC[pkg].compact(hide_tail(pkg, cl, 5))
        sizes = []
        real = sync.apply_delta
        try:
            sync.apply_delta = lambda h, nodes, **kw: sizes.append(
                len(nodes)) or real(h, nodes, **kw)
            a, b = sync.sync_pair(ours, peer)
        finally:
            sync.apply_delta = real
        return sizes, a, b, len(peer.ct.nodes)

    sizes, a, b, n_peer = twin(run)["device"]
    assert sizes == [6, 0] and n_peer not in sizes
    assert a.ct.weave == b.ct.weave


def test_fuzz_compaction_preserves_semantics():
    def run(pkg, w):
        rng = random.Random(0x6C)
        outs = []
        for case in range(15):
            cl = pkg.clist(*[str(i) for i in range(rng.randrange(1, 15))],
                           weaver=w)
            for _ in range(rng.randrange(5, 30)):
                cl = cl.insert(rand_node(pkg, rng, cl, rng.choice(
                    ["siteAAAAAAAAA", "siteBBBBBBBBB"])))
            out = GC[pkg].compact(cl)
            outs.append((cl, out, GC[pkg].compact(out)))
        return outs

    for cl, out, again in twin(run)["device"]:
        before = cl.causal_to_edn()
        assert out.causal_to_edn() == before == again.causal_to_edn()
        assert len(again.ct.nodes) == len(out.ct.nodes)


def test_base_collections_rejected_with_guidance():
    with pytest.raises(ct.CausalError):
        ct.compact(ct.base())


def test_stability_frontier_math():
    a = {"s1": [10, 0], "s2": [5, 2]}
    b = {"s1": [7, 1], "s2": [5, 9], "s3": [2, 0]}
    assert t_gc.stability_frontier(a, b) == j_gc.stability_frontier(a, b) \
        == {"s1": [7, 1], "s2": [5, 2]}
    assert t_gc.stability_frontier() == {}


def test_frontier_prevents_tombstone_resurrection():
    def run(pkg, w):
        sync, gc = SYNC[pkg], GC[pkg]
        base = pkg.clist(*"abc", weaver=w)
        site_a, site_b = "siteAAAAAAAAA", "siteBBBBBBBBB"
        head = list(base)[-1][0]
        d_id = (10, site_a, 0)
        a_rep = pkg.CausalList(base.ct.evolve(site_id=site_a)).insert(
            (d_id, head, "D"))
        b_rep = pkg.CausalList(a_rep.ct.evolve(site_id=site_b)).append(
            d_id, pkg.hide)
        c_rep = pkg.CausalList(b_rep.ct)
        frontier = gc.stability_frontier(sync.version_vector(a_rep),
                                         sync.version_vector(c_rep))
        dropped = gc.compact(c_rep)
        safe = gc.compact(c_rep, stable_vv=frontier)
        return (c_rep, dropped, dropped.merge(a_rep), safe,
                safe.merge(a_rep), d_id)

    c_rep, dropped, resurrected, safe, healed, d_id = twin(run)["device"]
    assert "D" not in c_rep.causal_to_edn()
    assert d_id not in dropped.ct.nodes
    assert "D" in resurrected.causal_to_edn()  # the documented hazard
    assert "D" not in healed.causal_to_edn()
    assert safe.causal_to_edn() == c_rep.causal_to_edn()


def test_frontier_still_reclaims_stable_regions():
    def run(pkg, w):
        cl = hide_tail(pkg, pkg.clist(*[str(i) for i in range(30)],
                                      weaver=w), 10)
        f = GC[pkg].stability_frontier(SYNC[pkg].version_vector(cl),
                                       SYNC[pkg].version_vector(cl))
        out = GC[pkg].compact(cl, stable_vv=f)
        return cl, out, GC[pkg].compact_stats(cl, out)

    cl, out, st = twin(run)["device"]
    assert st["dropped"] >= 20 and out.causal_to_edn() == cl.causal_to_edn()


def test_compaction_reweaves_on_the_device_route():
    """A ``weaver="torch"`` compaction rebuilds the surviving bag with
    one device reweave, equal to the pure weave of the same bag."""
    cl = hide_tail(ct, ct.clist(*[str(i) for i in range(50)],
                                weaver="torch"), 12)
    calls = []
    real = torchw.refresh_list_weave
    try:
        torchw.refresh_list_weave = lambda t: calls.append(
            len(t.nodes)) or real(t)
        out = ct.compact(cl)
    finally:
        torchw.refresh_list_weave = real
    assert calls == [len(out.ct.nodes)] and out.ct.weaver == "torch"
    pure = t_clist.weave(out.ct.evolve(weaver="pure"))
    assert out.ct.weave == pure.weave


def test_gc_compaction_under_resident_weave_falls_back():
    """``tests/test_delta_weave.py:293``: compaction rewrites a tree's
    history; the session re-uploads (delta state dropped) and every
    wave and merge stays equal to the reference's."""
    def run(pkg, w, Session, merge_wave):
        h = pkg.clist(weaver=w)
        h = type(h)(h.ct.evolve(site_id="sBASE00000000"))
        base = type(h)(pkg.collections.clist.weave(
            h.extend([f"w{i}" for i in range(30)]).ct))
        base.ct.lanes.segments()
        pairs = []
        for p in range(2):
            a = type(base)(base.ct.evolve(site_id=f"sA{p:011d}")).extend(
                [f"a{p}.{i}" for i in range(4)])
            b = type(base)(base.ct.evolve(site_id=f"sB{p:011d}")).extend(
                [f"b{p}.{i}" for i in range(3)])
            pairs.append((a, b))
        sess = Session(pairs)
        sess.wave()
        assert sess._delta is not None
        a0, b0 = pairs[0]
        for _ in range(3):
            a0 = a0.append(list(a0)[-1][0], pkg.hide)
        a0c = GC[pkg].compact(a0)
        assert len(a0c.ct.nodes) < len(a0.ct.nodes)
        pairs2 = [(a0c, b0)] + pairs[1:]
        sess.update(pairs2)
        d = sess.wave()
        assert np.array_equal(d, merge_wave(pairs2).digest)
        return d, [sess.merged(i) for i in range(2)], pairs2

    with seeded(6):
        j_d, j_m, _ = run(c, "jax", JSession, j_merge_wave)
    with seeded(6):
        t_d, t_m, pairs2 = run(ct, "torch", TSession, ct.merge_wave)
    assert np.array_equal(t_d, j_d)
    for i, (x, y) in enumerate(pairs2):
        assert t_m[i].ct.weave == x.merge(y).ct.weave
        assert t_serde.dumps(t_m[i].ct.weave) == \
            c.serde.dumps(j_m[i].ct.weave)


@pytest.mark.parametrize("tail, every", [(5, 3), (12, 8), (30, 5)])
def test_compacted_tail_weave_is_the_filtered_weave(tail, every):
    """Compacting a hidden tail drops a chain of leaves, so the pure
    weave of the compacted nodes is the uncompacted weave with the
    dropped nodes taken out — the cheap oracle the chip smoke holds a
    10k-node compaction to. Here the pure reweave checks it, on a list
    shaped like the smoke's (interior tombstones every few values, then
    the hidden tail)."""
    cl = ct.clist(*[str(i) for i in range(40)], weaver="torch")
    vals = []
    for i in range(60):
        vals.append(f"v{i}")
        if i % every == every - 1:
            vals.append(ct.hide)
    cl = cl.extend(vals)
    visible = [n[0] for n in cl]
    for nid in reversed(visible[-tail:]):
        cl = cl.append(nid, ct.hide)
    out = ct.compact(cl)
    assert len(out.ct.nodes) <= len(cl.ct.nodes) - 2 * tail
    pure = t_clist.weave(out.ct.evolve(weaver="pure"))
    assert pure.weave == out.ct.weave == [
        n for n in cl.ct.weave if n[0] in out.ct.nodes]
