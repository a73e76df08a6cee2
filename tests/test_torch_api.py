"""The port's list API against the JAX package's pure weaver.

One seeded op script (``conj``, ``extend``, ``hide`` and concurrent
inserts from three sites) is replayed in both packages with the same
site ids, so both mint the same node ids. The port's device routes —
the ``weaver="torch"`` merge and ``merge_wave(pairs).merged(i)``, on the
CPU through the kernels' plain versions — must give the weave (node ids
in order) and the visible values that ``cause_tpu``'s pure weaver gives,
and ``merge_wave`` must equal the port's own pure merge. Ids and values
are compared EXACTLY (list equality).
"""

import random

import numpy as np
import pytest

import cause_tpu as c
from cause_tpu.collections.clist import CausalList as JList

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as tbench
from cause_tpu_torch.collections.clist import CausalList as TList
from cause_tpu_torch.weaver import torchw

BASE_SITE = "siteBASE00000"
SITES = ("siteA00000000", "siteB00000000", "siteC00000000")


@pytest.fixture
def on_cpu():
    """The port's handle-level paths on the CPU for this test only."""
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def replay(pkg, CausalList, seed, n_ops=15, n_base=(60, 100)):
    """Replay the seeded op script with one package; returns the three
    replicas (pure weaver). Every random choice is made on node ids and
    op kinds that both packages share, so both mint the same nodes. The
    shared base is long enough that the merged trees stay inside the v5
    rung's segment-table budget (a quarter of the capacity)."""
    rng = random.Random(seed)
    base = CausalList(pkg.clist().ct.evolve(site_id=BASE_SITE))
    base = base.conj(*[f"b{i}" for i in range(rng.randrange(*n_base))])
    base = base.extend([f"e{i}" for i in range(rng.randrange(0, 5))])
    reps = [CausalList(base.ct.evolve(site_id=s)) for s in SITES]
    for k in range(n_ops):
        r = rng.randrange(3)
        h = reps[r]
        op = rng.choice(("conj", "extend", "hide", "insert", "insert"))
        ids = sorted(h.ct.nodes)
        if op == "conj":
            h = h.conj(f"c{seed}.{k}")
        elif op == "extend":
            h = h.extend([f"x{seed}.{k}.{j}" for j in range(rng.randrange(
                1, 4))])
        elif op == "hide":
            target = rng.choice(ids[1:]) if len(ids) > 1 else ids[0]
            h = h.append(target, pkg.hide)
        else:  # a concurrent insert at a random cause, own site
            cause = rng.choice(ids)
            yarn = h.ct.yarns.get(SITES[r])
            tip = yarn[-1][0][0] if yarn else 0
            h = h.insert(pkg.node(1 + max(cause[0], tip), SITES[r], cause,
                                  f"i{seed}.{k}"))
        reps[r] = h
    return reps


def weave_ids(h):
    return [n[0] for n in h.ct.weave]


def same(got, want):
    """Weave node ids in order, the visible nodes, and their values."""
    return (weave_ids(got) == weave_ids(want) and list(got) == list(want)
            and got.causal_to_edn() == want.causal_to_edn())


def to_torch(h):
    return TList(h.ct.evolve(weaver="torch"))


SEEDS = (0, 1, 2, 3, 7, 11)


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_merge_matches_jax_pure_weaver(on_cpu, seed):
    jreps = replay(c, JList, seed)
    treps = replay(ct, TList, seed)
    for j, t in zip(jreps, treps):  # the replay minted the same nodes
        assert sorted(j.ct.nodes) == sorted(t.ct.nodes)
        assert same(t, j)
    fallbacks = torchw.pure_fallbacks
    for a, b in ((0, 1), (1, 2), (2, 0)):
        want = jreps[a].merge(jreps[b])
        got = to_torch(treps[a]).merge(to_torch(treps[b]))
        assert got.ct.weaver == "torch"
        assert same(got, want)
    # three-way convergence through the N-way device route
    want3 = jreps[0].merge(jreps[1]).merge(jreps[2])
    got3 = to_torch(treps[0]).merge_many([to_torch(treps[1]),
                                          to_torch(treps[2])])
    assert same(got3, want3)
    assert torchw.pure_fallbacks == fallbacks


@pytest.mark.parametrize("seed", SEEDS)
def test_torch_full_reweave_matches_jax(on_cpu, seed):
    """A full rebuild of one replica on the device route equals the
    JAX package's incrementally maintained (pure) weave."""
    from cause_tpu_torch.collections import clist as t_clist

    jreps = replay(c, JList, seed)
    treps = replay(ct, TList, seed)
    for j, t in zip(jreps, treps):
        rebuilt = t_clist.weave(t.ct.evolve(weaver="torch"))
        assert [n[0] for n in rebuilt.weave] == weave_ids(j)


def test_merge_wave_matches_jax_and_port_pure(on_cpu):
    jreps_all, treps_all = [], []
    for seed in SEEDS:
        jreps_all.append(replay(c, JList, seed))
        treps_all.append(replay(ct, TList, seed))
    pairs_idx = [(0, 1), (1, 2), (2, 0)]
    tpairs = [(to_torch(t[a]), to_torch(t[b]))
              for t in treps_all for a, b in pairs_idx]
    jwant = [j[a].merge(j[b]) for j in jreps_all for a, b in pairs_idx]
    res = ct.merge_wave(tpairs)
    assert res.kernel == "v5" and res.fallback == [] and res.poisoned == []
    assert res.digest_valid.all()
    for i, (a, b) in enumerate(tpairs):
        got = res.merged(i)
        port_pure = TList(a.ct.evolve(weaver="pure")).merge(
            TList(b.ct.evolve(weaver="pure")))
        assert same(got, jwant[i])
        assert same(got, port_pure)
    # an identical pair converges to the same digest as its mirror
    twin = ct.merge_wave([tpairs[0], tpairs[0][::-1]])
    assert twin.digest[0] == twin.digest[1]


def test_tree_outside_v5_budget_goes_to_pure_weaver(on_cpu):
    """A small tree with more segments than the v5 table budget is woven
    by the pure weaver (the v4/v2/v1 rungs are not ported), counted in
    ``pure_fallbacks``, and still equals the JAX package's weave."""
    jreps = replay(c, JList, 0, n_ops=40, n_base=(2, 3))
    treps = replay(ct, TList, 0, n_ops=40, n_base=(2, 3))
    before = torchw.pure_fallbacks
    got = to_torch(treps[0]).merge(to_torch(treps[1]))
    assert torchw.pure_fallbacks == before + 1
    want = jreps[0].merge(jreps[1])
    assert same(got, want)


def test_merge_wave_on_fleet_handles(on_cpu):
    """``tree_fleet_handles`` (the smoke's API fleet, small here): every
    pair rides the device route and equals the port's pure merge."""
    hs = tbench.tree_fleet_handles(6, 120, 30, hide_every=4)
    pairs = [(hs[2 * i], hs[2 * i + 1]) for i in range(3)]
    res = ct.merge_wave(pairs)
    assert res.fallback == [] and res.digest_valid.all()
    assert len(set(res.digest.tolist())) == 3
    for i, (a, b) in enumerate(pairs):
        want = TList(a.ct.evolve(weaver="pure")).merge(
            TList(b.ct.evolve(weaver="pure")))
        assert same(res.merged(i), want)
    assert np.all(res.rank[:, :1] == 0)  # each pair's root ranks first


def test_wave_buffers_reuse_keeps_results(on_cpu):
    """A second wave through the same ``WaveBuffers`` with a shorter tree
    in the same slot (the shrink gap is re-padded) equals a fresh wave
    and the pure merge."""
    from cause_tpu_torch.parallel.wave import WaveBuffers

    base = TList(ct.clist(*[f"w{i}" for i in range(80)]).ct.evolve(
        weaver="torch"))
    a = TList(base.ct.evolve(site_id=SITES[0])).extend(
        [f"a{i}" for i in range(30)])
    b = TList(base.ct.evolve(site_id=SITES[1])).extend(
        [f"b{i}" for i in range(30)])
    b_short = TList(base.ct.evolve(site_id=SITES[1])).extend(["s"])
    bufs = WaveBuffers()
    for pair in ((a, b), (a, b_short)):
        res = ct.merge_wave([pair], ctx=bufs)
        fresh = ct.merge_wave([pair])
        assert np.array_equal(res.digest, fresh.digest)
        want = TList(pair[0].ct.evolve(weaver="pure")).merge(
            TList(pair[1].ct.evolve(weaver="pure")))
        assert same(res.merged(0), want)


def test_dispatch_full_rows_budget_and_retry(on_cpu, monkeypatch):
    """``dispatch_full_rows`` equals the weave-digest program at its
    pow2 budget, retries overflowing rows at double the budget, and
    raises when the doubled budget still overflows."""
    from cause_tpu_torch.collections.shared import CausalError
    from cause_tpu_torch.parallel.wave import dispatch_full_rows
    from cause_tpu_torch.weaver.arrays import next_pow2

    batch = tbench.batched_pair_lanes(3, 60, 20, 128, hide_every=5)
    v5 = tbench.batched_v5_inputs(batch, 128)
    need = tbench.v5_token_budget(v5)
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    u = next_pow2(need)
    r, v, d, _ = ct.batched_weave_digest(
        *(lanes[k] for k in tbench.LANE_KEYS5), u_max=u, k_max=u,
        device="cpu")
    rank, vis, dig, info = dispatch_full_rows(v5, device="cpu")
    assert info == {"u_need": need, "u_max": u, "retried": 0}
    assert np.array_equal(rank, r.numpy()) and np.array_equal(vis, v.numpy())
    assert np.array_equal(dig, d.numpy().astype(np.uint32))
    # a budget estimate just over half the need: every row overflows once
    tokens = max(tbench.estimate_tokens({k: v5[k][i] for k in v5})
                 for i in range(3))
    half = next_pow2(tokens) // 2
    monkeypatch.setattr(tbench, "v5_token_budget", lambda _l: half)
    rank2, _, dig2, info2 = dispatch_full_rows(v5, device="cpu")
    assert info2["retried"] == 3
    assert np.array_equal(dig2, dig)
    monkeypatch.setattr(tbench, "v5_token_budget", lambda _l: 4)
    with pytest.raises(CausalError):
        dispatch_full_rows(v5, device="cpu")


def test_run_dispatch_retries_only_transient_failures():
    from cause_tpu_torch.parallel import recovery

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise recovery.TransientDispatchError("flake")
        return "done"

    assert recovery.run_dispatch("wave", flaky, backoff_s=0) == "done"
    assert len(calls) == 3
    calls.clear()

    def broken():
        calls.append(1)
        raise ValueError("shape")

    with pytest.raises(ValueError):
        recovery.run_dispatch("wave", broken, backoff_s=0)
    assert len(calls) == 1
    calls.clear()

    def down():
        calls.append(1)
        raise recovery.TransientDispatchError("flake")

    with pytest.raises(recovery.TransientDispatchError):
        recovery.run_dispatch("wave", down, retries=1, backoff_s=0)
    assert len(calls) == 2


# ------------------------------------- the reference's weaver name (C.4)


def _jax_named(kind):
    """A collection built with the reference's device weaver name, and
    the full reweave of its tree (a base: its list collection's)."""
    from cause_tpu_torch.collections import clist as t_clist
    from cause_tpu_torch.collections import cmap as t_cmap

    if kind == "list":
        return ct.clist(*"abc", weaver="jax"), t_clist.weave
    if kind == "map":
        return ct.cmap("x", 1, "y", 2, weaver="jax"), t_cmap.weave
    if kind == "set":
        return ct.cset("a", "b", weaver="jax"), t_clist.weave
    if kind == "counter":
        return ct.ccounter(weaver="jax").increment(3), t_clist.weave
    cb = ct.transact(ct.base(weaver="jax"),
                     [[None, None, {ct.K("l"): list("abcd")}]])
    assert cb.cb.weaver == "torch"
    lists = [h for h in cb.cb.collections.values()
             if isinstance(h, TList)]
    assert len(lists) == 1
    return lists[0], t_clist.weave


KINDS = ("list", "map", "set", "counter", "base")


@pytest.fixture
def device_calls(monkeypatch):
    """Counts the device route's calls on the CPU: the v5 sites of B1, B2
    and B3 (lists, sets, counters) and the map forest's linearization
    (PyTorch ops, no kernel)."""
    from cause_tpu_torch.weaver import torchw5

    calls = {}

    def counting(mod, name):
        real = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(mod, name, wrapper)

    for name in ("sort_pairs", "euler_walk", "fphase_expand"):
        counting(torchw5, name)
    counting(torchw, "linearize_map_forest")
    return calls


@pytest.mark.parametrize("kind", KINDS)
def test_reference_weaver_name_takes_the_device_route(on_cpu, device_calls,
                                                      kind):
    """ROADMAP C.4: ``weaver="jax"`` builds a ``"torch"`` collection, whose
    full reweave takes the device route (on the CPU through the plain
    versions) and equals the pure weave."""
    h, weave_fn = _jax_named(kind)
    assert h.ct.weaver == "torch"
    before = torchw.pure_fallbacks
    got = weave_fn(h.ct)
    assert torchw.pure_fallbacks == before
    if kind == "map":
        assert device_calls == {"linearize_map_forest": 1}
    else:
        assert device_calls == {"sort_pairs": 6, "euler_walk": 1,
                                "fphase_expand": 1}
    assert got.weave == weave_fn(h.ct.evolve(weaver="pure")).weave


@pytest.mark.parametrize("kind", KINDS)
def test_reference_weaver_name_raises_without_a_card(kind):
    """With no card and the default device, a ``weaver="jax"``
    collection's reweave refuses as a ``weaver="torch"`` one does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    before = ct.default_device()
    ct.use_device("cuda")
    try:
        h, weave_fn = _jax_named(kind)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            weave_fn(h.ct)
    finally:
        ct.use_device(before)
