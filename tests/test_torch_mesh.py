"""The port's replica mesh against the JAX package's sharded steps.

The reference runs its sharded steps on conftest's 8-device virtual CPU
mesh (``shard_map``); the port runs its own at world 1 (a gloo group in
this process) and over spawned gloo ranks (``parallel.ranks``). The same
marshalled numpy lanes go to both, so ``order``, ``rank``, ``visible``,
``overflow``, the uint32 digests and the three fleet totals compare bit
for bit.

- The steps (mirrors ``tests/test_parallel.py:41``): ``build_batch``'s
  16 pairs through v1, v2, v3, v4, v5 and v5f at world 1 and over 4
  ranks, against the reference's sharded outputs, each other and the
  pure merge; identical rows give identical digests (``:119``); the
  digest is blind to input overlap (``:151``); a batch that does not
  divide the mesh raises in both packages.
- The mesh: ``make_mesh()`` needs the card unless asked for the CPU,
  spans the whole group, and refuses more ranks than a group has.
  ``tests/test_parallel.py:191`` (a step cache keyed on trace switches)
  has no counterpart: the port caches no step.
- The map routes (mirrors ``tests/test_mapw.py:83``), the wave at world
  1 (``tests/test_wave.py:121``, ``:160``, and v5w refused under a
  mesh in both) and ``entry()`` against ``__graft_entry__.entry()``.
"""

import os
import random

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import cause_tpu as c
from cause_tpu.collections import clist as c_list
from cause_tpu.collections import shared as s
from cause_tpu.ids import new_site_id
from cause_tpu.parallel import make_mesh as j_make_mesh
from cause_tpu.parallel import mesh as j_mesh
from cause_tpu.weaver import mapw as j_mapw
from cause_tpu.weaver.arrays import SiteInterner

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as t_bench
from cause_tpu_torch.parallel import mesh as t_mesh
from cause_tpu_torch.parallel.entry import dryrun_multichip, entry
from cause_tpu_torch.parallel.ranks import run_ranks
from cause_tpu_torch.weaver import mapw as t_mapw

from test_jax_weaver import (_tree_lanes, build_batch, decode_device_weave,
                             pair_lane_nodes)
from test_torch_map import make_pairs as map_pairs
from test_torch_mesh_ranks import STEPS, run_step, steps_rank
from test_torch_session import JAX, PORT
from test_torch_session import make_pairs as list_pairs

CAP = 16


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's device paths on the CPU for each test."""
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


@pytest.fixture(scope="module", autouse=True)
def no_group_after_the_module():
    """The world-1 group the tests start lives until the module ends."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def mesh1():
    return t_mesh.make_mesh(device="cpu")


def host(out):
    """A step's outputs as numpy, the digest (index 3 in both contracts)
    as uint32."""
    out = [np.asarray(x.cpu() if torch.is_tensor(x) else x) for x in out]
    out[3] = out[3].view(np.uint32)
    return out


def assert_same(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (what, i, g.dtype, w.dtype)
        assert np.array_equal(g, w), (what, i)


@pytest.fixture(scope="module")
def batch():
    """``tests/test_parallel.py``'s batch: 16 pairs, cap 16, 4 edits a
    side; the v5 lanes and their token budget."""
    pairs, lanes, _metas = build_batch(random.Random(5150), 16, CAP,
                                       n_edits=4)
    v5 = t_bench.batched_v5_inputs(
        {k: lanes[k] for k in t_bench.LANE_KEYS4}, CAP)
    return pairs, lanes, v5, t_bench.v5_token_budget(v5)


@pytest.fixture(scope="module")
def reference(batch):
    """The reference's sharded outputs of every step on its 8-device
    mesh, computed on first use."""
    _pairs, lanes, v5, u5 = batch
    mesh, done = j_make_mesh(), {}

    def get(name):
        if name not in done:
            done[name] = host(run_step(j_mesh, mesh, name, lanes, v5, u5))
        return done[name]
    return get


@pytest.fixture(scope="module")
def four_ranks(batch):
    """Every step of the port over 4 spawned gloo ranks."""
    _pairs, lanes, v5, u5 = batch
    return run_ranks(4, steps_rank, lanes, v5, u5, device="cpu")


def check_against_pure(batch, name, out):
    """Each row's weave is the pure merge's (v1-v4: decoded through
    ``order``; v5: the same ids at the same ranks as v1's), and the
    visible total is the pure lists' length."""
    pairs, lanes, _v5, _u5 = batch
    expect_total = 0
    for b, (a_ct, b_ct) in enumerate(pairs):
        pure = s.merge_trees(c_list.weave, a_ct, b_ct)
        expect_total += len(c_list.causal_list_to_list(pure))
        if name in ("v5", "v5f"):
            continue
        weave, _ = decode_device_weave(out[0][b], out[1][b],
                                       pair_lane_nodes(a_ct, b_ct, CAP))
        assert weave == pure.weave, (name, b)
    assert int(out[4]) == expect_total


@pytest.mark.parametrize("name", STEPS)
def test_sharded_step_at_world_one_matches_the_reference(batch, reference,
                                                         mesh1, name):
    _pairs, lanes, v5, u5 = batch
    got = host(run_step(t_mesh, mesh1, name, lanes, v5, u5))
    want = reference(name)
    assert_same(got, want, name)
    assert int(got[5]) == 0 and int(got[6]) == 0
    check_against_pure(batch, name, got)
    # every generation converges to v1's digests and totals
    v1 = reference("v1")
    assert np.array_equal(got[3], v1[3])
    assert int(got[4]) == int(v1[4])
    if name in ("v5", "v5f"):
        assert not got[2].any()
        # rank equivalence through the coordinate change: the same ids
        # at the same weave positions (a duplicate id may keep the other
        # side's lane)
        M = v1[1].shape[1]
        for b in range(len(v1[0])):
            rc = np.full(M, M, np.int32)
            rc[v1[0][b]] = v1[1][b]
            ids = []
            for r in (rc, got[0][b]):
                kept = r < M
                ids.append(sorted(zip(r[kept], lanes["hi"][b][kept],
                                      lanes["lo"][b][kept])))
            assert ids[0] == ids[1], b


@pytest.mark.parametrize("name", STEPS)
def test_sharded_step_over_four_gloo_ranks_matches_world_one(
        batch, reference, four_ranks, mesh1, name):
    _pairs, lanes, v5, u5 = batch
    got = host(four_ranks[name])
    assert_same(got, host(run_step(t_mesh, mesh1, name, lanes, v5, u5)),
                name)
    assert_same(got, reference(name), name)


def identical_rows(B, cap, rows):
    """Lanes of ``B`` rows, each one of ``rows`` (a list of per-row
    lane dicts), in order: the first half the first row, the rest the
    last."""
    pick = [rows[0]] * (B // 2) + [rows[-1]] * (B - B // 2)
    return {k: np.stack([r[k] for r in pick]) for k in rows[0]}


def pair_row(left_ct, right_ct, interner, cap):
    nl, (lhi, llo), (lchi, lclo) = _tree_lanes(left_ct, interner, cap)
    nr, (rhi, rlo), (rchi, rclo) = _tree_lanes(right_ct, interner, cap)
    return {"hi": np.concatenate([lhi, rhi]),
            "lo": np.concatenate([llo, rlo]),
            "chi": np.concatenate([lchi, rchi]),
            "clo": np.concatenate([lclo, rclo]),
            "vc": np.concatenate([nl.vclass, nr.vclass]),
            "valid": np.concatenate([nl.valid, nr.valid])}


def v1_digests(mod, mesh, lanes):
    out = mod.sharded_merge_weave(mesh, *(lanes[k]
                                          for k in t_bench.LANE_KEYS))
    return host(out)


@pytest.mark.parametrize("overlap", ["identical rows", "input overlap"])
def test_digests_detect_convergence(mesh1, overlap):
    """``tests/test_parallel.py:119``: identical pairs in every row give
    identical digests; ``:151``: rows merging (A, B) and (A u B, B),
    the same union over other lanes, give one digest too."""
    base = c.clist(*"xyz")
    a = c_list.CausalList(base.ct.evolve(site_id=new_site_id())).conj("!")
    b = c_list.CausalList(base.ct.evolve(site_id=new_site_id())).cons("?")
    if overlap == "identical rows":
        cap = 16
        lefts = [a.ct]
    else:
        cap = 32
        lefts = [a.ct, s.merge_trees(c_list.weave, a.ct, b.ct)]
    interner = SiteInterner({i[1] for left in lefts for i in left.nodes}
                            | {i[1] for i in b.ct.nodes})
    rows = [pair_row(left, b.ct, interner, cap) for left in lefts]
    lanes = identical_rows(len(jax.devices()), cap, rows)
    want = v1_digests(j_mesh, j_make_mesh(), lanes)
    got = v1_digests(t_mesh, mesh1, lanes)
    assert_same(got, want, overlap)
    assert int(got[5]) == 0
    assert (got[3] == got[3][0]).all()


@pytest.mark.parametrize("name", STEPS)
def test_sharded_steps_upload_lanes_with_the_batched_dtypes(mesh1, batch,
                                                            name):
    """A step uploads its rows as ``benchgen.lanes_from_numpy`` does
    (int32 lanes, bool flags): int64 lanes give the int32 lanes'
    outputs."""
    _pairs, lanes, v5, u5 = batch
    wide = {k: v.astype(np.int64) for k, v in lanes.items()}
    wide5 = {k: v.astype(np.int64) for k, v in v5.items()}
    assert_same(host(run_step(t_mesh, mesh1, name, wide, wide5, u5)),
                host(run_step(t_mesh, mesh1, name, lanes, v5, u5)), name)


def test_a_batch_that_does_not_divide_the_mesh_raises_in_both(batch):
    _pairs, lanes, _v5, _u5 = batch
    odd = {k: v[:12] for k, v in lanes.items()}
    args = [odd[k] for k in t_bench.LANE_KEYS]
    with pytest.raises(ValueError):
        j_mesh.sharded_merge_weave(j_make_mesh(), *args)
    # every rank refuses before any collective; the caller gets the
    # rank's exception
    with pytest.raises(ValueError, match="3 rows does not divide the 2-rank"):
        run_ranks(2, t_mesh.sharded_merge_weave, *(a[:3] for a in args),
                  device="cpu")


def test_make_mesh_spans_the_whole_group(monkeypatch):
    if dist.is_initialized():
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="run_ranks"):
        t_mesh.make_mesh(2, device="cpu")
    assert not dist.is_initialized()
    mesh = t_mesh.make_mesh(device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    assert mesh.mesh_dim_names == (t_mesh.REPLICA_AXIS,)
    assert mesh.size() == 1 and mesh.get_group() is dist.group.WORLD
    again = t_mesh.make_mesh(1, device="cpu")
    assert again.get_group() is mesh.get_group()
    with pytest.raises(ValueError, match="spans all of them"):
        t_mesh.make_mesh(2, device="cpu")
    # a group serves only its backend's device: a CPU mesh refuses an
    # NCCL group (the gloo group stands in for one here)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="needs a gloo group"):
        t_mesh.make_mesh(device="cpu")


def test_entry_points_need_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    ct.use_device("cuda")
    for call in (t_mesh.make_mesh, entry, lambda: dryrun_multichip(1),
                 lambda: run_ranks(1, t_mesh.sharded_merge_weave),
                 lambda: run_ranks(1, dryrun_multichip, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_mesh.make_mesh(device="cuda")


@pytest.mark.parametrize("route", ["v4", "v5"])
def test_sharded_map_merge_agrees_with_batched(mesh1, route):
    """``tests/test_mapw.py:83``: the sharded map routes equal the
    batched ones, the reference's sharded ones and the pure merge."""
    jp = map_pairs(c, 8, n_keys=4, edits=3)
    tp = map_pairs(ct, 8, n_keys=4, edits=3)
    jl, jmeta = j_mapw.pair_rows([(a.ct.nodes, b.ct.nodes) for a, b in jp])
    tl, tmeta = t_mapw.pair_rows([(a.ct.nodes, b.ct.nodes) for a, b in tp])
    for k in jl:
        assert np.array_equal(jl[k], tl[k]), k
    jmesh = j_make_mesh(8)
    if route == "v4":
        got = host(t_mapw.sharded_merge_map_weave(mesh1, tl))
        want = host(j_mapw.sharded_merge_map_weave(jmesh, jl))
        batched = t_mapw.batched_merge_map_weave(tl, device="cpu")
        order, rank = got[0], got[1]
        # the host digest twin stays bit-identical to the device mix
        assert np.array_equal(got[3], t_mapw.map_row_digest(
            tl, got[0], got[1], got[2]))
        for i, (g, w) in enumerate(zip(got[:3], batched[:3])):
            assert np.array_equal(g, w.numpy()), i
    else:
        out, u = t_mapw.sharded_merge_map_weave_v5(mesh1, tl,
                                                   tmeta["capacity"])
        jout, ju = j_mapw.sharded_merge_map_weave_v5(jmesh, jl,
                                                     jmeta["capacity"])
        assert u == ju
        got, want = host(out), host(jout)
        (r, v, _c, ov), _u = t_mapw.batched_merge_map_weave_v5(
            tl, tmeta["capacity"], device="cpu")
        for g, w in zip(got[:3], (r, v, ov)):
            assert np.array_equal(g, w.numpy())
        order, rank = None, got[0]
    assert_same(got, want, route)
    assert int(got[6]) == 0
    for i, (a, b) in enumerate(tp):
        weave = t_mapw.merged_map_weave(tl, tmeta, order, rank, i)
        ref = a.merge(b).ct.weave
        for k in ref:
            assert weave[k] == ref[k], (route, i, k)


@pytest.fixture
def bench_kernel():
    """Set ``BENCH_KERNEL`` for a test, restoring it after."""
    before = os.environ.get("BENCH_KERNEL")

    def set_(value):
        os.environ["BENCH_KERNEL"] = value
    yield set_
    if before is None:
        os.environ.pop("BENCH_KERNEL", None)
    else:
        os.environ["BENCH_KERNEL"] = before


@pytest.mark.parametrize("kernel", ["v5", "v5f"])
def test_wave_sharded_over_mesh(mesh1, bench_kernel, kernel):
    """``tests/test_wave.py:121``, on twin fleets: digests equal the
    reference's sharded wave's and the unsharded wave's, every
    ``merged(i)`` equals ``a.merge(b)``."""
    bench_kernel(kernel)
    jpairs = list_pairs(JAX, 8, n_base=40, n_div=4)
    tpairs = list_pairs(PORT, 8, n_base=40, n_div=4)
    want = JAX.merge_wave(jpairs, mesh=j_make_mesh(8))
    res = ct.merge_wave(tpairs, mesh1)
    assert res.kernel == kernel
    assert not res.fallback and res.digest_valid.all()
    assert np.array_equal(res.digest, want.digest)
    assert np.array_equal(res.digest, ct.merge_wave(tpairs).digest)
    for i, (a, b) in enumerate(tpairs):
        assert ct.causal_to_edn(res.merged(i)) == \
            ct.causal_to_edn(a.merge(b))


def test_wave_v5w_has_no_sharded_step_in_both(mesh1, bench_kernel):
    bench_kernel("v5w")
    jpairs = list_pairs(JAX, 2, n_base=10, n_div=2)
    tpairs = list_pairs(PORT, 2, n_base=10, n_div=2)
    with pytest.raises(ValueError, match="v5w"):
        JAX.merge_wave(jpairs, mesh=j_make_mesh(2))
    with pytest.raises(ValueError, match="v5w"):
        ct.merge_wave(tpairs, mesh1)
    assert ct.merge_wave(tpairs).kernel == "v5w"


def test_wave_mesh_survives_fallback_shrink(mesh1):
    """``tests/test_wave.py:160``: a pair off the device domain falls
    back in both packages, and the other pairs' digests agree."""
    waves = {}
    for tw, mesh in ((JAX, j_make_mesh(8)), (PORT, mesh1)):
        pairs = list_pairs(tw, 8, n_base=30, n_div=3)
        a, b = pairs[3]
        big = ((1 << 31) - 1, a.get_site_id(), 0)
        pairs[3] = (a.insert((big, tw.pkg.root_id, "huge-ts")),
                    b.insert((big, tw.pkg.root_id, "huge-ts")))
        res = tw.merge_wave(pairs, mesh=mesh)
        assert res.fallback == [3]
        assert not res.digest_valid[3] and res.digest_valid[0]
        for i, (x, y) in enumerate(pairs):
            assert tw.pkg.causal_to_edn(res.merged(i)) == \
                tw.pkg.causal_to_edn(x.merge(y))
        waves[tw.port] = res
    assert np.array_equal(waves[True].digest_valid, waves[False].digest_valid)
    assert np.array_equal(waves[True].digest, waves[False].digest)


def test_entry_matches_the_reference():
    """``entry()`` on the CPU: the reference's lanes, and its v4 merge's
    outputs under ``jax.jit``."""
    import __graft_entry__ as graft

    jfn, jargs = graft.entry()
    fn, args = entry(device="cpu")
    assert len(args) == len(jargs)
    for g, w in zip(args, jargs):
        assert np.array_equal(g.numpy(), np.asarray(w))
    want = jax.jit(jfn)(*jargs)
    got = fn(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[4]) and not bool(got[3])
