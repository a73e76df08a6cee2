"""The port's delta-native weave, its int32 digest and the session's
routing onto it, against the JAX package.

- The digest's twins: the port's int32 ``mix32``/``replica_digest`` and
  its numpy ``mix32_np`` equal the reference's uint32 ``mix32``,
  ``mix32_np`` and ``replica_digest`` bit for bit, on random int32
  inputs with INT32_MIN and INT32_MAX, rows that keep every lane and
  rows that keep none.
- Generator identity: the same ``delta_sweep_inputs`` arrays (the port's
  copy of the generator equals the reference's) go through the
  reference's ``jaxwd`` and the port's ``torchwd``; the window ranks,
  visibility, digests and overflow flags are equal, the delta digest is
  the full-width digest, and the splice gives back the full-width ranks.
- Session routing (mirrors ``tests/test_delta_weave.py``): steady-state
  rounds ride the delta wave, anchor tombstones, window-budget overflow,
  rank reassignment and ``delta=False`` take the full-width wave, and
  every wave's digests and frontier equal the reference session's on the
  twin fleet (see ``test_torch_session``).
- ``merge_wave``'s positional parameters are the reference's
  ``(pairs, mesh, ctx)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cause_tpu as c
from cause_tpu import benchgen as j_bench
from cause_tpu.parallel import mesh as j_mesh
from cause_tpu.parallel.wave import WaveBuffers as JBuffers
from cause_tpu.weaver import jaxwd

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as t_bench
from cause_tpu_torch.parallel import mesh as t_mesh
from cause_tpu_torch.parallel.wave import WaveBuffers as TBuffers
from cause_tpu_torch.weaver import torchwd
from cause_tpu_torch.weaver.arrays import next_pow2

# on_cpu is the autouse fixture that runs the port on the CPU
from test_torch_session import (JAX, PORT, Recorder, make_base,  # noqa: F401
                                make_pairs, on_cpu, paths, replica, twin_run)

I32_MIN = int(np.iinfo(np.int32).min)
I32_MAX = int(np.iinfo(np.int32).max)
KEYS = t_bench.LANE_KEYS5


# ------------------------------------------------------ the int32 digest


def digest_inputs(seed, B=6, m=97):
    """Random int32 ids and positions with the extremes planted, random
    visibility; row 0 keeps every lane, row 1 none, the rest a mix."""
    rng = np.random.default_rng(seed)
    full = lambda: rng.integers(I32_MIN, I32_MAX, size=(B, m),  # noqa: E731
                                dtype=np.int64, endpoint=True)
    hi, lo = full(), full()
    for x in (hi, lo):
        x[:, :4] = [I32_MIN, I32_MAX, -1, 0]
    hi, lo = hi.astype(np.int32), lo.astype(np.int32)
    rank = np.stack([rng.permutation(m) for _ in range(B)]).astype(np.int32)
    rank[1] = m
    rank[2:][rng.random((B - 2, m)) < 0.3] = m
    vis = rng.random((B, m)) < 0.6
    return hi, lo, rank, vis


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int32_digest_bit_identical_to_reference(seed):
    hi, lo, rank, vis = digest_inputs(seed)
    pos = np.where(rank < rank.shape[1], rank, I32_MAX).astype(np.int32)
    T = torch.from_numpy
    port = t_mesh.mix32(T(hi), T(lo), T(pos), T(vis))
    assert port.dtype == torch.int32
    want = np.asarray(j_mesh.mix32(jnp.asarray(hi), jnp.asarray(lo),
                                   jnp.asarray(pos), jnp.asarray(vis)))
    assert want.dtype == np.uint32
    assert np.array_equal(port.numpy().view(np.uint32), want)
    assert np.array_equal(t_mesh.mix32_np(hi, lo, pos, vis), want)
    assert np.array_equal(j_mesh.mix32_np(hi, lo, pos, vis), want)

    got = t_mesh.replica_digest(T(hi), T(lo), T(rank), T(vis))
    assert got.dtype == torch.int32
    ref = np.asarray(jax.vmap(j_mesh.replica_digest)(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(rank),
        jnp.asarray(vis)))
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert ref[1] == 0  # a row that keeps nothing sums to zero


def test_avalanche_twins_agree_with_replica_digest():
    rng = np.random.RandomState(7)
    n = 64
    hi = rng.randint(0, 2**30, n).astype(np.int32)
    lo = rng.randint(0, 2**30, n).astype(np.int32)
    rank = rng.permutation(n).astype(np.int32)
    rank[5:9] = n  # dropped lanes
    vis = rng.rand(n) > 0.3
    kept = rank < n
    host = int(t_mesh.mix32_np(hi, lo, rank, vis)[kept]
               .sum(dtype=np.uint64) & np.uint64(0xFFFFFFFF))
    T = torch.from_numpy
    dev = int(torch.where(T(kept), t_mesh.mix32(T(hi), T(lo), T(rank),
                                                T(vis)), 0)
              .sum(dtype=torch.int32)) & 0xFFFFFFFF
    whole = int(t_mesh.replica_digest(T(hi)[None], T(lo)[None],
                                      T(rank)[None], T(vis)[None])[0])
    ref = int(np.asarray(j_mesh.replica_digest(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(rank),
        jnp.asarray(vis))))
    assert host == dev == whole & 0xFFFFFFFF == ref


# ------------------------------------------- generator-level identity


@pytest.mark.parametrize("shape", [
    (4, 120, 40, 256, 8),   # tombstones every 8th suffix node
    (3, 60, 5, 128, 3),     # dense tombstones
    (2, 200, 1, 256, 0),    # single-op divergence
    (5, 50, 30, 128, 2),
])
def test_generator_full_vs_delta_digest_identity(shape):
    B, nb, nd, cap, he = shape
    sw = t_bench.delta_sweep_inputs(B, nb, nd, cap, hide_every=he)
    jw = j_bench.delta_sweep_inputs(B, nb, nd, cap, hide_every=he)
    for arm in ("full", "window"):
        for k in KEYS:
            assert np.array_equal(sw[arm][k], jw[arm][k]), (arm, k)
    for k in ("r0", "prefix_digest", "starts", "counts"):
        assert np.array_equal(sw[k], jw[k]) and sw[k].dtype == jw[k].dtype
    assert sw["wcap"] == jw["wcap"]

    u = next_pow2(t_bench.v5_token_budget(sw["full"]))
    full = t_bench.lanes_from_numpy(sw["full"], "cpu")
    rank, vis, dig_full, ovf = ct.batched_weave_digest(
        *(full[k] for k in KEYS), u_max=u, k_max=u, device="cpu")
    assert not ovf.any()
    nw = 2 * sw["wcap"]
    win = t_bench.lanes_from_numpy(sw["window"], "cpu")
    got = torchwd.batched_delta_weave(
        *(win[k] for k in KEYS), sw["prefix_digest"], sw["r0"],
        u_max=nw, k_max=nw, device="cpu")
    want = jaxwd.batched_delta_weave(
        *(jnp.asarray(jw["window"][k]) for k in KEYS),
        jnp.asarray(jw["prefix_digest"]), jnp.asarray(jw["r0"]),
        u_max=nw, k_max=nw)
    rw, vw, dig_delta, ovw = got
    assert not ovw.any()
    assert np.array_equal(rw.numpy(), np.asarray(want[0]))
    assert np.array_equal(vw.numpy(), np.asarray(want[1]))
    assert np.array_equal(dig_delta.numpy().view(np.uint32),
                          np.asarray(want[2]))
    assert np.array_equal(ovw.numpy(), np.asarray(want[3]))
    assert torch.equal(dig_delta, dig_full)

    # the splice, in place, against the full kernel and the reference's
    rf = torch.full((B, 2 * cap), 2 * cap, dtype=torch.int32)
    vf = torch.zeros((B, 2 * cap), dtype=torch.bool)
    out = torchwd.splice_ranks(rf, vf, rw, vw, sw["starts"], sw["counts"],
                               sw["r0"])
    assert out[0] is rf and out[1] is vf
    jrf, jvf = jaxwd.splice_ranks(
        jnp.asarray(np.full((B, 2 * cap), 2 * cap, np.int32)),
        jnp.asarray(np.zeros((B, 2 * cap), bool)), want[0], want[1],
        jnp.asarray(jw["starts"]), jnp.asarray(jw["counts"]),
        jnp.asarray(jw["r0"]))
    assert np.array_equal(rf.numpy(), np.asarray(jrf))
    assert np.array_equal(vf.numpy(), np.asarray(jvf))
    s0 = nb + 1
    for t in range(2):
        sl = slice(t * cap + s0, t * cap + s0 + nd)
        assert torch.equal(rank[:, sl], rf[:, sl])
        assert torch.equal(vis[:, sl], vf[:, sl])


# --------------------------------------------------- session routing


def test_session_steady_state_rides_delta_path():
    """Multi-round editing (conj, extend, own-suffix tombstones) rides
    the delta wave and stays bit-identical to merge_wave and to the
    reference session; materialization matches pairwise merge."""
    def scenario(tw):
        pairs = make_pairs(tw, 4, n_base=60, n_div=6, n_div_b=4)
        rec = Recorder(tw, tw.Session(pairs))
        rec.wave(pairs)
        for rnd in range(3):
            pairs = [(a.conj(f"x{rnd}").extend([f"y{rnd}"]),
                      b.conj(f"q{rnd}")) for a, b in pairs]
            if rnd == 1:  # tombstone a's own suffix tail (window-local)
                pairs = [(a.append(list(a)[-1][0], tw.pkg.hide), b)
                         for a, b in pairs]
            rec.update(pairs)
            rec.wave(pairs)
        rec.merged(pairs[:1])
        return rec.log

    log = twin_run(scenario)
    assert paths(log)[0] == "full"
    assert "delta" in paths(log)[1:]


def test_session_zero_initial_divergence():
    """Identical replicas (zero divergence) establish a frontier at once;
    later rounds ride the delta wave once the suffix chains glue."""
    def scenario(tw):
        base = make_base(tw, 40)
        a, b = replica(tw, base, "A", 0), replica(tw, base, "B", 0)
        rec = Recorder(tw, tw.Session([(a, b)] * 3))
        rec.wave()
        assert rec.sess._delta is not None
        pairs = [(a, b)] * 3
        for rnd in range(3):
            pairs = [(x.conj(f"A{rnd}"), y.conj(f"B{rnd}"))
                     for x, y in pairs[:1]] * 3
            rec.update(pairs)
            rec.wave(pairs)
        return rec.log

    log = twin_run(scenario)
    assert "delta" in paths(log)[1:]


def test_anchor_tombstone_falls_back_to_full_wave():
    def scenario(tw):
        base = make_base(tw, 30)
        a, b = replica(tw, base, "A", 0), replica(tw, base, "B", 0)
        rec = Recorder(tw, tw.Session([(a, b)] * 2))
        rec.wave()
        assert rec.sess._delta is not None
        anchor_id = list(a)[-1][0]  # base tail == converged weave tail
        p2 = [(a.append(anchor_id, tw.pkg.hide), b.conj("v"))] * 2
        rec.update(p2)
        assert rec.sess._delta is None  # dropped at update time
        rec.wave(p2)
        return rec.log

    assert paths(twin_run(scenario)) == ["full", "full"]


def test_window_budget_overflow_rebuilds_then_reestablishes():
    def scenario(tw):
        base = make_base(tw, 30)
        pairs = [(replica(tw, base, "A", 0), replica(tw, base, "B", 0))]
        rec = Recorder(tw, tw.Session(pairs, d_max=4))
        rec.wave()
        w0 = rec.sess._delta["w_cap"]
        assert w0 == 8  # pow2(0 divergence + 1 + d_max)
        saw_invalidate = False
        for rnd in range(4):
            pairs = [(a.conj(f"r{rnd}a1").conj(f"r{rnd}a2"),
                      b.conj(f"r{rnd}b1").conj(f"r{rnd}b2"))
                     for a, b in pairs]
            rec.update(pairs)
            saw_invalidate |= rec.sess._delta is None
            rec.wave(pairs)
        assert saw_invalidate
        assert rec.sess._delta["w_cap"] > w0  # the next budget bucket
        return rec.log

    twin_run(scenario)


def test_rank_reassignment_invalidates_delta_state():
    def scenario(tw):
        pairs = make_pairs(tw, 2, n_base=30, n_div=6, n_div_b=4)
        rec = Recorder(tw, tw.Session(pairs))
        rec.wave()
        assert rec.sess._delta is not None
        rec.sess._views[0][0].interner._reassign()
        pairs2 = [(a.conj("post"), b) for a, b in rec.sess.pairs]
        rec.update(pairs2)
        assert rec.sess._delta is None  # the full upload dropped it
        rec.wave(pairs2)
        assert rec.sess._delta is not None
        return rec.log

    twin_run(scenario)


def test_delta_disabled_session_stays_full_width():
    def scenario(tw):
        pairs = make_pairs(tw, 2, n_base=30, n_div=6, n_div_b=4)
        rec = Recorder(tw, tw.Session(pairs, delta=False))
        rec.wave()
        pairs = [(a.conj("x"), b.conj("y")) for a, b in pairs]
        rec.update(pairs)
        rec.wave(pairs)
        assert rec.sess._delta is None
        return rec.log

    assert paths(twin_run(scenario)) == ["full", "full"]


# ---------------------------------------- merge_wave's parameters


def test_merge_wave_positional_ctx_like_the_reference():
    """``merge_wave(pairs, None, bufs)`` hands ``bufs`` to ``ctx`` in
    both packages: the port fills the buffers, and its digests equal
    the ones it gives with ``ctx=`` by keyword and the reference's."""
    jpairs = make_pairs(JAX, 2, n_base=30, n_div=4)
    tpairs = make_pairs(PORT, 2, n_base=30, n_div=4)
    jbufs, tbufs = JBuffers(), TBuffers()
    want = c.parallel.merge_wave(jpairs, None, jbufs)
    got = ct.merge_wave(tpairs, None, tbufs)
    assert jbufs.shape is not None and tbufs.shape is not None
    assert tbufs.shape == jbufs.shape
    by_kw = ct.merge_wave(tpairs, ctx=TBuffers())
    assert np.array_equal(got.digest, by_kw.digest)
    assert np.array_equal(got.digest, want.digest)


def test_merge_wave_refuses_a_mesh():
    tpairs = make_pairs(PORT, 1, n_base=10, n_div=2)
    with pytest.raises(NotImplementedError, match="A.15"):
        ct.merge_wave(tpairs, object())
