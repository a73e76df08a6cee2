"""The port's fused v5 token pipeline (v5f) against the JAX package's.

- K1/K2/K4 (``cause_tpu_torch.weaver.befuse``; on the CPU the wrappers
  take their plain versions) against ``cause_tpu``'s
  ``pallas_befuse.k1_sort_redirect`` / ``k2_runs`` / ``k4_rank_kills``
  (Pallas in interpret mode, as tests/test_befuse.py runs them here) on
  real pipeline intermediates, each stage fed the REFERENCE's outputs of
  the stage before, and against the pure ``row_k1`` / ``row_k2`` /
  ``row_k4`` on a wider seeded sweep.
- ``batched_merge_weave_v5f`` against ``cause_tpu``'s v5f and the port's
  own v5 (rank, visible, conflict, overflow, and ``replica_digest`` on
  top), on the reference's v5f cases.
- ``merge_wave`` under ``BENCH_KERNEL``.

Every output is an integer or a flag, so every comparison is EXACT
(``np.array_equal``), no tolerance. Interpret-mode programs are large
(tests/test_befuse.py:114-117): the Pallas calls here stay within a few
``(N, u_max)`` buckets, and the sweep uses the pure row functions.
"""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cause_tpu as c
from cause_tpu import benchgen as jbench
from cause_tpu.parallel.mesh import replica_digest as j_digest
from cause_tpu.weaver import pallas_befuse as pb
from cause_tpu.weaver import pallas_ops
from cause_tpu.weaver.jaxw5f import batched_merge_weave_v5f as j_v5f

import torch

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as tbench
from cause_tpu_torch.collections.clist import CausalList as TList
from cause_tpu_torch.parallel.mesh import replica_digest as t_digest
from cause_tpu_torch.weaver import befuse, torchw5f

from test_list import rand_node

KEYS = jbench.LANE_KEYS5
_digest = jax.jit(jax.vmap(j_digest))


def _t(x):
    return torch.from_numpy(np.array(x))


def _lanes(v5):
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    return [lanes[k] for k in KEYS]


def record_kernel_inputs(monkeypatch, v5, u, k):
    """Run the port's v5f on the CPU and record the inputs of its K1, K2
    and K4 calls (K1's are the hoisted phase-D prep over ``_v5_ab``'s
    tokens, padded to P)."""
    seen = {}

    def rec(name, fn):
        def call(*args, **kw):
            seen[name] = (args, kw)
            return fn(*args, **kw)
        monkeypatch.setattr(torchw5f, name, call)

    rec("k1_sort_redirect", befuse.k1_sort_redirect)
    rec("k2_runs", befuse.k2_runs)
    rec("k4_rank_kills", befuse.k4_rank_kills)
    out = ct.batched_merge_weave_v5f(*_lanes(v5), u_max=u, k_max=k,
                                     device="cpu")
    return seen, out


def assert_outputs(want, got, tag, rows=None):
    """Every output, one to one; ``rows`` restricts the comparison."""
    assert len(want) == len(got), tag
    for j, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        if rows is not None:
            w, g = w[rows], g[rows]
        assert w.shape == g.shape, (tag, j, w.shape, g.shape)
        assert np.array_equal(w, g), (
            f"{tag} output {j} differs at {np.argwhere(w != g)[:8].tolist()}")


def _v5_case(B, nb, nd, cap, he):
    batch = tbench.batched_pair_lanes(B, nb, nd, cap, hide_every=he)
    v5 = tbench.batched_v5_inputs(batch, cap)
    return v5, tbench.v5_token_budget(v5)


# ------------------------------------------------- K1, K2, K4 vs Pallas


@pytest.mark.parametrize("B,nb,nd,cap,he,du", [
    (3, 120, 40, 256, 8, 0),    # P = 256
    (5, 60, 3, 64, 2, 0),       # P = 128: one block
    (4, 100, 60, 192, 4, 160),  # u_max > k_max: P = 512, Kp = 256
])
def test_kernels_match_pallas_on_pipeline_inputs(monkeypatch, B, nb, nd,
                                                 cap, he, du):
    v5, u = _v5_case(B, nb, nd, cap, he)
    U, k_max = u + du, u
    seen, out = record_kernel_inputs(monkeypatch, v5, U, k_max)
    assert not out[3].any()
    P = befuse.next_pow2(max(U, 128))
    Kp = befuse.next_pow2(max(k_max, 128))
    N = v5["hi"].shape[1]

    # K1 on the port's own pipeline inputs
    args1, kw1 = seen["k1_sort_redirect"]
    assert args1[0].shape == (B, P) and kw1 == {"U": U}
    ref1 = jax.vmap(lambda *a: pb.k1_sort_redirect(*a, U=U))(
        *(jnp.asarray(x.numpy()) for x in args1))
    assert_outputs(ref1, befuse.k1_sort_redirect(*args1, U=U), "K1")

    # K2 on the reference's K1 outputs
    in2 = (ref1[0], ref1[1], ref1[2], ref1[4], ref1[5], ref1[6])
    ref2 = jax.vmap(lambda *a: pb.k2_runs(*a, U=U, k_max=k_max, Kp=Kp))(*in2)
    got2 = befuse.k2_runs(*(_t(x) for x in in2), U=U, k_max=k_max, Kp=Kp)
    assert_outputs(ref2, got2, "K2")

    # K4 on the reference's K2 outputs and its walk
    fc, ns, parent_up, run_w, hc, h_w, run_id, glued_i, prev_kept, scal2 = ref2
    base = jax.vmap(lambda *a: pallas_ops.euler_walk(*a, Kp))(
        fc, ns, parent_up, run_w)
    in4 = (base, hc, h_w, run_id, ref1[4], ref1[0], ref1[1], ref1[3],
           glued_i, prev_kept, ref1[5], scal2)
    ref4 = jax.vmap(lambda *a: pb.k4_rank_kills(*a, U=U, k_max=k_max, N=N))(
        *in4)
    got4 = befuse.k4_rank_kills(*(_t(x) for x in in4), U=U, k_max=k_max, N=N)
    assert_outputs(ref4, got4, "K4")


def test_k2_tables_past_n_runs_are_the_stable_order():
    """Positions past n_runs of K2's [Kp] tables are not masked: they hold
    the non-head tokens in index order (the compaction sort's stable
    order), and the sibling sort sees them through ``hc``."""
    rng = np.random.default_rng(5)
    B, P = 4, 128
    keep = (rng.random((B, P)) < 0.8).astype(np.int32)
    keep[:, 0] = 1
    sv_len = rng.integers(1, 4, size=(B, P)).astype(np.int32)
    sv_vc = rng.choice(np.array([0, 0, 1, 2, 3], np.int32), size=(B, P))
    sv_tsp = (rng.random((B, P)) < 0.3).astype(np.int32)
    cause = np.stack([np.maximum(np.arange(P) - rng.integers(1, 4, P), 0)
                      for _ in range(B)]).astype(np.int32)
    parent = np.stack([rng.integers(0, P, P) for _ in range(B)]).astype(
        np.int32) * (rng.random((B, P)) < 0.5)
    ins = (sv_len, sv_vc, sv_tsp, keep, cause, parent.astype(np.int32))
    got = befuse.k2_runs(*(_t(x) for x in ins), U=P, k_max=P, Kp=P)
    ref = jax.vmap(lambda *a: pb.k2_runs(*a, U=P, k_max=P, Kp=P))(
        *(jnp.asarray(x) for x in ins))
    assert_outputs(ref, got, "K2 synthetic")
    n_runs = got[9][:, 0].numpy()
    hc = got[4].numpy()
    for r in range(B):
        assert n_runs[r] < P
        tail = hc[r, n_runs[r]:]
        assert np.all(np.diff(tail) > 0)  # non-heads, in index order


# -------------------------------------------------- pure row functions


def _fuzz_batch(seed, n_docs=6, cap=64):
    """Seeded multi-site documents (deterministic site ids): two replicas
    off a shared base, random inserts from two sites each, hides and
    h.shows among them."""
    rng = random.Random(seed)
    site_no = iter(range(10 ** 6))

    def site():
        return f"bfSite{seed % 1000:03d}{next(site_no):04d}"

    from cause_tpu.weaver.arrays import NodeArrays, SiteInterner

    rows = []
    while len(rows) < n_docs:
        ra = c.CausalList(c.clist().ct.evolve(site_id=site()))
        ra = ra.conj(*[str(i) for i in range(rng.randrange(1, 20))])
        rb = c.CausalList(ra.ct.evolve(site_id=site()))
        sa, sb = site(), site()
        for _ in range(rng.randrange(0, 15)):
            ra = ra.insert(rand_node(rng, ra, site_id=sa))
        for _ in range(rng.randrange(0, 15)):
            rb = rb.insert(rand_node(rng, rb, site_id=sb))
        if max(len(ra.ct.nodes), len(rb.ct.nodes)) > cap:
            continue
        it = SiteInterner(nid[1] for h in (ra, rb) for nid in h.ct.nodes)
        parts = []
        for t, h in enumerate((ra, rb)):
            na = NodeArrays.from_nodes_map(h.ct.nodes, cap, it)
            hi, lo = na.id_lanes()
            parts.append({"hi": hi, "lo": lo, "vc": na.vclass,
                          "valid": na.valid,
                          "cci": np.where(na.cause_idx >= 0,
                                          na.cause_idx + t * cap,
                                          -1).astype(np.int32)})
        rows.append({k: np.concatenate([p[k] for p in parts])
                     for k in parts[0]})
    v5 = {k: np.stack([jbench.v5_inputs(r, cap, s_max=cap)[k]
                       for r in rows]) for k in KEYS}
    return v5


@pytest.fixture(scope="module")
def row_fns():
    eye = pb._eye_f32()
    k1 = jax.jit(lambda *a: pb.row_k1(eye, *a, U=128))
    k2 = jax.jit(lambda *a: pb.row_k2(eye, *a, U=128, k_max=128, Kp=128))
    k4 = jax.jit(lambda *a: pb.row_k4(eye, *a, U=128, k_max=128, N=128))
    return k1, k2, k4


def _row(x, r):
    return jnp.asarray(x[r:r + 1].numpy())


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_row_functions_sweep(monkeypatch, row_fns, seed):
    """Seeded API fuzz rows (cap 64, budget 128: one shape) through the
    port's plain K1/K2/K4 and the pure ``row_k*``, row by row, each on
    the port's own intermediates."""
    k1, k2, k4 = row_fns
    v5 = _fuzz_batch(seed)
    seen, out = record_kernel_inputs(monkeypatch, v5, 128, 128)
    for name, fn, n_scal in (("k1_sort_redirect", k1, 1),
                             ("k2_runs", k2, 3), ("k4_rank_kills", k4, 2)):
        args, kw = seen[name]
        got = getattr(befuse, name)(*args, **kw)
        if name == "k4_rank_kills":  # row_k4 takes n_runs, sp_last
            args = args[:-1] + (args[-1][:, 0:1], args[-1][:, 2:3])
        for r in range(args[0].shape[0]):
            want = fn(*(_row(x, r) for x in args))
            n_arr = len(want) - n_scal
            for j in range(n_arr):
                assert np.array_equal(np.asarray(want[j])[0],
                                      got[j][r].numpy()), (name, r, j)
            scal = got[-1][r].numpy()
            for j in range(n_scal):
                assert int(np.asarray(want[n_arr + j]).ravel()[0]) == \
                    scal[j], (name, r, "scal", j)


# ------------------------------------------------------- the v5f batch


def jax_v5f(v5, u, k):
    args = [jnp.asarray(v5[x]) for x in KEYS]
    r, v, cf, ov = jax.jit(
        lambda *a: j_v5f(*a, u_max=u, k_max=k))(*args)
    dg = _digest(args[0], args[1], r, v)
    return tuple(np.asarray(x) for x in (r, v, cf, ov, dg))


def port_v5f(v5, u, k, v5_too=True):
    args = _lanes(v5)
    out = ct.batched_merge_weave_v5f(*args, u_max=u, k_max=k, device="cpu")
    dg = t_digest(args[0], args[1], out[0], out[1])
    res = tuple(x.numpy() for x in out) + (dg.numpy().astype(np.uint32),)
    if v5_too:
        base = ct.batched_merge_weave_v5(*args, u_max=u, k_max=k,
                                         device="cpu")
        for name, b, g in zip(("rank", "visible", "conflict", "overflow"),
                              base, out):
            if out[3].any():  # overflow rows: only the flags are specified
                assert name != "overflow" or torch.equal(b, g)
            else:
                assert torch.equal(b, g), f"v5f {name} differs from v5"
    return res


def assert_same(want, got, tag):
    names = ("rank", "visible", "conflict", "overflow", "digest")
    for w, g, name in zip(want, got, names):
        assert w.shape == g.shape, (tag, name)
        assert np.array_equal(w, g), (
            f"{tag} {name} differs at {np.argwhere(w != g)[:8].tolist()}")


@pytest.mark.parametrize("B,nb,nd,cap,he", [
    (3, 120, 40, 256, 8),
    (8, 120, 40, 192, 4),
    (5, 60, 3, 64, 2),
    (4, 0, 30, 64, 3),
    (2, 30, 10, 64, 0),
    (6, 50, 40, 128, 2),
])
def test_v5f_batch_parity(B, nb, nd, cap, he):
    v5, u = _v5_case(B, nb, nd, cap, he)
    want = jax_v5f(v5, u, u)
    assert not want[3].any()
    assert_same(want, port_v5f(v5, u, u), f"B={B} cap={cap}")


def test_v5f_separate_budgets():
    """u_max != k_max: the token and run widths split."""
    v5, u = _v5_case(2, 100, 40, 192, 5)
    want = jax_v5f(v5, u + 40, u)
    assert not want[3].any()
    assert_same(want, port_v5f(v5, u + 40, u), "u!=k")


def test_v5f_overflow_flags():
    """An undersized budget: only the overflow flag is specified, and it
    agrees row by row with the JAX v5f and the port's v5."""
    v5, _ = _v5_case(4, 100, 60, 192, 4)
    want = jax_v5f(v5, 16, 16)
    got = port_v5f(v5, 16, 16)
    assert want[3].any()
    assert np.array_equal(want[3], got[3])


def test_v5f_n_not_multiple_of_128():
    """N = 144: the JAX v5f falls back to v5 (its Pallas F kernel needs
    N % 128 == 0); the port runs the fused pipeline, with the same
    outputs."""
    v5, u = _v5_case(3, 30, 10, 72, 3)
    assert v5["hi"].shape[1] == 144
    want = jax_v5f(v5, u, u)
    assert_same(want, port_v5f(v5, u, u), "N=144")


def test_v5f_fuzz_api_documents():
    """The seeded multi-site API fuzz at cap 64, budget 128 (one bucket,
    as tests/test_befuse.py:111-135)."""
    v5 = _fuzz_batch(0xBEEF, n_docs=10)
    want = jax_v5f(v5, 128, 128)
    assert not want[3].any()
    assert_same(want, port_v5f(v5, 128, 128), "fuzz")


def test_v5f_refuses_run_budget_above_token_budget():
    v5, u = _v5_case(2, 30, 10, 64, 3)
    with pytest.raises(ValueError, match="Kp"):
        ct.batched_merge_weave_v5f(*_lanes(v5), u_max=128, k_max=129,
                                   device="cpu")


# ---------------------------------------------------- merge_wave routing


@pytest.fixture
def on_cpu():
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def _pure_merge(a, b):
    return TList(a.ct.evolve(weaver="pure")).merge(
        TList(b.ct.evolve(weaver="pure")))


def _same(got, want):
    return ([n[0] for n in got.ct.weave] == [n[0] for n in want.ct.weave]
            and list(got) == list(want))


@pytest.fixture(scope="module")
def fleet():
    hs = tbench.tree_fleet_handles(6, 120, 30, hide_every=4)
    return [(hs[2 * i], hs[2 * i + 1]) for i in range(3)]


def test_merge_wave_v5f_matches_v5_and_pure(on_cpu, monkeypatch, fleet):
    monkeypatch.delenv("BENCH_KERNEL", raising=False)
    base = ct.merge_wave(fleet)
    assert base.kernel == "v5"
    monkeypatch.setenv("BENCH_KERNEL", "v5f")
    res = ct.merge_wave(fleet)
    assert res.kernel == "v5f"
    assert res.fallback == [] and res.digest_valid.all()
    assert np.array_equal(res.digest, base.digest)
    assert np.array_equal(res.rank, base.rank)
    for i, (a, b) in enumerate(fleet):
        assert _same(res.merged(i), _pure_merge(a, b))


@pytest.mark.parametrize("knob", ["v5", "v5w", " v5f "])
def test_merge_wave_records_its_pipeline(on_cpu, monkeypatch, fleet, knob):
    monkeypatch.setenv("BENCH_KERNEL", knob)
    res = ct.merge_wave(fleet[:1])
    assert res.kernel == knob.strip()
    monkeypatch.delenv("BENCH_KERNEL")
    assert np.array_equal(res.digest, ct.merge_wave(fleet[:1]).digest)


def test_merge_wave_v5f_retries_overflow_rows_on_v5f(on_cpu, monkeypatch,
                                                     fleet):
    """A starved budget: every row overflows once and is retried at the
    doubled budget through the same pipeline, with the same result."""
    from cause_tpu_torch.parallel import wave

    monkeypatch.setenv("BENCH_KERNEL", "v5f")
    want = ct.merge_wave(fleet)
    pipelines = []
    real = wave._dispatch

    def spy(lanes, u, device, site, pipeline="v5"):
        pipelines.append((u, pipeline))
        return real(lanes, u, device, site, pipeline)

    def half_budget(lanes):  # just over half of the largest row's need
        need = max(tbench.estimate_tokens({k: lanes[k][i] for k in KEYS})
                   for i in range(lanes["hi"].shape[0]))
        return befuse.next_pow2(need) // 2

    monkeypatch.setattr(wave, "_dispatch", spy)
    monkeypatch.setattr(tbench, "v5_token_budget", half_budget)
    res = ct.merge_wave(fleet)
    h = pipelines[0][0]
    assert pipelines == [(h, "v5f"), (2 * h, "v5f")]
    assert res.fallback == [] and np.array_equal(res.digest, want.digest)


@pytest.mark.parametrize("knob", ["v4", "v5x"])
def test_bench_kernel_outside_the_v5_family_raises_in_both(on_cpu,
                                                          monkeypatch,
                                                          fleet, knob):
    monkeypatch.setenv("BENCH_KERNEL", knob)
    with pytest.raises(ValueError, match="BENCH_KERNEL"):
        ct.merge_wave(fleet[:1])
    jhs = jbench.tree_fleet_handles(2, 20, 5, hide_every=4)
    with pytest.raises(ValueError, match="BENCH_KERNEL"):
        c.merge_wave([(jhs[0], jhs[1])])
