"""The port's v5 batch against the JAX package's, on the same arrays.

``cause_tpu_torch``'s ``batched_merge_weave_v5`` and
``batched_weave_digest`` (on the CPU: every sort, the forest walk and
the lane expansion take their plain versions) against
``cause_tpu``'s, both fed ONE marshalled numpy batch. The JAX side runs
with its three kernel switches off (XLA sort, pointer doubling, the
XLA F phase) and, in one test, on (``CAUSE_TPU_SORT=pallas``,
``euler="walk"``, ``CAUSE_TPU_FPHASE=pallas``, Pallas in interpret
mode: slow to compile here, so once), flipped with ``monkeypatch`` and
``jax.clear_caches()`` as tests/test_fphase.py does. Outputs are
integers and flags, so every comparison is EXACT. Digests are compared
only on the same marshalled arrays (site ranks are per-process
interner state)."""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import cause_tpu as c
from cause_tpu import benchgen as jbench
from cause_tpu.parallel.mesh import replica_digest
from cause_tpu.weaver import jaxw5, jaxwd
from cause_tpu.weaver.arrays import NodeArrays, SiteInterner

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as tbench

from test_list import rand_node

KEYS = jbench.LANE_KEYS5


_digest = jax.jit(jax.vmap(replica_digest))


@pytest.fixture
def switches(monkeypatch):
    """``set(on)``: the JAX package's three kernel switches on (Pallas
    sort, Euler walk, Pallas F phase) or off, with the jit caches
    cleared around each flip (the switches are read at trace time)."""
    def set_(on):
        for name in ("CAUSE_TPU_SORT", "CAUSE_TPU_FPHASE"):
            if on:
                monkeypatch.setenv(name, "pallas")
            else:
                monkeypatch.delenv(name, raising=False)
        jax.clear_caches()

    yield set_
    monkeypatch.delenv("CAUSE_TPU_SORT", raising=False)
    monkeypatch.delenv("CAUSE_TPU_FPHASE", raising=False)
    jax.clear_caches()


def jax_v5(v5, u, on=False, k_max=None):
    """The JAX reference: ``(rank, visible, conflict, overflow,
    digest)``; the digest is ``replica_digest`` over the kernel's
    outputs, as ``jaxwd.batched_weave_digest`` computes it."""
    args = [jnp.asarray(v5[k]) for k in KEYS]
    r, v, cf, ov = jaxw5.batched_merge_weave_v5(
        *args, u_max=u, k_max=u if k_max is None else k_max,
        euler="walk" if on else "doubling")
    dg = _digest(args[0], args[1], r, v)
    return (np.asarray(r), np.asarray(v), np.asarray(cf), np.asarray(ov),
            np.asarray(dg))


def port_v5(v5, u, k_max=None):
    k_max = u if k_max is None else k_max
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    args = [lanes[k] for k in KEYS]
    r, v, cf, ov = ct.batched_merge_weave_v5(*args, u_max=u, k_max=k_max,
                                             device="cpu")
    r2, v2, dg, ov2 = ct.batched_weave_digest(*args, u_max=u, k_max=k_max,
                                              device="cpu")
    assert r.equal(r2) and v.equal(v2) and ov.equal(ov2)
    return (r.numpy(), v.numpy(), cf.numpy(), ov.numpy(),
            dg.numpy().astype(np.uint32))


def assert_same(want, got, tag=""):
    names = ("rank", "visible", "conflict", "overflow", "digest")
    for w, g, name in zip(want, got, names):
        assert w.shape == g.shape, (tag, name, w.shape, g.shape)
        assert np.array_equal(w, g), (
            f"{tag} {name} differs at {np.argwhere(w != g)[:8].tolist()}")


@pytest.mark.parametrize("B,nb,nd,cap,he", [
    (3, 120, 40, 256, 8),   # N = 512
    (4, 30, 10, 72, 3),     # N = 144: not a multiple of 128
    (5, 0, 30, 64, 3),      # no shared base
    (2, 30, 10, 64, 0),     # no tombstones
])
def test_batched_pair_lanes_parity(switches, B, nb, nd, cap, he):
    batch = tbench.batched_pair_lanes(B, nb, nd, cap, hide_every=he)
    v5 = tbench.batched_v5_inputs(batch, cap)
    # the port's marshal is a copy: it must give the JAX one's arrays
    v5_j = jbench.batched_v5_inputs(
        jbench.batched_pair_lanes(B, nb, nd, cap, hide_every=he), cap)
    for k in KEYS:
        assert np.array_equal(v5[k], v5_j[k]), k
    u = tbench.v5_token_budget(v5)
    assert u == jbench.v5_token_budget(v5_j)
    switches(False)
    want = jax_v5(v5, u)
    assert not want[3].any()
    assert_same(want, port_v5(v5, u), f"B={B} cap={cap}")


def test_separate_budgets_parity(switches):
    """u_max != k_max (the shape of tests/test_befuse.py:70-80): pins
    ``_v5`` unchanged now that its phases A and B are ``_v5_ab``, which
    the fused pipeline shares."""
    row = jbench.divergent_pair_lanes(n_base=100, n_div=40, capacity=192,
                                      hide_every=5)
    v5row = jbench.v5_inputs(row, 192)
    u = jbench.v5_token_budget(v5row)
    v5 = {k: v[None] for k, v in v5row.items()}
    switches(False)
    want = jax_v5(v5, u + 40, k_max=u)
    assert not want[3].any()
    assert_same(want, port_v5(v5, u + 40, k_max=u), "u!=k")


def test_switches_on_parity(switches):
    """With the Pallas sort, the Euler walk and the Pallas F phase on,
    the JAX package gives the same arrays, and so does the port."""
    batch = tbench.batched_pair_lanes(2, 30, 10, 64, hide_every=3)
    v5 = tbench.batched_v5_inputs(batch, 64)  # N = 128: the Pallas F phase
    u = tbench.v5_token_budget(v5)
    switches(True)
    want = jax_v5(v5, u, on=True)
    assert not want[3].any()
    assert_same(want, port_v5(v5, u), "switches on")


def test_weave_digest_program_parity(switches):
    """``batched_weave_digest`` against its JAX counterpart directly."""
    batch = tbench.batched_pair_lanes(3, 60, 20, 128, hide_every=5)
    v5 = tbench.batched_v5_inputs(batch, 128)
    u = tbench.v5_token_budget(v5)
    switches(False)
    r, v, dg, ov = jaxwd.batched_weave_digest(
        *(jnp.asarray(v5[k]) for k in KEYS), u_max=u, k_max=u)
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    r2, v2, dg2, ov2 = ct.batched_weave_digest(
        *(lanes[k] for k in KEYS), u_max=u, k_max=u, device="cpu")
    assert np.array_equal(np.asarray(r), r2.numpy())
    assert np.array_equal(np.asarray(v), v2.numpy())
    assert np.array_equal(np.asarray(ov), ov2.numpy())
    assert np.array_equal(np.asarray(dg), dg2.numpy().astype(np.uint32))
    assert len(set(dg2.tolist())) == 3  # distinct pairs, distinct digests


def _api_row(handles, cap):
    """Concat row of K API-built replicas (one interner, cci offsets)."""
    sites = set()
    for h in handles:
        sites |= {i[1] for i in h.ct.nodes}
    it = SiteInterner(sites)
    nas = [NodeArrays.from_nodes_map(h.ct.nodes, capacity=cap, interner=it)
           for h in handles]
    row = {
        "hi": np.concatenate([na.id_lanes()[0] for na in nas]),
        "lo": np.concatenate([na.id_lanes()[1] for na in nas]),
        "cci": np.concatenate([
            np.where(na.cause_idx >= 0, na.cause_idx + i * cap, -1)
            .astype(np.int32) for i, na in enumerate(nas)]),
        "vc": np.concatenate([na.vclass for na in nas]),
        "valid": np.concatenate([na.valid for na in nas]),
    }
    return row


def _stack_rows(rows, cap):
    v5rows = [jbench.v5_inputs(r, cap) for r in rows]
    s_max = max(v["sg_len"].shape[0] for v in v5rows)
    v5rows = [jbench.v5_inputs(r, cap, s_max=s_max) for r in rows]
    return {k: np.stack([v[k] for v in v5rows]) for k in KEYS}


def test_multi_site_fuzz_documents(switches):
    """Seeded multi-site documents: 2-3 replicas off a shared base, each
    with random inserts from two sites (hides and h.shows among them)."""
    from cause_tpu.collections.clist import CausalList

    rng = random.Random(0xC0FFEE)
    site_no = iter(range(1000))

    def new_site_id():  # deterministic 13-character site ids
        return f"fuzzSite{next(site_no):05d}"

    cap = 64
    rows = []
    for _ in range(6):
        base = CausalList(c.clist().ct.evolve(site_id=new_site_id()))
        base = base.conj(*[f"b{i}" for i in range(rng.randrange(1, 10))])
        reps = []
        for _ in range(rng.randrange(2, 4)):
            r = CausalList(base.ct.evolve(site_id=new_site_id()))
            sites = [r.ct.site_id, new_site_id()]
            for _ in range(rng.randrange(0, 9)):
                r = r.insert(rand_node(rng, r, site_id=rng.choice(sites)))
            reps.append(r)
        while len(reps) < 3:  # equal row widths: pad with an empty tree
            reps.append(reps[0].empty())
        rows.append(_api_row(reps, cap))
    v5 = _stack_rows(rows, cap)
    u = max(jbench.estimate_tokens({k: v5[k][i] for k in KEYS})
            for i in range(len(rows))) + 8
    switches(False)
    want = jax_v5(v5, u)
    assert not want[3].any()
    assert_same(want, port_v5(v5, u), "fuzz")


def test_overflow_row_flags_identically(switches):
    """An undersized token budget: only the overflow flag is specified
    (the outputs of an overflowed row are not, pallas_befuse.py:45-47),
    and it must agree row by row."""
    batch = tbench.batched_pair_lanes(4, 100, 60, 192, hide_every=4)
    v5 = tbench.batched_v5_inputs(batch, 192)
    switches(False)
    want = jax_v5(v5, 16)
    got = port_v5(v5, 16)
    assert want[3].any()
    assert np.array_equal(want[3], got[3])


def test_conflict_flag(switches):
    """Duplicate ids with differing bodies in an exploded region flag a
    conflict in both packages."""
    cap = 32
    row = jbench.divergent_pair_lanes(n_base=10, n_div=4, capacity=cap,
                                      hide_every=2)
    ia = 1 + 10 + 1
    ib = cap + 1 + 10 + 2
    row["hi"][ib] = row["hi"][ia]
    row["lo"][ib] = row["lo"][ia]
    row["vc"][ib] = 1 - (row["vc"][ia] & 1)
    v5 = {k: v[None] for k, v in jbench.v5_inputs(row, cap).items()}
    switches(False)
    want = jax_v5(v5, 80)
    assert want[2].all()
    assert_same(want, port_v5(v5, 80), "conflict")
