"""The port's ``weave_arrays`` ladder and ``merge_wave_scalar`` against
the JAX package's.

Each tree is built in both packages from the same op script with the
same site ids and uuid, so both mint the same nodes and marshal the
same lanes. The reference's own predicates (segment count against the
v5 table budget, the host run estimate against the run budget, the
kernels' overflow flags) pick a rung; the port must walk the same rungs
in the same order (each package's rung calls are recorded), return the
same ranks and visibility, weave the ``weaver="torch"`` handle and its
merge with a twin on the device (``pure_fallbacks`` unchanged) and equal
the reference's weave. The trees are the ones whose rung the ladder
exists for, at a tenth of the size the chip smoke drives: a set of
``add``s, and that set with every third member ``discard``ed (v1); a
list of appends whose cursor jumps every 8 ops (v5) and every 3 ops
(v1); a list of pastes whose deleted last characters are undeleted
later, whose segments explode past v5's token budget while its runs fit
v4's run budget (v4).

No tree takes the v2 rung: v2 is tried only after v4 overflowed at the
same run budget, and v4's run count IS the host estimate the rung test
reads (``tests/test_torch_generations.py``
``test_estimate_runs_equals_the_device_run_count``), so whenever the
estimate fits, v4 does not overflow.

``merge_wave_scalar`` runs every kernel name the reference takes on one
``benchgen`` batch: the v5-family digests equal the reference's integer
for integer; the v1-v4 float checksums at ``rtol=1e-6`` (another
summation order); the overflow count exactly.
"""

import random

import numpy as np
import pytest

import jax.numpy as jnp

import cause_tpu as c
from cause_tpu import benchgen as jb
from cause_tpu.collections import clist as j_clist
from cause_tpu.weaver import jaxw, jaxw4, jaxw5
from cause_tpu.weaver.arrays import NodeArrays as JArrays

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as tb
from cause_tpu_torch.collections import clist as t_clist
from cause_tpu_torch.weaver import torchw, torchw4, torchw5
from cause_tpu_torch.weaver.arrays import NodeArrays as TArrays
from cause_tpu_torch.weaver.arrays import next_pow2

SITE, TWIN = "sLADDER000000", "sLADDERTWIN00"
UUID = "ladderTreeUuid0000000"


@pytest.fixture
def on_cpu():
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def _fresh(pkg, kind, site=SITE):
    if kind == "set":
        h = pkg.cset()
    else:
        mod = j_clist if pkg is c else t_clist
        h = mod.CausalList(mod.new_causal_tree("pure", lazy=True))
    return type(h)(h.ct.evolve(site_id=site, uuid=UUID))


def jump_list(pkg, n, every, seed=5):
    """``n`` appends, each after the previous one, with the cursor
    jumping to a random earlier node every ``every`` ops."""
    rng = random.Random(seed)
    h = _fresh(pkg, "list")
    ids = [pkg.root_id]
    cursor = pkg.root_id
    for i in range(n):
        if i and i % every == 0:
            cursor = ids[rng.randrange(len(ids))]
        h = h.append(cursor, f"v{i}")
        cursor = (h.ct.lamport_ts, SITE, 0)
        ids.append(cursor)
    return h


def discard_set(pkg, n, every):
    """A set of ``n`` adds with every ``every``-th member discarded
    (``every`` 0: none)."""
    h = _fresh(pkg, "set")
    for i in range(n):
        h = h.add(f"m{i}")
    for i in range(0, n, every) if every else ():
        h = h.discard(f"m{i}")
    return h


def pasted_runs(pkg, runs, length):
    """A list of ``runs`` typed runs of ``length`` characters at the
    front, each run's last character deleted and the previous run's
    deletion undone (an ``h.show`` of its ``hide``) after it. Each run
    and its ``hide`` are one segment with a special tail, which the
    later ``h.show`` names as its cause: v5 explodes the segment to one
    token a node, past its token budget, while the runs stay few."""
    h = _fresh(pkg, "list")
    prev_hide = None
    for r in range(runs):
        cause = pkg.root_id
        for i in range(length):
            h = h.append(cause, f"r{r}.{i}")
            cause = (h.ct.lamport_ts, SITE, 0)
        h = h.append(cause, pkg.hide)
        hide = (h.ct.lamport_ts, SITE, 0)
        if prev_hide is not None:
            h = h.append(prev_hide, pkg.h_show)
        prev_hide = hide
    return h


TREES = {
    # name: (the tree in a package, the rungs the reference's predicates walk)
    "set_of_adds": (lambda p: discard_set(p, 100, 0), ["v5"]),
    "set_discarding_every_third": (lambda p: discard_set(p, 100, 3),
                                   ["v1"]),
    "list_jumping_every_8": (lambda p: jump_list(p, 400, 8), ["v5"]),
    "list_jumping_every_3": (lambda p: jump_list(p, 400, 3), ["v1"]),
    "pastes_past_v5_tokens": (lambda p: pasted_runs(p, 4, 45),
                              ["v5", "v4"]),
}


def spy_rungs(monkeypatch, log):
    """Record each rung either package dispatches from ``weave_arrays``."""
    def wrap(mod, attr, tag):
        real = getattr(mod, attr)

        def call(*a, **kw):
            log.append(tag)
            return real(*a, **kw)
        monkeypatch.setattr(mod, attr, call)

    for pkg, mods in (("jax", ((jaxw5, "merge_weave_kernel_v5_jit", "v5"),
                               (jaxw4, "merge_weave_kernel_v4_jit", "v4"),
                               (jaxw, "_linearize_v2_jit", "v2"),
                               (jaxw, "_linearize_jit", "v1"))),
                      ("torch", ((torchw5, "batched_merge_weave_v5", "v5"),
                                 (torchw4, "batched_merge_weave_v4", "v4"),
                                 (torchw, "_linearize_v2", "v2"),
                                 (torchw, "_linearize", "v1")))):
        for mod, attr, tag in mods:
            wrap(mod, attr, (pkg, tag))


def rungs(log, pkg):
    return [tag for p, tag in log if p == pkg]


def weave_ids(ct_):
    return [n[0] for n in ct_.weave]


@pytest.mark.parametrize("name", sorted(TREES))
def test_weave_arrays_takes_the_reference_rung(on_cpu, monkeypatch, name):
    build, want_rungs = TREES[name]
    j, t = build(c), build(ct)
    assert sorted(j.ct.nodes) == sorted(t.ct.nodes)
    log = []
    spy_rungs(monkeypatch, log)
    want = jaxw.weave_arrays(JArrays.from_nodes_map(j.ct.nodes))
    got = torchw.weave_arrays(TArrays.from_nodes_map(t.ct.nodes))
    assert rungs(log, "jax") == want_rungs
    assert rungs(log, "torch") == want_rungs
    assert np.array_equal(got[0], np.asarray(want[0]))
    assert np.array_equal(got[1], np.asarray(want[1]))

    # the handle's reweave and its merge with a twin, on the device
    pure = j_clist.weave(j.ct.evolve(weaver="pure"))
    before = torchw.pure_fallbacks
    woven = torchw.refresh_list_weave(t.ct.evolve(weaver="torch"))
    assert weave_ids(woven) == weave_ids(pure)
    twin = [type(h)(h.ct.evolve(site_id=TWIN)) for h in (j, t)]
    twin = [h.add("twin") if name.startswith("set") else h.conj("twin")
            for h in twin]
    want_m = type(j)(j.ct.evolve(weaver="pure")).merge(twin[0])
    got_m = type(t)(t.ct.evolve(weaver="torch")).merge(
        type(t)(twin[1].ct.evolve(weaver="torch")))
    assert got_m.ct.weaver == "torch"
    assert [n[0] for n in got_m.get_weave()] == [
        n[0] for n in want_m.get_weave()]
    assert got_m.causal_to_edn() == want_m.causal_to_edn()
    assert torchw.pure_fallbacks == before


def test_off_domain_trees_are_counted(on_cpu):
    """A tree with an id beyond the PackSpec is woven by the pure weaver
    in both packages; the port counts it in ``pure_fallbacks``."""
    big = ((1 << 31) - 1, SITE, 0)
    t = _fresh(ct, "list").insert((big, ct.root_id, "huge"))
    before = torchw.pure_fallbacks
    woven = torchw.refresh_list_weave(t.ct.evolve(weaver="torch"))
    assert torchw.pure_fallbacks == before + 1
    j = _fresh(c, "list").insert((big, c.root_id, "huge"))
    assert weave_ids(woven) == weave_ids(
        j_clist.weave(j.ct.evolve(weaver="pure")))


# -------------------------------------------------- merge_wave_scalar


@pytest.fixture(scope="module")
def scalar_batch():
    batch = jb.batched_pair_lanes(5, 30, 9, 64, hide_every=2)
    v5 = jb.batched_v5_inputs(batch, 64)
    return batch, v5, jb.pair_run_budget(batch), next_pow2(
        jb.v5_token_budget(v5))


@pytest.mark.parametrize("kernel", ["v1", "v2", "v3", "v4", "v4w", "v5",
                                    "v5w", "v5f"])
def test_merge_wave_scalar_matches_the_reference(scalar_batch, kernel):
    batch, v5, k, u = scalar_batch
    if kernel.startswith("v5"):
        keys, k_max, u_max = jb.LANE_KEYS5, u, u
    else:
        keys = jb.LANE_KEYS4 if kernel.startswith("v4") else jb.LANE_KEYS
        k_max, u_max = (0 if kernel == "v1" else k), 0
    arrays = [v5[x] if kernel.startswith("v5") else batch[x] for x in keys]
    want = np.asarray(jb.merge_wave_scalar(
        *map(jnp.asarray, arrays), k_max=k_max, kernel=kernel, u_max=u_max))
    got = tb.merge_wave_scalar(*arrays, k_max=k_max, kernel=kernel,
                               u_max=u_max, device="cpu").numpy()
    assert got.shape == want.shape
    if kernel.startswith("v5"):
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
        if want.ndim:
            assert got[1] == want[1] == 0


def test_merge_wave_scalar_counts_overflowed_rows():
    """A busted budget: every row counts as overflowed, as in the
    reference."""
    batch = tb.batched_pair_lanes(4, 20, 6, 32, hide_every=2)
    for kernel, keys in (("v2", jb.LANE_KEYS), ("v4", jb.LANE_KEYS4)):
        arrays = [batch[x] for x in keys]
        got = tb.merge_wave_scalar(*arrays, k_max=4, kernel=kernel,
                                   device="cpu").numpy()
        want = np.asarray(jb.merge_wave_scalar(
            *map(jnp.asarray, arrays), k_max=4, kernel=kernel))
        assert got[1] == want[1] == 4
