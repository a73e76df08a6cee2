"""The port's single-row v5 and v5f entry points against the JAX package's.

``torchw5.merge_weave_kernel_v5`` and ``torchw5f.merge_weave_kernel_v5f``
(one replica set's ``[N]`` lanes and ``[S]`` tables, as
``cause_tpu_torch.fleet_bench`` and ``cause_tpu_torch.soak`` call them)
against ``jaxw5.merge_weave_kernel_v5_jit`` and
``jaxw5f.merge_weave_kernel_v5f_jit`` on the same numpy row, output for
output (rank, visible, conflict, overflow), on the fleet bench's smoke
row (``fleet_lanes(8, 800, 100, 1024)``) and on rows that the soak's
``v5f_round`` builds; each also against row 0 of the port's batched form.
On the CPU the port's kernel sites take their plain versions. Every
output is an integer or a flag: every comparison is exact.
"""

import random

import numpy as np
import pytest

import jax.numpy as jnp

from cause_tpu import benchgen as jb
from cause_tpu.weaver.jaxw5 import merge_weave_kernel_v5_jit
from cause_tpu.weaver.jaxw5f import merge_weave_kernel_v5f_jit

from cause_tpu_torch import benchgen as tb
from cause_tpu_torch import soak
from cause_tpu_torch.weaver import torchw5, torchw5f

KEYS = tb.LANE_KEYS5
NAMES = ("rank", "visible", "conflict", "overflow")
REF = {"v5": merge_weave_kernel_v5_jit, "v5f": merge_weave_kernel_v5f_jit}
PORT = {"v5": (torchw5.merge_weave_kernel_v5,
               torchw5.batched_merge_weave_v5),
        "v5f": (torchw5f.merge_weave_kernel_v5f,
                torchw5f.batched_merge_weave_v5f)}


def fleet_row():
    lanes = tb.fleet_lanes(8, 800, 100, 1024, hide_every=8)
    ref = jb.fleet_lanes(8, 800, 100, 1024, hide_every=8)
    for k in ref:
        assert np.array_equal(lanes[k], ref[k]), k
    v5row = tb.v5_inputs(lanes, 1024)
    return v5row, tb.v5_token_budget(v5row)


def soak_rows(n=4):
    """The first ``n`` rows that ``v5f_round`` builds from seeds 5, 11,
    17, ... (the seeds of its kind), with its budget."""
    rows, seed = [], 5
    while len(rows) < n:
        row = soak.v5f_row(random.Random(seed))
        if row is not None:
            rows.append((row, soak.V5F_U))
        seed += 6
    return rows


def run_both(kernel, v5row, u):
    ref = REF[kernel](*[jnp.asarray(v5row[k]) for k in KEYS], u_max=u,
                      k_max=u)
    single, batched = PORT[kernel]
    got = single(*[v5row[k] for k in KEYS], u_max=u, k_max=u,
                 device="cpu")
    rows = batched(*[v5row[k][None] for k in KEYS], u_max=u, k_max=u,
                   device="cpu")
    return ([np.asarray(x) for x in ref], [x.numpy() for x in got],
            [x[0].numpy() for x in rows])


@pytest.mark.parametrize("kernel", ["v5", "v5f"])
@pytest.mark.parametrize("source", ["fleet", "soak"])
def test_single_row_equals_the_reference_and_the_batch(kernel, source):
    cases = [fleet_row()] if source == "fleet" else soak_rows()
    for v5row, u in cases:
        ref, got, row0 = run_both(kernel, v5row, u)
        for name, r, g, b in zip(NAMES, ref, got, row0):
            assert g.shape == r.shape, name
            assert np.array_equal(g, r), (kernel, source, name)
            assert np.array_equal(g, b), (kernel, source, name)
        assert not bool(got[3]), "the budget must fit"


@pytest.mark.parametrize("kernel", ["v5", "v5f"])
def test_overflowing_budget_raises_the_flag_in_both(kernel):
    v5row, u = fleet_row()
    small = 128  # the row needs about 800 tokens
    ref, got, row0 = run_both(kernel, v5row, small)
    assert bool(np.asarray(ref[3])) and bool(got[3]) and bool(row0[3])
    assert u > small
