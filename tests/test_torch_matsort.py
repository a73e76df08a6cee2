"""The port's ``matrix_sort`` against the JAX package's and stable sorts.

The rank count with the position tie-break defines the unique stable
order, so ``cause_tpu_torch.weaver.matsort.matrix_sort`` must equal the
reference's ``matrix_sort``, stable ``lax.sort`` and the port's own
``sort_pairs_plain`` exactly, on the same numpy operands. Mirrors
``tests/test_matsort.py:19-62``; that file's remaining cases test the
reference's ``CAUSE_TPU_SORT`` switch, which the port does not have.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from cause_tpu.weaver.matsort import matrix_sort as j_matrix_sort

from cause_tpu_torch.weaver.bitonic import sort_pairs_plain
from cause_tpu_torch.weaver.matsort import matrix_sort

I32_MAX = np.iinfo(np.int32).max


def check(ops, num_keys):
    want = [np.asarray(x) for x in lax.sort(
        tuple(jnp.asarray(x) for x in ops), num_keys=num_keys,
        is_stable=True)]
    ref = [np.asarray(x) for x in j_matrix_sort(
        tuple(jnp.asarray(x) for x in ops), num_keys=num_keys)]
    t_ops = tuple(torch.from_numpy(x) for x in ops)
    got = [x.numpy() for x in matrix_sort(t_ops, num_keys=num_keys)]
    plain = [x.numpy() for x in sort_pairs_plain(
        tuple(x.reshape(-1, x.shape[-1]) for x in t_ops), num_keys)]
    for w, r, g, p in zip(want, ref, got, plain):
        assert np.array_equal(g, w)
        assert np.array_equal(g, r)
        assert np.array_equal(g.reshape(p.shape), p)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 64, 100, 257, 300])
@pytest.mark.parametrize("num_keys", [1, 2])
def test_matches_stable_sorts(n, num_keys):
    """Few distinct key values: plenty of ties for the position
    tie-break."""
    rng = np.random.RandomState(n * 10 + num_keys)
    ops = tuple(rng.randint(-3, 7, size=n).astype(np.int32)
                for _ in range(num_keys)) + (
        np.arange(n, dtype=np.int32) * 3,)
    check(ops, num_keys)


def test_batched_and_sentinels():
    rng = np.random.RandomState(0)
    hi = rng.randint(0, 50, size=(4, 100)).astype(np.int32)
    hi[:, 40:] = I32_MAX  # invalid-lane sentinel region
    lo = rng.randint(0, 50, size=(4, 100)).astype(np.int32)
    src = np.tile(np.arange(100, dtype=np.int32), (4, 1))
    check((hi, lo, src), 2)


def test_full_int32_range_keys():
    """Negative keys, INT32_MIN and the I32_MAX sentinel as real values,
    at a width past one block (n = 300)."""
    keys = np.array([I32_MAX, -5, 0, I32_MAX, np.iinfo(np.int32).min, 7]
                    * 50, np.int32)
    check((keys, np.arange(keys.size, dtype=np.int32)), 1)
