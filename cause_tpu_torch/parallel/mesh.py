"""The per-replica convergence digest.

Counterpart of ``mix32`` / ``mix32_np`` / ``replica_digest`` in
``cause_tpu.parallel.mesh`` (the ``mesh=`` sharding of that module is
not ported yet). The digest is an order-sensitive, lane-order-blind
fingerprint of one replica's weave: every kept lane goes through a
murmur3-style avalanche of (id, weave position, visibility), and the
terms sum with uint32 wraparound.

PyTorch has no uint32 arithmetic, so the terms live in int32 with
two's-complement wraparound, which has the same low 32 bits as uint32
arithmetic for every add and multiply: the uint32 constants become
their signed twins, and a logical right shift is the arithmetic shift
masked to the bits that stay (``x >> 16`` keeps 16, ``x >> 13`` keeps
19). The result is bit-identical to the JAX digest on the same
marshalled arrays; ``np.asarray(d).astype(np.uint32)`` (or
``.view(np.uint32)``) reads a digest as the reference's uint32.

SCOPE: comparable only within one interner domain — hi/lo encode
site RANKS, which are assigned per process (first seen, first ranked).
Compare digests of the same marshalled arrays, never across two
processes' (or two packages') handle marshals.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["mix32", "mix32_np", "replica_digest"]


def _s32(c: int) -> int:
    """The int32 twin of a uint32 constant."""
    return c - (1 << 32) if c >= 1 << 31 else c


_C_HI = _s32(0x9E3779B1)
_C_LO = _s32(0x85EBCA77)
_C_POS = _s32(0xC2B2AE35)
_C_VIS = 40503
_C_F1 = _s32(0x85EBCA6B)
_C_F2 = _s32(0xC2B2AE35)


def mix32(hi, lo, pos, visible) -> torch.Tensor:
    """The per-lane avalanche term, int32 holding the uint32 bits: the
    one device copy, which ``replica_digest`` sums over a replica's kept
    lanes and the delta wave (``weaver.torchwd.batched_delta_weave``)
    over window lanes at offset positions."""
    i32 = torch.int32
    x = (hi.to(i32) * _C_HI + lo.to(i32) * _C_LO + pos.to(i32) * _C_POS
         + visible.to(i32) * _C_VIS + 1)
    x = x ^ ((x >> 16) & 0xFFFF)
    x = x * _C_F1
    x = x ^ ((x >> 13) & 0x7FFFF)
    x = x * _C_F2
    x = x ^ ((x >> 16) & 0xFFFF)
    return x


def mix32_np(hi, lo, pos, visible) -> np.ndarray:
    """Numpy twin of ``mix32`` in uint32, copied from the reference:
    the session and the merge tree freeze a resident prefix's digest
    contribution with it on the host, so it must stay bit-identical to
    ``mix32`` (tests/test_torch_delta.py pins the two)."""
    x = (
        hi.astype(np.uint32) * np.uint32(0x9E3779B1)
        + lo.astype(np.uint32) * np.uint32(0x85EBCA77)
        + pos.astype(np.uint32) * np.uint32(0xC2B2AE35)
        + visible.astype(np.uint32) * np.uint32(40503)
        + np.uint32(1)
    )
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def replica_digest(hi, lo, rank, visible) -> torch.Tensor:
    """``[B]`` int32 digests (the uint32 bits) of ``[B, m]`` replicas:
    the wraparound sum of the kept lanes' (rank < m) terms."""
    m = rank.shape[-1]
    kept = rank < m
    x = mix32(hi, lo, torch.where(kept, rank, 0), visible)
    return torch.where(kept, x, 0).sum(dim=-1, dtype=torch.int32)
