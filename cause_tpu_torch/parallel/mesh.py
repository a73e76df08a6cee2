"""The per-replica convergence digest.

Counterpart of ``mix32`` / ``replica_digest`` in
``cause_tpu.parallel.mesh`` (the ``mesh=`` sharding of that module is
not ported yet). The digest is an order-sensitive, lane-order-blind
fingerprint of one replica's weave: every kept lane goes through a
murmur3-style avalanche of (id, weave position, visibility), and the
terms sum with uint32 wraparound.

PyTorch has no full uint32 arithmetic, so the terms live in int64 with
``& 0xFFFFFFFF`` after every multiply and add; a 32x32-bit product is
taken in two 16-bit halves so no int64 intermediate overflows. The
result is bit-identical to the JAX digest on the same marshalled
arrays.

SCOPE: comparable only within one interner domain — hi/lo encode
site RANKS, which are assigned per process (first seen, first ranked).
Compare digests of the same marshalled arrays, never across two
processes' (or two packages') handle marshals.
"""

from __future__ import annotations

import torch

__all__ = ["mix32", "replica_digest"]

_MASK = 0xFFFFFFFF


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _MASK


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for x in [0, 2^32): the product in 16-bit
    halves of ``c`` (each partial product < 2^48)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def mix32(hi, lo, pos, visible) -> torch.Tensor:
    """The per-lane avalanche term (int64 holding a uint32)."""
    x = (_mul32(_u32(hi), 0x9E3779B1)
         + _mul32(_u32(lo), 0x85EBCA77)
         + _mul32(_u32(pos), 0xC2B2AE35)
         + _mul32(_u32(visible), 40503)
         + 1) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def replica_digest(hi, lo, rank, visible) -> torch.Tensor:
    """``[B]`` digests (int64 holding uint32) of ``[B, m]`` replicas:
    the wraparound sum of the kept lanes' (rank < m) terms."""
    m = rank.shape[-1]
    kept = rank < m
    pos = torch.where(kept, rank, 0)
    x = mix32(hi, lo, pos, visible)
    return torch.where(kept, x, 0).sum(dim=-1) & _MASK
