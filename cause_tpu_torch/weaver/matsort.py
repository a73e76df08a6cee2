"""Matrix rank-sort: a comparator-free stable sort as plain PyTorch ops.

Port of ``cause_tpu.weaver.matsort``, where it is one of the JAX
package's switchable sort strategies for the kernels' few-thousand-lane
token sorts. Each element's stable-sort position is counted with a
blocked O(n^2) lexicographic comparison against the whole row (the
original position is the last key, so ranks are unique and the result
is THE stable order); the permutation is inverted by one scatter of the
positions to their ranks and applied by gathers. The blocks bound each
step's compare tensor to ``[B, block, n]``.

Same contract as ``bitonic.sort_pairs``: int32 ``[..., n]`` operands,
sorted along the last axis, ascending and lexicographic over the first
``num_keys``, the rest riding as payloads; keys may span the full int32
range, sentinels included. The port has no sort switch or strategy
registry, so no path calls it: it stands beside ``sort_pairs_plain`` and
the B1 kernel as a third, independent form of the same sort.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["matrix_sort"]

# query rows compared against the whole row per step
_BLOCK = 256


def _lex_lt(keys, qkeys) -> torch.Tensor:
    """``[B, q, n]``: element j of the row sorts strictly before query
    element i. The last key is the position, so ties are broken."""
    lt = eq = None
    for kf, kq in zip(keys, qkeys):
        a = kf[:, None, :]
        b = kq[:, :, None]
        if lt is None:
            lt, eq = a < b, a == b
        else:
            lt = lt | (eq & (a < b))
            eq = eq & (a == b)
    return lt


def _matrix_sort_rows(operands, num_keys: int):
    B, n = operands[0].shape
    dev = operands[0].device
    iota = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    keys = [x for x in operands[:num_keys]] + [iota]
    rank = torch.empty((B, n), dtype=torch.int32, device=dev)
    for s in range(0, n, _BLOCK):
        q = [k[:, s:s + _BLOCK] for k in keys]
        rank[:, s:s + _BLOCK] = _lex_lt(keys, q).sum(dim=-1,
                                                     dtype=torch.int32)
    # invert the permutation (ranks are unique): src[r] = the element
    # whose rank is r
    src = torch.empty((B, n), dtype=torch.int64, device=dev)
    src.scatter_(1, rank.long(), iota.long())
    return tuple(torch.gather(x, -1, src) for x in operands)


def matrix_sort(operands: Sequence[torch.Tensor],
                num_keys: int = 1) -> Tuple[torch.Tensor, ...]:
    """Stable last-axis lexicographic sort (module docstring). Leading
    dimensions are flattened into rows."""
    operands = tuple(operands)
    shape = operands[0].shape
    flat = [x.reshape(-1, shape[-1]) for x in operands]
    return tuple(x.reshape(shape)
                 for x in _matrix_sort_rows(flat, num_keys))
