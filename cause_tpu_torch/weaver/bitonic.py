"""B1: the kernels' row sort — range-compressed radix sorts.

Counterpart of ``cause_tpu.weaver.bitonic.sort_pairs`` and of the
Pallas kernel it switches to (``cause_tpu.weaver.pallas_sort``): sort
int32 ``[B, n]`` operands along the last axis, ascending and
lexicographic over the first ``num_keys`` operands, ties broken by the
original position (so the result is THE stable order, for every input,
duplicates and int32-max sentinels included); the other operands ride
as payloads.

``sort_pairs`` takes the plain version for tensors on the CPU and
launches the CUDA kernel (``csrc/sort.cu``) for tensors on the card.
There is no fallback between the two. The kernel takes one of three
forms, by the rule ``b1_form`` on P = next_pow2(n) and the key count:

- ``"radix"``: one or two keys and 256 <= P <= 8192 (every site of the
  wave): one CTA a row, stable LSD radix passes over the keys
  compressed to the bits their range spans (``csrc/radix.cuh``);
- ``"wide"``: P > 8192, or keys and positions too large for a block's
  shared memory: the same idea over a row spread across CTAs, each
  digit pass one launch through global memory (a tile finds its offsets
  by a look-back over the row's earlier tiles), on scratch this wrapper
  allocates at the size the library names
  (``cause_sort_wide_scratch_bytes``; ``csrc/radix_wide.cuh``); how many
  passes a row takes is decided on the card, and nothing is read back;
- ``"network"``: every other row (P < 256, or three or more keys that
  fit): a bitonic network in shared memory (``csrc/bitonic.cuh``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .. import kernels

__all__ = ["sort_pairs", "sort_pairs_plain", "sort_pairs_cuda", "b1_form"]

MAX_OPS = 9
RADIX_MIN_P, RADIX_MAX_P = 256, 8192  # csrc/radix.cuh


def b1_form(n: int, num_keys: int, smem_limit: int) -> str:
    """The form B1 takes for rows of ``n`` lanes and ``num_keys`` keys on
    a card whose blocks may use ``smem_limit`` bytes of shared memory
    (``csrc/sort.cu``'s ``sort_form`` mirrors it): ``"radix"`` at one or
    two keys and 256 <= P <= 8192, ``"wide"`` at P > 8192 or where the
    network's keys and positions would not fit, ``"network"``
    otherwise."""
    P = 1 << max(0, (n - 1).bit_length())
    if num_keys <= 2 and RADIX_MIN_P <= P <= RADIX_MAX_P:
        return "radix"
    if P > RADIX_MAX_P or (num_keys + 1) * P * 4 > smem_limit:
        return "wide"
    return "network"


def sort_pairs_plain(operands: Sequence[torch.Tensor],
                     num_keys: int = 1) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version: successive stable sorts, least
    significant key first, then one gather of every operand."""
    operands = tuple(operands)
    first = operands[0]
    perm = torch.arange(first.shape[-1], device=first.device)
    perm = perm.expand(first.shape).contiguous()
    for key in reversed(operands[:num_keys]):
        k = torch.gather(key, -1, perm)
        idx = torch.sort(k, dim=-1, stable=True).indices
        perm = torch.gather(perm, -1, idx)
    return tuple(torch.gather(x, -1, perm) for x in operands)


def _check(operands, num_keys):
    if not 1 <= len(operands) <= MAX_OPS:
        raise ValueError(f"sort takes 1..{MAX_OPS} operands, got {len(operands)}")
    if not 1 <= num_keys <= len(operands):
        raise ValueError(f"num_keys {num_keys} outside 1..{len(operands)}")
    shape = operands[0].shape
    dev = operands[0].device
    for x in operands:
        if x.dtype != torch.int32:
            raise TypeError(f"sort is int32-only, got {x.dtype}")
        if x.shape != shape or x.dim() != 2:
            raise ValueError(f"sort takes equal [B, n] operands, got "
                             f"{[tuple(o.shape) for o in operands]}")
        if x.device != dev:
            raise ValueError("sort operands span devices")
        if not x.is_contiguous():
            raise ValueError("sort operands must be contiguous")


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    """Dynamic shared memory a block may use on the card (bytes)."""
    with torch.cuda.device(device_index):
        return kernels.library("sort").cause_sort_smem_limit()


def sort_pairs_cuda(operands: Sequence[torch.Tensor],
                    num_keys: int = 1) -> Tuple[torch.Tensor, ...]:
    """Launch the B1 kernel on CUDA operands (see ``csrc/sort.cu``)."""
    operands = tuple(operands)
    _check(operands, num_keys)
    x0 = operands[0]
    if x0.device.type != "cuda":
        raise ValueError(f"sort_pairs_cuda needs CUDA tensors, got {x0.device}")
    B, n = x0.shape
    n_ops = len(operands)
    outs = tuple(torch.empty_like(x) for x in operands)
    lib = kernels.library("sort")
    scratch, nbytes = None, 0
    with torch.cuda.device(x0.device):
        if b1_form(n, num_keys, _smem_limit(x0.device.index)) == "wide":
            nbytes = lib.cause_sort_wide_scratch_bytes(B, n, num_keys)
            scratch = torch.empty(nbytes, dtype=torch.uint8,
                                  device=x0.device)
        ins = (ctypes.c_void_p * n_ops)(*[x.data_ptr() for x in operands])
        outp = (ctypes.c_void_p * n_ops)(*[o.data_ptr() for o in outs])
        rc = lib.cause_sort_rows(
            ins, outp, n_ops, num_keys, B, n,
            scratch.data_ptr() if scratch is not None else None, nbytes,
            kernels.stream_handle(x0.device))
    kernels.check(rc, "sort")
    kernels.launches["sort"] += 1
    return outs


def sort_pairs(operands: Sequence[torch.Tensor],
               num_keys: int = 1) -> Tuple[torch.Tensor, ...]:
    """Sort ``[B, n]`` int32 operands row by row (module docstring):
    the plain version on the CPU, the B1 kernel on the card."""
    dev = operands[0].device
    if dev.type == "cpu":
        return sort_pairs_plain(operands, num_keys)
    if dev.type == "cuda":
        return sort_pairs_cuda(operands, num_keys)
    raise ValueError(f"no sort for device {dev}")
