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
There is no fallback between the two. The kernel takes one of four
forms, by the rule ``b1_form`` on P = next_pow2(n), the key count and
the card's limits (``b1_limits``: a block's opt-in shared memory, and
how large a cluster the card co-schedules), decided here alone and
passed to the library as a form code:

- ``"radix"``: one or two keys and 256 <= P <= 8192 (every site of the
  wave): one CTA a row, stable LSD radix passes over the keys
  compressed to the bits their range spans (``csrc/radix.cuh``);
- ``"network"``: P < 256, or three or more keys at P <= 8192 whose keys
  and positions fit a block's shared memory: a bitonic network in
  shared memory (``csrc/bitonic.cuh``). The cluster form takes these
  rows too, but at 1,024 rows of 16-64 lanes the network took 1.2-3.0x
  less time on an H100, and at a few rows the two tie
  (``chip_smoke.py --tiles``);
- ``"cluster"``: every other row that a thread-block cluster holds, C =
  ceil(n / L) CTAs of L lanes (``cluster_lanes``) with C no larger than
  the card co-schedules (up to 16 x 8,192 = 131,072 lanes): the radix
  passes over the row in the cluster's distributed shared memory, one
  launch, no scratch (``csrc/radix_cluster.cuh``);
- ``"wide"``: rows past the cluster's reach: the radix passes over a row
  spread across (row, tile) CTAs of 4,096 lanes, each digit pass
  one launch through global memory (a tile finds its offsets by a
  look-back over the row's earlier tiles), on scratch this wrapper
  allocates at the size the library names
  (``cause_sort_wide_scratch_bytes``; ``csrc/radix_wide.cuh``); how many
  passes a row takes is decided on the card, and nothing is read back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from .. import kernels

__all__ = ["sort_pairs", "sort_pairs_plain", "sort_pairs_cuda", "b1_form",
           "b1_forms", "b1_limits", "cluster_lanes", "B1Limits"]

MAX_OPS = 9                            # csrc/sort.cu: CAUSE_SORT_MAX_OPS
RADIX_MIN_P, RADIX_MAX_P = 256, 8192  # csrc/radix.cuh
CLUSTER_MAX = 16                      # csrc/radix_cluster.cuh
# the cluster form's lanes a CTA, in the order of cause_sort_cluster_reach
CLUSTER_LANES = (4096, 8192)
B1_FORMS = ("radix", "network", "cluster", "wide")  # form codes 0-3


class B1Limits(NamedTuple):
    """What B1's rule reads of a card: the dynamic shared memory a block
    may use (bytes), and per CTA width of the cluster form (lanes) the
    largest cluster the card co-schedules (0: none)."""
    smem: int
    clusters: Tuple[Tuple[int, int], ...]


@functools.lru_cache(maxsize=None)
def b1_limits(device_index: int) -> B1Limits:
    """The card's limits for B1's rule, asked once per device and
    process: the shared memory from ``kernels.device_limits``, the
    cluster reach from ``cudaOccupancyMaxActiveClusters``
    (``cause_sort_cluster_reach``)."""
    out = (ctypes.c_int * len(CLUSTER_LANES))()
    with torch.cuda.device(device_index):
        kernels.check(kernels.library("sort").cause_sort_cluster_reach(out),
                      "cluster reach")
    return B1Limits(kernels.device_limits(device_index).smem,
                    tuple(zip(CLUSTER_LANES, out)))


def cluster_lanes(n: int, limits: B1Limits) -> int:
    """Lanes a CTA of the cluster form for rows of ``n`` lanes: the
    first width of ``CLUSTER_LANES`` at which ceil(n / L) CTAs make a
    cluster the card co-schedules (``limits.clusters``), or 0 where none
    reaches."""
    for lanes, most in limits.clusters:
        if -(-n // lanes) <= min(most, CLUSTER_MAX):
            return lanes
    return 0


def b1_forms(n: int, num_keys: int, limits: B1Limits) -> tuple:
    """Every form B1 can take for rows of ``n`` lanes and ``num_keys``
    keys on the card of ``limits``, the rule's first."""
    P = 1 << max(0, (n - 1).bit_length())
    forms = []
    if num_keys <= 2 and RADIX_MIN_P <= P <= RADIX_MAX_P:
        forms.append("radix")
    if P <= RADIX_MAX_P and (num_keys + 1) * P * 4 <= limits.smem:
        forms.append("network")
    if cluster_lanes(n, limits):
        forms.append("cluster")
    forms.append("wide")
    return tuple(forms)


def b1_form(n: int, num_keys: int, limits: B1Limits) -> str:
    """The form B1 takes for rows of ``n`` lanes and ``num_keys`` keys on
    the card of ``limits``: ``"radix"`` at one or two keys and 256 <= P
    <= 8192, ``"network"`` where the network's keys and positions fit a
    block's shared memory at P <= 8192, ``"cluster"`` where a cluster the
    card co-schedules holds the row, ``"wide"`` otherwise."""
    return b1_forms(n, num_keys, limits)[0]


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


def sort_pairs_cuda(operands: Sequence[torch.Tensor], num_keys: int = 1,
                    form: str = None, lanes: int = None
                    ) -> Tuple[torch.Tensor, ...]:
    """Launch the B1 kernel on CUDA operands (see ``csrc/sort.cu``) in
    ``form`` (None: the rule's, ``b1_form``), the cluster form at
    ``lanes`` a CTA (None: ``cluster_lanes``)."""
    operands = tuple(operands)
    _check(operands, num_keys)
    x0 = operands[0]
    if x0.device.type != "cuda":
        raise ValueError(f"sort_pairs_cuda needs CUDA tensors, got {x0.device}")
    B, n = x0.shape
    n_ops = len(operands)
    outs = tuple(torch.empty_like(x) for x in operands)
    lib = kernels.library("sort")
    limits = b1_limits(x0.device.index)
    if form is None:
        form = b1_form(n, num_keys, limits)
    if form != "cluster":
        lanes = 0
    elif lanes is None:
        lanes = cluster_lanes(n, limits)
    scratch, nbytes = None, 0
    if form == "wide" and B and n:
        nbytes = lib.cause_sort_wide_scratch_bytes(B, n, num_keys)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x0.device)
    with torch.cuda.device(x0.device):
        ins = (ctypes.c_void_p * n_ops)(*[x.data_ptr() for x in operands])
        outp = (ctypes.c_void_p * n_ops)(*[o.data_ptr() for o in outs])
        rc = lib.cause_sort_rows(
            ins, outp, n_ops, num_keys, B, n, B1_FORMS.index(form), lanes,
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
