"""B2: ranking the contracted forest — child links, pointer doubling,
and the Euler walk kernel.

Counterparts: ``_link_children``, ``_euler_rank`` and ``_host_jump`` of
``cause_tpu.weaver.jaxw`` (:80-137, :197-212) and the Pallas walk
``cause_tpu.weaver.pallas_ops.euler_walk``. ``euler_walk`` takes the
plain version (``euler_walk_plain``: ``_euler_rank``'s weighted
preorder rank by pointer doubling) for tensors on the CPU, and launches
the CUDA kernel (``csrc/euler_walk.cu``) for tensors on the card. The
kernel ranks the Euler tour as a list (a ruling set, where the Pallas
kernel walks the whole tour in one thread): one tour slot in 32 is a
splitter (picked by a hash of the slot, which in the split form mixes
its bits both ways), a walk per sublist, the splitter chain ranked, and the reached sublists walked
again to stamp the bases. It takes one of two forms, by the rule
``walk_form``: ``"row"``, one CTA a row in shared memory with one walk
along the splitter chain; ``"split"``, the same steps over (row, block)
CTAs in global scratch with the chain ranked by pointer jumping, for
rows too wide for shared memory. Everything is batched
``[B, K]`` int32.

The walk and the doubling agree on every run the walk reaches. A run it
never reaches keeps the row's total weight in the walk, while the
doubling ranks it along its own stretch of the tour (the v5 kernel's
invalid run slots sort before the root as its siblings and rank 0
there). The kernel masks those slots, so its outputs do not depend on
them, but the plain version gives unreached runs the total too, so that
it equals the walk on every input.
"""

from __future__ import annotations

import math

import torch

from .. import kernels
from ..obs.core import span
from .gatherops import at_set, take1d

__all__ = ["link_children", "euler_rank", "host_jump", "euler_walk",
           "euler_walk_plain", "euler_walk_cuda", "walk_form"]

# csrc/euler_walk.cu: threads a CTA, and one tour slot in
# 2**WALK_LOG_STRIDE is a splitter
WALK_THREADS = 256
WALK_LOG_STRIDE = 5
WALK_FORMS = ("row", "split")  # the kernel's form codes 0 and 1


def walk_row_bytes(K: int) -> int:
    """Shared memory the row form's CTA takes for a row of ``K`` runs:
    int32 weights and bases, four int32 tables a splitter (one tour slot
    in ``2**WALK_LOG_STRIDE`` of next_pow2(2K)), uint16 successors and
    the block's reduction buffer."""
    ns = max(1, (1 << (2 * K - 1).bit_length()) >> WALK_LOG_STRIDE)
    return (2 * K + 4 * ns) * 4 + 2 * K * 2 + WALK_THREADS // 32 * 4


def walk_form(K: int, smem_limit: int) -> str:
    """The form B2 takes for rows of ``K`` runs on a card whose blocks may
    use ``smem_limit`` bytes of shared memory: ``"row"`` where a row fits
    there (its uint16 successors need 2K <= 65535), ``"split"``
    otherwise. Timed on an H100 (``chip_smoke.py --forms``, PERF.md): the
    split form lost at K = 4,096 at every B from 1 to 256 and on the
    merge tree's forests at 8 x 16,384, and won at K = 32,768 and wider
    at every B timed."""
    if 2 * K <= 65535 and walk_row_bytes(K) <= smem_limit:
        return "row"
    return "split"


def link_children(order: torch.Tensor, parent_sort: torch.Tensor):
    """Given lanes sorted into sibling order (``order``) and each lane's
    parent key, link the per-parent child lists: returns
    (first_child, next_sibling) as ``[B, N]`` lane-index tensors
    (-1 = none)."""
    B, N = parent_sort.shape
    p = take1d(parent_sort, order)
    true1 = torch.ones((B, 1), dtype=torch.bool, device=p.device)
    is_start = torch.cat([true1, p[:, 1:] != p[:, :-1]], dim=1)
    same_parent_next = torch.cat([p[:, 1:] == p[:, :-1], ~true1], dim=1)
    succ_in_sort = torch.cat(
        [order[:, 1:], torch.zeros_like(order[:, :1])], dim=1)
    ns_sorted = torch.where(same_parent_next, succ_in_sort, -1)
    next_sibling = at_set(torch.zeros_like(order), order, ns_sorted)
    ok_parent = (p >= 0) & (p < N)
    fc_target = torch.where(is_start & ok_parent, p, N)
    first_child = at_set(
        torch.full((B, N + 1), -1, dtype=torch.int32, device=p.device),
        fc_target, order)[:, :N]
    return first_child.contiguous(), next_sibling.contiguous()


def euler_rank(first_child, next_sibling, parent_up, weights):
    """Weighted preorder rank + subtree weight via an Euler tour (2N
    edges: d(i)=i, u(i)=N+i) and pointer-doubling suffix sums. The rank
    of node i is the total weight strictly before d(i) in the tour."""
    B, N = first_child.shape
    dev = first_child.device
    idx = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    up = N + idx
    next_d = torch.where(first_child >= 0, first_child, up)
    next_u = torch.where(
        next_sibling >= 0, next_sibling,
        torch.where(parent_up >= 0, N + parent_up, up))
    nx = torch.cat([next_d, next_u], dim=1)
    val = torch.cat([weights.to(torch.int32),
                     torch.zeros((B, N), dtype=torch.int32, device=dev)],
                    dim=1)
    for _ in range(max(1, math.ceil(math.log2(2 * N)))):
        val, nx = val + take1d(val, nx), take1d(nx, nx)
    s_down = val[:, :N]
    s_up = val[:, N:]
    total = weights.to(torch.int32).sum(dim=1, keepdim=True,
                                        dtype=torch.int32)
    rank = (total - s_down).to(torch.int32)
    size = (s_down - s_up).to(torch.int32)
    return rank, size


def host_jump(special, cause, steps: int):
    """First non-special ancestor of each lane through the cause chain
    (``cause`` ``[B, M]`` lane indices in range), by ``steps`` rounds of
    pointer doubling where the current host is special. Counterpart of
    ``cause_tpu.weaver.jaxw._host_jump`` (:197-212), which stops once no
    related lane's host is special: after that a round changes no
    related lane (padding and root lanes are never special), so a fixed
    ``ceil(log2(M))`` rounds give the same hosts on every lane the
    caller reads, without reading a flag back from the device a round."""
    host = cause
    for _ in range(steps):
        host = torch.where(take1d(special, host), take1d(host, host), host)
    return host


def euler_walk_plain(fc, ns, parent_run, run_len):
    """The walk's bases by pointer doubling: ``euler_rank``'s rank for
    every run the tour reaches from d(0), the row's total weight for
    the rest. Reachability comes from a second suffix count along the
    same doubling: the tour's successor links have in-degree at most
    one, so d(i) lies after d(0) exactly when both chains end at the
    same terminal and d(i) is no farther from it."""
    B, N = fc.shape
    dev = fc.device
    idx = torch.arange(N, dtype=torch.int32, device=dev).expand(B, N)
    up = N + idx
    next_d = torch.where(fc >= 0, fc, up)
    next_u = torch.where(ns >= 0, ns,
                         torch.where(parent_run >= 0, N + parent_run, up))
    nx = torch.cat([next_d, next_u], dim=1)
    w = run_len.to(torch.int32)
    val = torch.cat([w, torch.zeros_like(w)], dim=1)
    slot = torch.arange(2 * N, dtype=torch.int32, device=dev).expand(B, 2 * N)
    steps = (nx != slot).to(torch.int32)  # 0 at the self-loop terminals
    for _ in range(max(1, math.ceil(math.log2(2 * N)))):
        val, steps, nx = (val + take1d(val, nx), steps + take1d(steps, nx),
                          take1d(nx, nx))
    total = w.sum(dim=1, keepdim=True, dtype=torch.int32)
    rank = (total - val[:, :N]).to(torch.int32)
    term, dist = nx[:, :N], steps[:, :N]
    reached = (term == term[:, :1]) & (dist <= dist[:, :1])
    return torch.where(reached, rank, total).to(torch.int32)


def _check(tables):
    shape = tables[0].shape
    for x in tables:
        if x.dtype != torch.int32:
            raise TypeError(f"euler_walk is int32-only, got {x.dtype}")
        if x.shape != shape or x.dim() != 2:
            raise ValueError("euler_walk takes four equal [B, K] tables")
        if x.device != tables[0].device:
            raise ValueError("euler_walk tables span devices")
        if not x.is_contiguous():
            raise ValueError("euler_walk tables must be contiguous")


def _smem_limit(device_index: int) -> int:
    """Dynamic shared memory a block may use on the card (bytes)."""
    return kernels.device_limits(device_index).smem


def euler_walk_cuda(fc, ns, parent_run, run_len, form=None):
    """Launch the B2 kernel on CUDA tables (see ``csrc/euler_walk.cu``)
    in ``form`` (``"row"`` or ``"split"``; None: the rule's,
    ``walk_form``)."""
    tables = (fc, ns, parent_run, run_len)
    _check(tables)
    if fc.device.type != "cuda":
        raise ValueError(f"euler_walk_cuda needs CUDA tensors, got {fc.device}")
    B, K = fc.shape
    if form is None:
        form = walk_form(K, _smem_limit(fc.device.index))
    split = WALK_FORMS.index(form)
    base = torch.empty_like(fc)
    lib = kernels.library("euler_walk")
    # the split form's arrays
    scratch = (torch.empty(lib.cause_euler_walk_scratch_words(B, K),
                           dtype=torch.int32, device=fc.device)
               if split and B and K else None)
    with torch.cuda.device(fc.device):
        rc = lib.cause_euler_walk(
            fc.data_ptr(), ns.data_ptr(), parent_run.data_ptr(),
            run_len.data_ptr(), base.data_ptr(), B, K, split,
            scratch.data_ptr() if scratch is not None else None,
            kernels.stream_handle(fc.device))
    kernels.check(rc, "euler_walk")
    kernels.launches["euler_walk"] += 1
    return base


def euler_walk(fc, ns, parent_run, run_len):
    """Weighted preorder base per run of each row's contracted forest:
    the ``[B, K]`` first_child / next_sibling tables from
    ``link_children``, parent run ids (-1 at roots and invalid slots)
    and run lengths (0 at invalid slots). Runs not reached from run 0
    get the row's total weight. The plain version on the CPU, the B2
    kernel on the card."""
    dev = fc.device
    with span("kernel.b2", on=fc, rows=fc.shape[0], lanes=fc.shape[-1],
              operands=4, keys=0) as sp:
        if dev.type == "cpu":
            base = euler_walk_plain(fc, ns, parent_run, run_len)
        elif dev.type == "cuda":
            base = euler_walk_cuda(fc, ns, parent_run, run_len)
        else:
            raise ValueError(f"no euler_walk for device {dev}")
        if sp.live:
            sp.set(form="plain" if dev.type == "cpu" else walk_form(
                fc.shape[-1], _smem_limit(dev.index)),
                bytes=kernels.contract_bytes(fc, ns, parent_run, run_len,
                                             base))
        return base
