"""Multi-device execution and the per-replica convergence digest.

Counterpart of ``cause_tpu.parallel.mesh``.

The mesh. The reference shards the replica axis of a batched merge over
a ``jax.sharding.Mesh`` with ``shard_map``, one process driving every
device. The port is SPMD over ``torch.distributed``: one process per
device, joined in one process group, and a one-dimensional
``DeviceMesh`` whose dimension (``REPLICA_AXIS``) is the replica axis.
Seen from each rank the contract is the reference's:

- every rank calls a sharded step with the same global ``[B, ...]``
  inputs (numpy arrays or tensors);
- rank ``r`` of ``W`` takes the contiguous block of rows ``[r*B/W,
  (r+1)*B/W)`` (the block ``shard_map`` gives device ``r``) to its own
  device and runs the batched kernel of its generation on it;
- every rank returns the global outputs: the per-row ones (``order``,
  ``rank``, ``visible``, ``overflow``, ``digest``) gathered over the
  group in rank order, the fleet totals (``total_visible``,
  ``n_conflicts``, ``n_overflow``) summed over it with ``all_reduce``
  (the reference's ``psum``), as tensors on the rank's device.

A batch that does not divide the mesh raises, as ``shard_map`` refuses
it. The reference's steps are jitted programs cached per mesh, budgets
and trace-time switches; the port compiles nothing per shape and has no
switches, so it keeps no step cache. ``parallel.ranks.run_ranks`` starts
the ranks of a mesh on one host.

The digest is an order-sensitive, lane-order-blind fingerprint of one
replica's weave: every kept lane goes through a murmur3-style avalanche
of (id, weave position, visibility), and the terms sum with uint32
wraparound.

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

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..obs.core import span

__all__ = [
    "REPLICA_AXIS",
    "make_mesh",
    "mix32",
    "mix32_np",
    "replica_digest",
    "sharded_merge_weave",
    "sharded_merge_weave_v4",
    "sharded_merge_weave_v5",
]

REPLICA_AXIS = "replicas"


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
    with span("replica.digest", on=rank,
              rows=rank.shape[0] if rank.dim() > 1 else 1, lanes=m):
        kept = rank < m
        x = mix32(hi, lo, torch.where(kept, rank, 0), visible)
        return torch.where(kept, x, 0).sum(dim=-1, dtype=torch.int32)


# ------------------------------------------------------------- the mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = REPLICA_AXIS,
              device=None):
    """A one-dimensional ``DeviceMesh`` named ``axis`` over every rank of
    the default process group, on ``device``'s type (the package default
    when None, so CUDA unless ``use_device`` said otherwise: without a
    card it raises). Each rank's device is ``cuda:{rank % cards}`` or the
    CPU.

    With a default group, ``n_devices`` must be None or the group's
    size: a mesh spans the whole group (the reference's sub-mesh of the
    first ``n_devices`` devices has no SPMD counterpart, since every
    rank would have to agree to sit out), and its backend must be the
    device's (NCCL for CUDA, gloo for the CPU). Without one, ``n_devices``
    None or 1 starts a group of one rank on an in-memory store (NCCL on
    a card, gloo on the CPU); more ranks than one raises, as they need
    processes of their own (``parallel.ranks.run_ranks``)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        world = dist.get_world_size()
        # a group of several backends ("cpu:gloo,cuda:nccl") names each
        if backend not in dist.get_backend():
            raise ValueError(
                f"make_mesh(device={str(dev)!r}): the process group runs "
                f"{dist.get_backend()}, and a {dev.type} mesh needs a "
                f"{backend} group")
        if n_devices is not None and n_devices != world:
            raise ValueError(
                f"make_mesh({n_devices}): the process group has {world} "
                f"ranks, and a mesh spans all of them")
    elif n_devices not in (None, 1):
        raise ValueError(
            f"make_mesh({n_devices}): no process group; start {n_devices} "
            f"ranks with cause_tpu_torch.parallel.ranks.run_ranks")
    if dev.type == "cuda":
        rank = dist.get_rank() if dist.is_initialized() else 0
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return init_device_mesh(dev.type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def _rank_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local(mesh, keys, arrays):
    """This rank's device and its contiguous block of each global ``[B,
    ...]`` array's rows, uploaded as the ``benchgen`` lane of its key
    (``keys[i]`` names ``arrays[i]``)."""
    from ..benchgen import lane_tensor

    B, W = len(arrays[0]), mesh.size()
    if B % W:
        raise ValueError(
            f"a batch of {B} rows does not divide the {W}-rank mesh")
    n, r = B // W, mesh.get_local_rank()
    rows = slice(r * n, (r + 1) * n)
    dev = _rank_device(mesh)
    return dev, [lane_tensor(k, x[rows], dev) for k, x in zip(keys, arrays)]


def _gather(mesh, *xs):
    """Each rank's ``[n, ...]`` rows of every ``x`` as the global ``[W*n,
    ...]`` tensor, in rank order, on every rank. Flags travel as uint8."""
    group, W = mesh.get_group(), mesh.size()
    out = []
    for x in xs:
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(wire) for _ in range(W)]
        dist.all_gather(parts, wire, group=group)
        full = torch.cat(parts)
        out.append(full.bool() if x.dtype == torch.bool else full)
    return out


def _fleet_reductions(mesh, hi, lo, rank, visible, conflict, overflow):
    """This rank's per-row digests and the fleet totals every step
    reports, summed over the mesh (int32, wrapping as ``psum`` does).
    ``hi``/``lo`` may come in any lane order that matches ``rank``'s
    coordinates: the digest's sum is blind to lane order."""
    digest = replica_digest(hi, lo, rank, visible)
    i32 = torch.int32
    totals = torch.stack([visible.sum(dtype=i32), conflict.sum(dtype=i32),
                          overflow.sum(dtype=i32)])
    dist.all_reduce(totals, group=mesh.get_group())
    total_visible, n_conflicts, n_overflow = totals.unbind()
    return digest, total_visible, n_conflicts, n_overflow


def _fleet_stats(mesh, hi, lo, order, rank, visible, conflict, overflow):
    """The v1-v4 epilogue: the id lanes put in sorted order by ``order``
    (their ranks index sorted lanes), the digests and totals, and the
    per-row outputs gathered."""
    idx = order.long()
    digest, total_visible, n_conflicts, n_overflow = _fleet_reductions(
        mesh, torch.take_along_dim(hi, idx, 1),
        torch.take_along_dim(lo, idx, 1), rank, visible, conflict, overflow)
    order, rank, visible, digest = _gather(mesh, order, rank, visible,
                                           digest)
    return (order, rank, visible, digest, total_visible, n_conflicts,
            n_overflow)


def sharded_merge_weave(mesh, hi, lo, cause_hi, cause_lo, vclass, valid,
                        k_max: int = 0, kernel: str = "v3"):
    """The batched merge+weave with the replica axis split over the mesh
    (``benchgen.LANE_KEYS`` lanes). Returns ``(order, rank, visible,
    digest, total_visible, n_conflicts, n_overflow)``: per-replica rows
    and fleet totals. ``k_max`` > 0 runs a compressed kernel with that
    run budget, ``kernel`` "v3" (sparse-irregular, ``torchw3``) or any
    other value the chain-compressed v2 (``torchw``); rows counted in
    ``n_overflow`` carry unspecified ranks and want ``k_max=0`` (v1) or
    a bigger budget. The batch must divide the mesh."""
    from ..benchgen import LANE_KEYS

    dev, (hi, lo, chi, clo, vc, va) = _local(
        mesh, LANE_KEYS, (hi, lo, cause_hi, cause_lo, vclass, valid))
    if k_max > 0:
        if kernel == "v3":
            from ..weaver.torchw3 import batched_merge_weave_v3 as step
        else:
            from ..weaver.torchw import batched_merge_weave_v2 as step
        order, rank, visible, conflict, overflow = step(
            hi, lo, chi, clo, vc, va, k_max=k_max, device=dev)
    else:
        from ..weaver.torchw import batched_merge_weave

        order, rank, visible, conflict = batched_merge_weave(
            hi, lo, chi, clo, vc, va, device=dev)
        overflow = torch.zeros_like(conflict)
    return _fleet_stats(mesh, hi, lo, order, rank, visible, conflict,
                        overflow)


def sharded_merge_weave_v4(mesh, hi, lo, cci, vclass, valid, k_max: int):
    """``sharded_merge_weave`` for the v4 kernel (``torchw4``, the
    ``benchgen.LANE_KEYS4`` lanes: ``cci`` is each lane's cause index
    in the concatenated pre-sort row). Same outputs; the batch must
    divide the mesh."""
    from ..benchgen import LANE_KEYS4
    from ..weaver.torchw4 import batched_merge_weave_v4

    dev, (hi, lo, cci, vc, va) = _local(mesh, LANE_KEYS4,
                                        (hi, lo, cci, vclass, valid))
    order, rank, visible, conflict, overflow = batched_merge_weave_v4(
        hi, lo, cci, vc, va, k_max=k_max, device=dev)
    return _fleet_stats(mesh, hi, lo, order, rank, visible, conflict,
                        overflow)


def sharded_merge_weave_v5(mesh, lanes, u_max: int, k_max: int,
                           pipeline: str = "v5"):
    """The v5 segment-union merge with the replica axis split over the
    mesh: ``lanes`` is the ``benchgen.LANE_KEYS5`` dict of ``[B, ...]``
    arrays. Returns ``(rank, visible, overflow, digest, total_visible,
    n_conflicts, n_overflow)``: rank and visibility per concat lane (no
    ``order`` in the v5 contract), and the per-row overflow flags,
    whose rows carry unspecified ranks and must run again. ``pipeline``
    "v5f" runs the fused token pipeline (``torchw5f``), any other value
    ``torchw5``. The batch must divide the mesh."""
    from ..benchgen import LANE_KEYS5

    if pipeline == "v5f":
        from ..weaver.torchw5f import batched_merge_weave_v5f as step
    else:
        from ..weaver.torchw5 import batched_merge_weave_v5 as step
    dev, args = _local(mesh, LANE_KEYS5, [lanes[k] for k in LANE_KEYS5])
    rank, visible, conflict, overflow = step(*args, u_max=u_max,
                                             k_max=k_max, device=dev)
    digest, total_visible, n_conflicts, n_overflow = _fleet_reductions(
        mesh, args[0], args[1], rank, visible, conflict, overflow)
    rank, visible, overflow, digest = _gather(mesh, rank, visible, overflow,
                                              digest)
    return (rank, visible, overflow, digest, total_visible, n_conflicts,
            n_overflow)
