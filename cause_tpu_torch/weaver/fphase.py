"""B3: the v5 F-phase — expanding token results back to concat lanes.

Counterpart of ``cause_tpu.weaver.pallas_fphase.fphase_expand`` and of
the XLA form it replaces (``cause_tpu.weaver.jaxw5``, phase F). Per row
and lane: the rank is the base of the last kept token at or before the
lane plus the lane's offset from that token, for valid lanes that a
surviving segment covers or that carry a token of their own (else N);
visibility drops specials, lanes killed from outside (``flags`` bit 1)
and lanes followed by a tombstone in the same covered segment.

``fphase_expand`` takes the plain version for tensors on the CPU and
launches the CUDA kernel (``csrc/fphase.cu``) for tensors on the card.
"""

from __future__ import annotations

import torch

from .. import kernels
from .arrays import VCLASS_H_HIDE, VCLASS_HIDE

__all__ = ["fphase_expand", "fphase_expand_plain", "fphase_expand_cuda"]


def fphase_expand_plain(lk, tb_l, cov_start, cov_end, vclass, seg, flags):
    """The plain PyTorch version: one searchsorted per lane into the
    sorted token lanes and into the sorted coverage starts (what the XLA
    form's delta scatters and cumsums telescope to)."""
    B, N = vclass.shape
    lane = torch.arange(N, dtype=torch.int32, device=vclass.device)
    lane = lane.expand(B, N).contiguous()

    j = torch.searchsorted(lk.contiguous(), lane, right=True) - 1
    found = j >= 0
    jc = j.clamp(min=0)
    base_f = torch.where(found, torch.gather(tb_l, 1, jc), 0)
    lane_f = torch.where(found, torch.gather(lk, 1, jc), 0)
    has_tok = found & (lane_f == lane)

    js = torch.searchsorted(cov_start.contiguous(), lane, right=True) - 1
    end = torch.where(js >= 0, torch.gather(cov_end, 1, js.clamp(min=0)), 0)
    in_surv = end > lane

    valid = (flags & 1) > 0
    killed_ext = (flags & 2) > 0
    rank = torch.where(valid & (in_surv | has_tok), base_f + (lane - lane_f),
                       N).to(torch.int32)

    hide = (vclass == VCLASS_HIDE) | (vclass == VCLASS_H_HIDE)
    false1 = torch.zeros((B, 1), dtype=torch.bool, device=vclass.device)
    nxt_same = torch.cat(
        [(seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] >= 0), false1], dim=1)
    nxt_hide = torch.cat([hide[:, 1:], false1], dim=1)
    kill_in = in_surv & nxt_same & nxt_hide
    visible = valid & (rank < N) & (vclass == 0) & ~killed_ext & ~kill_in
    return rank, visible


def _check(lk, tb_l, cov_start, cov_end, vclass, seg, flags):
    tensors = (lk, tb_l, cov_start, cov_end, vclass, seg, flags)
    for x in tensors:
        if x.dtype != torch.int32:
            raise TypeError(f"fphase_expand is int32-only, got {x.dtype}")
        if x.dim() != 2 or x.device != lk.device:
            raise ValueError("fphase_expand takes [B, width] tensors on "
                             "one device")
        if not x.is_contiguous():
            raise ValueError("fphase_expand inputs must be contiguous")
    B = vclass.shape[0]
    if (lk.shape != tb_l.shape or cov_start.shape != cov_end.shape
            or vclass.shape != seg.shape or vclass.shape != flags.shape
            or lk.shape[0] != B or cov_start.shape[0] != B):
        raise ValueError(
            "fphase_expand shapes: lk/tb [B, U], cs/ce [B, S], "
            f"vc/seg/flags [B, N]; got {[tuple(x.shape) for x in tensors]}")
    if lk.shape[1] < 1 or cov_start.shape[1] < 1:
        raise ValueError("fphase_expand needs U >= 1 and S >= 1")


def fphase_expand_cuda(lk, tb_l, cov_start, cov_end, vclass, seg, flags):
    """Launch the B3 kernel on CUDA tensors (see ``csrc/fphase.cu``)."""
    _check(lk, tb_l, cov_start, cov_end, vclass, seg, flags)
    if lk.device.type != "cuda":
        raise ValueError(f"fphase_expand_cuda needs CUDA tensors, got {lk.device}")
    B, N = vclass.shape
    rank = torch.empty_like(vclass)
    vis = torch.empty(vclass.shape, dtype=torch.bool, device=vclass.device)
    lib = kernels.library("fphase")
    with torch.cuda.device(lk.device):
        rc = lib.cause_fphase_expand(
            lk.data_ptr(), tb_l.data_ptr(), cov_start.data_ptr(),
            cov_end.data_ptr(), vclass.data_ptr(), seg.data_ptr(),
            flags.data_ptr(), rank.data_ptr(), vis.data_ptr(),
            B, N, lk.shape[1], cov_start.shape[1],
            kernels.stream_handle(lk.device))
    kernels.check(rc, "fphase")
    kernels.launches["fphase"] += 1
    return rank, vis


def fphase_expand(lk, tb_l, cov_start, cov_end, vclass, seg, flags):
    """Per-lane ``(rank, visible)`` for ``[B, N]`` rows from phase F's
    lane-sorted kept tokens (``lk``: lanes with N past the kept prefix,
    ``tb_l``: their bases), the SORTED surviving-segment coverage table
    (``cov_start`` ascending with sentinel start N / end 0), the lanes'
    value classes and segment ordinals, and ``flags`` (bit 0 valid, bit
    1 killed from outside). The plain version on the CPU, the B3 kernel
    on the card; any N."""
    dev = lk.device
    if dev.type == "cpu":
        return fphase_expand_plain(lk, tb_l, cov_start, cov_end, vclass,
                                   seg, flags)
    if dev.type == "cuda":
        return fphase_expand_cuda(lk, tb_l, cov_start, cov_end, vclass,
                                  seg, flags)
    raise ValueError(f"no fphase_expand for device {dev}")
