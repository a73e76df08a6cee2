"""The weave-and-digest programs: full width and delta-native.

Counterpart of ``cause_tpu.weaver.jaxwd``. ``batched_weave_digest`` is
the full-width program: the batched v5 kernel and the per-row digest
over the same lanes. ``batched_delta_weave`` reweaves only the
divergent WINDOW of a resident weave — one anchor lane (the converged
prefix weave's final node, playing the root) plus each tree's
divergent-suffix lanes — and returns the TOTAL document digest: within
the delta domain (``parallel.wave.delta_domain_ok``) the full weave
factors exactly as ``weave(prefix) ++ weave(window) \\ anchor``, so the
window's ranks offset by the anchor's rank ``r0`` are the full-weave
ranks, and the digest, a wraparound sum of per-lane terms, is the
frozen prefix sum plus the window's terms. ``splice_ranks`` writes the
window's ranks and visibility into the resident full-width tensors in
place, where the reference donates the buffers to its jitted scatter.

Budgets: the window runs at ``u_max = k_max = N_w`` (the window width),
so the token and run budgets cannot overflow; the flag stays as a
safety net. On the card every v5 dispatch here runs the B1 sort (six
calls), the B2 walk and the B3 expansion, at the window's width.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import mix32, replica_digest
from .torchw5 import _prepare, _v5

__all__ = ["batched_weave_digest", "batched_delta_weave", "splice_ranks"]


def batched_weave_digest(hi, lo, cci, vclass, valid, seg,
                         sg_min_hi, sg_min_lo, sg_max_hi, sg_max_lo,
                         sg_len, sg_lane0, sg_dense, sg_tail_special,
                         sg_valid, sg_vsum, u_max: int, k_max: int,
                         device="cuda"):
    """The batched v5 segment-union kernel AND the per-row convergence
    digest over the same lanes. Returns ``(rank, visible, digest,
    overflow)``; ``digest`` is ``[B]`` int32 holding the uint32 bits."""
    args = _prepare((hi, lo, cci, vclass, valid, seg, sg_min_hi, sg_min_lo,
                     sg_max_hi, sg_max_lo, sg_len, sg_lane0, sg_dense,
                     sg_tail_special, sg_valid, sg_vsum), device)
    rank, visible, _conflict, overflow = _v5(*args, u_max=int(u_max),
                                             k_max=int(k_max))
    digest = replica_digest(args[0], args[1], rank, visible)
    return rank, visible, digest, overflow


def _u32_tensor(x, dev) -> torch.Tensor:
    """A host uint32 array (or a tensor of its int32 bits) as int32 on
    ``dev``."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.int32)
    arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(dev)


def batched_delta_weave(hi, lo, cci, vclass, valid, seg,
                        sg_min_hi, sg_min_lo, sg_max_hi, sg_max_lo,
                        sg_len, sg_lane0, sg_dense, sg_tail_special,
                        sg_valid, sg_vsum, prefix_digest, r0,
                        u_max: int, k_max: int, device="cuda"):
    """The delta wave: v5 over the ``[B, 2*wcap]`` window lanes plus the
    incremental digest. ``prefix_digest`` is the [B] uint32 sum of the
    resident prefix's terms (anchor included; numpy uint32 or a tensor
    of its int32 bits), ``r0`` the [B] anchor rank (shared prefix length
    - 1).

    Returns ``(rank_w, visible_w, digest, overflow)``: window-local
    ranks (full rank = ``r0 + rank_w``, applied by the splice), window
    visibility, the [B] int32 digest bit-identical to the full-width
    wave's, and the per-row overflow flag."""
    args = _prepare((hi, lo, cci, vclass, valid, seg, sg_min_hi, sg_min_lo,
                     sg_max_hi, sg_max_lo, sg_len, sg_lane0, sg_dense,
                     sg_tail_special, sg_valid, sg_vsum), device)
    hi, lo = args[0], args[1]
    dev = hi.device
    # the host inputs go over before the dispatch is queued: a copy from
    # host memory waits for the work queued before it
    r0_t = torch.as_tensor(r0, dtype=torch.int32, device=dev)
    prefix = _u32_tensor(prefix_digest, dev)
    rank_w, visible_w, _conflict, overflow = _v5(*args, u_max=int(u_max),
                                                 k_max=int(k_max))
    Nw = hi.shape[1]
    wcap = Nw // 2
    lane = torch.arange(Nw, device=dev)
    # the anchor lanes (one copy per tree) belong to the PREFIX digest:
    # the kept copy ranks 0 in the window but carries the prefix's own
    # rank and visibility in the full weave
    is_anchor = (lane == 0) | (lane == wcap)
    kept = (rank_w < Nw) & ~is_anchor[None, :]
    pos = torch.where(kept, r0_t[:, None] + rank_w, 0)
    terms = mix32(hi, lo, pos, visible_w)
    window_sum = torch.where(kept, terms, 0).sum(dim=1, dtype=torch.int32)
    return rank_w, visible_w, prefix + window_sum, overflow


def splice_ranks(rank_full, vis_full, rank_w, vis_w, starts, counts, r0):
    """Splice a delta wave's window ranks and visibility into the
    resident ``[B, 2*cap]`` tensors IN PLACE, and return them.

    ``rank_w``/``vis_w`` are the ``[B, 2*wcap]`` window outputs;
    ``starts[B, 2]`` each tree's shared-prefix length (the full-lane
    index of its first divergent lane), ``counts[B, 2]`` its divergent
    lane count, ``r0`` the [B] anchor rank. Window lane ``t*wcap+1+j``
    maps to full lane ``t*cap + starts[t] + j`` for ``j < counts[t]``;
    window lanes dropped as twins splice the full-width sentinel
    ``2*cap``. Only those lanes are written: no index outside the
    resident tensors is ever formed."""
    B, N = rank_full.shape
    cap = N // 2
    Nw = rank_w.shape[1]
    wcap = Nw // 2
    dev = rank_full.device
    starts = torch.as_tensor(starts, dtype=torch.int64, device=dev)
    counts = torch.as_tensor(counts, dtype=torch.int64, device=dev)
    r0 = torch.as_tensor(r0, dtype=torch.int32, device=dev)
    off = torch.arange(wcap - 1, device=dev)
    for t in range(2):
        rows, j = (off[None, :] < counts[:, t:t + 1]).nonzero(as_tuple=True)
        src = t * wcap + 1 + j
        w_rank = rank_w[rows, src]
        val = torch.where(w_rank < Nw, r0[rows] + w_rank, N).to(
            rank_full.dtype)
        dst = t * cap + starts[rows, t] + j
        rank_full.index_put_((rows, dst), val)
        vis_full.index_put_((rows, dst), vis_w[rows, src])
    return rank_full, vis_full
