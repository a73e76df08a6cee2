"""The full-width weave-and-digest program.

Counterpart of ``batched_weave_digest`` in ``cause_tpu.weaver.jaxwd``
(the delta-native wave of that module, ``batched_delta_weave`` and
``splice_ranks``, comes with the FleetSession port).
"""

from __future__ import annotations

from ..parallel.mesh import replica_digest
from .torchw5 import _prepare, _v5

__all__ = ["batched_weave_digest"]


def batched_weave_digest(hi, lo, cci, vclass, valid, seg,
                         sg_min_hi, sg_min_lo, sg_max_hi, sg_max_lo,
                         sg_len, sg_lane0, sg_dense, sg_tail_special,
                         sg_valid, sg_vsum, u_max: int, k_max: int,
                         device="cuda"):
    """The batched v5 segment-union kernel AND the per-row convergence
    digest over the same lanes. Returns ``(rank, visible, digest,
    overflow)``; ``digest`` is ``[B]`` int64 holding uint32 values."""
    args = _prepare((hi, lo, cci, vclass, valid, seg, sg_min_hi, sg_min_lo,
                     sg_max_hi, sg_max_lo, sg_len, sg_lane0, sg_dense,
                     sg_tail_special, sg_valid, sg_vsum), device)
    rank, visible, _conflict, overflow = _v5(*args, u_max=int(u_max),
                                             k_max=int(k_max))
    digest = replica_digest(args[0], args[1], rank, visible)
    return rank, visible, digest, overflow
