"""The v4 merge+weave kernel: marshal-resolved causes, no device search.

Port of ``cause_tpu.weaver.jaxw4``. Each lane carries ``cci``, the index
of its cause in the concatenated pre-sort lane array (known at marshal
time; -1 for the root and padding), so cause resolution is one id sort
carrying ``(iota, vclass, cci)`` payloads — the iota payload IS the
sort permutation — then one scatter of each sorted lane's kept-head
position to its concat slot and one gather through ``cci``. Everything
after that is v3's back half (``torchw3``), with the host walk stepping
through the resolved cause positions and the run-tail kill comparing
positions instead of ids.

The batch is an explicit leading ``[B, ...]`` dimension. On the card
the two sorts are the B1 kernel and the contracted forest is ranked by
the B2 walk (``euler.euler_walk``) under both ``euler`` arms, as the v5
port ranks v5 and v5w; on the CPU the same calls take their plain
versions. The walk equals the reference's pointer doubling on every run
the outputs read. Semantics are exact against the JAX package, overflow
included.
"""

from __future__ import annotations

import torch

from .arrays import I32_MAX
from .bitonic import sort_pairs
from .euler import euler_walk
from .gatherops import at_set, take1d
from .torchw import _prepare, _row
from .torchw3 import _back_half, _compact, _host_walk, _kept_scan
from .torchw5 import _cummax, _cumsum, _iota, _shift1

__all__ = ["merge_weave_kernel_v4", "batched_merge_weave_v4", "EULER"]

BIG = int(I32_MAX)
I32 = torch.int32

# the reference's two ranking arms; both are the B2 walk here
EULER = ("doubling", "walk")


def _rank_walk(fc, ns, parent_up, run_len):
    return euler_walk(fc, ns, parent_up, run_len)


def _v4(hi, lo, cci, vclass, valid, k_max: int):
    B, N = hi.shape
    dev = hi.device
    idx = _iota(B, N, dev)

    # union: one 2-key sort carrying (order, vclass, cci) payloads
    hi = torch.where(valid, hi, BIG)
    lo = torch.where(valid, lo, BIG)
    h, l, order, vc, cci_s = sort_pairs((hi, lo, idx, vclass, cci),
                                        num_keys=2)
    del hi, lo
    va = ~((h == BIG) & (l == BIG))
    dup = (h == _shift1(h, -1)) & (l == _shift1(l, -1)) & (idx > 0) & va
    keep = va & ~dup
    del h, l

    # cause resolution: concat slot -> kept head of the sorted duplicate
    # group, one scatter + one gather
    khead = _cummax(torch.where(keep, idx, -1))
    concat2head = at_set(torch.zeros((B, N), dtype=I32, device=dev), order,
                         khead)
    cp = take1d(concat2head, cci_s.clamp(0, N - 1))
    cause_pos = torch.where(va & (cci_s >= 0), cp, 0).to(I32)
    del khead, concat2head, cp, cci_s

    # duplicate lanes must agree on body (cause + value class); equal
    # cause ids resolve to equal kept heads
    conflict = (dup & ((vc != _shift1(vc, 0))
                       | (cause_pos != _shift1(cause_pos, 0)))).any(dim=1)

    cum_keep = _cumsum(keep)
    kidx = cum_keep - 1
    n_kept = cum_keep[:, -1:]
    is_root = keep & (idx == 0)
    special = keep & (vc > 0)
    rel = keep & ~is_root
    sp_pack, prev_kept, prev_kept_special = _kept_scan(keep, special, idx)

    # adjacency: my cause IS the previous kept node
    adj = rel & (cause_pos == prev_kept) & (prev_kept >= 0)
    host_case = adj & ~special & prev_kept_special
    irregular = rel & (~adj | host_case)

    # compact irregular lanes into K slots; a special's parent is its
    # cause, so the host walk steps through cause_pos itself
    q_lane, q_valid, _ = _compact(irregular, k_max)
    q_c = q_lane.clamp(0, N - 1)
    q_special = take1d(special, q_c)
    q_cause = take1d(cause_pos, q_c)
    host_q = _host_walk(q_cause, q_valid, q_special, special, cause_pos)
    q_parent = torch.where(q_special, q_cause, host_q).to(I32)

    def tail_is_cause(s_c, t_c):
        # cause ids compare as kept-head positions
        return take1d(cause_pos, s_c) == t_c

    rank, visible, overflow = _back_half(
        keep, vc, idx, kidx, n_kept, is_root, special, sp_pack, prev_kept,
        adj, host_case, irregular, q_lane, q_valid, q_parent, k_max,
        _rank_walk, tail_is_cause)
    return order, rank, visible, conflict, overflow


def batched_merge_weave_v4(hi, lo, cci, vclass, valid, k_max: int,
                           euler: str = "doubling", device="cuda"):
    """Marshal-resolved batch on ``device``: ``[B, M]`` lanes (the
    ``benchgen.LANE_KEYS4`` layout: invalid lanes carry int32 max ids,
    ``cci`` the concat index of each lane's cause or -1) -> per row
    ``(order, rank, visible, conflict, overflow)``, as
    ``torchw3.batched_merge_weave_v3``. ``euler`` names the reference's
    ranking arm ("doubling" or "walk"); both rank with ``euler_walk``."""
    if euler not in EULER:
        raise ValueError(f"euler must be one of {EULER}, got {euler!r}")
    args = _prepare((hi, lo, cci, vclass, valid), device, bools=(4,))
    return _v4(*args, k_max=int(k_max))


def merge_weave_kernel_v4(hi, lo, cci, vclass, valid, k_max: int,
                          euler: str = "doubling", device="cuda"):
    """``batched_merge_weave_v4`` for one replica set's ``[M]`` lanes."""
    out = batched_merge_weave_v4(*_row((hi, lo, cci, vclass, valid)),
                                 k_max=k_max, euler=euler, device=device)
    return tuple(x[0] for x in out)
