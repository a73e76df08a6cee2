"""The device weaver behind ``weaver="torch"`` handles, and the v1/v2
merge kernels.

Counterpart of ``cause_tpu.weaver.jaxw``: the kernel half (``linearize``,
``linearize_v2``, ``merge_weave_kernel``, ``merge_weave_kernel_v2``,
their batches and the host run estimator, :99-325, :435-466, :690-792)
and the API half (:469-673): ``weave_arrays``, ``refresh_list_weave``,
``merge_list_trees`` and ``merge_many_list_trees`` for list-shaped
trees, and ``linearize_map_forest``, ``refresh_map_weave`` and
``merge_map_trees`` for maps. The weave of a tree is a pure function of
its node set (jaxw's module docstring derives the order semantics).

The kernels compute the whole ``[B, N]`` batch at once (the reference
computes a row and ``vmap``s it); a single-row function is the batch of
one. v1 is the host pointer-jump, one child sort under the derived tree
T*, an Euler tour over 2N edges ranked by pointer doubling
(``euler.euler_rank``) and the visibility compare; v2 ranks a
chain-contracted tree instead, with a static run budget and an overflow
flag. On the card every row sort is the B1 kernel (``sort_pairs``); the
tours keep pointer doubling, as the reference's XLA does.

A list's full rebuild or merge marshals the tree's cached lanes and
walks the reference's ladder on the package's device
(``device.use_device``): the v5 segment-union kernel when the tree's
segments fit its table budget, then v4 (``torchw4``) and v2 when the
host run estimate fits the run budget, then v1, which takes every tree.
So every tree of the device domain is woven on the device; the pure
weaver takes only trees the reference also weaves on the host (ids
beyond the PackSpec, dangling causes), and ``pure_fallbacks`` counts
those. A map's rebuild runs one forest linearization (PyTorch ops over
``euler.link_children``/``euler_rank``, as the reference's is XLA with
no Pallas kernel).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..device import default_device, resolve_device
from .arrays import I32_MAX, VCLASS_H_HIDE, VCLASS_HIDE, NodeArrays
from .bitonic import sort_pairs
from .euler import euler_rank, host_jump, link_children
from .gatherops import at_add, at_set, take1d

__all__ = [
    "linearize",
    "linearize_v2",
    "estimate_runs",
    "merge_weave_kernel",
    "merge_weave_kernel_v2",
    "batched_merge_weave",
    "batched_merge_weave_v2",
    "weave_arrays",
    "refresh_list_weave",
    "merge_list_trees",
    "merge_many_list_trees",
    "linearize_map_forest",
    "refresh_map_weave",
    "merge_map_trees",
    "pure_fallbacks",
]

I32 = torch.int32
BIG = int(I32_MAX)

# trees the device route handed to the pure weaver: off the device
# domain (ids beyond the PackSpec, dangling causes), as in the reference
pure_fallbacks = 0


# ------------------------------------------------------------ v1 / v2


def _iota(B: int, n: int, dev) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=dev).expand(B, n).contiguous()


def _steps(n: int) -> int:
    """The doubling rounds of the reference's host jump over n lanes."""
    return max(1, math.ceil(math.log2(max(n, 1))))


def _child_sort(parent_sort, special, hi, lo):
    """Group lanes under their parents in sibling order: specials first,
    then descending id (``jaxw._child_sort``). The reference's
    ``lexsort((-lo, -hi, not_special, parent_sort))`` as one B1 sort of
    three keys, the first two packed into ``parent_sort * 2 +
    not_special`` (order-preserving: ``parent_sort <= N``)."""
    B, N = parent_sort.shape
    packed = (parent_sort * 2 + (~special).to(I32)).to(I32)
    order = sort_pairs((packed, (-hi).to(I32), (-lo).to(I32),
                        _iota(B, N, hi.device)), num_keys=3)[3]
    return link_children(order, parent_sort)


def _visibility(rank, valid, vclass, cause_idx, is_root):
    """``hide?`` (list.cljc:48-55) through the weave successor: a lane
    is hidden when the lane ranked right after it is a hide whose cause
    is that lane. Invalid lanes all write the table's last slot, which
    only invalid lanes read (``jaxw._scatter_by_rank``)."""
    B, N = rank.shape
    idx = _iota(B, N, rank.device)
    node_at = at_set(torch.full((B, N + 2), -1, dtype=I32,
                                device=rank.device),
                     torch.where(valid, rank, N + 1), idx)
    succ = take1d(node_at, rank.clamp(0, N) + 1)
    succ_safe = succ.clamp(0, N - 1)
    svc = take1d(vclass, succ_safe)
    succ_is_hide = ((succ >= 0)
                    & ((svc == VCLASS_HIDE) | (svc == VCLASS_H_HIDE))
                    & (take1d(cause_idx, succ_safe) == idx))
    return valid & (vclass == 0) & ~is_root & ~succ_is_hide


def _linearize(hi, lo, cause_idx, vclass, valid):
    """v1 over ``[B, N]`` lanes: ``(rank, visible)``."""
    B, N = hi.shape
    idx = _iota(B, N, hi.device)
    is_root = valid & (idx == 0)
    special = valid & (vclass > 0)
    rel = valid & ~is_root
    cause_safe = cause_idx.clamp(0, N - 1)
    host = host_jump(special, cause_safe, _steps(N))
    parent_t = torch.where(special, cause_safe, host)
    del host
    parent_sort = torch.where(rel, parent_t, N).to(I32)
    fc, ns = _child_sort(parent_sort, special, hi, lo)
    del parent_sort
    parent_up = torch.where(rel, parent_t, -1).to(I32)
    rank, _size = euler_rank(fc, ns, parent_up, valid.to(I32))
    del fc, ns, parent_up, _size
    rank = torch.where(valid, rank, N).to(I32)
    return rank, _visibility(rank, valid, vclass, cause_idx, is_root)


def _linearize_v2(hi, lo, cause_idx, vclass, valid, k_max: int):
    """v2 over ``[B, N]`` lanes (valid lanes in ascending id order):
    ``(rank, visible, overflow)``. The host jump runs ``ceil(log2 N)``
    doubling rounds where the reference stops once no related lane's
    host is special; a round after that changes no related lane, so the
    hosts it reads are the same (``euler.host_jump``)."""
    B, N = hi.shape
    dev = hi.device
    K = k_max
    idx = _iota(B, N, dev)
    is_root = valid & (idx == 0)
    special = valid & (vclass > 0)
    rel = valid & ~is_root
    cause_safe = cause_idx.clamp(0, N - 1)
    host = host_jump(special, cause_safe, _steps(N))
    parent = torch.where(rel, torch.where(special, cause_safe, host),
                         -1).to(I32)
    del host

    # chain contraction over kept-lane positions
    kidx = torch.cumsum(valid.to(I32), dim=1, dtype=I32) - 1
    has_parent = parent >= 0
    pc = parent.clamp(0, N - 1)
    child_count = at_add(torch.zeros((B, N + 1), dtype=I32, device=dev),
                         torch.where(has_parent, pc, N), 1)[:, :N]
    only_child = has_parent & (take1d(child_count, pc) == 1)
    glued = only_child & (take1d(kidx, pc) == kidx - 1)
    del child_count, only_child
    run_start = valid & ~glued
    run_id = torch.cumsum(run_start.to(I32), dim=1, dtype=I32) - 1
    overflow = run_start.sum(dim=1) > K
    offset = kidx - torch.cummax(torch.where(run_start, kidx, -1),
                                 dim=1).values

    # compacted run arrays (slot K is the discard sentinel)
    slot = torch.where(run_start & (run_id < K), run_id, K)
    head_lane = at_set(torch.full((B, K + 1), -1, dtype=I32, device=dev),
                       slot, idx)[:, :K]
    head_special = at_set(torch.zeros((B, K + 1), dtype=torch.bool,
                                      device=dev), slot, special)[:, :K]
    head_parent = at_set(torch.full((B, K + 1), -1, dtype=I32, device=dev),
                         slot, parent)[:, :K]
    lane_ok = valid & (run_id < K) & (run_id >= 0)
    run_len = at_add(torch.zeros((B, K + 1), dtype=I32, device=dev),
                     torch.where(lane_ok, run_id, K), 1)[:, :K]
    valid_run = head_lane >= 0
    parent_run = torch.where(head_parent >= 0,
                             take1d(run_id, head_parent.clamp(0, N - 1)),
                             -1).to(I32)

    # sibling sort over runs: packed parent + class, then descending
    # head lane (lanes are id-sorted, so lane order is id order)
    has_run_parent = valid_run & (parent_run >= 0)
    parent_sort = torch.where(has_run_parent, parent_run, K).to(I32)
    packed = (parent_sort * 2 + (~head_special).to(I32)).to(I32)
    order = sort_pairs((packed, (-head_lane).to(I32), _iota(B, K, dev)),
                       num_keys=2)[2]
    fc, ns = link_children(order, parent_sort)
    parent_up = torch.where(has_run_parent, parent_run, -1).to(I32)
    base, _ = euler_rank(fc, ns, parent_up,
                         torch.where(valid_run, run_len, 0))

    # expand: every run's lanes are contiguous in the preorder
    rank = torch.where(valid, take1d(base, run_id.clamp(0, K - 1)) + offset,
                       N).to(I32)
    return (rank, _visibility(rank, valid, vclass, cause_idx, is_root),
            overflow)


def _merge_front_half(hi, lo, cause_hi, cause_lo, vclass, valid):
    """Union + cause resolution of the v1/v2 merge kernels
    (``jaxw._merge_front_half``): id sort, duplicate drop, conflict
    detection, sort-join cause resolution. The id sort carries the other
    lanes as payloads. The sort-join's node-before-query key is implied
    by stability (node records precede query records in the
    concatenation), so its sort has two keys, and its sorted keys are
    the query ids the match compares."""
    B, M = hi.shape
    dev = hi.device
    iota = _iota(B, M, dev)
    hi_s, lo_s, order, valid_s, vclass_s, chi_s, clo_s = sort_pairs(
        (hi, lo, iota, valid.to(I32), vclass, cause_hi, cause_lo),
        num_keys=2)
    valid_s = valid_s.bool()
    false1 = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    dup = torch.cat([false1, (hi_s[:, 1:] == hi_s[:, :-1])
                     & (lo_s[:, 1:] == lo_s[:, :-1])], dim=1)
    keep = valid_s & ~dup

    def prev(x):
        return torch.cat([x[:, :1], x[:, :-1]], dim=1)

    conflict = (dup & valid_s & ((chi_s != prev(chi_s))
                                 | (clo_s != prev(clo_s))
                                 | (vclass_s != prev(vclass_s)))).any(dim=1)
    rec_hi = torch.cat([torch.where(keep, hi_s, BIG), chi_s], dim=1)
    rec_lo = torch.cat([torch.where(keep, lo_s, BIG), clo_s], dim=1)
    del chi_s, clo_s, valid_s
    key_hi, key_lo, ord2 = sort_pairs(
        (rec_hi.to(I32), rec_lo.to(I32), _iota(B, 2 * M, dev)), num_keys=2)
    del rec_hi, rec_lo
    is_node_rec = (ord2 < M) & take1d(keep, ord2.clamp(0, M - 1))
    last_node = torch.cummax(torch.where(is_node_rec, ord2, -1),
                             dim=1).values
    last_safe = last_node.clamp(0, M - 1)
    match = ((last_node >= 0) & (take1d(hi_s, last_safe) == key_hi)
             & (take1d(lo_s, last_safe) == key_lo))
    answer = torch.where(match, last_node, -1)
    del key_hi, key_lo, last_safe, match, last_node
    # node records write past the kept columns (a non-kept node's
    # negative index counts from the end, as in JAX's scatter)
    q_lane = torch.where(is_node_rec, 2 * M, ord2 - M)
    ci = at_set(torch.full((B, 2 * M + 1), -1, dtype=I32, device=dev),
                q_lane, answer)[:, :M].contiguous()
    return order, (hi_s, lo_s, ci, vclass_s, keep, conflict)


def _prepare(args, device, bools=(5,)):
    """Move kernel lanes to ``device`` as contiguous int32 (bool at the
    positions ``bools``)."""
    dev = resolve_device(device)
    return [torch.as_tensor(x).to(device=dev,
                                  dtype=torch.bool if i in bools else I32
                                  ).contiguous()
            for i, x in enumerate(args)]


def _row(args):
    """One row's lanes as a batch of one."""
    return [x[None] for x in args]


def linearize(hi, lo, cause_idx, vclass, valid, device="cuda"):
    """Weave position and visibility for one tree's ``[N]`` node lanes
    (``jaxw.linearize``): lane 0 is the root sentinel; returns ``(rank,
    visible)`` with rank N on invalid lanes."""
    args = _row(_prepare((hi, lo, cause_idx, vclass, valid), device,
                         bools=(4,)))
    return tuple(x[0] for x in _linearize(*args))


def linearize_v2(hi, lo, cause_idx, vclass, valid, k_max: int,
                 device="cuda"):
    """The chain-compressed linearization of one tree
    (``jaxw.linearize_v2``): valid lanes in ascending id order; returns
    ``(rank, visible, overflow)``, rank and visibility unspecified when
    the tree has more than ``k_max`` runs."""
    args = _row(_prepare((hi, lo, cause_idx, vclass, valid), device,
                         bools=(4,)))
    return tuple(x[0] for x in _linearize_v2(*args, k_max=int(k_max)))


def batched_merge_weave(hi, lo, cause_hi, cause_lo, vclass, valid,
                        device="cuda"):
    """Union + reweave of ``[B, M]`` replica lanes on ``device`` (v1,
    ``jaxw.batched_merge_weave``): the concatenated id lanes of each
    row's trees (invalid lanes carry int32 max), their cause id lanes,
    value classes and valid flags. Returns per row ``(order, rank,
    visible, conflict)``: ``order`` maps sorted lanes to input lanes,
    rank and visibility index sorted lanes."""
    order, (hi_s, lo_s, ci, vc_s, keep, conflict) = _merge_front_half(
        *_prepare((hi, lo, cause_hi, cause_lo, vclass, valid), device))
    rank, visible = _linearize(hi_s, lo_s, ci, vc_s, keep)
    return order, rank, visible, conflict


def batched_merge_weave_v2(hi, lo, cause_hi, cause_lo, vclass, valid,
                           k_max: int, device="cuda"):
    """The chain-compressed batch (``jaxw.batched_merge_weave_v2``):
    ``(order, rank, visible, conflict, overflow)``; a row with more than
    ``k_max`` runs raises its overflow flag and carries unspecified
    ranks."""
    order, (hi_s, lo_s, ci, vc_s, keep, conflict) = _merge_front_half(
        *_prepare((hi, lo, cause_hi, cause_lo, vclass, valid), device))
    rank, visible, overflow = _linearize_v2(hi_s, lo_s, ci, vc_s, keep,
                                            int(k_max))
    return order, rank, visible, conflict, overflow


def merge_weave_kernel(hi, lo, cause_hi, cause_lo, vclass, valid,
                       device="cuda"):
    """``batched_merge_weave`` for one replica set's ``[M]`` lanes."""
    out = batched_merge_weave(*_row((hi, lo, cause_hi, cause_lo, vclass,
                                     valid)), device=device)
    return tuple(x[0] for x in out)


def merge_weave_kernel_v2(hi, lo, cause_hi, cause_lo, vclass, valid,
                          k_max: int, device="cuda"):
    """``batched_merge_weave_v2`` for one replica set's ``[M]`` lanes."""
    out = batched_merge_weave_v2(*_row((hi, lo, cause_hi, cause_lo, vclass,
                                        valid)), k_max=k_max, device=device)
    return tuple(x[0] for x in out)


def estimate_runs(cause_idx, vclass, valid) -> int:
    """Host-side (numpy) count of the chain-contracted tree's runs —
    the contraction ``linearize_v2`` performs, so the rung is chosen
    before dispatch (``jaxw.estimate_runs``)."""
    cause_idx = np.asarray(cause_idx)
    vclass = np.asarray(vclass)
    valid = np.asarray(valid)
    n = cause_idx.shape[0]
    idx = np.arange(n, dtype=np.int32)
    is_root = valid & (idx == 0)
    special = valid & (vclass > 0)
    rel = valid & ~is_root
    cause_safe = np.clip(cause_idx, 0, n - 1)
    host = cause_safe.copy()
    for _ in range(max(1, math.ceil(math.log2(max(2, n))))):
        on_special = special[host] & rel
        if not on_special.any():
            break
        host = np.where(on_special, host[host], host)
    parent = np.where(rel, np.where(special, cause_safe, host), -1)
    kidx = np.cumsum(valid.astype(np.int32)) - 1
    has_parent = parent >= 0
    pc = np.clip(parent, 0, n - 1)
    child_count = np.bincount(pc[has_parent], minlength=n)
    only_child = has_parent & (child_count[pc] == 1)
    glued = only_child & (kidx[pc] == kidx - 1)
    return int((valid & ~glued).sum())


def _run_budget(capacity: int) -> int:
    return max(16, capacity // 8)


# ------------------------------------------------------------ the API


def weave_arrays(na: NodeArrays, segs=None, device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Weave one tree on the device; returns host ``(rank, visible)``
    numpy arrays. The reference's ladder, rung for rung
    (``jaxw.weave_arrays``): the v5 segment-union kernel when the tree's
    segments fit the capacity-derived table budget and it does not
    overflow, then v4 and v2 when the host run estimate fits the run
    budget and they do not overflow, then v1, which takes every tree.
    ``segs`` may carry a precomputed ``tree_segments`` table (the lane
    cache memoizes them per view)."""
    from ..benchgen import LANE_KEYS5, lanes_from_numpy
    from .segments import concat_segments, tree_segments
    from .torchw4 import batched_merge_weave_v4
    from .torchw5 import batched_merge_weave_v5

    dev = default_device() if device is None else device
    hi, lo = na.id_lanes()
    if segs is None:
        segs = tree_segments(hi, lo, na.cause_idx, na.vclass, na.n)
    # capacity-derived budget (NOT n_segs-derived), as the JAX rung
    s_max = max(16, na.capacity // 4)
    if segs["sg_len"].shape[0] <= s_max:
        tables = concat_segments([(segs, na.n)], na.capacity, s_max)
        u_max = s_max + 8
        row = {"hi": hi, "lo": lo, "cci": na.cause_idx, "vc": na.vclass,
               "valid": na.valid, **tables}
        lanes = lanes_from_numpy({k: row[k][None] for k in LANE_KEYS5},
                                 dev)
        rank, visible, _, overflow = batched_merge_weave_v5(
            *(lanes[k] for k in LANE_KEYS5), u_max=u_max, k_max=u_max,
            device=dev)
        if not bool(overflow[0]):
            # v5 ranks are per concat lane == this tree's lane order
            return rank[0].cpu().numpy(), visible[0].cpu().numpy()
    k_max = _run_budget(na.capacity)
    args = _row(_prepare((hi, lo, na.cause_idx, na.vclass, na.valid), dev,
                         bools=(4,)))
    if estimate_runs(na.cause_idx, na.vclass, na.valid) <= k_max:
        _, rank, visible, _, overflow = batched_merge_weave_v4(
            *args, k_max=k_max, device=dev)
        if not bool(overflow[0]):
            # v4 ranks are per sorted lane, and a tree's lanes are
            # already id-sorted, so the identity order carries over
            return rank[0].cpu().numpy(), visible[0].cpu().numpy()
        rank, visible, overflow = _linearize_v2(*args, k_max=k_max)
        if not bool(overflow[0]):
            return rank[0].cpu().numpy(), visible[0].cpu().numpy()
    rank, visible = _linearize(*args)
    return rank[0].cpu().numpy(), visible[0].cpu().numpy()


def _pure_weave(ct):
    """The pure full rebuild of ``ct``, keeping its weaver label."""
    from ..collections import clist as c_list

    return c_list.weave(ct.evolve(weaver="pure")).evolve(weaver=ct.weaver)


def refresh_list_weave(ct):
    """Full list-weave rebuild on device (the ``weaver="torch"`` path of
    clist.weave): identical to the pure scan. The marshal goes through
    the persistent lane cache, and the view rides along on the result
    so the next rebuild or merge wave ships cached lanes."""
    global pure_fallbacks
    from . import lanecache

    view = lanecache.view_for(ct)
    if view is None:  # ids beyond the PackSpec: off the device domain
        pure_fallbacks += 1
        return _pure_weave(ct)
    na = view.node_arrays()
    rank, _ = weave_arrays(na, segs=view.segments(na))
    order = np.argsort(rank[: na.capacity], kind="stable")
    weave = [na.nodes[i] for i in order[: na.n]]
    return ct.evolve(weave=weave, lanes=view)


def merge_list_trees(ct1, ct2):
    """Device-backed merge: union the node stores, then one reweave on
    device, with a tree identical to the reference's reduce-insert."""
    return merge_many_list_trees((ct1, ct2))


def _pure_fleet_fallback(first, cts):
    """N-way union + pure reweave, for fleets off the device domain."""
    from ..collections import clist as c_list
    from ..collections import shared as s

    ct = s.union_nodes_many([first.evolve(weaver="pure")] + cts[1:])
    return c_list.weave(ct).evolve(weaver=first.weaver)


def merge_many_list_trees(cts):
    """Converge a fleet of list replicas into one tree: C-speed node
    union, vectorized validation (append-only bodies, cause-must-exist
    on the marshalled cause lanes) and ONE device reweave of the union.
    Equals any fold of pairwise merges."""
    global pure_fallbacks
    from ..collections import shared as s
    from . import lanecache

    cts = list(cts)
    if not cts:
        raise s.CausalError("Nothing to merge.", {"causes": {"empty-fleet"}})
    first = cts[0]
    for ct in cts[1:]:
        s.check_mergeable(first, ct)

    # earlier trees win the dict union so a conflict report's
    # existing_node carries the body already in the merge target
    nodes = {}
    for ct in reversed(cts):
        nodes.update(ct.nodes)
    for ct in cts:
        if not (ct.nodes.items() <= nodes.items()):
            for nid, body in ct.nodes.items():
                if nodes[nid] != body:
                    raise s.CausalError(
                        "This node is already in the tree and can't be "
                        "changed.",
                        {"causes": {"append-only", "edits-not-allowed"},
                         "existing_node": (nid,) + nodes[nid]},
                    )

    # marshal the union: fold cached views vectorized when every input
    # carries a fresh, rank-compatible one; otherwise one fresh build
    view = None
    in_views = [
        ct.lanes if (isinstance(ct.lanes, lanecache.LaneView)
                     and ct.lanes.n == len(ct.nodes)) else None
        for ct in cts
    ]
    if all(v is not None for v in in_views):
        view = lanecache.union_views_many(in_views)
    if view is None:
        view = lanecache.build_view(nodes, first.uuid)
    na = view.node_arrays() if view is not None \
        else NodeArrays.from_nodes_map(nodes)
    n = na.n
    if na.spec_ok:
        has_cause = na.cause_hi[:n] >= 0
    else:
        from ..ids import is_id

        has_cause = np.fromiter(
            (is_id(cause) for _, cause, _ in na.nodes), bool, n
        )
    dangling = (na.cause_idx[:n] == -1) & has_cause
    if dangling.any():
        # only *incoming* nodes are validated, as in the pure union
        first_ids = first.nodes
        for i in np.flatnonzero(dangling):
            if na.nodes[i][0] not in first_ids:
                raise s.CausalError(
                    "The cause of this node is not in the tree.",
                    {"causes": {"cause-must-exist"}, "node": na.nodes[i]},
                )
        # pre-existing dangling causes (weft gibberish) are outside the
        # device domain: the kernel would parent them under root
        pure_fallbacks += 1
        return _pure_fleet_fallback(first, cts)

    if not na.spec_ok:
        pure_fallbacks += 1
        return _pure_fleet_fallback(first, cts)

    rank, _ = weave_arrays(na, segs=view.segments(na) if view else None)
    order = np.argsort(rank[: na.capacity], kind="stable")
    weave = [na.nodes[i] for i in order[:n]]
    # na.nodes is already in sorted id order -> yarns group in one pass
    yarns = {}
    for node in na.nodes:
        yarns.setdefault(node[0][1], []).append(node)
    lamport = max(first.lamport_ts, int(na.ts[:n].max(initial=0)))
    return first.evolve(
        nodes=nodes, yarns=yarns, weave=weave, lamport_ts=lamport,
        lanes=view,
    )


def linearize_map_forest(cause_idx, key_rank, vclass, valid, n_keys: int,
                         k_cap: int):
    """Map-weave ordering on the device: one forest preorder over the
    per-key mini list-weaves (map.cljc:21-45).

    Lanes are the real nodes in ascending id order (``[N]`` tensors);
    ``k_cap`` slots of virtual key roots (lane N+k is key k's ROOT
    sentinel, ``n_keys`` of them live) are appended internally.
    Key-caused lanes hang off their key's root, id-caused lanes off
    their target; then the standard T* derivation applies per
    component.

    Returns ``s_down`` (``[N]`` int32): the tour suffix weight of each
    real lane. Within one key's component s_down strictly decreases
    along weave order, so the host orders each key's nodes by
    descending s_down."""
    N = cause_idx.shape[0]
    M = N + k_cap
    dev = cause_idx.device
    i32 = torch.int32
    idx = torch.arange(M, dtype=i32, device=dev)
    is_rootlane = idx >= N
    valid_all = torch.cat(
        [valid, torch.arange(k_cap, device=dev) < n_keys])
    special = torch.cat([valid & (vclass > 0),
                         torch.zeros(k_cap, dtype=torch.bool, device=dev)])
    cause_all = torch.cat([
        torch.where(key_rank >= 0, N + key_rank, cause_idx.clamp(0, N - 1)),
        torch.arange(N, M, dtype=i32, device=dev),  # roots cause themselves
    ]).to(i32)
    rel = valid_all & ~is_rootlane
    host = host_jump(special[None], cause_all[None],
                     max(1, math.ceil(math.log2(M))))[0]
    parent_t = torch.where(special, cause_all, host)
    parent_sort = torch.where(rel, parent_t, M).to(i32)
    # sibling order: specials first, then descending id == descending
    # lane (real lanes are id-sorted; roots are parentless) — the
    # reference's lexsort on (packed, -idx) as one int64 key
    packed = parent_sort * 2 + (~special).to(i32)
    key = packed.long() * M + (M - 1 - idx).long()
    order = torch.sort(key, stable=True).indices.to(i32)
    fc, ns = link_children(order[None], parent_sort[None])
    parent_up = torch.where(rel, parent_t, -1).to(i32)
    weights = rel.to(i32)
    rank, _size = euler_rank(fc, ns, parent_up[None], weights[None])
    # per-lane suffix weight: euler_rank's rank = total - s_down
    s_down = weights.sum(dtype=i32) - rank[0]
    return s_down[:N]


def refresh_map_weave(ct, device=None):
    """Full map-weave rebuild on the device (the ``weaver="torch"`` path
    of cmap.weave): marshal with ``map_lanes``, rank the forest on the
    package's device (or ``device``), and split the order back into the
    per-key weave dict — identical to the pure per-key replay (which it
    falls back to off-domain)."""
    from ..collections import cmap as c_map
    from .arrays import OutsideDomain, next_pow2, rebuild_map_weave

    try:
        nodes, cause_idx, key_rank, vclass, valid_n, keys = (
            _padded_map_lanes(ct.nodes))
    except OutsideDomain:
        return c_map.weave(ct.evolve(weaver="pure")).evolve(weaver=ct.weaver)
    if not nodes:
        return ct.evolve(weave={})
    dev = resolve_device(device)
    k_cap = next_pow2(max(1, len(keys)))
    s_down = linearize_map_forest(
        *(torch.from_numpy(a).to(dev)
          for a in (cause_idx, key_rank, vclass, valid_n)),
        len(keys), k_cap).cpu().numpy()
    n = len(nodes)
    # each lane's key ordinal (single-level rule: an id-caused lane's
    # target is key-caused), then per key by descending s_down
    kr = key_rank[:n]
    key_of = np.where(kr >= 0, kr, kr[np.clip(cause_idx[:n], 0, None)])
    order = np.lexsort((-s_down[:n].astype(np.int64), key_of))
    return ct.evolve(weave=rebuild_map_weave(nodes, key_of, order, keys))


def _padded_map_lanes(nodes_map):
    """map_lanes padded to a power-of-two capacity with a valid mask."""
    from .arrays import map_lanes, next_pow2

    nodes, cause_idx, key_rank, vclass, keys = map_lanes(nodes_map)
    n = len(nodes)
    cap = next_pow2(max(1, n))
    pad = cap - n
    cause_idx = np.concatenate([cause_idx, np.full(pad, -1, np.int32)])
    key_rank = np.concatenate([key_rank, np.full(pad, -1, np.int32)])
    vclass = np.concatenate([vclass, np.zeros(pad, np.int32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    return nodes, cause_idx, key_rank, vclass, valid, keys


def merge_map_trees(ct1, ct2):
    """Device-backed map merge (map.cljc:248-249 semantics): union the
    node stores on the host, then one forest linearization on the
    device over the per-key mini-weaves — the map twin of
    ``merge_list_trees``."""
    from ..collections import shared as s

    return refresh_map_weave(s.union_nodes(ct1, ct2))
