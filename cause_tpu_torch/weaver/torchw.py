"""The device weaver behind ``weaver="torch"`` handles.

Counterpart of the API half of ``cause_tpu.weaver.jaxw`` (:331-432,
:469-673): ``weave_arrays``, ``refresh_list_weave``, ``merge_list_trees``
and ``merge_many_list_trees`` for list-shaped trees, and
``linearize_map_forest``, ``refresh_map_weave`` and ``merge_map_trees``
for maps. The weave of a tree is a pure function of its node set
(jaxw's module docstring derives the order semantics). A list's full
rebuild or merge marshals the tree's cached lanes and runs ONE v5
segment-union dispatch on the package's device (``device.use_device``);
a map's runs one forest linearization there (PyTorch ops over
``euler.link_children``/``euler_rank``, as the reference's is XLA
with no Pallas kernel).

The JAX package backs the v5 rung with v4, v2 and v1 kernels for trees
v5 does not take (too many segments for the table budget, or a budget
overflow). Those rungs are not ported yet: such a tree goes to the pure
weaver, as off-domain trees (ids beyond the PackSpec, dangling causes)
do in both packages, and ``pure_fallbacks`` counts it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import default_device, resolve_device
from .arrays import NodeArrays

__all__ = [
    "weave_arrays",
    "refresh_list_weave",
    "merge_list_trees",
    "merge_many_list_trees",
    "linearize_map_forest",
    "refresh_map_weave",
    "merge_map_trees",
    "pure_fallbacks",
]

# trees the v5 rung did not take, woven by the pure weaver instead
pure_fallbacks = 0


def weave_arrays(na: NodeArrays, segs=None, device=None
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Run the v5 segment-union kernel over one tree; returns host
    ``(rank, visible)`` numpy arrays, or None when the v5 rung does not
    take the tree (more segments than the capacity-derived table
    budget, or a token/run overflow). ``segs`` may carry a precomputed
    ``tree_segments`` table (the lane cache memoizes them per view)."""
    from ..benchgen import LANE_KEYS5, lanes_from_numpy
    from .segments import concat_segments, tree_segments
    from .torchw5 import batched_merge_weave_v5

    hi, lo = na.id_lanes()
    if segs is None:
        segs = tree_segments(hi, lo, na.cause_idx, na.vclass, na.n)
    # capacity-derived budget (NOT n_segs-derived), as the JAX rung
    s_max = max(16, na.capacity // 4)
    if segs["sg_len"].shape[0] > s_max:
        return None
    tables = concat_segments([(segs, na.n)], na.capacity, s_max)
    u_max = s_max + 8
    row = {"hi": hi, "lo": lo, "cci": na.cause_idx, "vc": na.vclass,
           "valid": na.valid, **tables}
    dev = default_device() if device is None else device
    lanes = lanes_from_numpy({k: row[k][None] for k in LANE_KEYS5}, dev)
    rank, visible, _, overflow = batched_merge_weave_v5(
        *(lanes[k] for k in LANE_KEYS5), u_max=u_max, k_max=u_max,
        device=dev)
    if bool(overflow[0]):
        return None
    # v5 ranks are per concat lane == this tree's lane order
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
        return _pure_weave(ct)
    na = view.node_arrays()
    out = weave_arrays(na, segs=view.segments(na))
    if out is None:
        pure_fallbacks += 1
        return _pure_weave(ct).evolve(lanes=view)
    order = np.argsort(out[0][: na.capacity], kind="stable")
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
        return _pure_fleet_fallback(first, cts)

    if not na.spec_ok:
        return _pure_fleet_fallback(first, cts)

    out = weave_arrays(na, segs=view.segments(na) if view else None)
    if out is None:
        pure_fallbacks += 1
        return _pure_fleet_fallback(first, cts)
    order = np.argsort(out[0][: na.capacity], kind="stable")
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
    from .euler import euler_rank, host_jump, link_children

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
