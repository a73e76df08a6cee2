"""The native host weave backend ("native"): full reweaves and merges
through the C++ linearizer (``cause_tpu_torch/native/weaver.cpp``). A
copy of ``cause_tpu.weaver.nativew``.

Same contract as the device weaver — the pure sequential weaver is the
oracle; this backend recomputes whole weaves in O(n) instead of the
O(n^2) host replay (reference: src/causal/collections/list.cljc:20-28)
and turns merges into union + one reweave instead of the O(n*m)
reduce-insert (shared.cljc:300-314). Incremental single-node weaves
stay on the pure path, where the O(n) scan is already optimal.

Fallback discipline: any input outside the native domain (a weft-cut
"gibberish tree" with dangling causes, a map whose id-caused nodes
target other id-caused nodes — semantics the pure weaver defines by
its insertion scan, not by tree structure) silently falls back to the
pure full rebuild, so ``weaver="native"`` never changes semantics, only
speed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import native
from .arrays import OutsideDomain as _OutsideDomain

__all__ = [
    "available",
    "refresh_list_weave",
    "refresh_map_weave",
    "merge_trees",
]


def available() -> bool:
    return native.available()


def _list_lanes(nodes_map) -> Tuple[list, np.ndarray, np.ndarray]:
    """(sorted_nodes, cause_idx, vclass) for a list tree, via the shared
    NodeArrays marshaller (lane order = sorted id order, lane 0 = root).
    A dangling cause (weft gibberish) is outside the native domain."""
    from .arrays import NodeArrays

    na = NodeArrays.from_nodes_map(nodes_map, capacity=max(1, len(nodes_map)))
    n = na.n
    if n > 1 and (na.cause_idx[1:n] < 0).any():
        raise _OutsideDomain()
    return na.nodes, na.cause_idx[:n], na.vclass[:n]


def _inverse_permutation(rank: np.ndarray) -> np.ndarray:
    """rank is a bijection of 0..n-1; its inverse in O(n)."""
    order = np.empty(rank.shape[0], np.intp)
    order[rank] = np.arange(rank.shape[0], dtype=np.intp)
    return order


def refresh_list_weave(ct):
    """Full list-weave rebuild through the native linearizer; identical
    output to the pure replay (falls back to it off-domain). Reuses —
    and attaches — the persistent lane cache when the tree is inside
    its domain, so native trees share the incremental-marshal benefits
    (PackSpec-overflowing ids keep the direct marshal: the native
    linearizer needs no packed lanes)."""
    from ..collections import clist as c_list
    from . import lanecache

    # PackSpec-overflowing trees (view None) re-marshal via
    # _list_lanes — a second O(n) pass, accepted: the native linearizer
    # works beyond the packed-id domain and such trees are rare corners
    view = lanecache.view_for(ct)
    try:
        if view is not None:
            a, n = view.arena, view.n
            nodes = a.nodes[:n]
            cause_idx = a.cause_idx[:n]
            vclass = a.vclass[:n]
            if n > 1 and (cause_idx[1:] < 0).any():
                raise _OutsideDomain()  # dangling causes (weft gibberish)
        else:
            nodes, cause_idx, vclass = _list_lanes(ct.nodes)
        rank = native.weave_list_ranks(cause_idx, vclass)
    except (RuntimeError, _OutsideDomain):
        return c_list.weave(ct.evolve(weaver="pure")).evolve(weaver=ct.weaver)
    order = _inverse_permutation(rank)
    return ct.evolve(weave=[nodes[i] for i in order], lanes=view)


def refresh_map_weave(ct):
    """Full map-weave rebuild through the native linearizer: one forest
    preorder, split into the per-key weave dict (identical to the pure
    per-key replay; falls back off-domain)."""
    from ..collections import cmap as c_map

    from .arrays import map_lanes, rebuild_map_weave

    try:
        nodes, cause_idx, key_rank, vclass, keys = map_lanes(ct.nodes)
        rank, key_out = native.weave_map_ranks(
            cause_idx, key_rank, vclass, len(keys)
        )
    except (RuntimeError, _OutsideDomain):
        return c_map.weave(ct.evolve(weaver="pure")).evolve(weaver=ct.weaver)
    order = _inverse_permutation(rank)
    return ct.evolve(weave=rebuild_map_weave(nodes, key_out, order, keys))


def refresh_weave(ct):
    from ..collections import shared as s

    # only map trees carry the per-key weave dict; every other type
    # (list, and the list-shaped set/counter) uses the flat list weave
    if ct.type == s.MAP_TYPE:
        return refresh_map_weave(ct)
    return refresh_list_weave(ct)


def merge_trees(ct1, ct2):
    """Union the node stores host-side, then one native reweave —
    O(n+m) instead of the reference's O(n*m) reduce-insert, with an
    identical resulting tree."""
    from ..collections import shared as s

    return refresh_weave(s.union_nodes(ct1, ct2))
