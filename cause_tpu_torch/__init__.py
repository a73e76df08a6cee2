"""cause_tpu_torch — the causal-tree CRDT with its device path in PyTorch
and hand-written CUDA kernels for NVIDIA Hopper.

The port of ``cause_tpu`` (which stays the JAX reference). It imports
neither JAX nor ``cause_tpu``: the host modules it needs are its own
copies. What is ported so far is the v5 merge wave end to end and the
steady-state sync loop built on it: list handles (``clist``) whose
``weaver="torch"`` reweaves and merges run on the device, with the set
and counter handles (``cset``, ``ccounter``) riding the same list
route; map handles (``cmap``), whose ``weaver="torch"`` reweaves and
merges run one forest linearization on the device, and
``merge_map_wave``, which runs many map replica pairs as key-rooted
forests through the v5 kernel; ``serde`` for all four collections;
``merge_wave`` over many list replica pairs, the device-resident
``FleetSession`` (full
waves, delta updates, delta-native waves over the divergent window,
``converge``, ``merged``, ``checkpoint``/``restore``), the merge
reduction tree (``merge_tree``, ``merge_tree_report``, the
``flat_fold`` control) and ``merge_all``, which routes fleets of four
or more ``weaver="torch"`` list-shaped replicas through the tree. Beneath
them run
the batched v5 segment-union kernel, the full-width and delta-window
weave-and-digest programs (``batched_weave_digest``,
``batched_delta_weave``) and the per-row digest, with the token sort
(B1), the contracted-forest walk (B2) and the lane expansion (B3) as
CUDA kernels (``csrc/``, built with nvcc on first use), and the fused
v5f pipeline (``batched_merge_weave_v5f``, and ``merge_wave`` under
``BENCH_KERNEL=v5f``), whose token phases are the K1, K2 and K4 kernels
(B4-B6).

Device entry points take ``device=`` and default to ``"cuda"``; the
handle-level paths run on the package default, which only
``use_device`` changes. Without a card, asking for CUDA raises.
"""

from __future__ import annotations

from .benchgen import LANE_KEYS5, lanes_from_numpy
from .collections.ccounter import CausalCounter, new_causal_counter
from .collections.clist import CausalList, new_causal_list
from .collections.cmap import CausalMap, new_causal_map
from .collections.cset import CausalSet, new_causal_set
from .collections.shared import CausalError, CausalTree
from .device import default_device, resolve_device, use_device
from .ids import (
    H_HIDE,
    H_SHOW,
    HIDE,
    ROOT_ID,
    K,
    Keyword,
    is_special,
    new_site_id,
    new_uid,
    node,
)
from .parallel.session import FleetSession
from .parallel.tree import flat_fold, merge_tree, merge_tree_report
from .parallel.wave import WaveResult, merge_wave
from .weaver.mapw import MapWaveResult, merge_map_wave
from .weaver.torchw5 import batched_merge_weave_v5
from .weaver.torchw5f import batched_merge_weave_v5f
from .weaver.torchwd import batched_delta_weave, batched_weave_digest

__version__ = "0.1.0"

hide = HIDE
h_hide = H_HIDE
h_show = H_SHOW
root_id = ROOT_ID

# the causal collections; ``weaver="torch"`` runs full reweaves and
# merges on the device
clist = new_causal_list
cmap = new_causal_map
cset = new_causal_set
ccounter = new_causal_counter


def merge(a, b):
    """Merge two replicas of one collection (same uuid and type)."""
    return a.merge(b)


def merge_all(causal, *more, tree=True):
    """Converge a whole fleet of replicas into one collection.

    Fleets of four or more ``weaver="torch"`` list-shaped replicas
    (lists, sets, counters) go through the merge reduction tree
    (``parallel.tree``): ceil(log2(n)) batched device rounds, level 0
    full width, later levels on the delta window path. ``tree=False``,
    or any fleet outside the tree's domain (maps, pure weaver, fewer
    than four replicas, PackSpec overflow), takes the flat path: the
    N-way node union and ONE reweave (``merge_many``).
    Either way the result equals folding ``merge`` in any order."""
    if tree and len(more) >= 3 \
            and getattr(getattr(causal, "ct", None), "weaver", "") == "torch":
        from .parallel.tree import merge_all_tree

        routed = merge_all_tree([causal, *more])
        if routed is not None:
            return routed
    return causal.merge_many(more)


__all__ = [
    "CausalCounter",
    "CausalError",
    "CausalList",
    "CausalMap",
    "CausalSet",
    "CausalTree",
    "FleetSession",
    "K",
    "Keyword",
    "LANE_KEYS5",
    "MapWaveResult",
    "WaveResult",
    "batched_delta_weave",
    "batched_merge_weave_v5",
    "batched_merge_weave_v5f",
    "batched_weave_digest",
    "ccounter",
    "clist",
    "cmap",
    "cset",
    "default_device",
    "flat_fold",
    "h_hide",
    "h_show",
    "hide",
    "is_special",
    "lanes_from_numpy",
    "merge",
    "merge_all",
    "merge_map_wave",
    "merge_tree",
    "merge_tree_report",
    "merge_wave",
    "new_site_id",
    "new_uid",
    "node",
    "resolve_device",
    "root_id",
    "use_device",
]
