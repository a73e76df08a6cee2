"""cause_tpu_torch — the causal-tree CRDT with its device path in PyTorch
and hand-written CUDA kernels for NVIDIA Hopper.

The port of ``cause_tpu`` (which stays the JAX reference). It imports
neither JAX nor ``cause_tpu``: the host modules it needs are its own
copies. The flat public API mirrors the reference's facade (itself the
reference Clojure library's ``core.cljc``): the ``CausalBase`` database
(``base``, ``transact``, ``undo``, ``redo``, refs to nested
collections), the list, map, set and counter collections, node
construction, ``insert``/``append``/``weft``/``merge``, materialization
(``causal_to_edn``, ``blame``, ``content_digest``), serialization
(``dumps``/``loads``), anti-entropy sync (``sync_pair``,
``sync_stream``, ``sync_base_pair``, ``version_vector``) and tombstone
compaction (``compact``, ``compact_stats``, ``stability_frontier``).
Every name of the reference's ``__all__`` is here.

The one framework flag is the weave backend: ``weaver="torch"`` on
``base`` / ``clist`` / ``cmap`` / ``cset`` / ``ccounter`` runs full
reweaves and merges on the device (a base passes it to every
collection it creates, so its sync rounds, loads and compactions
reweave there); the pure host weaver is the default and the semantics
oracle. Beyond the reference's facade the port exports its device
entry points: ``merge_wave`` over many list replica pairs (with the
sync layer's quarantine check), ``merge_map_wave`` over map pairs, the
device-resident ``FleetSession``, the merge reduction tree
(``merge_tree``, ``merge_tree_report``, the ``flat_fold`` control),
``merge_all``, which routes fleets of four or more ``weaver="torch"``
list-shaped replicas through the tree, and the batched programs
beneath them (``batched_merge_weave_v5``, ``batched_merge_weave_v5f``,
``batched_weave_digest``, ``batched_delta_weave``), whose token sort
(B1), contracted-forest walk (B2), lane expansion (B3) and fused token
phases (K1, K2, K4: B4-B6) are CUDA kernels (``csrc/``, built with nvcc
on first use). The fault-injection engine (``chaos``) and the recovery
ladder (``parallel.recovery``) drive the same seams as the reference's.
Beside the facade, as in the reference, sit the serving plane
(``cause_tpu_torch.serve``: admission, the write-ahead log, residency,
the batched tick and ``SyncService``), its network transport
(``cause_tpu_torch.net``) and the native host weaver
(``weaver="native"``, built with g++ on first use).

Device entry points take ``device=`` and default to ``"cuda"``; the
handle-level paths run on the package default, which only
``use_device`` changes. Without a card, asking for CUDA raises.
"""

from __future__ import annotations

from .cbase import (
    CausalBase,
    Ref,
    is_ref,
    new_causal_base,
    uuid_to_ref,
)
from .collections.ccounter import CausalCounter, new_causal_counter
from .collections.clist import CausalList, new_causal_list
from .collections.cmap import CausalMap, new_causal_map
from .collections.cset import CausalSet, new_causal_set
from .collections.shared import CausalError, CausalTree, causal_to_edn
from .ids import (
    H_HIDE,
    H_SHOW,
    HIDE,
    ROOT_ID,
    SPECIALS,
    K,
    Keyword,
    is_special,
    new_site_id,
    new_uid,
    node,
)

__version__ = "0.1.0"

# The device names, each by the module that holds it. They resolve on
# first use (``__getattr__`` below), so ``import cause_tpu_torch`` and
# its host names (bases, collections, ids, serde, sync, gc) load
# neither torch nor numpy: the analyser's CLI runs where neither is
# installed.
_DEVICE_NAMES = {
    "LANE_KEYS5": "benchgen",
    "lanes_from_numpy": "benchgen",
    "default_device": "device",
    "resolve_device": "device",
    "use_device": "device",
    "FleetSession": "parallel.session",
    "flat_fold": "parallel.tree",
    "merge_tree": "parallel.tree",
    "merge_tree_report": "parallel.tree",
    "WaveBuffers": "parallel.wave",
    "WaveResult": "parallel.wave",
    "merge_wave": "parallel.wave",
    "MapWaveResult": "weaver.mapw",
    "merge_map_wave": "weaver.mapw",
    "batched_merge_weave_v5": "weaver.torchw5",
    "batched_merge_weave_v5f": "weaver.torchw5f",
    "batched_delta_weave": "weaver.torchwd",
    "batched_weave_digest": "weaver.torchwd",
}


def __getattr__(name):
    mod = _DEVICE_NAMES.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_DEVICE_NAMES))

# Special values have special effects on causal collections. Specials
# do not compose: applying hide to a hide is not a show (core.cljc:13-14).
hide = HIDE
h_hide = H_HIDE
h_show = H_SHOW

# The id of the first node in every causal list; insert at the front by
# using root_id as the cause (core.cljc:16-18).
root_id = ROOT_ID

# Causal base. This is what you want 99% of the time (core.cljc:21-28).
base = new_causal_base


def transact(causal_base, tx):
    """Apply one or many changes at the current logical time
    (protocols.cljc:38-39)."""
    return causal_base.transact(tx)


def undo(causal_base):
    """Undo a transaction by the local site-id (protocols.cljc:43-44)."""
    return causal_base.undo()


def redo(causal_base):
    """Redo a transaction by the local site-id (protocols.cljc:45-46)."""
    return causal_base.redo()


def get_collection(causal_base, ref_or_uuid=None):
    """The collection for a ref/uuid, or the root collection
    (protocols.cljc:40-42)."""
    return causal_base.get_collection(ref_or_uuid)


def set_site_id(causal_base, site_id):
    """Set the local site-id (protocols.cljc:47-48)."""
    return causal_base.set_site_id(site_id)


# Causal meta attributes (core.cljc:33-35).
def get_uuid(causal):
    return causal.get_uuid()


def get_ts(causal):
    return causal.get_ts()


def get_site_id(causal):
    return causal.get_site_id()


# the causal collections; ``weaver="torch"`` runs full reweaves and
# merges on the device
clist = new_causal_list
cmap = new_causal_map
cset = new_causal_set
ccounter = new_causal_counter


# Causal collection functions (core.cljc:45-50).
def insert(causal, node, more_nodes_in_tx=None):
    """Insert a node in the causal collection (protocols.cljc:20-21)."""
    return causal.insert(node, more_nodes_in_tx)


def append(causal, cause, value):
    """Create and insert a node at the current lamport timestamp
    (protocols.cljc:22-24)."""
    return causal.append(cause, value)


def weft(causal, ids_to_cut_yarns):
    """Cut each yarn at an id and rebuild the collection at a previous
    point in time (protocols.cljc:25-27)."""
    return causal.weft(ids_to_cut_yarns)


def merge(causal1, causal2):
    """Merge two causal collections of the same type and uuid
    (protocols.cljc:28-31)."""
    return causal1.merge(causal2)


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


def get_weave(causal):
    """The woven cache of nodes (protocols.cljc:14-15)."""
    return causal.get_weave()


def content_digest(causal) -> int:
    """Canonical convergence digest of a collection's node bag:
    order-free, process-free, interner-free — two replicas anywhere
    digest equal iff their node sets are equal. Per-node blake2b over
    the canonical serde encoding, combined by a permutation-invariant
    sum; equal to the reference's digest of the same bag. The device
    ``parallel.mesh.replica_digest`` is the fast intra-process twin;
    this one is the cross-host check."""
    import hashlib
    import json as _json

    from . import serde as _serde

    total = 0
    for item in _serde.encode_node_items(causal.get_nodes()):
        blob = _json.dumps(item, allow_nan=False).encode()
        h = hashlib.blake2b(blob, digest_size=8).digest()
        total = (total + int.from_bytes(h, "big")) & (2**64 - 1)
    return total


def blame(causal):
    """Who wrote what, when: the visible content annotated with each
    element's author site and lamport time ("time = lamport-ts, who =
    site-id", the reference's README.md:48) — a projection of the
    weave, not extra bookkeeping.

    Lists (and sets/counters, which share the list tree) yield
    ``[(value, site_id, lamport_ts), ...]`` in weave order; maps yield
    ``{key: (value, site_id, lamport_ts)}`` for each live key (the LWW
    winner's author); bases yield ``{collection_uuid: blame}``."""
    from .collections.clist import causal_list_to_list
    from .collections.cmap import BLANK, active_node

    if isinstance(causal, CausalBase):
        return {
            uuid: blame(coll)
            for uuid, coll in causal.cb.collections.items()
        }
    if isinstance(causal, CausalMap):
        out = {}
        for key, key_weave in causal.ct.weave.items():
            nd = active_node(key, key_weave)
            if nd is not BLANK:
                nid = nd[0]
                out[key] = (nd[2], nid[1], nid[0])
        return out
    return [
        (value, nid[1], nid[0])
        for nid, _cause, value in causal_list_to_list(causal.ct)
    ]


def get_nodes(causal):
    """The canonical {id: (cause, value)} store (protocols.cljc:16-17)."""
    return causal.get_nodes()


# Serialization, compaction and anti-entropy sync.
from .serde import dumps, loads  # noqa: E402
from .gc import compact, compact_stats, stability_frontier  # noqa: E402
from .sync import (  # noqa: E402
    sync_base_pair,
    sync_pair,
    sync_stream,
    version_vector,
)

__all__ = [
    "append",
    "base",
    "batched_delta_weave",
    "batched_merge_weave_v5",
    "batched_merge_weave_v5f",
    "batched_weave_digest",
    "blame",
    "causal_to_edn",
    "CausalBase",
    "CausalCounter",
    "CausalError",
    "CausalList",
    "CausalMap",
    "CausalSet",
    "CausalTree",
    "ccounter",
    "clist",
    "cmap",
    "compact",
    "compact_stats",
    "content_digest",
    "cset",
    "default_device",
    "dumps",
    "flat_fold",
    "FleetSession",
    "get_collection",
    "get_nodes",
    "get_site_id",
    "get_ts",
    "get_uuid",
    "get_weave",
    "H_HIDE",
    "h_hide",
    "H_SHOW",
    "h_show",
    "HIDE",
    "hide",
    "insert",
    "is_ref",
    "is_special",
    "K",
    "Keyword",
    "LANE_KEYS5",
    "lanes_from_numpy",
    "loads",
    "MapWaveResult",
    "merge",
    "merge_all",
    "merge_map_wave",
    "merge_tree",
    "merge_tree_report",
    "merge_wave",
    "new_causal_base",
    "new_causal_counter",
    "new_causal_list",
    "new_causal_map",
    "new_causal_set",
    "new_site_id",
    "new_uid",
    "node",
    "redo",
    "Ref",
    "resolve_device",
    "ROOT_ID",
    "root_id",
    "set_site_id",
    "SPECIALS",
    "stability_frontier",
    "sync_base_pair",
    "sync_pair",
    "sync_stream",
    "transact",
    "undo",
    "use_device",
    "uuid_to_ref",
    "version_vector",
    "WaveBuffers",
    "WaveResult",
    "weft",
]
