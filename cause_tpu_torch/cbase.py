"""CausalBase — a database of nested causal collections with shared history.

Port of reference src/causal/base/core.cljc: atomic transactions over
multiple collections, EDN-like value flattening (nested dicts/lists
become their own collections referenced by Ref values; strings inside
lists explode to char nodes), a shared lamport clock and site-id, a
sorted history log of reverse-paths, and undo/redo built as *new*
inverting transactions (history stays append-only).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Tuple

from . import util as u
from .collections import ccounter as c_counter
from .collections import clist as c_list
from .collections import cmap as c_map
from .collections import cset as c_set
from .collections import shared as s
from .collections.ccounter import CausalCounter
from .collections.clist import CausalList
from .collections.cmap import CausalMap
from .collections.cset import CausalSet
from .ids import (
    HIDE,
    H_HIDE,
    H_SHOW,
    ROOT_ID,
    is_special,
    new_site_id,
    new_uid,
)

__all__ = [
    "Ref",
    "CB",
    "CausalBase",
    "new_cb",
    "new_causal_base",
    "uuid_to_ref",
    "causal_to_ref",
    "is_ref",
    "ref_to_uuid",
    "get_collection_",
    "cb_to_edn",
    "transact_",
    "undo_",
    "redo_",
    "reset_",
    "invert_",
    "invert_path",
    "subhis",
    "tx_id_indexes",
    "get_next_tx_id",
    "expand_reverse_path",
    "reverse_path_to_path",
    "map_to_nodes",
    "list_to_nodes",
    "flatten_value",
]

REF_NS = "causal.collection.ref"


@dataclass(frozen=True)
class Ref:
    """A pointer to a collection inside a CausalBase. This package's
    analogue of the reference's ref keywords
    ``:causal.collection.ref/<uuid>`` (base/core.cljc:62-74).
    Materializes through the containing base when rendered."""

    uuid: str

    def __repr__(self) -> str:
        return f":{REF_NS}/{self.uuid}"

    def causal_to_edn(self, opts: Optional[dict] = None):
        """Ref deref on render (the Keyword CausalTo extension,
        base/core.cljc:83-90). Without a base in opts the ref passes
        through unchanged. Cyclic refs render as the unexpanded ref at
        the point of recurrence instead of dying with RecursionError —
        the reference leaves this as an open TODO (base/core.cljc:89)."""
        opts = opts or {}
        cb = opts.get("cb")
        if cb is None:
            return self
        stack = opts.get("_ref_stack", frozenset())
        if self.uuid in stack:
            return self  # cycle: stop expanding, keep the pointer
        opts = dict(opts, _ref_stack=stack | {self.uuid})
        return s.causal_to_edn(get_collection_(cb, self), opts)


def uuid_to_ref(uuid: str) -> Ref:
    return Ref(uuid)


def causal_to_ref(causal) -> Ref:
    return Ref(causal.get_uuid())


def is_ref(v) -> bool:
    return type(v) is Ref


def ref_to_uuid(ref) -> str:
    return ref.uuid if type(ref) is Ref else ref


@dataclass(frozen=True)
class CB:
    """The causal-base value (schema at base/core.cljc:21-43):
    shared clock/site, the sorted reverse-path history log, the three
    undo/redo cursors, and the collections map."""

    lamport_ts: int
    uuid: str
    site_id: str
    history: list  # sorted list of (id, uuid) reverse-paths
    first_undo_lamport_ts: Optional[int]
    last_undo_lamport_ts: Optional[int]
    last_redo_lamport_ts: Optional[int]
    root_uuid: Optional[str]
    collections: Dict[str, Any]
    weaver: str = "pure"

    def evolve(self, **kw) -> "CB":
        return replace(self, **kw)


def new_cb(weaver: str = "pure") -> CB:
    """A fresh causal base; note the lamport clock starts at 1
    (base/core.cljc:45-58)."""
    return CB(
        lamport_ts=1,
        uuid=new_uid(),
        site_id=new_site_id(),
        history=[],
        first_undo_lamport_ts=None,
        last_undo_lamport_ts=None,
        last_redo_lamport_ts=None,
        root_uuid=None,
        collections={},
        weaver=s.weaver_name(weaver),
    )


def get_collection_(cb: CB, uuid_or_ref=None):
    """The collection for a uuid/ref, or the root collection
    (base/core.cljc:76-81)."""
    if uuid_or_ref is None:
        uuid_or_ref = cb.root_uuid
    if uuid_or_ref is None:
        return None
    return cb.collections.get(ref_to_uuid(uuid_or_ref))


def cb_to_edn(cb: CB, opts: Optional[dict] = None):
    """Materialize the root collection, threading the base through opts
    so Refs deref recursively (base/core.cljc:92-96)."""
    opts = dict(opts or {})
    opts["cb"] = cb
    return s.causal_to_edn(get_collection_(cb), opts)


# ------------------------------ Transact ------------------------------


def _is_maplike(v) -> bool:
    """The reference's ``map?`` — CausalMap counts as a map
    (it implements IPersistentMap there)."""
    return isinstance(v, (dict, CausalMap))


def _is_setlike(v) -> bool:
    """Set-shaped values nest as CausalSet collections (beyond the
    reference, which has no set type — README.md:250 roadmap): Python
    set/frozenset literals and CausalSet handles."""
    return isinstance(v, (set, frozenset, CausalSet))


def _is_counterlike(v) -> bool:
    return isinstance(v, CausalCounter)


def _is_seqable(v) -> bool:
    """The reference's ``seqable?`` restricted to the value shapes the
    tx engine understands: strings, sequences, sets, and causal
    collections."""
    return isinstance(v, (str, list, tuple, set, frozenset, dict,
                          CausalList, CausalMap, CausalSet))


def _as_map(v) -> dict:
    return v.causal_to_edn() if isinstance(v, CausalMap) else v


def _as_seq(v):
    return v.causal_to_edn() if isinstance(v, CausalList) else v


def _as_set(v):
    return v.causal_to_edn() if isinstance(v, CausalSet) else v


def new_node(cb: CB, tx_index: Optional[int], cause, value):
    """Mint a local node; returns ``(next_tx_index, node)``
    (base/core.cljc:100-105)."""
    ti = tx_index or 0
    return (
        ti + 1,
        ((cb.lamport_ts, cb.site_id, ti), cause, value),
    )


def insert(cb: CB, uuid: str, nodes) -> CB:
    """Insert a same-tx run of nodes into the collection at ``uuid`` and
    splice their reverse-paths into the sorted history
    (base/core.cljc:107-115)."""
    nodes = list(nodes)
    reverse_paths = [(n[0], uuid) for n in nodes]
    coll = cb.collections[uuid]
    coll = coll.insert(nodes[0], nodes[1:] or None)
    collections = dict(cb.collections)
    collections[uuid] = coll
    history = u.insert_sorted(
        cb.history, reverse_paths[0], next_vals=reverse_paths[1:]
    )
    return cb.evolve(collections=collections, history=history)


def add_collection_of_this_values_type_to_cb(cb: CB, value, is_root: bool = False):
    """Create an empty collection matching the value's shape; returns
    ``(cb, uuid_or_None)`` (base/core.cljc:117-126)."""
    if _is_maplike(value):
        causal = c_map.new_causal_map(weaver=cb.weaver)
    elif _is_setlike(value):
        causal = c_set.new_causal_set(weaver=cb.weaver)
    elif _is_counterlike(value):
        causal = c_counter.new_causal_counter(weaver=cb.weaver)
    elif _is_seqable(value):
        causal = c_list.new_causal_list(weaver=cb.weaver)
    else:
        return cb, None
    uuid = causal.get_uuid()
    collections = dict(cb.collections)
    collections[uuid] = causal
    cb = cb.evolve(collections=collections)
    if is_root:
        cb = cb.evolve(root_uuid=uuid)
    return cb, uuid


def map_to_nodes(cb: CB, tx_index: int, map_value):
    """Flatten a mapping into key-caused nodes; returns
    ``(cb, tx_index, nodes)`` (base/core.cljc:130-138)."""
    nodes = []
    for k, v in _as_map(map_value).items():
        cb, tx_index, flat_v = flatten_value(cb, tx_index, v,
                                             preserve_strings=True)
        tx_index, n = new_node(cb, tx_index, k, flat_v)
        nodes.append(n)
    return cb, tx_index, nodes


def list_to_nodes(cb: CB, tx_index: int, list_value, cause=None):
    """Flatten a sequence into cause-chained nodes; strings explode to
    char nodes inline (base/core.cljc:140-156). Divergence: the
    reference splits per code unit (its char-seq helper is unused and
    ZWJ-broken, util.cljc:94-97); we split into grapheme-ish clusters
    via util.char_seq so combined emoji stay single nodes. Returns
    ``(cb, tx_index, nodes, last_node_id)``."""
    is_string = isinstance(list_value, str)
    value = u.char_seq(list_value) if is_string else _as_seq(list_value)
    nodes = []
    cause = cause if cause is not None else ROOT_ID
    for v in value:
        if not is_string and isinstance(v, str):
            cb, tx_index, more_nodes, cause = list_to_nodes(
                cb, tx_index, v, cause
            )
            nodes.extend(more_nodes)
        else:
            cb, tx_index, flat_v = flatten_value(
                cb, tx_index, v, preserve_strings=is_string
            )
            tx_index, n = new_node(cb, tx_index, cause, flat_v)
            nodes.append(n)
            cause = n[0]
    return cb, tx_index, nodes, cause


def _set_member_key(x):
    """Deterministic sort key for set members across processes: the
    canonical serde encoding where possible (repr of a frozenset is
    hash-seed dependent), else a type-tagged repr."""
    from . import serde  # lazy: serde imports this module

    try:
        return (0, serde.dumps(x))
    except Exception:  # noqa: BLE001 - unencodable: best-effort order
        return (1, type(x).__name__, repr(x))


def set_to_nodes(cb: CB, tx_index: int, set_value, cause=None):
    """Flatten a set-shaped value into cause-chained add-nodes (the
    shape ``CausalSet.add`` mints). Elements stay whole — no string
    explosion; a set of chars is a set of strings — and iterate in a
    deterministic order so replicas flattening equal literals mint
    comparable structures. Members must render hashable: a member that
    would flatten to a nested collection Ref (dict/list/frozenset
    inside a set) is rejected up front — its rendered value could
    never live in the materialized Python set. Returns
    ``(cb, tx_index, nodes, last_id)``.
    """
    nodes = []
    cause = cause if cause is not None else ROOT_ID
    for v in sorted(_as_set(set_value), key=_set_member_key):
        cb, tx_index, flat_v = flatten_value(cb, tx_index, v,
                                             preserve_strings=True)
        if is_ref(flat_v):
            raise s.CausalError(
                "set members must be scalar (a nested collection "
                "cannot render into a set)",
                {"causes": {"unhashable-set-member"},
                 "type": type(v).__name__},
            )
        tx_index, n = new_node(cb, tx_index, cause, flat_v)
        nodes.append(n)
        cause = n[0]
    return cb, tx_index, nodes, cause


def counter_to_nodes(cb: CB, tx_index: int, value, cause=None):
    """One delta node carrying the counter's current value (a nested
    CausalCounter enters the base as its materialized sum — the same
    render-then-rebuild stance the reference takes for nested causal
    collections, base/core.cljc:130-138)."""
    delta = value.value() if isinstance(value, CausalCounter) else value
    cause = cause if cause is not None else ROOT_ID
    if delta == 0:
        return cb, tx_index, [], cause
    tx_index, n = new_node(cb, tx_index, cause, delta)
    return cb, tx_index, [n], n[0]


def flatten_collection(cb: CB, tx_index: int, value, node_fn):
    """Turn a nested collection value into its own collection plus a Ref
    (base/core.cljc:158-164)."""
    cb, uuid = add_collection_of_this_values_type_to_cb(cb, value)
    out = node_fn(cb, tx_index, value)
    cb, tx_index, nodes = out[0], out[1], out[2]
    if nodes:
        cb = insert(cb, uuid, nodes)
    return cb, tx_index, uuid_to_ref(uuid)


def flatten_value(cb: CB, tx_index: int, value, preserve_strings: bool = False):
    """Recursively flatten an EDN-like value (base/core.cljc:166-172,
    extended with the set/counter types the reference only road-maps:
    set literals and CausalSet handles nest as CausalSet collections,
    CausalCounter handles as counter collections — all behind Refs,
    all first-class in history/undo/serde/sync)."""
    if preserve_strings and isinstance(value, str):
        return cb, tx_index, value
    if _is_maplike(value):
        return flatten_collection(cb, tx_index, value, map_to_nodes)
    if _is_setlike(value):
        return flatten_collection(cb, tx_index, value, set_to_nodes)
    if _is_counterlike(value):
        return flatten_collection(cb, tx_index, value, counter_to_nodes)
    if _is_seqable(value):
        return flatten_collection(cb, tx_index, value, list_to_nodes)
    return cb, tx_index, value


def value_to_nodes(cb: CB, tx_index: int, cause, value, causal=None):
    """Nodes for a value merged into an existing collection
    (base/core.cljc:174-182). ``causal`` disambiguates the target type
    when the value shape alone would pick the wrong flattener (a set
    literal into a CausalSet must not explode strings per char)."""
    if _is_maplike(value):
        return map_to_nodes(cb, tx_index, value)
    if isinstance(causal, CausalSet) and (_is_setlike(value)
                                          or _is_seqable(value)):
        if isinstance(value, str):
            members = {value}  # strings are single members, never chars
        elif _is_setlike(value):
            members = value
        else:
            try:
                members = set(_as_seq(value))
            except TypeError:
                raise s.CausalError(
                    "set members must be hashable",
                    {"causes": {"unhashable-set-member"}},
                ) from None
        cb, tx_index, nodes, _ = set_to_nodes(cb, tx_index, members, cause)
        return cb, tx_index, nodes
    if isinstance(causal, CausalCounter) and _is_counterlike(value):
        cb, tx_index, nodes, _ = counter_to_nodes(cb, tx_index, value,
                                                  cause)
        return cb, tx_index, nodes
    if _is_seqable(value):
        cb, tx_index, nodes, _ = list_to_nodes(cb, tx_index, value, cause)
        return cb, tx_index, nodes
    tx_index, n = new_node(cb, tx_index, cause, value)
    return cb, tx_index, [n]


def merge_value_into_parent_collection(cb: CB, uuid, cause, value) -> bool:
    """Should the value's members merge directly into the addressed
    collection rather than nest (base/core.cljc:184-190)? Sets accept
    set-shaped/sequence members; counters accept scalar deltas through
    the plain-node path below instead."""
    causal = cb.collections.get(uuid)
    if cause is None and _is_maplike(value) and isinstance(causal, CausalMap):
        return True
    if (
        not _is_maplike(value)
        and (_is_seqable(value) or _is_setlike(value))
        and isinstance(causal, (CausalList, CausalSet))
    ):
        return True
    if _is_counterlike(value) and isinstance(causal, CausalCounter):
        return True
    return False


def handle_tx_part_value(cb: CB, tx_part, tx_index: int):
    """(base/core.cljc:192-201)"""
    uuid, cause, value = tx_part
    causal = cb.collections.get(uuid)
    if isinstance(causal, CausalSet) and _is_maplike(value):
        # a nested-collection Ref could never render inside the
        # materialized Python set — reject at transact, not at render
        raise s.CausalError(
            "set members must be scalar (a nested collection cannot "
            "render into a set)",
            {"causes": {"unhashable-set-member"}},
        )
    if merge_value_into_parent_collection(cb, uuid, cause, value):
        cb, tx_index, nodes = value_to_nodes(cb, tx_index, cause, value,
                                             causal)
        if nodes:
            cb = insert(cb, uuid, nodes)
        return cb, tx_index
    cb, tx_index, flat_value = flatten_value(
        cb, tx_index, value, preserve_strings=isinstance(causal, CausalMap)
    )
    tx_index, n = new_node(cb, tx_index, cause, flat_value)
    cb = insert(cb, uuid, [n])
    return cb, tx_index


def handle_tx_part_potential_root(cb: CB, tx_part):
    """A tx-part without a uuid creates a new root collection
    (base/core.cljc:203-208)."""
    uuid, _, value = tx_part
    if uuid is not None:
        return cb, uuid
    return add_collection_of_this_values_type_to_cb(cb, value, is_root=True)


def validate_tx_part(cb: CB, tx_part) -> None:
    """(base/core.cljc:210-220)"""
    uuid, _, value = tx_part
    causal = cb.collections.get(uuid) if uuid is not None else None
    if uuid is not None and cb.root_uuid is None:
        raise s.CausalError(
            "Please transact a root collection first by setting uuid and "
            "cause to nil",
            {"value": value},
        )
    if uuid is not None and causal is None:
        raise s.CausalError(
            "Collection with provided uuid not found", {"uuid": uuid}
        )
    if uuid is None and not isinstance(value, (dict, list, tuple, set,
                                               frozenset, CausalList,
                                               CausalMap, CausalSet,
                                               CausalCounter)):
        raise s.CausalError(
            "Root node must satisfy the coll? predicate", {"value": value}
        )


def handle_tx_part(cb: CB, tx_part, tx_index: int):
    """One tx-part: validate, resolve/create the target collection, then
    flatten and insert the value (base/core.cljc:222-230)."""
    validate_tx_part(cb, tx_part)
    cb, uuid = handle_tx_part_potential_root(cb, tx_part)
    _, cause, value = tx_part
    return handle_tx_part_value(cb, (uuid, cause, value), tx_index)


def transact_(cb: CB, tx) -> CB:
    """Apply a transaction ``[(collection_uuid, cause, value), ...]``
    (base/core.cljc:232-252). The lamport clock ticks once per
    transaction; tx-index orders the nodes within it; a successful
    transact clears the undo/redo cursors."""
    tx_index = 0
    for tx_part in tx:
        cb, tx_index = handle_tx_part(cb, tuple(tx_part), tx_index)
    return cb.evolve(
        lamport_ts=cb.lamport_ts + 1,
        first_undo_lamport_ts=None,
        last_undo_lamport_ts=None,
        last_redo_lamport_ts=None,
    )


# ------------------------------ History ------------------------------


@dataclass(frozen=True)
class Path:
    """An expanded history entry: which collection, which node
    (base/core.cljc:21)."""

    uuid: str
    node: tuple


def expand_reverse_path(cb: CB, reverse_path):
    """``(node, collection)`` for a reverse-path (base/core.cljc:260-265)."""
    nid, uuid = reverse_path
    collection = get_collection_(cb, uuid)
    body = collection.get_nodes()[nid]
    return (nid, body[0], body[1]), collection


def reverse_path_to_path(cb: CB, reverse_path) -> Path:
    """(base/core.cljc:267-270)"""
    node, _ = expand_reverse_path(cb, reverse_path)
    return Path(uuid=reverse_path[1], node=node)


def tx_id_indexes(cb: CB, tx_id):
    """``(tx_start_i, tx_end_i)`` of the reverse-paths for a tx-id in the
    history (base/core.cljc:272-291)."""
    if tx_id is None:
        return None, None
    history = cb.history
    tx_start_node_id = tuple(tx_id) + (0,)
    tx_start_i = u.binary_search(
        history,
        tx_start_node_id,
        match_fn=lambda rp, t: rp[0] == t,
        less_than_fn=lambda rp, t: rp[0] < t,
    )
    if not isinstance(tx_start_i, int):
        return tx_start_i, None
    tx_id = tuple(tx_id)
    i = tx_start_i
    while i + 1 < len(history) and history[i + 1][0][:2] == tx_id:
        i += 1
    return tx_start_i, i


_UNSET = object()


def subhis(cb: CB, start_tx_id, end_tx_id=_UNSET):
    """History slice between two tx-ids inclusive; None means open end;
    the 2-arg form slices a single tx (base/core.cljc:293-311)."""
    if end_tx_id is _UNSET:
        end_tx_id = start_tx_id
    history = cb.history
    start_tx_i, end_tx_i = tx_id_indexes(cb, start_tx_id)
    if start_tx_id != end_tx_id:
        _, end_tx_i = tx_id_indexes(cb, end_tx_id)
    if (start_tx_id is not None and start_tx_i is None) or (
        end_tx_id is not None and end_tx_i is None
    ):
        return []  # a named tx-id that isn't in history
    if end_tx_i is not None:
        return history[(start_tx_i or 0): end_tx_i + 1]
    return history[(start_tx_i or 0):]


def invert_path(path: Path):
    """The inverting tx-part for one path (base/core.cljc:313-320):
    hide/h.hide invert to h.show, h.show to h.hide, and a plain value is
    h.hidden *by id*."""
    nid, cause, value = path.node
    if value is HIDE or value is H_HIDE:
        return (path.uuid, cause, H_SHOW)
    if value is H_SHOW:
        return (path.uuid, cause, H_HIDE)
    return (path.uuid, nid, H_HIDE)


def invert_(cb: CB, history_to_invert) -> CB:
    """Invert a slice of history as one new transaction, with as few
    tx-parts as possible (base/core.cljc:322-343): oldest changes
    transact last (winning at equal causes); paths nested under a
    collection that is itself about to be hidden are dropped; only the
    last tx-part per (uuid, cause) is kept."""
    paths = [
        reverse_path_to_path(cb, rp) for rp in reversed(list(history_to_invert))
    ]
    soon_to_be_hidden_uuids = {
        ref_to_uuid(p.node[2]) for p in paths if is_ref(p.node[2])
    }
    not_nested_paths = [
        p for p in paths if p.uuid not in soon_to_be_hidden_uuids
    ]
    tx = [invert_path(p) for p in not_nested_paths]
    deduped = {}
    for tp in tx:
        deduped[(tp[0], tp[1])] = tp
    return transact_(cb, list(deduped.values()))


def reset_(cb: CB, tx_id, site_ids=None):
    """Undo all transactions back to tx-id; with site-ids, only those
    sites' entries (base/core.cljc:345-352). The 2-arg reference form
    returns the history slice (as-is quirk, preserved)."""
    if site_ids is None:
        return subhis(cb, tx_id, None)
    sites = set(site_ids)
    slice_ = [rp for rp in subhis(cb, tx_id, None) if rp[0][1] in sites]
    return invert_(cb, slice_)


def get_next_tx_id(cb: CB, last_undo_or_redo_ts):
    """The tx-id next in line to be undone/redone: the newest local-site
    entry strictly below the cursor (base/core.cljc:354-369).

    The reference slices history to the exact tx (cursor-1, site) —
    sound there because a base's clock only ever advances through local
    transactions, so local tx timestamps are consecutive. Here
    ``sync_base_pair`` fast-forwards the clock past timestamps consumed
    by peers, so the previous local tx can sit at ANY lower ts; scan
    for it instead of assuming cursor-1 (an exact-slice miss silently
    ended the undo chain after one post-sync undo)."""
    limit = last_undo_or_redo_ts
    for rp in reversed(cb.history):
        lamport_ts, site_id = rp[0][0], rp[0][1]
        if limit is not None and lamport_ts >= limit:
            continue
        if site_id == cb.site_id:
            return (lamport_ts, cb.site_id)
    return None


def undo_(cb: CB) -> CB:
    """Undo the next transaction on the local site's undo stack
    (base/core.cljc:375-390). Undo IS a new transaction."""
    next_undo_tx_id = get_next_tx_id(cb, cb.last_undo_lamport_ts)
    if next_undo_tx_id is None:
        return cb
    reverse_paths = [
        rp for rp in subhis(cb, next_undo_tx_id) if rp[0][1] == cb.site_id
    ]
    first_undo = (
        cb.first_undo_lamport_ts
        if cb.first_undo_lamport_ts is not None
        else next_undo_tx_id[0]
    )
    cb = invert_(cb, reverse_paths)
    return cb.evolve(
        first_undo_lamport_ts=first_undo,
        last_undo_lamport_ts=next_undo_tx_id[0],
        last_redo_lamport_ts=None,
    )


def redo_(cb: CB) -> CB:
    """Redo the previously-undone transaction; never redoes past the
    first undo (base/core.cljc:392-409)."""
    next_redo_tx_id = get_next_tx_id(cb, cb.last_redo_lamport_ts)
    first_undo = cb.first_undo_lamport_ts
    last_undo = cb.last_undo_lamport_ts
    if (
        first_undo is None
        or next_redo_tx_id is None
        or next_redo_tx_id[0] <= first_undo
    ):
        return cb
    reverse_paths = [
        rp for rp in subhis(cb, next_redo_tx_id) if rp[0][1] == cb.site_id
    ]
    cb = invert_(cb, reverse_paths)
    return cb.evolve(
        first_undo_lamport_ts=first_undo,
        last_undo_lamport_ts=last_undo,
        last_redo_lamport_ts=next_redo_tx_id[0],
    )


# ------------------------------ CausalBase ------------------------------


class CausalBase:
    """Immutable CausalBase handle (base/core.cljc:415-457)."""

    __slots__ = ("cb",)

    def __init__(self, cb: CB):
        object.__setattr__(self, "cb", cb)

    def __setattr__(self, *a):
        raise AttributeError("CausalBase is immutable")

    # -- CausalBase protocol (protocols.cljc:37-48) --
    def transact(self, tx) -> "CausalBase":
        return CausalBase(transact_(self.cb, tx))

    def get_collection(self, ref_or_uuid=None):
        return get_collection_(self.cb, ref_or_uuid)

    def undo(self) -> "CausalBase":
        return CausalBase(undo_(self.cb))

    def redo(self) -> "CausalBase":
        return CausalBase(redo_(self.cb))

    def set_site_id(self, site_id: str) -> "CausalBase":
        return CausalBase(self.cb.evolve(site_id=site_id))

    # -- CausalMeta --
    def get_uuid(self) -> str:
        return self.cb.uuid

    def get_ts(self) -> int:
        return self.cb.lamport_ts

    def get_site_id(self) -> str:
        return self.cb.site_id

    # -- CausalTo --
    def causal_to_edn(self, opts: Optional[dict] = None):
        return cb_to_edn(self.cb, opts)

    def __eq__(self, other) -> bool:
        return isinstance(other, CausalBase) and self.cb == other.cb

    def __hash__(self) -> int:
        return hash((self.cb.uuid, self.cb.lamport_ts, self.cb.site_id,
                     len(self.cb.history)))

    def __repr__(self) -> str:
        return f"#causal/base {cb_to_edn(self.cb)!r}"


def new_causal_base(weaver: str = "pure") -> CausalBase:
    """Create a new causal base (base/core.cljc:454-457). ``weaver``
    selects the weave backend for every collection it creates:
    ``"torch"`` runs their full reweaves and merges on the device."""
    return CausalBase(new_cb(weaver))
