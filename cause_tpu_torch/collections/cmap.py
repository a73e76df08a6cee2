"""CausalMap — a map CRDT: LWW-register per key with per-key mini-weaves.

Port of reference src/causal/collections/map.cljc. Each key owns a small
list-weave rooted at the sentinel; plain key-caused writes weave at the
root in recency order (newest first), so the first visible node is the
last-writer-wins value; id-caused nodes (hide/show of one specific
write) weave under that write, enabling undo by id (map.cljc:21-45).

``weaver="torch"`` runs full rebuilds and merges as one forest
linearization on the device (``weaver.torchw``); ``"native"`` runs them
through the C++ host linearizer (``weaver.nativew``).
"""

from __future__ import annotations

from typing import Optional

from ..ids import (
    HIDE,
    H_HIDE,
    ROOT_ID,
    ROOT_NODE,
    is_id,
    is_special,
    new_site_id,
    new_uid,
    node_from_kv,
)
from ..weaver import pure
from . import shared as s
from .shared import CausalTree

__all__ = [
    "new_causal_tree",
    "weave",
    "BLANK",
    "active_node",
    "CausalMap",
    "new_causal_map",
]

# sentinel returned by active_node when a key's value is hidden
BLANK = object()


_MISSING = object()


def _update_in(container, path, f, args):
    """The one ``update_in`` recursion, over CausalMap-likes (anything
    with ``get``/``assoc``) and plain dicts. A missing or
    non-associative intermediate raises a CausalError naming the
    offending segment. Mirrors ``get_in``'s presence semantics: a
    dict key explicitly holding None is present (just not associative);
    a CausalMap register holding None is indistinguishable from absent."""
    k = path[0]
    is_cmap = hasattr(container, "assoc")
    if len(path) == 1:
        new_v = f(container.get(k), *args)
        return container.assoc(k, new_v) if is_cmap else {**container, k: new_v}
    inner = container.get(k) if is_cmap else container.get(k, _MISSING)
    missing = inner is None if is_cmap else inner is _MISSING
    if missing:
        raise s.CausalError(
            "update_in: missing intermediate key.",
            {"causes": {"missing-path-segment"}, "key": k,
             "path": list(path)},
        )
    if not hasattr(inner, "assoc") and not isinstance(inner, dict):
        raise s.CausalError(
            "update_in: intermediate value is not associative.",
            {"causes": {"not-associative"}, "key": k,
             "value_type": type(inner).__name__},
        )
    new_inner = _update_in(inner, path[1:], f, args)
    return (container.assoc(k, new_inner) if is_cmap
            else {**container, k: new_inner})


def new_causal_tree(weaver: str = "pure") -> CausalTree:
    """A fresh map tree; the weave is a dict of key -> list-weave
    (map.cljc:12-19)."""
    return CausalTree(
        type=s.MAP_TYPE,
        lamport_ts=0,
        uuid=new_uid(),
        site_id=new_site_id(),
        nodes={},
        yarns={},
        weave={},
        weaver=weaver,
    )


def weave(ct: CausalTree, node=None, more_nodes=None) -> CausalTree:
    """The map weave function (map.cljc:21-45).

    An id-caused node resolves to its cause's key and weaves under the
    cause inside that key's weave; a key-caused node weaves at the root
    of its key's weave (so plain writes order by recency). Full rebuild
    folds all nodes in sorted id order.
    """
    if node is None:
        if ct.weaver == "native":
            from ..weaver import nativew

            return nativew.refresh_map_weave(ct)
        if ct.weaver == "torch":
            from ..weaver import torchw

            return torchw.refresh_map_weave(ct)
        ct = ct.evolve(weave={})
        for nid in sorted(ct.nodes):
            ct = weave(ct, node_from_kv((nid, ct.nodes[nid])))
        return ct
    nid, cause, v = node
    cause_is_id = is_id(cause)
    if cause_is_id:
        key = ct.nodes.get(cause, (None, None))[0]
        cause_in_weave = cause
    else:
        key = cause
        cause_in_weave = ROOT_ID  # non-id causes weave to the root
    if nid not in ct.nodes:
        return ct
    key_weave = ct.weave.get(key) or [ROOT_NODE]
    key_weave = pure.weave_node(key_weave, (nid, cause_in_weave, v))
    new_weave = dict(ct.weave)
    new_weave[key] = key_weave
    ct = ct.evolve(weave=new_weave)
    if more_nodes:
        return weave(ct, more_nodes[0], list(more_nodes[1:]) or None)
    return ct


def active_node(k, weave_for_key):
    """The active node for one key's weave, or BLANK when hidden
    (map.cljc:47-59). First visible non-root, non-special node whose
    successor is not a hide — i.e. the LWW winner."""
    if not weave_for_key:
        return BLANK
    first_v = weave_for_key[1][2] if len(weave_for_key) > 1 else None
    if first_v is HIDE or first_v is H_HIDE:
        return BLANK
    n_w = len(weave_for_key)
    for i, n in enumerate(weave_for_key):
        nid, _, v = n
        nr_v = weave_for_key[i + 1][2] if i + 1 < n_w else None
        if nid == ROOT_ID:
            continue
        if is_special(v):
            continue
        if nr_v is HIDE or nr_v is H_HIDE:
            continue
        return (nid, k, v)
    return BLANK


def get_(ct: CausalTree, k):
    """Current value at key, or None (map.cljc:61-66)."""
    node = active_node(k, ct.weave.get(k))
    if node is BLANK:
        return None
    return node[2]


def count_(ct: CausalTree) -> int:
    """Number of keys with a visible value (map.cljc:68-73)."""
    return sum(
        1 for k, w in ct.weave.items() if active_node(k, w) is not BLANK
    )


def assoc_(ct: CausalTree, k, v, *kvs) -> CausalTree:
    """Set a key (skips writing an equal value twice, map.cljc:75-81)."""
    if v != get_(ct, k):
        ct = s.append(weave, ct, k, v)
    if kvs:
        return assoc_(ct, *kvs)
    return ct


def dissoc_(ct: CausalTree, k, *ks) -> CausalTree:
    """Hide a key (only keys with a truthy current value, matching the
    reference's nil/false-punning guard, map.cljc:83-89)."""
    cur = get_(ct, k)
    if cur is not None and cur is not False:
        ct = s.append(weave, ct, k, HIDE)
    if ks:
        return dissoc_(ct, *ks)
    return ct


def empty_(ct: CausalTree) -> CausalTree:
    """A fresh tree preserving identity (map.cljc:91-92)."""
    return new_causal_tree(ct.weaver).evolve(site_id=ct.site_id, uuid=ct.uuid)


def causal_map_to_edn(ct: CausalTree, opts: Optional[dict] = None) -> dict:
    """Materialize the current state as a plain dict (map.cljc:94-103)."""
    out = {}
    for k, w in ct.weave.items():
        node = active_node(k, w)
        if node is not BLANK:
            out[node[1]] = s.causal_to_edn(node[2], opts)
    return out


def causal_map_to_list(ct: CausalTree) -> list:
    """The active nodes, newest key first — the reference's reduce-kv
    conj onto a list reverses weave order (map.cljc:105-109)."""
    out = []
    for k, w in ct.weave.items():
        node = active_node(k, w)
        if node is not BLANK:
            out.append(node)
    out.reverse()
    return out


class CausalMap:
    """Immutable CausalMap handle (map.cljc:111-260).

    ``len`` counts visible keys; iteration yields the active *nodes*
    (newest first); ``cm[k]`` / ``cm.get(k)`` return current values.
    """

    __slots__ = ("ct",)

    def __init__(self, ct: CausalTree):
        object.__setattr__(self, "ct", ct)

    def __setattr__(self, *a):
        raise AttributeError("CausalMap is immutable")

    # -- CausalMeta --
    def get_uuid(self) -> str:
        return self.ct.uuid

    def get_ts(self) -> int:
        return self.ct.lamport_ts

    def get_site_id(self) -> str:
        return self.ct.site_id

    # -- CausalTree protocol --
    def get_weave(self):
        return self.ct.weave

    def get_nodes(self):
        return self.ct.nodes

    def insert(self, node, more_nodes=None) -> "CausalMap":
        return CausalMap(s.insert(weave, self.ct, node, more_nodes))

    def append(self, cause, value) -> "CausalMap":
        return CausalMap(s.append(weave, self.ct, cause, value))

    def weft(self, ids_to_cut_yarns) -> "CausalMap":
        return CausalMap(
            s.weft(weave, lambda: new_causal_tree(self.ct.weaver), self.ct,
                   ids_to_cut_yarns)
        )

    def merge(self, other: "CausalMap") -> "CausalMap":
        if self.ct.weaver == "torch":
            from ..weaver import torchw

            return CausalMap(torchw.merge_map_trees(self.ct, other.ct))
        if self.ct.weaver == "native":
            from ..weaver import nativew

            return CausalMap(nativew.merge_trees(self.ct, other.ct))
        return CausalMap(s.merge_trees(weave, self.ct, other.ct))

    def merge_many(self, others) -> "CausalMap":
        """Converge a whole fleet in one pass: N-way node union + one
        full reweave (equals any fold of pairwise merges)."""
        ct = s.union_nodes_many([self.ct] + [o.ct for o in others])
        return CausalMap(weave(ct))

    # -- CausalTo --
    def causal_to_edn(self, opts: Optional[dict] = None) -> dict:
        return causal_map_to_edn(self.ct, opts)

    # -- Python container interop (map.cljc:111-216) --
    def assoc(self, k, v, *kvs) -> "CausalMap":
        return CausalMap(assoc_(self.ct, k, v, *kvs))

    def dissoc(self, k, *ks) -> "CausalMap":
        return CausalMap(dissoc_(self.ct, k, *ks))

    def conj(self, mapping) -> "CausalMap":
        kvs = []
        for k, v in dict(mapping).items():
            kvs.extend((k, v))
        return CausalMap(assoc_(self.ct, *kvs)) if kvs else self

    def empty(self) -> "CausalMap":
        return CausalMap(empty_(self.ct))

    def get(self, k, not_found=None):
        v = get_(self.ct, k)
        return not_found if v is None else v

    def __getitem__(self, k):
        return get_(self.ct, k)

    def __contains__(self, k) -> bool:
        return get_(self.ct, k) is not None

    def __len__(self) -> int:
        return count_(self.ct)

    def __iter__(self):
        return iter(causal_map_to_list(self.ct))

    def keys(self):
        return causal_map_to_edn(self.ct).keys()

    def values(self):
        return causal_map_to_edn(self.ct).values()

    def items(self):
        return causal_map_to_edn(self.ct).items()

    _MISSING = _MISSING

    def get_in(self, path, not_found=None):
        """Walk ``path`` through nested gettable values — CausalMaps,
        plain dicts, and sequences indexed by int (Clojure ``get-in``
        over associative values; exercised at map_test.cljc:56-61).
        A plain-dict key explicitly holding None is *present* (returned
        as None); a CausalMap register holding None is indistinguishable
        from an absent key — the ``get``/``active_node`` contract."""
        cur = self
        for k in path:
            if isinstance(cur, dict):
                cur = cur.get(k, CausalMap._MISSING)
                if cur is CausalMap._MISSING:
                    return not_found
            elif hasattr(cur, "get"):
                cur = cur.get(k)
                if cur is None:
                    return not_found
            elif (isinstance(cur, (list, tuple)) and isinstance(k, int)
                  and 0 <= k < len(cur)):
                cur = cur[k]
            else:
                return not_found
        return cur

    def update(self, k, f, *args) -> "CausalMap":
        """Assoc ``f(current, *args)`` at ``k`` (Clojure ``update``)."""
        return self.assoc(k, f(self.get(k), *args))

    def update_in(self, path, f, *args) -> "CausalMap":
        """Apply ``f`` at a nested path (Clojure ``update-in``).
        Intermediates may be CausalMaps or plain dicts; a missing
        intermediate raises a CausalError naming the absent segment
        (rather than Clojure's silent nil->map auto-create, which would
        mint an un-caused collection inside a CRDT)."""
        path = list(path)
        if not path:
            raise ValueError("update_in: empty path")
        return _update_in(self, path, f, args)

    def reduce_kv(self, f, init):
        """Fold ``f(acc, k, v)`` over the rendered map — the IKVReduce
        analogue, which the reference also defines over the
        materialized EDN (map.cljc:141-143)."""
        acc = init
        for k, v in causal_map_to_edn(self.ct).items():
            acc = f(acc, k, v)
        return acc

    # -- IObj/IMeta analogue (map.cljc:159-163) --
    def with_meta(self, m) -> "CausalMap":
        return CausalMap(self.ct.evolve(meta=m))

    def meta(self):
        return self.ct.meta

    def __eq__(self, other) -> bool:
        return isinstance(other, CausalMap) and self.ct == other.ct

    def __hash__(self) -> int:
        return hash((self.ct.uuid, self.ct.lamport_ts, self.ct.site_id,
                     tuple(sorted(self.ct.nodes))))

    def __repr__(self) -> str:
        return f"#causal/map {causal_map_to_edn(self.ct)!r}"

    def __str__(self) -> str:
        return str(causal_map_to_edn(self.ct))


def new_causal_map(*kvs, weaver: str = "pure", **kwargs) -> CausalMap:
    """Create a new causal map from alternating keys and values and/or
    keyword arguments (map.cljc:256-260)."""
    cm = CausalMap(new_causal_tree(weaver))
    pairs = list(kvs)
    for k, v in kwargs.items():
        pairs.extend((k, v))
    if pairs:
        cm = cm.assoc(*pairs)
    return cm
