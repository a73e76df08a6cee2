"""CausalList — a sequence CRDT (RGA-style causal tree).

Port of reference src/causal/collections/list.cljc: causes are
predecessor ids, the weave is a flat list of nodes, and rendering skips
specials, tombstoned nodes and the root. Python container protocols
mirror the reference's Clojure interop: ``len`` counts *active values*
(list.cljc:76-77) while iteration yields the visible *nodes* themselves
(list.cljc:94-95) — "seq returns nodes, count counts values".
"""

from __future__ import annotations

from typing import Optional

from ..ids import (
    HIDE,
    H_HIDE,
    ROOT_ID,
    ROOT_NODE,
    is_special,
    new_site_id,
    new_uid,
    node_from_kv,
)
from ..weaver import pure
from . import shared as s
from .handle import ListTreeHandle
from .shared import CausalTree

__all__ = [
    "new_causal_tree",
    "weave",
    "extend_",
    "hide_q",
    "causal_list_to_edn",
    "causal_list_to_list",
    "CausalList",
    "new_causal_list",
]


def new_causal_tree(weaver: str = "pure", lazy: bool = False) -> CausalTree:
    """A fresh list tree seeded with the root sentinel in all three
    stores (list.cljc:11-18). ``lazy`` defers the weave cache to first
    read (shared.ensure_weave) — the fleet-editing mode."""
    return CausalTree(
        type=s.LIST_TYPE,
        lamport_ts=0,
        uuid=new_uid(),
        site_id=new_site_id(),
        nodes={ROOT_ID: (None, None)},
        yarns={"0": [ROOT_NODE]},
        weave=[ROOT_NODE],
        weaver=weaver,
        lazy_weave=lazy,
    )


def weave(ct: CausalTree, node=None, more_consecutive_nodes_in_same_tx=None) -> CausalTree:
    """The list weave function (list.cljc:20-34).

    Full rebuild (no node): fold every node, in sorted id order, through
    the sequential weave — O(n^2) on the host, or one batched device
    linearization when the tree's weaver is "torch". Incremental (node
    given): O(n) single scan; a run of same-tx nodes is spliced in the
    same pass.
    """
    if node is None:
        if ct.weaver == "torch":
            from ..weaver import torchw

            return torchw.refresh_list_weave(ct)
        if ct.weaver == "native":
            from ..weaver import nativew

            return nativew.refresh_list_weave(ct)
        w = []
        for nid in sorted(ct.nodes):
            w = pure.weave_node(w, node_from_kv((nid, ct.nodes[nid])))
        return ct.evolve(weave=w)
    if node[0] not in ct.nodes:
        return ct
    return ct.evolve(
        weave=pure.weave_node(ct.weave, node, more_consecutive_nodes_in_same_tx)
    )


def _tail_id(ct: CausalTree):
    """Id of the last weave node — from the lazy tail hint when it is
    alive (no weave needed), else from the (materialized) weave."""
    if ct.weave is None and ct.weave_tail is not None:
        return ct.weave_tail
    return s.ensure_weave(weave, ct).weave[-1][0]


def conj_(ct: CausalTree, *values) -> CausalTree:
    """Append value(s) after the last node of the current weave
    (list.cljc:36-40)."""
    for v in values:
        ct = s.append(weave, ct, _tail_id(ct), v)
    return ct


def cons_(v, ct: CausalTree) -> CausalTree:
    """Insert a value at the front (cause = root, list.cljc:42-43)."""
    return s.append(weave, ct, ROOT_ID, v)


# one transaction holds 2^13 nodes (tx-indices 0..8191, PackSpec.tx_bits);
# longer pastes split into several transactions
MAX_TX_RUN = 1 << 13


def extend_(ct: CausalTree, values) -> CausalTree:
    """Append many values as contiguous transaction runs: one lamport
    tick per run, tx-index ordering within it, one O(n+m) weave splice
    (the paste path — reference README.md:50,229, list.cljc:23-25 —
    where per-value conj would cost O(n*m))."""
    values = list(values)
    while values:
        chunk, values = values[:MAX_TX_RUN], values[MAX_TX_RUN:]
        cause = _tail_id(ct)
        ct = ct.evolve(lamport_ts=ct.lamport_ts + 1)
        nodes = []
        for i, v in enumerate(chunk):
            nid = (ct.lamport_ts, ct.site_id, i)
            nodes.append((nid, cause, v))
            cause = nid
        ct = s.insert(weave, ct, nodes[0], nodes[1:] or None)
    return ct


def empty_(ct: CausalTree) -> CausalTree:
    """A fresh tree preserving identity (site-id, uuid, weaver, lazy
    mode) (list.cljc:45-46)."""
    return new_causal_tree(ct.weaver, lazy=ct.lazy_weave).evolve(
        site_id=ct.site_id, uuid=ct.uuid)


def hide_q(node, next_node_in_weave) -> bool:
    """Is this node hidden when the weave is rendered? (list.cljc:48-55)
    Hidden iff it is a special, or the next weave node is a hide/h.hide
    targeting it, or it is the root."""
    if is_special(node[2]):
        return True
    nr = next_node_in_weave
    if nr is not None and (nr[2] is HIDE or nr[2] is H_HIDE) and node[0] == nr[1]:
        return True
    return node == ROOT_NODE


def causal_list_to_edn(ct: CausalTree, opts: Optional[dict] = None) -> list:
    """Materialize the current state as a plain list (list.cljc:57-66):
    pairwise scan over the weave keeping visible values."""
    w = s.ensure_weave(weave, ct).weave
    out = []
    for i, n in enumerate(w):
        nr = w[i + 1] if i + 1 < len(w) else None
        if not hide_q(n, nr):
            out.append(s.causal_to_edn(n[2], opts))
    return out


def causal_list_to_list(ct: CausalTree) -> list:
    """The visible *nodes* in weave order (list.cljc:68-72)."""
    w = s.ensure_weave(weave, ct).weave
    out = []
    for i, n in enumerate(w):
        nr = w[i + 1] if i + 1 < len(w) else None
        if not hide_q(n, nr):
            out.append(n)
    return out


class CausalList(ListTreeHandle):
    """Immutable CausalList handle (list.cljc:74-178).

    ``len`` counts active values; iteration yields visible nodes.
    All mutating-looking methods return a new CausalList. The shared
    protocol surface (metadata, insert/append/weft, pure/torch
    merge dispatch) lives on ``ListTreeHandle``.
    """

    __slots__ = ("ct",)

    _fresh = staticmethod(new_causal_tree)

    # -- CausalTo (protocols.cljc:33-35) --
    def causal_to_edn(self, opts: Optional[dict] = None) -> list:
        return causal_list_to_edn(self.ct, opts)

    def tail_id(self):
        """Id of the last weave node — what ``conj`` will cause. On a
        lazy tree with a live tail hint this is O(1), no weave needed."""
        return _tail_id(self.ct)

    # -- Python container interop (mirrors list.cljc:74-135) --
    def conj(self, *values) -> "CausalList":
        return CausalList(conj_(self.ct, *values))

    def cons(self, value) -> "CausalList":
        return CausalList(cons_(value, self.ct))

    def extend(self, values) -> "CausalList":
        """Append many values as one transaction run per 8k chunk —
        O(n+m) instead of conj's O(n*m)."""
        return CausalList(extend_(self.ct, values))

    def empty(self) -> "CausalList":
        return CausalList(empty_(self.ct))

    def __len__(self) -> int:
        return len(causal_list_to_edn(self.ct))

    def __iter__(self):
        return iter(causal_list_to_list(self.ct))

    def __getitem__(self, i):
        """Visible node(s) by weave position — the indexed view of the
        same sequence iteration yields (nodes, not values; the
        reference's seq/nth contract, list.cljc:94-95). Negative
        indices and slices follow Python list semantics.

        Each indexed access materializes the visible-node list (O(n));
        for bulk access iterate once (``list(cl)``) or render once
        (``causal_to_edn``) instead of indexing in a loop."""
        return causal_list_to_list(self.ct)[i]

    def nth(self, i, *default):
        """Node at position ``i``, or ``default`` when out of range
        (Clojure ``nth``'s 3-arity — negative indices are out of range,
        as in Clojure; use ``cl[i]`` for Python negative indexing)."""
        nodes = causal_list_to_list(self.ct)
        if 0 <= i < len(nodes):
            return nodes[i]
        if default:
            return default[0]
        raise IndexError(f"nth: index {i} out of range for {len(nodes)}")

    def get(self, i, not_found=None):
        """Rendered *value* at position ``i`` (``get`` on a Clojure
        sequential: the materialized element, not the node)."""
        vals = causal_list_to_edn(self.ct)
        if isinstance(i, int) and -len(vals) <= i < len(vals):
            return vals[i]
        return not_found

    def __repr__(self) -> str:
        return f"#causal/list {causal_list_to_edn(self.ct)!r}"

    def __str__(self) -> str:
        return str(causal_list_to_list(self.ct))


def new_causal_list(*items, weaver: str = "pure",
                    lazy: bool = False) -> CausalList:
    """Create a new causal list containing the items (list.cljc:175-178).
    ``lazy=True`` defers weave maintenance to first read — the editing
    mode for device-backed fleet replicas (shared.CausalTree.lazy_weave)."""
    cl = CausalList(new_causal_tree(weaver, lazy=lazy))
    if items:
        cl = cl.conj(*items)
    return cl
