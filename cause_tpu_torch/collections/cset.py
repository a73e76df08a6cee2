"""CausalSet — an observed-remove set CRDT on the causal tree.

A wish of the reference's roadmap ("Implement CausalSet", its
README.md:250) that the reference never built. The tree IS a list tree
(a chain of add-nodes under the weave tail, tombstones as hide
specials), so every weaver of list trees, the device kernels included,
weaves it with no code of its own.

Semantics (classic OR-set): ``add`` appends a node carrying the
element; ``discard`` tombstones every *observed* add-node of the
element. A concurrent add at another site is unobserved by the remover,
so it survives the merge — add wins, the standard OR-set resolution.
Rendered value: the distinct visible elements.
"""

from __future__ import annotations

from typing import Optional

from ..ids import HIDE
from . import clist as c_list
from . import shared as s
from .handle import ListTreeHandle
from .shared import CausalTree

__all__ = ["SET_TYPE", "CausalSet", "new_causal_set", "new_causal_tree"]

SET_TYPE = s.SET_TYPE


def new_causal_tree(weaver: str = "pure") -> CausalTree:
    """A set tree is a list tree with its own type tag."""
    return c_list.new_causal_tree(weaver).evolve(type=SET_TYPE)


def visible_nodes_by_value(ct: CausalTree) -> dict:
    """{element -> [visible nodes carrying it]} in weave order.
    ``add`` fail-fasts on unhashable elements, but nodes can also
    arrive through insert/merge/serde from a replica that did not —
    surface those as CausalError here, not a bare TypeError."""
    out: dict = {}
    for node in c_list.causal_list_to_list(ct):
        try:
            out.setdefault(node[2], []).append(node)
        except TypeError:
            raise s.CausalError(
                "set elements must be hashable",
                {"id": node[0], "type": type(node[2]).__name__},
            ) from None
    return out


def causal_set_to_edn(ct: CausalTree, opts: Optional[dict] = None) -> set:
    return {
        s.causal_to_edn(v, opts) for v in visible_nodes_by_value(ct)
    }


class CausalSet(ListTreeHandle):
    """Immutable CausalSet handle. ``len``/iteration cover the distinct
    visible elements; all mutating-looking methods return a new set.
    The shared protocol surface (metadata, insert/append/weft, merge
    dispatch) lives on ``ListTreeHandle``."""

    __slots__ = ("ct",)

    _fresh = staticmethod(new_causal_tree)

    # -- CausalTo --
    def causal_to_edn(self, opts: Optional[dict] = None) -> set:
        return causal_set_to_edn(self.ct, opts)

    # -- set interop --
    def add(self, value) -> "CausalSet":
        """Add an element. ALWAYS mints a fresh add-node, even when the
        element is already visible — the node is the OR-set's unique
        tag, and it is what lets this add survive a concurrent remove
        (a remove only covers the adds it observed). Skipping
        already-present values (the LWW map's assoc stance) would
        silently drop that protection."""
        try:
            hash(value)
        except TypeError:
            raise s.CausalError(
                "set elements must be hashable",
                {"type": type(value).__name__},
            ) from None
        return CausalSet(c_list.conj_(self.ct, value))

    def discard(self, value) -> "CausalSet":
        """Tombstone every *observed* add of the element (OR-set
        remove); a no-op when absent. Concurrent unobserved adds
        survive a later merge — add wins."""
        nodes = visible_nodes_by_value(self.ct).get(value, [])
        ct = self.ct
        for node in nodes:
            ct = s.append(c_list.weave, ct, node[0], HIDE)
        return CausalSet(ct) if nodes else self

    def empty(self) -> "CausalSet":
        return CausalSet(
            new_causal_tree(self.ct.weaver).evolve(
                site_id=self.ct.site_id, uuid=self.ct.uuid
            )
        )

    def __contains__(self, value) -> bool:
        return value in visible_nodes_by_value(self.ct)

    def __len__(self) -> int:
        return len(visible_nodes_by_value(self.ct))

    def __iter__(self):
        return iter(visible_nodes_by_value(self.ct))

    def __repr__(self) -> str:
        return f"#causal/set {causal_set_to_edn(self.ct)!r}"

    def __str__(self) -> str:
        return str(causal_set_to_edn(self.ct))


def new_causal_set(*items, weaver: str = "pure") -> CausalSet:
    cs = CausalSet(new_causal_tree(weaver))
    for v in items:
        cs = cs.add(v)
    return cs
