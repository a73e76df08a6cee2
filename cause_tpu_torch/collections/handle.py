"""Shared handle machinery for list-shaped causal collections.

List-shaped collections are handles over the same list-tree core
(reference: the deftype protocol surface, list.cljc:74-178) — same
metadata accessors, same insert/append/weft plumbing, and the same
pure/torch merge dispatch. That dispatch is exactly the code that must
never diverge between collection types, so it lives here once and each
concrete class contributes only its rendering and its type-specific
interop: ``CausalList``, ``CausalSet`` and ``CausalCounter``.
"""

from __future__ import annotations

from . import shared as _s

__all__ = ["ListTreeHandle"]


class ListTreeHandle:
    """Mixin for immutable handles over a list-shaped causal tree.

    Concrete classes define ``__slots__ = ("ct",)``, a ``_fresh``
    staticmethod returning an empty tree of their type (same weaver),
    and their own rendering/interop. Every method here returns
    ``type(self)(...)`` so subclasses stay closed under the shared
    operations.
    """

    __slots__ = ()

    def __init__(self, ct):
        object.__setattr__(self, "ct", ct)

    def __setattr__(self, *a):
        raise AttributeError(f"{type(self).__name__} is immutable")

    @staticmethod
    def _fresh(weaver: str):  # pragma: no cover - abstract
        raise NotImplementedError

    # -- CausalMeta (protocols.cljc:3-10) --
    def get_uuid(self) -> str:
        return self.ct.uuid

    def get_ts(self) -> int:
        return self.ct.lamport_ts

    def get_site_id(self) -> str:
        return self.ct.site_id

    @staticmethod
    def _weave_fn():
        # lazy: clist imports this module while defining CausalList
        from . import clist as _c_list

        return _c_list.weave

    # -- CausalTree protocol (protocols.cljc:12-31) --
    def get_weave(self):
        return _s.ensure_weave(self._weave_fn(), self.ct).weave

    def get_nodes(self):
        return self.ct.nodes

    def insert(self, node, more_nodes=None):
        return type(self)(
            _s.insert(self._weave_fn(), self.ct, node, more_nodes)
        )

    def append(self, cause, value):
        return type(self)(_s.append(self._weave_fn(), self.ct, cause, value))

    def weft(self, ids_to_cut_yarns):
        return type(self)(
            _s.weft(self._weave_fn(),
                    lambda: self._fresh(self.ct.weaver),
                    self.ct, ids_to_cut_yarns)
        )

    def merge(self, other):
        if self.ct.weaver == "torch":
            from ..weaver import torchw

            return type(self)(torchw.merge_list_trees(self.ct, other.ct))
        if self.ct.weaver == "native":
            from ..weaver import nativew

            return type(self)(nativew.merge_trees(self.ct, other.ct))
        return type(self)(_s.merge_trees(self._weave_fn(), self.ct, other.ct))

    def merge_many(self, others):
        """Converge a whole fleet in one pass: N-way node union + one
        full reweave (the weave is a pure function of the node set, so
        this equals any fold of pairwise merges). No reference
        analogue — the reference folds pairwise (shared.cljc:300-314).
        Under ``weaver="torch"`` the union, validations and reweave are
        all set-algebra/vectorized/device work — no per-node Python
        loop."""
        if self.ct.weaver == "torch":
            from ..weaver import torchw

            return type(self)(
                torchw.merge_many_list_trees(
                    [self.ct] + [o.ct for o in others]
                )
            )
        ct = _s.union_nodes_many([self.ct] + [o.ct for o in others])
        return type(self)(self._weave_fn()(ct))

    # -- IObj/IMeta analogue (list.cljc:97-101) --
    def with_meta(self, m):
        return type(self)(self.ct.evolve(meta=m))

    def meta(self):
        return self.ct.meta

    def __eq__(self, other) -> bool:
        if not isinstance(other, type(self)):
            return False
        a, b = self.ct, other.ct
        # cheap fields first, so a trivially-unequal compare (membership
        # tests, different uuids) never pays a stale-weave
        # materialization
        if (a.type, a.lamport_ts, a.uuid, a.site_id, a.weaver,
                a.nodes, a.yarns) != (
                b.type, b.lamport_ts, b.uuid, b.site_id, b.weaver,
                b.nodes, b.yarns):
            return False
        # everything canonical matches; a lazy handle equals its eager
        # twin, so materialize any stale weave before the final compare
        for ct_ in (a, b):
            if ct_.weave is None:
                _s.ensure_weave(self._weave_fn(), ct_)
        return a.weave == b.weave

    def __hash__(self) -> int:
        return hash((self.ct.uuid, self.ct.lamport_ts, self.ct.site_id,
                     tuple(sorted(self.ct.nodes))))
