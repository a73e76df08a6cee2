"""CausalCounter — a convergent counter CRDT on the causal tree.

A wish of the reference's roadmap ("Implement CausalCounter", its
README.md:249) that the reference never built. The tree is
a list tree whose node values are numeric deltas; the rendered value
is the sum of visible deltas. Addition commutes, so any merge order
converges; a delta can be undone by tombstoning its node (the same
id-caused hide the other collections use), giving the counter undo
semantics no ordinary PN-counter has.
"""

from __future__ import annotations

from numbers import Number
from typing import Optional

from ..ids import HIDE
from . import clist as c_list
from . import shared as s
from .handle import ListTreeHandle
from .shared import CausalTree

__all__ = [
    "COUNTER_TYPE", "CausalCounter", "new_causal_counter",
    "new_causal_tree",
]

COUNTER_TYPE = s.COUNTER_TYPE


def new_causal_tree(weaver: str = "pure") -> CausalTree:
    """A counter tree is a list tree with its own type tag."""
    return c_list.new_causal_tree(weaver).evolve(type=COUNTER_TYPE)


def counter_value(ct: CausalTree):
    return sum(
        n[2] for n in c_list.causal_list_to_list(ct)
        if isinstance(n[2], Number)
    )


def _check_delta(n) -> None:
    if not isinstance(n, Number) or isinstance(n, bool):
        raise s.CausalError(
            "Counter deltas must be numbers.",
            {"causes": {"not-a-number"}, "value": n},
        )


class CausalCounter(ListTreeHandle):
    """Immutable CausalCounter handle; mutating-looking methods return
    a new counter. The shared protocol surface (metadata,
    insert/append/weft, merge dispatch) lives on ``ListTreeHandle``."""

    __slots__ = ("ct",)

    _fresh = staticmethod(new_causal_tree)

    # -- CausalTo --
    def causal_to_edn(self, opts: Optional[dict] = None):
        return counter_value(self.ct)

    # -- counter interop --
    def increment(self, n=1) -> "CausalCounter":
        """Record a delta (any number, so decrement = increment(-n))."""
        _check_delta(n)
        return CausalCounter(c_list.conj_(self.ct, n))

    def decrement(self, n=1) -> "CausalCounter":
        _check_delta(n)  # before negating: -True is int 1
        return self.increment(-n)

    def undo_delta(self, node_id) -> "CausalCounter":
        """Tombstone one recorded delta by node id."""
        return self.append(node_id, HIDE)

    def value(self):
        return counter_value(self.ct)

    def deltas(self):
        """The visible delta nodes in weave order (for blame/undo)."""
        return [
            n for n in c_list.causal_list_to_list(self.ct)
            if isinstance(n[2], Number)
        ]

    def __int__(self) -> int:
        return int(counter_value(self.ct))

    def __repr__(self) -> str:
        return f"#causal/counter {counter_value(self.ct)!r}"

    def __str__(self) -> str:
        return str(counter_value(self.ct))


def new_causal_counter(start=0, weaver: str = "pure") -> CausalCounter:
    cc = CausalCounter(new_causal_tree(weaver))
    if start:
        cc = cc.increment(start)
    return cc
