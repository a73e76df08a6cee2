"""Node model: ids, special values, root sentinel, uid generation.

This is the port's equivalent of the reference spec schema
(reference: src/causal/collections/shared.cljc:20-73 and src/causal/util.cljc:12-23):

- an **id** is a ``(lamport_ts, site_id, tx_index)`` triple
  (shared.cljc:40); ``lamport_ts`` and ``tx_index`` are non-negative ints,
  ``site_id`` is a 13-char random string or ``"0"`` (shared.cljc:25,35-38).
  The total order over ids is plain lexicographic tuple comparison, which is
  exactly the reference's ``<<`` / ``compare`` order (util.cljc:4-10).
- a **tx-id** is the first two fields ``(lamport_ts, site_id)``
  (shared.cljc:41); ``tx_index`` is the within-transaction tie-breaker.
- a **node** is an ``(id, cause, value)`` triple (shared.cljc:55-57).
  ``cause`` is an id (lists) or a key (maps); ``value`` is any
  EDN-like Python value, a special, or a nested collection ref.
- **special values** ``HIDE``/``H_HIDE``/``H_SHOW`` (shared.cljc:21) are the
  tombstone / history-hide / history-show markers. Specials do not compose:
  hiding a hide is not a show (reference: src/causal/core.cljc:13-14).
- the **root** ``ROOT_ID = (0, "0", 0)`` / ``ROOT_NODE`` (shared.cljc:22-23)
  is the sentinel head of every list weave.

Everything here is host-side. On device (see weaver.arrays) ids
become structured int32 lanes with site ids interned to order-preserving
integer ranks, and values are reduced to a value-class lane.
"""

from __future__ import annotations

import random

__all__ = [
    "Keyword",
    "K",
    "Special",
    "HIDE",
    "H_HIDE",
    "H_SHOW",
    "SPECIALS",
    "is_special",
    "ROOT_ID",
    "ROOT_NODE",
    "UUID_LENGTH",
    "SITE_ID_LENGTH",
    "is_id",
    "is_key",
    "node",
    "node_from_kv",
    "get_tx",
    "new_uid",
    "new_site_id",
]


class Special:
    """One of the three special causal markers.

    Interned singletons; identity comparison is safe. Mirrors the
    reference special keywords :causal/hide, :causal/h.hide,
    :causal/h.show (shared.cljc:21).
    """

    __slots__ = ("name",)
    _interned: dict = {}
    _allowed = ("hide", "h.hide", "h.show")

    def __new__(cls, name: str) -> "Special":
        if name not in cls._allowed:
            raise ValueError(f"unknown special keyword: {name!r}")
        inst = cls._interned.get(name)
        if inst is None:
            inst = super().__new__(cls)
            object.__setattr__(inst, "name", name)
            cls._interned[name] = inst
        return inst

    def __setattr__(self, *a):  # immutable
        raise AttributeError("Special values are immutable")

    def __repr__(self) -> str:
        return f":causal/{self.name}"

    def __reduce__(self):  # pickle round-trips to the interned instance
        return (Special, (self.name,))

    # Specials sort after every non-special in no particular user-visible
    # order; they only need a *stable* order among themselves for the
    # host-side sorted containers (yarns never tie on id, so this is a
    # belt-and-braces fallback, never semantics).
    def __lt__(self, other):
        if isinstance(other, Special):
            return self.name < other.name
        return NotImplemented


class Keyword:
    """An interned symbolic key, the Python stand-in for EDN keywords.

    Map keys in the reference are keywords or strings
    (shared.cljc:42-43); the distinction matters to the CausalBase
    flattener, where a *string* inside a list explodes into char nodes
    while a keyword is stored whole (base/core.cljc:145-147). Plain
    Python strings also work as keys everywhere; use Keyword when you
    need the keyword behavior (or keyword-looking output).
    """

    __slots__ = ("name",)
    _interned: dict = {}

    def __new__(cls, name: str) -> "Keyword":
        inst = cls._interned.get(name)
        if inst is None:
            inst = super().__new__(cls)
            object.__setattr__(inst, "name", name)
            cls._interned[name] = inst
        return inst

    def __setattr__(self, *a):
        raise AttributeError("Keywords are immutable")

    def __repr__(self) -> str:
        return f":{self.name}"

    def __reduce__(self):
        return (Keyword, (self.name,))

    def __lt__(self, other):
        if isinstance(other, Keyword):
            return self.name < other.name
        return NotImplemented


K = Keyword


HIDE = Special("hide")
H_HIDE = Special("h.hide")
H_SHOW = Special("h.show")
SPECIALS = frozenset((HIDE, H_HIDE, H_SHOW))


def is_special(v) -> bool:
    """True for the three special markers (shared.cljc:21)."""
    return type(v) is Special


ROOT_ID = (0, "0", 0)
ROOT_NODE = (ROOT_ID, None, None)

UUID_LENGTH = 21
SITE_ID_LENGTH = 13

# Alphabet chosen so uids are valid identifier-ish tokens; first char is
# never a digit (reference: src/causal/util.cljc:12-13).
_FIRST_CHAR_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZ_abcdefghijklmnopqrstuvwxyz"
_ID_ALPHABET = "0123456789" + _FIRST_CHAR_ALPHABET

_rng = random.Random()


def new_uid(length: int = UUID_LENGTH) -> str:
    """Globally unique id string (reference: util.cljc:15-23)."""
    first = _rng.choice(_FIRST_CHAR_ALPHABET)
    rest = "".join(_rng.choice(_ID_ALPHABET) for _ in range(length - 1))
    return first + rest


def new_site_id() -> str:
    """13-char site identifier (shared.cljc:25,75)."""
    return new_uid(SITE_ID_LENGTH)


def is_id(x) -> bool:
    """Structural check for an id triple (shared.cljc:40).

    Like the reference's ``spec/valid? ::id`` this is a structural
    predicate, so a map key that happens to be an (int, str, int) triple
    is indistinguishable from an id — same ambiguity as the reference.
    """
    return (
        type(x) is tuple
        and len(x) == 3
        and type(x[0]) is int
        and x[0] >= 0
        and type(x[1]) is str
        and type(x[2]) is int
        and x[2] >= 0
    )


def is_key(x) -> bool:
    """Structural check for a map key cause (shared.cljc:42-43).

    The reference allows keywords and strings as map keys; we allow any
    hashable non-id value, with strings playing the keyword role.
    """
    return not is_id(x)


def node(lamport_ts: int, site_id: str, *rest):
    """Create a node for insertion into a causal collection.

    Mirrors the 4- and 5-arity forms of the reference ``new-node``
    (shared.cljc:77-98)::

        node(ts, site, cause, value)            # tx_index defaults to 0
        node(ts, site, tx_index, cause, value)
    """
    if len(rest) == 2:
        tx_index, (cause, value) = 0, rest
    elif len(rest) == 3:
        tx_index, cause, value = rest
    else:
        raise TypeError("node() takes (ts, site, cause, value) or (ts, site, tx, cause, value)")
    nid = (lamport_ts, site_id, tx_index)
    if cause == nid:
        raise ValueError("a node's cause cannot equal its own id")
    return (nid, cause, value)


def node_from_kv(kv):
    """Map a ``(id, (cause, value))`` entry of the nodes store back to a
    node triple (the 1-arity reference ``new-node``, shared.cljc:79-80)."""
    nid, (cause, value) = kv
    return (nid, cause, value)


def get_tx(n):
    """The ``(lamport_ts, site_id)`` transaction tuple of a node
    (shared.cljc:100-102)."""
    return n[0][:2]
