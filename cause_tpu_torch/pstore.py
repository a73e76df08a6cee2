"""Amortized-O(1) persistent stores for the hot append paths.

The causal tree is a frozen value: every op returns a new tree, and the
reference gets cheap copies from Clojure's persistent maps/vectors
(shared.cljc:104-119 — ``assoc``/``conj`` are structural sharing).
Python's dict/list made each insert O(n) (a 10k-node tree paid ~200 us
copying ``nodes`` and ~150 us copying its own yarn per conj). These two
classes restore the reference's cost model:

- ``OverlayMap``: an immutable Mapping of (base dict, small extra
  dict). ``assoc`` copies only the extra (bounded ~sqrt(n)), flattening
  into a new base when it grows past the bound — amortized O(sqrt(n))
  per insert instead of O(n).
- ``AppendVec``: an immutable Sequence of frozen blocks + a small
  tail. ``appended`` copies only the tail (bounded by BLOCK) —
  amortized O(1) per append.

Both interoperate with their plain counterparts (dict/list) — mixed
comparisons work via the reflected ``__eq__`` — so the rest of the
codebase keeps producing plain structures wherever it already does.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from itertools import chain

__all__ = ["OverlayMap", "AppendVec", "assoc_items", "yarn_appended"]

# below this store size a plain dict copy is cheaper than the overlay
# bookkeeping; yarns convert to AppendVec past the same scale
_SMALL = 2048


class OverlayMap(Mapping):
    """Immutable mapping = base dict + small extra dict (disjoint
    keys; ``assoc`` flattens on overlap, so lookups never shadow).

    The base is aliased, not copied: the constructor's caller promises
    the base dict is frozen from here on (see assoc_items)."""

    __slots__ = ("_base", "_extra")

    def __init__(self, base: dict, extra: dict):
        self._base = base
        self._extra = extra

    def __getitem__(self, k):
        e = self._extra
        if k in e:
            return e[k]
        return self._base[k]

    def __contains__(self, k):
        return k in self._extra or k in self._base

    def __iter__(self):
        return chain(self._base, self._extra)

    def __len__(self):
        return len(self._base) + len(self._extra)

    def get(self, k, default=None):
        e = self._extra
        if k in e:
            return e[k]
        return self._base.get(k, default)

    def assoc(self, items: dict) -> "Mapping":
        """This mapping plus ``items`` (new object; self unchanged)."""
        base, extra = self._base, self._extra
        if any(k in self for k in items):
            # overwrite: flatten so later lookups stay unambiguous
            out = dict(base)
            out.update(extra)
            out.update(items)
            return out
        new_extra = {**extra, **items}
        # keep the copied-every-assoc part ~sqrt(total): amortized
        # sqrt(n) per op; flattening is rare (every ~sqrt(n) ops)
        if len(new_extra) * len(new_extra) >= max(_SMALL, len(base)):
            out = dict(base)
            out.update(new_extra)
            return out
        return OverlayMap(base, new_extra)

    def __eq__(self, other):
        if not isinstance(other, Mapping):
            return NotImplemented
        if len(other) != len(self):
            return False
        for k, v in self.items():
            if k not in other or other[k] != v:
                return False
        return True

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None  # mutable-adjacent: match dict's unhashability

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"OverlayMap({len(self._base)}+{len(self._extra)})"


class AppendVec(Sequence):
    """Immutable sequence = tuple of frozen blocks + small tail tuple;
    ``appended`` shares every block (amortized O(1))."""

    __slots__ = ("_blocks", "_tail", "_len")

    BLOCK = 128

    def __init__(self, blocks=(), tail=(), length=None):
        self._blocks = blocks
        self._tail = tail
        self._len = (sum(len(b) for b in blocks) + len(tail)
                     if length is None else length)

    @staticmethod
    def from_list(xs) -> "AppendVec":
        xs = tuple(xs)
        B = AppendVec.BLOCK
        blocks = tuple(xs[i:i + B] for i in range(0, len(xs) - len(xs) % B, B))
        tail = xs[len(xs) - len(xs) % B:]
        return AppendVec(blocks, tail, len(xs))

    def appended(self, x) -> "AppendVec":
        tail = self._tail + (x,)
        if len(tail) >= self.BLOCK:
            return AppendVec(self._blocks + (tail,), (), self._len + 1)
        return AppendVec(self._blocks, tail, self._len + 1)

    def __len__(self):
        return self._len

    def __iter__(self):
        for b in self._blocks:
            yield from b
        yield from self._tail

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(self._len)
            if step != 1:
                return list(self)[i]
            # walk only the covered blocks: a suffix slice (the sync
            # delta path, sync.py:91) stays O(len(slice)), not O(n)
            out = []
            B = self.BLOCK
            nb = len(self._blocks)
            for b in range(max(0, start // B), nb):
                lo = b * B
                if lo >= stop:
                    break
                blk = self._blocks[b]
                out.extend(blk[max(0, start - lo):
                               max(0, min(B, stop - lo))])
            tail_lo = nb * B
            if stop > tail_lo:
                out.extend(self._tail[max(0, start - tail_lo):
                                      stop - tail_lo])
            return out
        n = self._len
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        if i >= n - len(self._tail):
            return self._tail[i - (n - len(self._tail))]
        b, off = divmod(i, self.BLOCK)
        return self._blocks[b][off]

    def __eq__(self, other):
        if isinstance(other, AppendVec):
            return (self._len == other._len
                    and all(a == b for a, b in zip(self, other)))
        if isinstance(other, (list, tuple)):
            return (self._len == len(other)
                    and all(a == b for a, b in zip(self, other)))
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    __hash__ = None

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"AppendVec({list(self)!r})"


def assoc_items(store: Mapping, items: dict) -> Mapping:
    """``store`` plus ``items``, picking the cheapest representation:
    plain-dict copy while small, OverlayMap structural sharing once the
    copy would dominate the op.

    ALIASING INVARIANT: past the small-store threshold the caller's
    ``store`` is wrapped as the OverlayMap base WITHOUT copying — it
    must never be mutated in place afterwards or every derived tree
    silently corrupts. All nodes stores in this codebase are treated
    as frozen (union_nodes_many copies first); new callers must keep
    that contract."""
    if isinstance(store, OverlayMap):
        return store.assoc(items)
    if len(store) < _SMALL or any(k in store for k in items):
        # small store, or an overwrite (assoc_nodes is historically
        # overwrite-tolerant): plain copy keeps keys unambiguous
        out = dict(store)
        out.update(items)
        return out
    return OverlayMap(store, dict(items))


def yarn_appended(yarn, n):
    """``yarn`` with ``n`` appended (new object), upgrading big lists
    to AppendVec so the per-append copy stays bounded."""
    if isinstance(yarn, AppendVec):
        return yarn.appended(n)
    if len(yarn) >= _SMALL:
        return AppendVec.from_list(yarn).appended(n)
    return list(yarn) + [n]
