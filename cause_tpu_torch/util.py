"""Ordering and sorted-vector algorithms (reference: src/causal/util.cljc).

These operate on plain Python lists kept in sorted order; comparison is
native tuple comparison, which coincides with the reference's ``compare``
for the id / node / reverse-path shapes used throughout.
"""

from __future__ import annotations

__all__ = [
    "lt",
    "sorted_insertion_index",
    "insert_sorted",
    "binary_search",
    "char_seq",
]


def lt(a, b) -> bool:
    """``<<`` — strictly-increasing comparison (util.cljc:4-10)."""
    return a < b


def sorted_insertion_index(coll, target, uniq: bool = False):
    """Binary-search insertion index in an already-sorted list
    (util.cljc:25-39). With ``uniq=True`` returns None when an exactly
    equal element is already present (dedupe-on-insert)."""
    low, high = 0, len(coll) - 1
    while low <= high:
        mid = (low + high) // 2
        mid_val = coll[mid]
        if mid_val == target:
            return None if uniq else mid
        if mid_val < target:
            low = mid + 1
        else:
            high = mid - 1
    return low


def insert_sorted(coll, val, next_vals=None, index=None):
    """Splice ``val`` (and optionally a run of ``next_vals``) into a list.

    With ``index=None`` the list is assumed sorted and the sort is
    maintained; if an equal element already exists the list is returned
    unchanged (reference: util.cljc:41-48, the ``:uniq`` path).
    Always returns a new list.
    """
    if index is None:
        index = sorted_insertion_index(coll, val, uniq=True)
        if index is None:
            return list(coll)
    out = list(coll[:index])
    out.append(val)
    if next_vals:
        out.extend(next_vals)
    out.extend(coll[index:])
    return out


def char_seq(text: str):
    """Split a string into user-perceived character units
    (util.cljc:76-92).

    The reference exists to keep UTF-16 surrogate pairs together on the
    JVM/JS hosts; Python 3 strings are code-point sequences so astral
    chars are whole by construction. We additionally keep combining
    marks, ZWJ sequences and variation selectors glued to their base
    character — the case the reference documents as known-broken
    (util.cljc:94-97). Unlike the reference (whose char-seq is unused;
    base/core.cljc:146 falls back to seq), this IS the CausalBase
    flattener's string splitter (cbase.list_to_nodes), so a ZWJ emoji
    survives transact->edn as one node.
    """
    import unicodedata

    out = []
    cluster = ""
    join_next = False
    for ch in text:
        cp = ord(ch)
        is_zwj = cp == 0x200D
        is_extend = (
            unicodedata.combining(ch) != 0
            or 0xFE00 <= cp <= 0xFE0F      # variation selectors
            or 0x1F3FB <= cp <= 0x1F3FF    # emoji skin-tone modifiers
        )
        if cluster and (join_next or is_zwj or is_extend):
            cluster += ch
        else:
            if cluster:
                out.append(cluster)
            cluster = ch
        join_next = is_zwj
    if cluster:
        out.append(cluster)
    return out


def binary_search(xs, x, match_fn=None, less_than_fn=None):
    """Binary search a sorted list with custom match / less-than predicates
    (util.cljc:50-64). Returns a matching index or None."""
    if match_fn is None:
        match_fn = lambda v, t: v == t
    if less_than_fn is None:
        less_than_fn = lambda v, t: v < t
    left, right = 0, len(xs) - 1
    while left <= right:
        i = (left + right) // 2
        v = xs[i]
        if match_fn(v, x):
            return i
        if less_than_fn(v, x):
            left = i + 1
        else:
            right = i - 1
    return None
