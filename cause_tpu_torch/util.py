"""Sorted-vector algorithms (reference: src/causal/util.cljc): the
subset the port's collections use.

These operate on plain Python lists kept in sorted order; comparison is
native tuple comparison, which coincides with the reference's ``compare``
for the id / node / reverse-path shapes used throughout.
"""

from __future__ import annotations

__all__ = [
    "sorted_insertion_index",
    "insert_sorted",
]


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
