"""Structural validation of causal values — the spec schema.

The reference types its data with clojure.spec (reference:
src/causal/collections/shared.cljc:20-73): ids, tx-ids, nodes, special
values, yarns, weaves, and the causal-tree map itself. This package keeps
the same shapes as plain tuples/dicts; this module is the runnable
schema — predicates for every spec plus a whole-tree validator used by
tests and debugging (not on hot paths).

The validators check structure AND the core invariants the reference
encodes in prose and specs:

- ids are ``(nat-int ts, site-id string, nat-int tx-index)`` with the
  root exactly ``(0, "0", 0)``;
- yarns are per-site, strictly time-sorted, and consistent with the
  canonical ``nodes`` store;
- the weave holds exactly the store's nodes (a permutation for lists; a
  per-key partition of mini-weaves for maps, each rooted at the
  sentinel);
- every id-shaped cause resolves inside the tree.
"""

from __future__ import annotations

from typing import List

from .collections import shared as s
from .ids import ROOT_ID, ROOT_NODE, SITE_ID_LENGTH, is_id, is_key

__all__ = [
    "valid_site_id",
    "valid_id",
    "valid_tx_id",
    "valid_node",
    "valid_value",
    "validate_tree",
    "explain_tree",
]


def valid_site_id(x) -> bool:
    """Site ids are 13-char strings, or "0" for the root site
    (shared.cljc:25,35-38)."""
    return isinstance(x, str) and (x == "0" or len(x) == SITE_ID_LENGTH)


def valid_id(x) -> bool:
    """``(lamport-ts, site-id, tx-index)`` (shared.cljc:40)."""
    return is_id(x) and valid_site_id(x[1])


def valid_tx_id(x) -> bool:
    """``(lamport-ts, site-id)`` (shared.cljc:41)."""
    return (
        isinstance(x, tuple)
        and len(x) == 2
        and isinstance(x[0], int)
        and x[0] >= 0
        and valid_site_id(x[1])
    )


def valid_value(x) -> bool:
    """Node values: any EDN-ish value, a special, or a nested ref
    (shared.cljc:46-52). Everything hashable-or-plain passes; this
    predicate exists for symmetry and future tightening."""
    return True


def valid_node(x) -> bool:
    """``(id, cause, value)`` where cause is an id or a key
    (shared.cljc:55-57)."""
    return (
        isinstance(x, tuple)
        and len(x) == 3
        and valid_id(x[0])
        and (valid_id(x[1]) or is_key(x[1]) or x[1] is None)
    )


def explain_tree(ct) -> List[str]:
    """All invariant violations of a causal tree (empty = valid). The
    runnable equivalent of ``s/explain ::causal-tree``."""
    problems: List[str] = []

    from .collections.ccounter import COUNTER_TYPE
    from .collections.cset import SET_TYPE

    if ct.type not in (s.LIST_TYPE, s.MAP_TYPE, SET_TYPE, COUNTER_TYPE):
        problems.append(f"unknown tree type {ct.type!r}")
        return problems
    if not isinstance(ct.lamport_ts, int) or ct.lamport_ts < 0:
        problems.append(f"bad lamport-ts {ct.lamport_ts!r}")
    if not isinstance(ct.uuid, str) or not ct.uuid:
        problems.append(f"bad uuid {ct.uuid!r}")
    if not valid_site_id(ct.site_id):
        problems.append(f"bad site-id {ct.site_id!r}")

    # set/counter trees are list-shaped (root sentinel, id causes,
    # flat list weave) — they share every list invariant
    is_list = ct.type in (s.LIST_TYPE, SET_TYPE, COUNTER_TYPE)

    # ---- canonical store
    for nid, body in ct.nodes.items():
        if not valid_id(nid):
            problems.append(f"bad id {nid!r}")
            continue
        if not isinstance(body, tuple) or len(body) != 2:
            problems.append(f"bad node body for {nid!r}")
            continue
        cause = body[0]
        if nid == ROOT_ID:
            continue
        if is_id(cause) and tuple(cause) not in ct.nodes:
            problems.append(f"dangling cause {cause!r} of {nid!r}")
        if is_list and not is_id(cause):
            problems.append(f"list node {nid!r} has non-id cause {cause!r}")
        if nid[0] > ct.lamport_ts:
            problems.append(
                f"node {nid!r} is newer than the tree clock {ct.lamport_ts}"
            )
    if is_list and ROOT_ID not in ct.nodes:
        problems.append("list tree is missing the root sentinel")

    # ---- yarns: per-site, strictly ascending, consistent with nodes
    yarn_ids = set()
    for site, yarn in ct.yarns.items():
        prev = None
        for n in yarn:
            if n[0][1] != site:
                problems.append(f"yarn {site!r} holds foreign node {n[0]!r}")
            if prev is not None and not (prev < n[0]):
                problems.append(f"yarn {site!r} is not time-sorted at {n[0]!r}")
            prev = n[0]
            if n[0] not in ct.nodes or ct.nodes[n[0]] != (n[1], n[2]):
                problems.append(f"yarn node {n[0]!r} disagrees with the store")
            yarn_ids.add(n[0])
    if yarn_ids != set(ct.nodes):
        problems.append("yarns and store hold different node sets")

    # ---- weave: same node set as the store, correct shape
    if is_list:
        if not isinstance(ct.weave, list):
            problems.append("list weave is not a list")
        else:
            weave_ids = [n[0] for n in ct.weave]
            if sorted(weave_ids) != sorted(ct.nodes):
                problems.append("list weave is not a permutation of the store")
            elif ct.weave and ct.weave[0] != ROOT_NODE:
                problems.append("list weave does not start at the root")
            else:
                for n in ct.weave[1:]:
                    if ct.nodes.get(n[0]) != (n[1], n[2]):
                        problems.append(
                            f"weave node {n[0]!r} disagrees with the store"
                        )
    else:
        if not isinstance(ct.weave, dict):
            problems.append("map weave is not a dict of key-weaves")
        else:
            woven = []
            for k, kw in ct.weave.items():
                if not kw or kw[0] != ROOT_NODE:
                    problems.append(f"key-weave {k!r} missing its root")
                    continue
                woven.extend(n[0] for n in kw[1:])
                for n in kw[1:]:
                    body = ct.nodes.get(n[0])
                    # in-weave causes are rewritten to the root for
                    # key-caused nodes (map.cljc:77): a root-caused
                    # entry must be filed under its store key, an
                    # id-caused one must keep its store cause; values
                    # must agree either way
                    if (
                        body is None
                        or body[1] != n[2]
                        or (n[1] == ROOT_ID and body[0] != k)
                        or (n[1] != ROOT_ID and body[0] != n[1])
                    ):
                        problems.append(
                            f"key-weave node {n[0]!r} disagrees with the store"
                        )
            if sorted(woven) != sorted(ct.nodes):
                problems.append("map weave does not partition the store")

    return problems


def validate_tree(ct) -> bool:
    """True iff the tree satisfies every invariant; raise-free."""
    return not explain_tree(ct)
