"""Causal-tree core: tree shape, insert/append, yarn cache, weft, merge.

The port's equivalent of the reference's generic CRDT core
(reference: src/causal/collections/shared.cljc). A causal tree holds:

- ``nodes`` — canonical append-only store ``{id: (cause, value)}``
  (shared.cljc:9,62);
- ``yarns`` — CACHE: per-site, time-sorted list of nodes
  (shared.cljc:10,64-65), kept so weft (time travel) is fast;
- ``weave`` — CACHE: the linearized output order; a list of nodes for
  list trees (shared.cljc:67) or a ``{key: list-weave}`` dict for map
  trees (shared.cljc:68).

Caches are disposable: ``refresh_caches`` rebuilds yarns, lamport-ts and
the weave from ``nodes`` alone (shared.cljc:259-266) — a tree can always
be reconstituted from a bag of nodes.

All operations are functional: they return a new ``CausalTree`` value and
never mutate their input (copy-on-write per call, mirroring the
reference's persistent maps). The host-side structures stay O(n)-per-op
like the reference; bulk/batched work belongs to the device weaver.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs
from .. import pstore
from .. import util as u
from ..ids import (
    ROOT_ID,
    is_key,
    is_special,
    new_site_id,
    new_uid,
    node_from_kv,
    get_tx,
)
from ..weaver import pure

__all__ = [
    "CausalTree",
    "CausalError",
    "assoc_nodes",
    "spin",
    "insert",
    "ensure_weave",
    "append",
    "refresh_ts",
    "yarns_to_nodes",
    "refresh_caches",
    "weft",
    "check_mergeable",
    "union_nodes",
    "union_nodes_many",
    "merge_trees",
    "causal_to_edn",
    "weaver_name",
]

LIST_TYPE = "list"
MAP_TYPE = "map"
# the list-shaped tree types of the set and counter collections
SET_TYPE = "set"
COUNTER_TYPE = "counter"


def weaver_name(name: str) -> str:
    """The weave backend a new tree or base gets: the reference's device
    weaver (``"jax"``) is this package's (``"torch"``); any other name
    is kept, as the reference keeps it."""
    return "torch" if name == "jax" else name


class CausalError(Exception):
    """Validation failure in a causal operation. Carries an info dict like
    the reference's ``ex-info`` (e.g. shared.cljc:163-181)."""

    def __init__(self, message: str, info: Optional[dict] = None):
        super().__init__(message)
        self.info = info or {}


@dataclass(frozen=True)
class CausalTree:
    """One causal tree (shared.cljc:72-73). Treat as immutable; all ops
    return a new tree. ``weaver`` selects the weave backend: "pure"
    (host scan, default) or "torch" (device kernels for full rebuilds
    and merges) — the framework's one real flag."""

    type: str
    lamport_ts: int
    uuid: str
    site_id: str
    nodes: Dict[tuple, tuple]
    yarns: Dict[str, list]
    # CACHE, excluded from equality: ``nodes`` (with ``yarns``) fully
    # determines the weave — ``ensure_weave`` rebuilds it from them —
    # and under ``lazy_weave`` a stale tree (weave=None) must still
    # compare equal to its materialized twin at the raw-dataclass
    # level, not only through ListTreeHandle.__eq__.
    weave: Any = field(compare=False)
    weaver: str = "pure"
    # IObj/IMeta analogue (list.cljc:97-101, map.cljc:159-163): an
    # arbitrary attachment that never affects equality and is not
    # serialized — Clojure metadata semantics.
    meta: Any = field(default=None, compare=False)
    # Lazy weave mode (list trees, opt-in): inserts skip the O(n) host
    # weave splice entirely; ``weave=None`` marks the cache stale and
    # any reader materializes it once via ``ensure_weave`` (a full
    # rebuild — device-routed under weaver="torch"). ``weave_tail`` is
    # the one incremental fact kept alive while stale: the id of the
    # current last weave node, valid only for the append-at-tail chain
    # (``conj``'s cause), invalidated by any other insert. No
    # reference analogue — the reference always weaves eagerly
    # (shared.cljc:12); this is the device-fleet editing mode where the
    # device wave, not the host, owns linearization.
    lazy_weave: bool = field(default=False, compare=False)
    weave_tail: Any = field(default=None, compare=False, repr=False)
    # CACHE: marshalled device lanes (weaver.lanecache.LaneView), the
    # fourth disposable cache next to yarns/weave — maintained on the
    # append fast path, attached by the device weaver after rebuilds,
    # and cleared by ``evolve`` whenever ``nodes`` changes without an
    # explicit replacement (so it can never go stale).
    lanes: Any = field(default=None, compare=False, repr=False)

    def evolve(self, **kw) -> "CausalTree":
        if "nodes" in kw and "lanes" not in kw:
            kw["lanes"] = None
        return replace(self, **kw)


WeaveFn = Callable[..., CausalTree]


def assoc_nodes(ct: CausalTree, nodes) -> CausalTree:
    """Add node triples to the canonical ``nodes`` store
    (shared.cljc:104-110). Structural sharing past the small-store
    threshold (pstore.assoc_items) keeps this amortized-sublinear, the
    reference's persistent-map cost model."""
    return ct.evolve(nodes=pstore.assoc_items(
        ct.nodes, {n[0]: (n[1], n[2]) for n in nodes}
    ))


def _spin_one(yarns: Dict[str, list], n) -> None:
    """Place one node into its site's time-sorted yarn, mutating the
    (freshly copied) yarns dict (shared.cljc:112-119)."""
    site = n[0][1]
    yarn = yarns.get(site)
    if yarn is None:
        yarns[site] = [n]
    elif yarn[-1][0] < n[0]:
        yarns[site] = pstore.yarn_appended(yarn, n)
    else:
        # expensive sorted splice; avoided on the append fast path above
        yarns[site] = u.insert_sorted(yarn, n)


def spin(ct: CausalTree, node=None, more_nodes=None) -> CausalTree:
    """Maintain the yarn cache (shared.cljc:121-149).

    With no node, rebuild every yarn from the canonical store in sorted
    id order. With a node (and optional same-tx run), place just those.
    The reference intends a bulk fast path for sequential list
    transactions (shared.cljc:137-143) but its guard never fires; we spin
    one node at a time, which is the behavior it actually exhibits (the
    per-site append fast path keeps the common case O(1)).
    """
    yarns = dict(ct.yarns)
    if node is None:
        # bulk rebuild: sorted ids grouped by site in one pass — the
        # incremental path's copy-on-append would be O(n^2) here
        yarns = {}
        for nid, (cause, value) in sorted(ct.nodes.items()):
            yarns.setdefault(nid[1], []).append((nid, cause, value))
    else:
        _spin_one(yarns, node)
        if more_nodes:
            for n in more_nodes:
                _spin_one(yarns, n)
    return ct.evolve(yarns=yarns)


def insert(weave_fn: WeaveFn, ct: CausalTree, node, more_nodes_in_tx=None) -> CausalTree:
    """Insert an arbitrary node from any site and any point in time
    (shared.cljc:151-184). Validations:

    - all nodes in one call must belong to the same transaction;
    - re-inserting an identical node is an idempotent no-op; inserting a
      *different* body under an existing id raises (append-only store);
    - an id-valued cause must already exist in the tree;
    - the local lamport-ts fast-forwards to the node's ts if greater.
    """
    nodes = [node]
    if more_nodes_in_tx:
        nodes.extend(more_nodes_in_tx)
    txs = {get_tx(n) for n in nodes}
    if len(txs) > 1:
        raise CausalError("All nodes must belong to the same tx.", {"txs": txs})
    # every node of the run gets the same scrutiny as a single insert —
    # a run must not be a validation bypass (append-only bodies, causes
    # resolving in the tree or earlier in the run)
    dup = 0
    for nd in nodes:
        existing = ct.nodes.get(nd[0])
        if existing is not None:
            if existing != (nd[1], nd[2]):
                raise CausalError(
                    "This node is already in the tree and can't be changed.",
                    {"causes": {"append-only", "edits-not-allowed"},
                     "existing_node": (nd[0],) + existing},
                )
            dup += 1
    if dup == len(nodes):
        return ct  # idempotency!
    if dup:
        raise CausalError(
            "A same-tx run must be all-new or an exact replay.",
            {"causes": {"append-only", "partial-tx-run"}},
        )
    seen = set()
    for nd in nodes:
        if not is_key(nd[1]) and nd[1] not in ct.nodes and nd[1] not in seen:
            raise CausalError(
                "The cause of this node is not in the tree.",
                {"causes": {"cause-must-exist"}},
            )
        seen.add(nd[0])
    if obs.enabled():
        # convergence-lag provenance: every local mutation funnels
        # through here (conj/cons/extend/insert all land on this
        # validated path), so this is the one host-side stamp point —
        # site and lamport ride in the node id, the monotonic clock is
        # captured inside op_created, all outside any trace
        op_ids = [nd[0] for nd in nodes]
        obs.lag.op_created(ct.uuid, op_ids)
        # distributed-trace mint: the same funnel is where a
        # locally-created batch gets its causal identity; ops already
        # bound (a replayed run) keep their original trace
        tr = obs.xtrace.new_trace()
        obs.xtrace.hop("mint", tr, parent="", source="funnel",
                       uuid=str(ct.uuid), ops=len(nodes))
        obs.xtrace.bind_ops(tr, op_ids)
    # a non-chaining same-tx run is the one input whose INCREMENTAL
    # weave (contiguous splice at the run head's cause — the
    # runs-stick-together rule) differs from a from-scratch rebuild
    # (each node at its own cause). Lazy deferral implies rebuild
    # semantics, so such a run must weave eagerly: materialize first,
    # then take the normal splice path below.
    lazy = ct.lazy_weave and ct.type == LIST_TYPE
    chained = all(
        nodes[i + 1][1] == nodes[i][0] for i in range(len(nodes) - 1)
    )
    if lazy and not chained:
        ensure_weave(weave_fn, ct)
        lazy = False
    # one fused evolve (dataclass replace is a measurable share of the
    # per-op cost): nodes, yarns, clock, lanes, and the lazy staleness
    # all land in a single copy
    kw = {"nodes": pstore.assoc_items(
        ct.nodes, {n[0]: (n[1], n[2]) for n in nodes}
    )}
    yarns = dict(ct.yarns)
    _spin_one(yarns, node)
    if more_nodes_in_tx:
        for n in more_nodes_in_tx:
            _spin_one(yarns, n)
    kw["yarns"] = yarns
    if node[0][0] > ct.lamport_ts:
        kw["lamport_ts"] = node[0][0]
    if ct.lanes is not None and ct.type == LIST_TYPE:
        from ..weaver import lanecache

        kw["lanes"] = lanecache.extend_view(ct.lanes, nodes)
    if lazy:
        # skip the weave splice; keep only the tail hint alive. The
        # run chains (checked above), so if its first cause is the
        # current last weave node the whole run lands at the end and
        # its last node becomes the new tail — for local conj, pastes,
        # AND foreign appends alike. Anything else may displace the
        # last element in ways only a weave scan can see: the hint
        # dies and the next tail read pays one materialization.
        prev_tail = (ct.weave[-1][0] if ct.weave is not None
                     else ct.weave_tail)
        kw["weave"] = None
        kw["weave_tail"] = (
            nodes[-1][0]
            if prev_tail is not None and nodes[0][1] == prev_tail
            else None
        )
        return ct.evolve(**kw)
    return weave_fn(ct.evolve(**kw), node, more_nodes_in_tx)


def ensure_weave(weave_fn: WeaveFn, ct: CausalTree) -> CausalTree:
    """Materialize a lazy tree's weave in place (no-op when fresh).

    The weave is a pure function of ``nodes``, so back-filling the
    frozen dataclass's cache field is referentially transparent — the
    same discipline as the lanes cache. Returns ``ct`` itself, now
    woven."""
    if ct.weave is not None:
        return ct
    fresh = weave_fn(ct)  # full rebuild; device-routed under "torch"
    object.__setattr__(ct, "weave", fresh.weave)
    object.__setattr__(ct, "weave_tail", None)
    if fresh.lanes is not None:
        object.__setattr__(ct, "lanes", fresh.lanes)
    if obs.enabled():
        # semantic layer: each paid materialization records weave
        # length vs live values + tombstone ratio — the read-side cost
        # the lazy fleet-editing mode defers, and the quantity GC
        # exists to reclaim
        obs.semantic.lazy_materialized(ct)
    return ct


def append(weave_fn: WeaveFn, ct: CausalTree, cause, value) -> CausalTree:
    """Mint a node at the next local lamport-ts and insert it
    (shared.cljc:186-192)."""
    ct2 = ct.evolve(lamport_ts=ct.lamport_ts + 1)
    n = ((ct2.lamport_ts, ct2.site_id, 0), cause, value)
    return insert(weave_fn, ct2, n)


def refresh_ts(ct: CausalTree) -> CausalTree:
    """Set lamport-ts to the max ts in the (up-to-date, sorted) yarns
    (shared.cljc:243-249)."""
    ts = 0
    for yarn in ct.yarns.values():
        if yarn:
            ts = max(ts, yarn[-1][0][0])
    return ct.evolve(lamport_ts=ts)


def yarns_to_nodes(ct: CausalTree) -> CausalTree:
    """Rebuild the canonical store from the yarns (shared.cljc:251-257)."""
    store = {}
    for yarn in ct.yarns.values():
        for n in yarn:
            store[n[0]] = (n[1], n[2])
    return ct.evolve(nodes=store)


def refresh_caches(weave_fn: WeaveFn, ct: CausalTree) -> CausalTree:
    """Rebuild yarns, lamport-ts and the weave from ``nodes`` alone
    (shared.cljc:259-266). The idempotency oracle of the test suite:
    an incrementally-maintained tree must equal its refreshed self."""
    ct = spin(ct)
    ct = refresh_ts(ct)
    return weave_fn(ct)


def weft(weave_fn: WeaveFn, new_causal_tree_fn: Callable[[], CausalTree],
         ct: CausalTree, ids_to_cut_yarns) -> CausalTree:
    """Time travel: cut each named site's yarn at an id and rebuild the
    sub-tree at that previous point in time (shared.cljc:268-293).
    Combinations of ids that do not preserve causality are invalid and
    yield gibberish trees, exactly as in the reference."""
    filtered = [i for i in ids_to_cut_yarns if tuple(i) != ROOT_ID]
    new_ct = new_causal_tree_fn()
    yarns = dict(new_ct.yarns)
    for nid in filtered:
        nid = tuple(nid)
        src_yarn = ct.yarns.get(nid[1], [])
        cut = []
        for n in src_yarn:
            if n[0] == nid:
                break
            cut.append(n)
        cut.append(node_from_kv((nid, ct.nodes[nid])))
        yarns[nid[1]] = cut
    new_ct = new_ct.evolve(
        yarns=yarns,
        site_id=ct.site_id,
        lamport_ts=max((i[0] for i in filtered), default=0),
        weaver=ct.weaver,
        lazy_weave=ct.lazy_weave,
    )
    new_ct = yarns_to_nodes(new_ct)
    return weave_fn(new_ct)


def check_mergeable(ct1: CausalTree, ct2: CausalTree) -> None:
    """Merge guards shared by the pure and device merge paths: type and
    uuid must match (shared.cljc:303-311)."""
    if ct1.type != ct2.type:
        raise CausalError(
            "Causal type missmatch. Merge not allowed.",
            {"causes": {"type-missmatch"}, "types": [ct1.type, ct2.type]},
        )
    if ct1.uuid != ct2.uuid:
        raise CausalError(
            "Causal UUID missmatch. Merge not allowed.",
            {"causes": {"uuid-missmatch"}, "uuids": [ct1.uuid, ct2.uuid]},
        )


def check_no_conflicting_bodies(nodes: dict, other: dict) -> None:
    """The append-only union validation every merge path shares: a
    duplicate id whose body differs raises, reporting the body already
    in ``nodes`` (the merge target's side). C-speed on the common case
    via the set-algebra membership test."""
    common = nodes.keys() & other.keys()
    for nid in common:
        if nodes[nid] != other[nid]:
            raise CausalError(
                "This node is already in the tree and can't be changed.",
                {"causes": {"append-only", "edits-not-allowed"},
                 "existing_node": (nid,) + nodes[nid]},
            )


def union_nodes(ct1: CausalTree, ct2: CausalTree) -> CausalTree:
    """The host half of every accelerated merge: guard, union the node
    stores (append-only conflict check, as in ``insert``), fast-forward
    the lamport clock, and respin the yarns. The caller reweaves with
    its backend. Shared by the device merge paths."""
    return union_nodes_many((ct1, ct2))


def union_nodes_many(cts) -> CausalTree:
    """N-way ``union_nodes``: one guard+union pass over a whole fleet of
    replicas, one respin. The weave being a pure function of the node
    set makes this equal to any fold of pairwise merges — including the
    validations: foreign nodes new to the union must have their
    id-shaped cause somewhere in it (insert's cause-must-exist check,
    shared.cljc:175-178; duplicates skip validation there too)."""
    cts = list(cts)
    if not cts:
        raise CausalError("Nothing to merge.", {"causes": {"empty-fleet"}})
    first = cts[0]
    nodes = dict(first.nodes)
    max_new_ts = first.lamport_ts
    added = []
    for ct in cts[1:]:
        check_mergeable(first, ct)
        other = ct.nodes
        # set-algebra split (C speed) instead of a per-node branch
        common = nodes.keys() & other.keys()
        for nid in common:
            if nodes[nid] != other[nid]:
                raise CausalError(
                    "This node is already in the tree and can't be changed.",
                    {"causes": {"append-only", "edits-not-allowed"},
                     "existing_node": (nid,) + nodes[nid]},
                )
        new_ids = other.keys() - nodes.keys()
        nodes.update((nid, other[nid]) for nid in new_ids)
        added.extend(new_ids)
    if added:
        ts_high = max(nid[0] for nid in added)
        if ts_high > max_new_ts:
            max_new_ts = ts_high
    for nid in added:
        cause = nodes[nid][0]
        if not is_key(cause) and cause not in nodes:
            raise CausalError(
                "The cause of this node is not in the tree.",
                {"causes": {"cause-must-exist"}, "node": (nid,) + nodes[nid]},
            )
    ct = first.evolve(nodes=nodes, lamport_ts=max_new_ts)
    return spin(ct)


def merge_trees(weave_fn: WeaveFn, ct1: CausalTree, ct2: CausalTree) -> CausalTree:
    """Merge two causal trees into one (shared.cljc:300-314).

    Same guards as the reference (type and uuid must match). Unlike the
    reference's arbitrary-order reduce-insert (which is O(n*m) and can
    trip the cause-must-exist check on unlucky iteration orders), we
    insert ct2's novel nodes in sorted id order — causes always sort
    before their effects, so the reduce is deterministic; the resulting
    tree is identical because a weave is a pure function of the node set.
    With ``weaver="torch"`` the merge is instead union + one batched
    device reweave (see weaver.torchw), the north-star path.
    """
    check_mergeable(ct1, ct2)
    for nid in sorted(ct2.nodes):
        ct1 = insert(weave_fn, ct1, node_from_kv((nid, ct2.nodes[nid])))
    return ct1


def causal_to_edn(value, opts: Optional[dict] = None):
    """Materialize a causal value to plain data; non-causal values pass
    through (shared.cljc:320-328). Polymorphic over anything exposing a
    ``causal_to_edn(opts)`` method (the CausalTo protocol,
    protocols.cljc:33-35) — collections, bases, and refs."""
    opts = opts or {}
    m = getattr(value, "causal_to_edn", None)
    if m is not None:
        return m(opts)
    return value
