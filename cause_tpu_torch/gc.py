"""Tombstone / weave GC: drop nodes that can no longer affect what a
reader sees. A copy of ``cause_tpu.gc``.

The reference ROADMAPS this and ships nothing ("Garbage collect
hidden nodes ... in the weave", reference README.md:254): reads and
writes stay O(n) over every tombstone forever. ``compact`` is that
wish, built: a new tree whose node bag keeps only

- the nodes the current weave renders (the ``hide_q`` scan for lists,
  the per-key LWW winner for maps — reference list.cljc:48-55,
  map.cljc:47-59 semantics);
- the transitive CAUSE closure of anything kept (a kept node's cause
  chain must survive or reconstitution fails cause-must-exist);
- every special (hide / h.hide / h.show) targeting a kept node, to a
  fixpoint — a kept-but-hidden ancestor must keep its hide marker or
  it would spring back to visibility.

Everything else — tombstoned runs, their hide markers, overwritten
LWW values, history specials whose effects are fully materialized —
is dropped, and the caches are reconstituted from the surviving bag
(the ordinary ``refresh_caches`` path, so the compacted tree is a
plain tree: serde, merge, sync, device weavers all Just Work).

What reclaims and what cannot — two interior-hole rules compose:

- the RGA skeleton reality: list causes chain through predecessors,
  so an interior tombstone that visible text was typed after remains
  as cause-chain skeleton — removing it would dangle descendants;
- the SYNC-soundness rule (found by a chaos soak, seed 700216):
  only per-site yarn SUFFIXES may drop. An interior yarn hole breaks
  the per-site prefix property sync deltas assume — a resend can
  carry a victim whose marker (another site's interior hole) is never
  resent, resurrecting the deletion after an ordinary sync with no
  cause-must-exist failure to trigger the fallback. Suffix-only
  dropping makes victim and marker travel together.

What GCs wholesale under both rules: hidden TAILS (delete-at-end:
61/91 nodes measured), undone branches, and any site whose entire
remaining contribution is obsolete (a map writer fully superseded by
later sites: its whole yarn drops). What stays: interior deletions,
and same-site LWW churn (every overwritten write sits below the
site's newest kept write — sound, and honestly 0 reclaimed).

Safety valve: compaction re-renders the compacted tree and compares
EDN with the original; any divergence (an exotic special interleaving
the conservative rules miss) returns the ORIGINAL handle unchanged —
compact() is always LOCALLY semantics-preserving, best-effort on
size.

Fleet-safety contract — the classic CRDT tombstone-GC precondition:
dropping a deletion (victim + hide marker) is only safe once EVERY
peer has seen the deletion. A peer that holds the victim but not its
hide marker would merge the victim back VISIBLY, and because the
victim's cause can survive compaction, that merge passes
cause-must-exist — no full-bag fallback fires, and if this replica
was the deletion's last carrier it is lost fleet-wide. Two ways to
hold the precondition:

- ``compact(handle, stable_vv=...)`` — the enforced form: pass the
  STABILITY FRONTIER (pointwise minimum of every peer's version
  vector — ``stability_frontier``; vectors come from
  ``sync.version_vector`` exchanges). Nodes above the frontier are
  never dropped, so any state a peer might still be missing
  survives, marker and all.
- ``compact(handle)`` — the quiesce form: caller asserts all peers
  are fully synced (single replica, checkpoint barrier, cold
  storage). The reference's "at rest storage is reduced" framing
  (reference README.md:19).

What the sync fallback DOES cover: a peer's delta that references a
dropped node as a CAUSE fails cause-must-exist and triggers the
full-bag frame (sync.py module docstring), re-importing the dropped
region — re-sync cost, not data loss. The frontier exists for the
case the fallback cannot see (surviving cause, missing marker).
"""

from __future__ import annotations

from typing import Dict, Optional, Set

from .collections import shared as s
from .collections.clist import hide_q, weave as list_weave
from .collections.cmap import BLANK, active_node, weave as map_weave
from .ids import ROOT_ID, is_id

__all__ = ["compact", "compact_stats", "stability_frontier"]


def stability_frontier(*version_vectors: dict) -> Dict[str, list]:
    """The pointwise minimum of peer version vectors (sync.py's
    ``{site: [ts, tx]}`` shape, compared lexicographically): every
    peer holds every site's nodes up to its frontier entry. A site
    absent from ANY peer's vector is absent from the frontier
    (nothing of that site is fleet-stable yet). Feed the result to
    ``compact(handle, stable_vv=...)``."""
    if not version_vectors:
        return {}
    out = {k: list(v) for k, v in version_vectors[0].items()}
    for vv in version_vectors[1:]:
        for site in list(out):
            if site not in vv:
                del out[site]
            else:
                out[site] = min(out[site], list(vv[site]))
    return out


def _closure(nodes: dict, keep: Set[tuple]) -> Set[tuple]:
    """Cause ancestors of everything kept, plus specials targeting
    kept nodes, to a fixpoint."""
    # function-level, as in the reference: arrays drags numpy in
    from .weaver.arrays import vclass_of

    keep = set(keep)
    # specials grouped by (id-)target once, so the fixpoint loop is
    # O(kept + specials) instead of O(kept * nodes)
    by_target: Dict[tuple, list] = {}
    for nid, (cause, value) in nodes.items():
        if vclass_of(value) > 0 and is_id(cause):
            by_target.setdefault(tuple(cause), []).append(nid)

    stack = list(keep)
    while stack:
        nid = stack.pop()
        cause = nodes[nid][0]
        if is_id(cause):
            cid = tuple(cause)
            if cid != ROOT_ID and cid in nodes and cid not in keep:
                keep.add(cid)
                stack.append(cid)
        for spec in by_target.get(nid, ()):
            if spec not in keep:
                keep.add(spec)
                stack.append(spec)
    return keep


def _rebuild(handle, ct, new_nodes: dict, weave_fn):
    """Reconstitute a tree from the surviving bag (fresh caches), on
    the same uuid/site/lamport so minting and merging continue
    unchanged."""
    fresh = ct.evolve(nodes=new_nodes, yarns={},
                      weave=type(ct.weave)() if isinstance(ct.weave,
                                                          dict) else [])
    fresh = s.spin(fresh)
    fresh = weave_fn(fresh)
    return type(handle)(fresh)


def _list_kept(handle) -> Set[tuple]:
    wv = list(handle.get_weave())
    keep: Set[tuple] = set()
    for i, n in enumerate(wv):
        if n[0] == ROOT_ID:
            continue
        nxt = wv[i + 1] if i + 1 < len(wv) else None
        if not hide_q(n, nxt):
            keep.add(n[0])
    return keep


def _map_kept(handle) -> Set[tuple]:
    keep: Set[tuple] = set()
    for k, wv in handle.get_weave().items():
        win = active_node(k, wv)
        if win is not BLANK and win[0] != ROOT_ID:
            keep.add(win[0])
    return keep


def compact_stats(before, after) -> dict:
    """The evidence line: node counts around a compaction."""
    nb, na = len(before.ct.nodes), len(after.ct.nodes)
    return {"nodes_before": nb, "nodes_after": na,
            "dropped": nb - na}


def compact(handle, stable_vv: Optional[dict] = None):
    """GC a CausalList or CausalMap handle (see module docstring).
    Returns a new handle of the same type — or the ORIGINAL handle
    when compaction finds nothing to drop or the safety valve
    declines it.

    ``stable_vv``: the fleet stability frontier (``{site: [ts,
    tx]}``, ``stability_frontier`` over peer ``sync.version_vector``
    outputs). When given, nodes ABOVE the frontier ((ts, tx) newer
    than the site's entry, or a site absent from it) are exempt from
    dropping — the fleet-safe form. When None, the caller asserts a
    quiesce point."""
    from .collections.clist import CausalList
    from .collections.cmap import CausalMap

    ct = getattr(handle, "ct", None)
    if ct is None:
        raise s.CausalError(
            "compact() GCs CausalList / CausalMap handles; compact "
            "base collections individually",
            {"causes": {"type-missmatch"},
             "type": type(handle).__name__},
        )
    if isinstance(handle, CausalList):
        kept0, weave_fn = _list_kept(handle), list_weave
    elif isinstance(handle, CausalMap):
        kept0, weave_fn = _map_kept(handle), map_weave
    else:
        raise s.CausalError(
            "compact() GCs CausalList / CausalMap handles; compact "
            "base collections individually",
            {"causes": {"type-missmatch"},
             "type": getattr(ct, "type", type(handle).__name__)},
        )

    nodes = dict(ct.nodes)
    keep = _closure(nodes, kept0)
    if stable_vv is not None:
        # fleet-safety frontier: anything a peer might not have seen
        # (newer than the frontier) must survive, and keeping a hidden
        # node re-pulls its markers/ancestors — re-run the closure
        # over the additions
        unstable = {
            nid for nid in nodes
            if nid != ROOT_ID
            and [nid[0], nid[2]] > list(
                stable_vv.get(nid[1], [-1, -1]))
        }
        if unstable - keep:
            keep = _closure(nodes, keep | unstable)

    # sync-soundness (a soak's catch, seed 700216): only per-site
    # yarn SUFFIXES may drop. An interior hole — a dropped node below
    # a surviving same-site node — breaks the per-site prefix property
    # the sync deltas assume: the victim's site tip can regress (so a
    # peer resends the victim) while the marker's site tip survives
    # (so the marker is never resent), and the deletion resurrects
    # VISIBLY after an ordinary sync, with no cause-must-exist failure
    # to trigger the full-bag fallback. Suffix-only dropping makes
    # victim and marker travel together in every resend. Fixpoint:
    # re-kept nodes pull their markers/ancestors, which can raise a
    # site's kept maximum again.
    by_site: Dict[str, list] = {}
    for nid in nodes:
        if nid != ROOT_ID:
            by_site.setdefault(nid[1], []).append(nid)
    for ids in by_site.values():
        ids.sort()
    while True:
        pre = len(keep)
        for ids in by_site.values():
            mx = None
            for nid in reversed(ids):
                if nid in keep:
                    mx = nid
                    break
            if mx is not None:
                for nid in ids:
                    if nid > mx:
                        break
                    keep.add(nid)
        keep = _closure(nodes, keep)
        if len(keep) == pre:
            break

    if ROOT_ID in nodes:
        keep.add(ROOT_ID)  # the sentinel head always survives
    if len(keep) >= len(nodes):
        return handle  # nothing to drop
    new_nodes = {nid: nodes[nid] for nid in keep}
    out = _rebuild(handle, ct, new_nodes, weave_fn)

    # safety valve: semantics must be untouched, or we decline
    from . import causal_to_edn

    if causal_to_edn(out) != causal_to_edn(handle):
        # pragma: no cover - conservative rules cover
        return handle
    return out
