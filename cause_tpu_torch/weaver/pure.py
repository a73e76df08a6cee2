"""The pure host weaver: the semantics-defining sequential weave kernel.

This is the port-of-record of the reference's conflict-resolution core
(reference: src/causal/collections/shared.cljc:194-241): ``weave_asap``
and ``weave_later`` are the two sibling-ordering predicates, and
``weave_node`` is the insertion scan that places one node (plus an
optional run of consecutive same-transaction nodes) into an existing
weave. It is used as

1. the default backend for incremental single-node / single-tx weaving
   (cheap, O(n) per insert), and
2. the differential-test oracle for the JAX device weaver
   (weaver.torchw), which recomputes whole weaves in parallel
   and must agree with this scan node-for-node.

Semantics notes (derived, and fuzz-verified against the reference's own
regression corpus):

* The woven order is a preorder DFS of the causal tree where the
  children of each node are ordered specials-first, then by descending
  id; among specials also descending id. ``weave_later``'s second
  disjunct (shared.cljc:213-219) is logically subsumed by its third
  (shared.cljc:220-223), so the ``seen`` set never changes the result;
  it is kept here for exactness.
* A special node always sticks immediately after the node it targets
  (its cause); a non-special sibling can never cut in front of it
  (the first ``weave_later`` disjunct, shared.cljc:208-212).
"""

from __future__ import annotations

from ..ids import is_special

__all__ = ["weave_asap", "weave_later", "weave_node"]


def weave_asap(nl, nm, nr) -> bool:
    """Should ``nm`` be inserted as soon as possible between ``nl``/``nr``?
    (shared.cljc:194-200). True once the scan has just passed ``nm``'s
    cause, or when ``nr`` is caused by ``nm``."""
    return (nl is not None and nl[0] == nm[1]) or (
        nr is not None and nm[0] == nr[1]
    )


def weave_later(nl, nm, nr, seen) -> bool:
    """Is there a reason ``nm`` cannot go between ``nl`` and ``nr``?
    (shared.cljc:202-223). Assumes weave_asap already holds."""
    nm_special = is_special(nm[2])
    nr_special = is_special(nr[2])
    # 1) nr is a hide/show that does not target nm: it must stay glued to
    #    its own target, unless nm is a *newer* special.
    if (
        nr_special
        and nm[0] != nr[1]
        and (not nm_special or nm[0] < nr[0])
    ):
        return True
    # 2) nr starts a sibling subtree (caused by nl, shares a cause with
    #    nl, or caused by an already-seen node) and nm is older: wait.
    #    (Subsumed by 3; kept for exactness with the reference.)
    if (
        (
            (nl is not None and (nl[0] == nr[1] or nl[1] == nr[1]))
            or nr[1] in seen
        )
        and nm[0] < nr[0]
        and (not nm_special or nr_special)
    ):
        return True
    # 3) nm is older than nr (and not a special jumping a non-special):
    #    newer siblings and their subtrees come first.
    if nm[0] < nr[0] and (not nm_special or nr_special):
        return True
    return False


def weave_node(current_weave, node, more_consecutive_nodes_in_same_tx=None):
    """Return a new list-weave with ``node`` (and an optional contiguous
    same-transaction run) woven in (shared.cljc:225-241).

    O(n) scan: walk the weave left to right; once ``weave_asap`` fires,
    insert at the first position ``weave_later`` does not veto. A run of
    m consecutive tx nodes is spliced in one pass, keeping transactional
    pastes O(n+m) rather than O(n*m) (reference: list.cljc:23-25).
    """
    w = current_weave
    n = len(w)
    prev_asap = False
    seen = set()
    i = 0
    nl = None
    while True:
        nr = w[i] if i < n else None
        asap = prev_asap or weave_asap(nl, node, nr)
        if nr is None or (asap and not weave_later(nl, node, nr, seen)):
            out = list(w[:i])
            out.append(node)
            if more_consecutive_nodes_in_same_tx:
                out.extend(more_consecutive_nodes_in_same_tx)
            out.extend(w[i:])
            return out
        if asap:
            # the reference conjes (first nl) — None before any step
            seen.add(nl[0] if nl is not None else None)
        nl = nr
        i += 1
        prev_asap = asap
