"""The plain reference: the weave of a set of replica lanes, and its digest.

Plain PyTorch, on whatever device its inputs are on. It reads the ids,
the cause ids, the value classes and the valid flags of each row, and
nothing that the program under test derives from them (no segment
tables, no cause lanes, no budgets).

The semantics, per row:

1. The row's node set is the union of its valid lanes by id; duplicate
   ids are one node. Each node's cause is the node whose id its cause
   id names; the root has none.
2. A special node (a hide, ``vc`` 1, an h.hide, 2, or an h.show, 3)
   hangs off its cause. Any other node hangs off its nearest ancestor
   along the causes that is not special.
3. Siblings are ordered specials first, then by descending id.
4. The weave is the preorder of that tree from the root; a node's rank
   is its position in it.
5. A node is visible when it is not special, not the root, and its
   newest special child, if it has one, is not a hide or an h.hide.

The preorder is taken without any walk: each node's preorder successor
is its first child, or else the next sibling of its nearest
ancestor-or-self that has one; the successor pointers are ranked by
pointer doubling.

``break_guarantee`` computes a weave that breaks one guarantee the
configuration states, as the control of the comparison: ``"deletes"``
ignores every hide, ``"order"`` puts siblings in ascending id order
(the oldest first), so replicas that met their edits in another order
would not converge.

The digest of a row is the wraparound uint32 sum over its nodes of a
murmur3-style avalanche of (id, rank, visibility): a frozen copy of the
arithmetic, computed here in int64 masked to 32 bits.
"""

from __future__ import annotations

import torch

__all__ = ["weave", "digest", "mix32", "BREAKS"]

BREAKS = (None, "deletes", "order")
M32 = 0xFFFFFFFF
I64 = torch.int64


def _key(hi, lo):
    """The order-preserving int64 of an id pair."""
    return hi.to(I64) * (1 << 32) + (lo.to(I64) & M32)


def _jump(ptr, stop):
    """Pointer doubling to a fixpoint: each entry follows ``ptr`` until
    it reaches an entry where ``stop`` holds (which points to itself)."""
    ptr = torch.where(stop, torch.arange(ptr.shape[1], device=ptr.device)
                      .expand_as(ptr), ptr)
    while True:
        nxt = torch.gather(ptr, 1, ptr)
        if torch.equal(nxt, ptr):
            return ptr
        ptr = nxt


def weave(hi, lo, chi, clo, vc, valid, break_guarantee=None) -> dict:
    """``[B, N]`` lanes -> a dict of the rows' weaves, by node.

    ``group[b, lane]`` is the node a lane holds (its index in the row's
    ascending id order of nodes; -1 for an invalid lane), ``n_nodes``
    the ``[B]`` node counts; ``hi``, ``lo``, ``rank`` and ``visible``
    are ``[B, N]`` by node (entries past ``n_nodes`` unused)."""
    if break_guarantee not in BREAKS:
        raise ValueError(f"break_guarantee must be one of {BREAKS}")
    B, N = hi.shape
    dev = hi.device
    END = N
    big = torch.iinfo(I64).max
    key = torch.where(valid, _key(hi, lo), big)
    skey, perm = torch.sort(key, dim=1, stable=True)
    svalid = skey != big
    first = torch.ones_like(svalid)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first &= svalid
    gid = torch.cumsum(first.to(I64), 1) - 1
    n_nodes = first.sum(1)
    group = torch.full((B, N), -1, dtype=I64, device=dev)
    group.scatter_(1, perm, torch.where(svalid, gid, -1))

    # node tables, [B, N + 1]: node g at column g, END at column N
    col = torch.where(first, gid, END)
    def node_table(lane_vals, fill):
        t = torch.full((B, N + 1), fill, dtype=lane_vals.dtype, device=dev)
        t.scatter_(1, col, lane_vals)
        t[:, END] = fill
        return t
    nkey = node_table(skey, big)
    nvc = node_table(torch.gather(vc, 1, perm).to(I64), 0)
    ncause_key = node_table(
        torch.gather(_key(chi, clo), 1, perm), -1)
    is_node = torch.arange(N + 1, device=dev)[None, :] < n_nodes[:, None]
    croot = torch.gather(chi, 1, perm) < 0
    nroot = node_table(croot, False) & is_node
    if int(nroot.sum()) != B:
        raise ValueError("every row needs exactly one root")

    # causes by id
    cpos = torch.searchsorted(nkey[:, :N].contiguous(),
                              ncause_key[:, :N].contiguous())
    cpos = torch.cat([cpos, torch.full((B, 1), END, device=dev)], 1)
    cpos = cpos.clamp(max=END)
    found = torch.gather(nkey, 1, cpos) == ncause_key
    child = is_node & ~nroot
    if bool((child & ~found).any()):
        raise ValueError("a cause id names no node of its row")
    cause = torch.where(child, cpos, END)
    special = is_node & (nvc > 0)
    # the parent: specials hang off their cause, others off the
    # nearest non-special ancestor
    idx = torch.arange(N + 1, device=dev).expand(B, N + 1)
    over = _jump(torch.where(special, cause, idx), ~special)
    host = torch.gather(over, 1, cause)
    parent = torch.where(child, torch.where(special, cause, host), END)

    # sibling order: by parent, specials first, then id descending
    # (ascending with "order" broken)
    by_id = idx.flip(1) if break_guarantee != "order" else idx
    sk = parent * 2 + (~special).to(I64)
    sk = torch.where(child, sk, 2 * END + 2)
    order = torch.gather(by_id, 1, torch.sort(
        torch.gather(sk, 1, by_id), dim=1, stable=True).indices)
    op = torch.gather(parent, 1, order)
    ochild = torch.gather(child, 1, order)
    same_next = torch.zeros_like(ochild)
    same_next[:, :-1] = (op[:, 1:] == op[:, :-1]) & ochild[:, 1:]
    nxt_in_order = torch.cat([order[:, 1:], order[:, :1]], 1)
    next_sib = torch.full((B, N + 1), END, dtype=I64, device=dev)
    next_sib.scatter_(1, order, torch.where(same_next & ochild,
                                            nxt_in_order, END))
    first_child = torch.full((B, N + 2), END, dtype=I64, device=dev)
    is_head = ochild.clone()
    is_head[:, 1:] &= op[:, 1:] != op[:, :-1]
    first_child.scatter_(1, torch.where(is_head, op, N + 1),
                         torch.where(is_head, order, END))
    first_child = first_child[:, :N + 1]

    # preorder successor, then its ranks by pointer doubling
    has_sib = next_sib != END
    anc = _jump(torch.where(child, parent, END), has_sib | ~child)
    climb = torch.gather(next_sib, 1, anc)
    succ = torch.where(first_child != END, first_child, climb)
    succ = torch.where(is_node, succ, END)
    succ[:, END] = END
    dist = is_node.to(I64)
    nxt = succ
    while True:
        live = nxt != END
        if not bool(live.any()):
            break
        dist = dist + torch.where(live, torch.gather(dist, 1, nxt), 0)
        nxt = torch.gather(nxt, 1, nxt)
    rank = n_nodes[:, None] - dist

    # visibility
    fc = first_child.clamp(max=END)
    fc_vc = torch.gather(nvc, 1, fc)
    hidden = (first_child != END) & ((fc_vc == 1) | (fc_vc == 2))
    if break_guarantee == "deletes":
        hidden = torch.zeros_like(hidden)
    visible = is_node & child & ~special & ~hidden
    return {"group": group, "n_nodes": n_nodes,
            "hi": (nkey[:, :N] >> 32), "lo": nkey[:, :N] & M32,
            "rank": rank[:, :N], "visible": visible[:, :N]}


def mix32(hi, lo, pos, visible):
    """The per-node avalanche term as int64 in [0, 2**32)."""
    x = ((hi.to(I64) & M32) * 0x9E3779B1 + (lo.to(I64) & M32) * 0x85EBCA77
         + (pos.to(I64) & M32) * 0xC2B2AE35
         + visible.to(I64) * 40503 + 1) & M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    x ^= x >> 16
    return x


def digest(w: dict):
    """``[B]`` int64 digests in [0, 2**32) of ``weave``'s rows: each
    node's term once."""
    N = w["rank"].shape[1]
    is_node = (torch.arange(N, device=w["rank"].device)[None, :]
               < w["n_nodes"][:, None])
    terms = mix32(w["hi"], w["lo"], w["rank"], w["visible"])
    return torch.where(is_node, terms, 0).sum(1) & M32
