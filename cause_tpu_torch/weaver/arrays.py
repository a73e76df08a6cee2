"""Host <-> device marshalling for the device weaver.

The device never sees values, site-id strings, or Python objects — only
fixed-width integer lanes (the "ids and classes only" contract from the
build plan, SURVEY.md §7):

- ``ts``, ``site``, ``tx`` (int32): the node id triple with site-id
  strings interned to **order-preserving** integer ranks, so
  lexicographic (ts, site_rank, tx) order equals the host id order.
  Ranks must be computed over the union of sites in play (all trees of
  a merge/batch) or cross-replica comparisons would disagree.
- ``cause_idx`` (int32): index of the cause node in the same array
  (-1 for the root and for key-caused map nodes).
- ``vclass`` (int32): 0 normal, 1 hide, 2 h.hide, 3 h.show
  (the special values of shared.cljc:21).
- ``valid`` (bool): padding mask — trees grow, kernel shapes don't.

Node ids also pack into a two-lane **(hi, lo) int32 pair**
(``PackSpec``: hi = ts, lo = site_rank<<tx_bits | tx) for duplicate
elimination and sort-join cause resolution in the batched merge kernel.
Two int32 lanes, not one int64: the kernels work on 32-bit lanes, and
the layout stays bit-compatible with the JAX package's marshal.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..ids import HIDE, H_HIDE, H_SHOW, ROOT_ID, is_special

__all__ = [
    "VCLASS_NORMAL",
    "VCLASS_HIDE",
    "VCLASS_H_HIDE",
    "VCLASS_H_SHOW",
    "PackSpec",
    "DEFAULT_PACK",
    "SiteInterner",
    "NodeArrays",
    "OutsideDomain",
    "map_lanes",
    "rebuild_map_weave",
    "vclass_of",
    "next_pow2",
]


class OutsideDomain(Exception):
    """The input is outside an accelerated weaver's domain (dangling
    causes from weft gibberish, exotic map cause chains); callers fall
    back to the pure weaver, which defines the semantics everywhere."""


VCLASS_NORMAL = 0
VCLASS_HIDE = 1
VCLASS_H_HIDE = 2
VCLASS_H_SHOW = 3


def vclass_of(value) -> int:
    if value is HIDE:
        return VCLASS_HIDE
    if value is H_HIDE:
        return VCLASS_H_HIDE
    if value is H_SHOW:
        return VCLASS_H_SHOW
    return VCLASS_NORMAL


def next_pow2(n: int) -> int:
    p = 8
    while p < n:
        p <<= 1
    return p


@dataclass(frozen=True)
class PackSpec:
    """Bit layout for the (hi, lo) id lanes: ``hi = ts`` (int32) and
    ``lo = (site_rank << tx_bits) | tx`` (int32). Defaults allow
    ts < 2^31-1, < 2^18 sites, tx < 2^13 (31 bits in lo); ``check``
    raises before any silent wraparound and reserves the all-ones
    packings for the I32_MAX padding sentinel. Lexicographic (hi, lo)
    order equals id order."""

    site_bits: int = 18
    tx_bits: int = 13

    def check(self, max_ts: int, n_sites: int, max_tx: int) -> None:
        # strict: the all-ones packings are reserved for the I32_MAX
        # padding sentinel, so a maximal real id must never reach them
        if max_ts >= (1 << 31) - 1:
            raise OverflowError(f"lamport-ts {max_ts} reaches the padding sentinel")
        if n_sites >= (1 << self.site_bits):
            raise OverflowError(f"{n_sites} sites exceed {self.site_bits} bits")
        if max_tx >= (1 << self.tx_bits):
            raise OverflowError(f"tx-index {max_tx} exceeds {self.tx_bits} bits")

    def pack_lo(self, site, tx):
        """Works on numpy arrays (pure int32 arithmetic)."""
        return (site.astype(np.int32) << self.tx_bits) | tx.astype(np.int32)


DEFAULT_PACK = PackSpec()

I32_MAX = np.int32(np.iinfo(np.int32).max)


class SiteInterner:
    """Order-preserving site-id -> rank mapping over a fixed site set.

    Built from the union of every site involved in a kernel invocation;
    sorted-string order defines the ranks, so integer comparisons on
    ranks agree with the host's lexicographic id order (SURVEY.md §7
    hard part 3)."""

    def __init__(self, sites):
        self.sites: List[str] = sorted(set(sites))
        self.rank: Dict[str, int] = {s: i for i, s in enumerate(self.sites)}

    def __len__(self) -> int:
        return len(self.sites)

    def __getitem__(self, site: str) -> int:
        return self.rank[site]


@dataclass
class NodeArrays:
    """Structure-of-arrays view of one causal tree's nodes, padded to
    ``capacity``. ``nodes[i]`` is the host node triple for lane i; the
    root sentinel is always lane 0 (ids sort it first)."""

    ts: np.ndarray
    site: np.ndarray
    tx: np.ndarray
    cause_idx: np.ndarray
    vclass: np.ndarray
    valid: np.ndarray
    cause_hi: np.ndarray
    cause_lo: np.ndarray
    nodes: list
    interner: SiteInterner
    n: int
    # the PackSpec the (cause_)hi/lo lanes were built with, and whether
    # the ids actually fit it (False = host-only marshal: cause_idx is
    # dict-resolved, device lanes raise)
    spec: PackSpec = DEFAULT_PACK
    spec_ok: bool = True

    @property
    def capacity(self) -> int:
        return int(self.ts.shape[0])

    @classmethod
    def from_nodes_map(
        cls,
        nodes_map: dict,
        capacity: Optional[int] = None,
        interner: Optional[SiteInterner] = None,
        spec: PackSpec = DEFAULT_PACK,
    ) -> "NodeArrays":
        """Build device lanes from a ``{id: (cause, value)}`` store.
        Lanes are in sorted id order (so lane index order == id order
        and every cause precedes its effects). Column extraction is a
        handful of comprehensions; cause resolution is one vectorized
        searchsorted over packed 64-bit id keys — the 10k-node API-level
        marshal is numpy-bound, not Python-loop-bound."""
        from ..ids import is_id

        ids = sorted(nodes_map)
        n = len(ids)
        cap = capacity or next_pow2(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < node count {n}")
        if interner is None:
            interner = SiteInterner(i[1] for i in ids)
        bodies = [nodes_map[nid] for nid in ids]
        nodes = [(nid, c, v) for nid, (c, v) in zip(ids, bodies)]

        ts = np.zeros(cap, np.int32)
        site = np.zeros(cap, np.int32)
        tx = np.zeros(cap, np.int32)
        vclass = np.zeros(cap, np.int32)
        valid = np.zeros(cap, bool)
        cause_idx = np.full(cap, -1, np.int32)
        cause_hi = np.full(cap, -1, np.int32)
        cause_lo = np.full(cap, -1, np.int32)
        if n:
            # dict lookups beat numpy unicode arrays for site interning
            # (and raise KeyError on a site missing from a shared
            # interner, which a searchsorted would silently mis-rank)
            rank = interner.rank
            ts[:n] = np.fromiter((i[0] for i in ids), np.int64, n)
            site[:n] = np.fromiter((rank[i[1]] for i in ids), np.int64, n)
            tx[:n] = np.fromiter((i[2] for i in ids), np.int64, n)
            vclass[:n] = np.fromiter(
                (vclass_of(v) for _, v in bodies), np.int32, n
            )
            valid[:n] = True

            causes = [c if is_id(c) else None for c, _ in bodies]
            has_cause = np.fromiter(
                (c is not None for c in causes), bool, n
            )
            c_tx_max = 0
            if has_cause.any():
                c_tx_max = max(c[2] for c in causes if c)
            max_tx_all = int(max(int(tx[:n].max(initial=0)), c_tx_max))
            try:
                spec.check(int(ts[:n].max(initial=0)), len(interner),
                           max_tx_all)
                spec_ok = True
            except OverflowError:
                # the host-only backends (nativew) need no (hi, lo)
                # packing; resolve causes by dict instead and leave the
                # device lanes unusable (id_lanes/cause_lanes re-check)
                spec_ok = False
            if has_cause.any() and spec_ok:
                c_ts = np.fromiter(
                    (c[0] if c else 0 for c in causes), np.int64, n
                )
                # a cause site unknown to the interner can never match a
                # lane, so it gets the one-past-the-end rank: the packed
                # query misses and the cause resolves to -1 (dangling)
                ghost = len(interner)
                c_site = np.fromiter(
                    (rank.get(c[1], ghost) if c else 0 for c in causes),
                    np.int64, n,
                )
                c_tx = np.fromiter(
                    (c[2] if c else 0 for c in causes), np.int64, n
                )
                chi = c_ts.astype(np.int32)
                clo = (c_site.astype(np.int32) << spec.tx_bits) | c_tx.astype(
                    np.int32
                )
                cause_hi[:n] = np.where(has_cause, chi, -1)
                cause_lo[:n] = np.where(has_cause, clo, -1)
                # resolve cause -> lane via packed keys (ids sorted =>
                # packed keys sorted, given the spec bounds hold)
                key = (ts[:n].astype(np.int64) << 32) | (
                    spec.pack_lo(site[:n], tx[:n]).astype(np.int64)
                    & 0xFFFFFFFF
                )
                q = (chi.astype(np.int64) << 32) | (
                    clo.astype(np.int64) & 0xFFFFFFFF
                )
                pos = np.searchsorted(key, q)
                pos_c = np.clip(pos, 0, n - 1)
                found = has_cause & (key[pos_c] == q)
                cause_idx[:n] = np.where(found, pos_c, -1)
            elif has_cause.any():
                idx_of = {nid: i for i, nid in enumerate(ids)}
                cause_idx[:n] = np.fromiter(
                    (idx_of.get(c, -1) if c else -1 for c in causes),
                    np.int64, n,
                )
        else:
            spec_ok = True
        return cls(
            ts=ts, site=site, tx=tx, cause_idx=cause_idx, vclass=vclass,
            valid=valid, cause_hi=cause_hi, cause_lo=cause_lo, nodes=nodes,
            interner=interner, n=n, spec=spec, spec_ok=spec_ok,
        )

    def id_lanes(self, spec: Optional[PackSpec] = None):
        """(hi, lo) int32 id lanes; padding lanes get int32 max so they
        sort last (real ids never reach int32 max by ``check``). The
        layout is fixed at marshal time — a different spec requires a
        re-marshal (so id and cause lanes can never disagree)."""
        if spec is not None and spec != self.spec:
            raise ValueError(
                "id_lanes are packed with the from_nodes_map spec "
                f"{self.spec}; re-marshal to use {spec}"
            )
        if not self.spec_ok:
            # covers cause-id overflow too (a node-only re-check would
            # let an overflowed cause slip through as silently dangling)
            raise OverflowError(
                "ids exceed the PackSpec bit layout; device lanes are "
                "unavailable (host backends can still use cause_idx)"
            )
        spec = self.spec
        max_ts = int(self.ts[: self.n].max(initial=0))
        max_tx = int(self.tx[: self.n].max(initial=0))
        spec.check(max_ts, len(self.interner), max_tx)
        hi = np.where(self.valid, self.ts.astype(np.int32), I32_MAX)
        lo = np.where(self.valid, spec.pack_lo(self.site, self.tx), I32_MAX)
        return hi, lo

    def cause_lanes(self, spec: Optional[PackSpec] = None):
        """(hi, lo) lanes of each node's cause id — any id-shaped cause,
        even one living in another replica's tree (merges resolve causes
        against the union) — or (-1, -1) when the cause is not an id
        (root sentinel, key causes, padding). Precomputed in
        ``from_nodes_map`` with its ``spec``; asking for a different
        layout (or one the ids overflow) is an error, not a silent
        mismatch against ``id_lanes``."""
        if spec is not None and spec != self.spec:
            raise ValueError(
                "cause_lanes were packed with the from_nodes_map spec "
                f"{self.spec}; re-marshal to use {spec}"
            )
        if not self.spec_ok:
            raise OverflowError(
                "ids exceed the PackSpec bit layout; device lanes are "
                "unavailable (host backends can still use cause_idx)"
            )
        return self.cause_hi, self.cause_lo


def map_lanes(nodes_map):
    """``(sorted_nodes, cause_idx, key_rank, vclass, keys)`` for a map
    tree — the shared marshaller of the native and device map weavers.

    Key resolution follows the pure weaver exactly (single level: an
    id-caused node's key is its target's cause, map.cljc:31-37), so the
    accelerated domain requires id-caused nodes to target key-caused
    nodes — everything the collection/base APIs generate. Anything else
    raises ``OutsideDomain`` and the caller falls back to pure.
    """
    from ..ids import is_id

    ids = sorted(nodes_map)
    idx_of = {nid: i for i, nid in enumerate(ids)}
    n = len(ids)
    cause_idx = np.full(n, -1, np.int32)
    key_rank = np.full(n, -1, np.int32)
    vclass = np.zeros(n, np.int32)
    keys = []
    key_ordinal = {}
    nodes = []
    for i, nid in enumerate(ids):
        cause, value = nodes_map[nid]
        vclass[i] = vclass_of(value)
        if is_id(cause):
            ci = idx_of.get(tuple(cause), -1)
            if ci < 0:
                raise OutsideDomain()  # dangling target
            target_cause = nodes_map[tuple(cause)][0]
            if is_id(target_cause):
                raise OutsideDomain()  # id-caused targeting id-caused
            cause_idx[i] = ci
        else:
            k = cause
            if k not in key_ordinal:
                key_ordinal[k] = len(keys)
                keys.append(k)
            key_rank[i] = key_ordinal[k]
        nodes.append((nid, cause, value))
    return nodes, cause_idx, key_rank, vclass, keys


def rebuild_map_weave(nodes, key_of, order, keys):
    """Split an accelerated forest ordering back into the per-key weave
    dict — shared by the native and device map weavers. ``nodes`` are
    host triples in lane order, ``key_of[i]`` each lane's resolved key
    ordinal, ``order`` the lanes in global weave order. Key-caused
    nodes' in-weave cause is rewritten to the root sentinel
    (map.cljc:77)."""
    from ..ids import ROOT_ID, ROOT_NODE, is_id

    weave = {}
    for i in order:
        nid, cause, value = nodes[i]
        k = keys[key_of[i]]
        in_weave_cause = cause if is_id(cause) else ROOT_ID
        weave.setdefault(k, [ROOT_NODE]).append((nid, in_weave_cause, value))
    return weave
