"""The one traffic generator: replica lanes drawn from a seed.

A traffic mix is a JSON file of parameters under ``traffic/``; this
module reads it together with a configuration's sizes and makes the
lanes. It extends copies of the port's chain generators
(``cause_tpu_torch.benchgen``: ``chain_tree_lanes``,
``batched_pair_lanes``, ``fleet_lanes``) so that the seed changes the
inputs:

- each row's site ids (distinct, above the base site);
- the hides: each divergent node is a hide with probability
  ``hide_p``, never a side's first node (the delta domain: its cause is
  the shared base tail, the anchor);
- the order of the sides' timestamps: each side's clock starts a drawn
  0-7 ticks past the base, so which side is newer at a position varies
  while every side's id interval still overlaps the others'.

A mix shapes the typing with three parameters; no shape has a name:

- ``base_run_mean``, ``div_run_mean``: the shared base, and each side's
  divergent nodes, are typed in runs of geometric length of that mean,
  each run headed at a uniformly drawn existing node (inserting after
  it is inserting at a uniformly drawn position of the text); ``null``
  types them as one run, a chain, as the port's generators make them.
  A mean of 1 is crdt-benchmarks' "insert at random positions": every
  node a one-character insert at a position of its own.
- ``hides``: ``"previous"`` points a hide at the node typed just
  before it (a backspace; never right after another hide; the next
  node is typed after the hide, as in the port's chains); ``"uniform"``
  points it at a uniformly drawn earlier live node (a delete at a drawn
  position; the next node of the run is typed after the last live
  node, and a run head drawn on a hide after the last live node before
  that hide).

Every tree's lanes come out in ascending id order, root at lane 0, with
both the cause ids (``chi``/``clo``, which the reference reads) and the
cause's concat lane (``cci``, which the port's marshal reads).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

I32_MAX = np.int32(np.iinfo(np.int32).max)
VC_HIDE = 1
SITE_BASE = 1
SITE_FIRST = 2
SITE_BITS = 18
TX_BITS = 13
CLOCK_SKEW = 8


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run: ``seed`` (any integer) and
    the stream's ordinals."""
    return np.random.default_rng([int(seed) & (2**64 - 1), *stream])


def _sites(rng, shape) -> np.ndarray:
    """Distinct site ranks along the last axis, each above the base."""
    n = shape[-1]
    span = (1 << SITE_BITS) - SITE_FIRST
    if n == 2:
        a = rng.integers(0, span, shape[:-1])
        b = rng.integers(0, span - 1, shape[:-1])
        b = b + (b >= a)
        return (np.stack([a, b], -1) + SITE_FIRST).astype(np.int32)
    flat = rng.choice(span, size=n, replace=False)
    return (np.broadcast_to(flat, shape) + SITE_FIRST).astype(np.int32)


def _alloc(R: int, width: int) -> Dict[str, np.ndarray]:
    """``[R, width]`` lanes, every lane padding."""
    return {
        "hi": np.full((R, width), I32_MAX, np.int32),
        "lo": np.full((R, width), I32_MAX, np.int32),
        "chi": np.full((R, width), -1, np.int32),
        "clo": np.full((R, width), -1, np.int32),
        "cci": np.full((R, width), -1, np.int32),
        "vc": np.zeros((R, width), np.int32),
        "valid": np.zeros((R, width), bool),
    }


def _fill(out, off: int, cap: int, ts, site, cause, vc) -> None:
    """Write R trees' ``[R, n]`` nodes (ascending id order; ``cause``
    the local cause lane, -1 at the root) into the columns
    ``off .. off + cap`` of ``out``."""
    R, n = ts.shape
    if n > cap:
        raise ValueError(f"capacity {cap} < node count {n}")
    sl = slice(off, off + n)
    hi, lo = out["hi"][:, sl], out["lo"][:, sl]
    hi[:] = ts
    lo[:] = site << TX_BITS
    has = cause >= 0
    cs = np.where(has, cause, 0)
    out["chi"][:, sl] = np.where(has, np.take_along_axis(hi, cs, 1), -1)
    out["clo"][:, sl] = np.where(has, np.take_along_axis(lo, cs, 1), -1)
    out["cci"][:, sl] = np.where(has, cause + off, -1)
    out["vc"][:, sl] = vc
    out["valid"][:, sl] = True


def _ids(rng, R: int, n_base: int, n_div: int, sites):
    """``(ts, site)`` ``[R, 1 + n_base + n_div]`` int32 of R trees: the
    root, the base (ts 1..n_base), then the divergent nodes from
    ``sites[r]`` on a clock started a drawn 0-7 ticks past the base."""
    n = 1 + n_base + n_div
    ts = np.empty((R, n), np.int32)
    ts[:, :n_base + 1] = np.arange(n_base + 1, dtype=np.int32)
    skew = rng.integers(0, CLOCK_SKEW, (R, 1), dtype=np.int32)
    ts[:, n_base + 1:] = (n_base + 1 + skew
                          + np.arange(n_div, dtype=np.int32))
    site = np.empty((R, n), np.int32)
    site[:, 0] = 0
    site[:, 1:n_base + 1] = SITE_BASE
    site[:, n_base + 1:] = sites[:, None]
    return ts, site


def _run_causes(rng, R: int, first: int, n: int, mean):
    """Causes of lanes ``first..first+n-1`` typed in runs of geometric
    length ``mean`` (``None``: one run): a run head is caused by a
    uniformly drawn existing lane (``[0, lane)``), every other node by
    the node typed before it."""
    lane = first + np.arange(n)
    if mean is None:
        return np.broadcast_to(lane - 1, (R, n)).astype(np.int64)
    head = rng.random((R, n)) < 1.0 / mean
    head[:, 0] = True
    drawn = np.floor(rng.random((R, n)) * lane).astype(np.int64)
    return np.where(head, drawn, lane - 1)


def _place_hides(rng, cause, vc, is_hide, first: int):
    """Point each hide of one tree (lanes ``first+j`` flagged in
    ``is_hide``) at a uniformly drawn earlier lane that is a live
    normal node: not the root, not a hide, not hidden already."""
    hidden = np.zeros(cause.shape[0], bool)
    for j in np.flatnonzero(is_hide):
        lane = first + j
        while True:
            t = int(rng.integers(1, lane))
            if vc[t] == 0 and not hidden[t]:
                break
        cause[lane] = t
        hidden[t] = True


def _after_live(is_hide, typed, first: int):
    """``"uniform"`` hides' typing: a node that continues a run follows
    the last live node before it, and a run head drawn on a hide the
    last live node before that hide."""
    R, n = is_hide.shape
    lane = first + np.arange(n)
    last_live = np.maximum.accumulate(
        np.where(is_hide, -1, lane[None, :]), axis=1)
    prev_live = np.concatenate(
        [np.full((R, 1), first - 1), last_live[:, :-1]], 1)
    prev_live = np.where(prev_live < 0, first - 1, prev_live)
    cont = typed == lane - 1
    j = np.clip(typed - first, 0, n - 1)
    on_hide = (typed >= first) & np.take_along_axis(is_hide, j, 1)
    typed = np.where(on_hide, np.take_along_axis(prev_live, j, 1), typed)
    return np.where(cont, prev_live, typed)


def trees(rng, out, off: int, cap: int, cfg: dict, mix: dict, sites,
          base_cause) -> None:
    """R trees into ``out`` at column ``off``, one a row: the root, the
    base (``base_cause``: ``[R, n_base]`` causes of lanes 1..n_base),
    then ``sites[r]``'s divergent nodes, typed and hidden as ``mix``
    says."""
    nb, nd, hp = cfg["base_nodes"], cfg["divergent_nodes"], cfg["hide_p"]
    R = sites.shape[0]
    ts, site = _ids(rng, R, nb, nd, sites)
    first = 1 + nb
    lane = first + np.arange(nd)
    is_hide = rng.random((R, nd)) < hp
    is_hide[:, 0] = False
    backspace = mix["hides"] == "previous"
    if backspace:
        is_hide[:, 1:] &= ~is_hide[:, :-1]
    elif mix["hides"] != "uniform":
        raise ValueError(f"hides is 'previous' or 'uniform', not "
                         f"{mix['hides']!r}")
    typed = _run_causes(rng, R, first, nd, mix["div_run_mean"])
    if backspace:
        div_cause = np.where(is_hide, lane - 1, typed)
    else:
        div_cause = _after_live(is_hide, typed, first)
    cause = np.concatenate(
        [np.full((R, 1), -1), np.broadcast_to(base_cause, (R, nb)),
         div_cause], 1).astype(np.int64)
    vc = np.zeros(cause.shape, np.int32)
    vc[:, first:] = is_hide * VC_HIDE
    if not backspace:
        for r in range(R):
            _place_hides(rng, cause[r], vc[r], is_hide[r], first)
    _fill(out, off, cap, ts, site, cause, vc)


def pair_batch(rng, cfg: dict, mix: dict) -> Dict[str, np.ndarray]:
    """A ``[B, 2*cap]`` batch of distinct documents, each a pair of
    replicas over a base of its own."""
    B, nb, cap = cfg["documents"], cfg["base_nodes"], cfg["capacity"]
    sites = _sites(rng, (B, 2))
    out = _alloc(B, 2 * cap)
    base = _run_causes(rng, B, 1, nb, mix["base_run_mean"])
    for t in range(2):
        trees(rng, out, t * cap, cap, cfg, mix, sites[:, t], base)
    return out


def fleet_row(rng, cfg: dict, mix: dict) -> Dict[str, np.ndarray]:
    """One ``[K*cap]`` row of K replicas of one document over one
    base, each with its own site, nodes, hides and clock skew."""
    K, nb, cap = cfg["replicas"], cfg["base_nodes"], cfg["capacity"]
    sites = _sites(rng, (K,))
    out = _alloc(K, cap)
    base = _run_causes(rng, 1, 1, nb, mix["base_run_mean"])
    trees(rng, out, 0, cap, cfg, mix, sites, base)
    out["cci"] = np.where(out["cci"] >= 0,
                          out["cci"] + cap * np.arange(K)[:, None], -1)
    return {k: v.reshape(-1) for k, v in out.items()}
