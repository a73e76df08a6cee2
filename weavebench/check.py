"""The comparison that decides ``correct``.

Once the window has closed, the reference weaves every row of every
batch the window drove, from the generated lanes, in blocks of rows;
the program's answers are held against it:

- ``rank_mismatch``: lanes whose rank disagrees. For every node exactly
  one of its lanes carries its reference rank and every other lane of
  it, and every padding lane, carries the lane count N (the program's
  mark for a lane it dropped); a node with no such lane, or with two,
  counts once;
- ``vis_mismatch``: lanes that carry their node's rank but not its
  visibility;
- ``digest_mismatch``: documents, over every wave of the window, whose
  digest disagrees with the reference digest of their weave.

Rows whose overflow flag the program raised are not compared: they
count as failed. ``docs_compared`` counts the documents whose digests
were compared. Each mismatch count has the limit 0: the comparison is
exact.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import weave as ref

LIMITS = {"rank_mismatch": 0, "vis_mismatch": 0, "digest_mismatch": 0}
BLOCK_LANES = 1 << 24


def _u32(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def compare_rows(lanes: dict, rank, vis, skip, dev,
                 break_guarantee=None):
    """Mismatch counts of one block of rows and its reference digests.

    ``lanes`` are the host ``[b, N]`` lanes, ``rank``/``vis`` the
    program's ``[b, N]`` answers (any device), ``skip`` a ``[b]`` bool
    mask of rows not to compare."""
    t = {k: torch.as_tensor(np.ascontiguousarray(v)).to(dev)
         for k, v in lanes.items()}
    w = ref.weave(t["hi"], t["lo"], t["chi"], t["clo"], t["vc"], t["valid"],
                  break_guarantee=break_guarantee)
    digests = ref.digest(w).cpu().numpy()
    rank = rank.to(dev).to(torch.int64)
    vis = vis.to(dev)
    B, N = rank.shape
    ok_row = ~torch.as_tensor(skip, device=dev)[:, None]
    g = w["group"]
    gi = torch.where(g >= 0, g, N)
    carries = (rank != N) & (g >= 0)
    n_carry = torch.zeros((B, N + 1), dtype=torch.int64, device=dev)
    n_carry.scatter_add_(1, gi, carries.to(torch.int64))
    is_node = (torch.arange(N, device=dev)[None, :]
               < w["n_nodes"][:, None])
    rr = torch.gather(w["rank"], 1, gi.clamp(max=N - 1))
    vv = torch.gather(w["visible"], 1, gi.clamp(max=N - 1))
    bad_rank = (carries & (rank != rr)) | ((g < 0) & (rank != N))
    bad_nodes = is_node & (n_carry[:, :N] != 1)
    good_carry = carries & (rank == rr)
    n_rank = int(((bad_rank & ok_row).sum() + (bad_nodes & ok_row).sum()))
    n_vis = int((good_carry & (vis != vv) & ok_row).sum())
    return n_rank, n_vis, digests


def compare(lanes_by_batch: list, outputs: list, waves: list, dev,
            break_guarantee=None) -> dict:
    """The compared numbers of a run. ``outputs`` holds each batch's
    kept ``(rank, vis)``, ``waves`` each wave's ``(batch, digests,
    overflow)`` as host arrays."""
    over = {}
    for b, _d, o in waves:
        over[b] = over.get(b, np.zeros(len(o), bool)) | np.asarray(o, bool)
    n_rank = n_vis = 0
    ref_dig = []
    for b, lanes in enumerate(lanes_by_batch):
        if outputs[b] is None:
            ref_dig.append(None)
            continue
        rank, vis = outputs[b]
        B, N = rank.shape
        step = max(1, BLOCK_LANES // N)
        skip = over.get(b, np.zeros(B, bool))
        digs = []
        for r0 in range(0, B, step):
            rows = slice(r0, r0 + step)
            nr, nv, d = compare_rows({k: v[rows] for k, v in lanes.items()},
                                     rank[rows], vis[rows], skip[rows], dev,
                                     break_guarantee)
            n_rank += nr
            n_vis += nv
            digs.append(d)
        ref_dig.append(np.concatenate(digs))
    n_dig = n_docs = 0
    for b, d, o in waves:
        live = ~np.asarray(o, bool)
        if ref_dig[b] is None:
            continue
        n_dig += int(((_u32(d) != ref_dig[b]) & live).sum())
        n_docs += int(live.sum())
    return {"rank_mismatch": n_rank, "vis_mismatch": n_vis,
            "digest_mismatch": n_dig, "docs_compared": n_docs}


def verdict(numbers: dict) -> bool:
    return (all(numbers[k] <= lim for k, lim in LIMITS.items())
            and numbers["docs_compared"] > 0)


def report(numbers: dict) -> dict:
    """The compared numbers beside their limits, for the result line."""
    out = {k: {"value": numbers[k], "limit": lim}
           for k, lim in LIMITS.items()}
    out["docs_compared"] = {"value": numbers["docs_compared"], "min": 1}
    return out


def as_program(w: dict, N: int):
    """A reference weave in the program's answer form: ``(rank, vis)``
    by lane, each node on its first lane, every other lane rank N; and
    the digests as int32 bits. The control puts it in the program's
    place."""
    g = w["group"]
    B = g.shape[0]
    dev = g.device
    lane = torch.arange(N, device=dev).expand(B, N)
    gi = torch.where(g >= 0, g, N)
    first = torch.full((B, N + 1), N, dtype=torch.int64, device=dev)
    first.scatter_reduce_(1, gi, lane, reduce="amin")
    is_first = (g >= 0) & (torch.gather(first, 1, gi) == lane)
    rank = torch.where(is_first,
                       torch.gather(w["rank"], 1, gi.clamp(max=N - 1)), N)
    vis = is_first & torch.gather(w["visible"], 1, gi.clamp(max=N - 1))
    d = ref.digest(w)
    d = torch.where(d >= 1 << 31, d - (1 << 32), d).to(torch.int32)
    return rank.to(torch.int32), vis, d
