"""The single-device entry and the multi-device dry run.

Counterpart of the reference's ``__graft_entry__.py``. ``entry`` gives
one replica-pair merge+weave (64-node trees with tombstones) through the
v4 kernel and its inputs on a device. ``dryrun_multichip`` runs one
merge step of every sharded kernel generation at tiny shapes over a mesh
of ``n_devices`` ranks (``ranks.run_ranks``), with the cross-rank
totals, then the map rows (real ``CausalMap`` replica pairs through the
sharded v4 and v5 map routes) and the wave row (``merge_wave(mesh=)``
over real list replica pairs), each checked against the host merge.

Every rank builds the same inputs (the SPMD contract of
``parallel.mesh``): the dry run's replicas carry fixed site ids, so each
rank's interner ranks their sites alike and the ranks marshal identical
lanes.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from .. import benchgen
from ..device import resolve_device
from .ranks import run_ranks

__all__ = ["entry", "dryrun_multichip", "list_pairs"]


def entry(device=None):
    """``(fn, args)``: ``fn(*args)`` merges and weaves one divergent
    replica pair (``benchgen.divergent_pair_lanes(n_base=48, n_div=16,
    capacity=128, hide_every=4)``, ``LANE_KEYS4`` lanes as tensors on
    ``device``, the package default when None) with the v4 kernel at
    ``k_max=64`` on that device, returning ``(order, rank, visible,
    conflict, overflow)``."""
    from ..weaver.torchw4 import merge_weave_kernel_v4

    dev = resolve_device(device)
    lanes = benchgen.divergent_pair_lanes(n_base=48, n_div=16, capacity=128,
                                          hide_every=4)
    args = tuple(torch.from_numpy(lanes[k]).to(dev)
                 for k in benchgen.LANE_KEYS4)
    return partial(merge_weave_kernel_v4, k_max=64, device=dev), args


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The dry run over ``n_devices`` ranks of ``device``'s type (the
    package default when None): CUDA needs a card a rank, "cpu" runs
    gloo ranks. Raises whatever check a rank fails."""
    run_ranks(n_devices, _dryrun_rank, device=resolve_device(device).type)


def _expect(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def _site(tag: str, i: int = 0) -> str:
    """A fixed 13-character site id."""
    return f"d{tag}{i:0{12 - len(tag)}d}"


def _dryrun_rank(mesh) -> None:
    """One rank's dry run over ``mesh`` (2 rows a rank)."""
    from .mesh import (sharded_merge_weave, sharded_merge_weave_v4,
                       sharded_merge_weave_v5)

    B = 2 * mesh.size()
    batch = benchgen.batched_pair_lanes(n_replicas=B, n_base=12, n_div=4,
                                        capacity=32, hide_every=2)
    lanes = tuple(batch[k] for k in benchgen.LANE_KEYS)
    lanes4 = tuple(batch[k] for k in benchgen.LANE_KEYS4)

    def check(name, out):
        # v1-v4 lead with `order`, v5 has none: the last four agree
        *_rows, digest, total_visible, n_conflicts, n_overflow = out
        _expect(int(n_conflicts) == 0 and int(n_overflow) == 0,
                f"{name}: {int(n_conflicts)} conflicts, {int(n_overflow)} "
                f"overflowed rows")
        d = digest.cpu().numpy()
        # every row merged a distinct divergent pair
        _expect(len(set(d.tolist())) > 1,
                f"{name}: batch rows converged identically")
        _expect(int(total_visible) > 0, f"{name}: nothing visible")
        return d

    v5lanes = benchgen.batched_v5_inputs(
        {k: batch[k] for k in benchgen.LANE_KEYS4}, 32)
    u5 = benchgen.v5_token_budget(v5lanes)
    digests = {
        "v1": check("v1", sharded_merge_weave(mesh, *lanes)),
        "v2": check("v2", sharded_merge_weave(mesh, *lanes, k_max=32,
                                              kernel="v2")),
        "v3": check("v3", sharded_merge_weave(mesh, *lanes, k_max=32)),
        "v4": check("v4", sharded_merge_weave_v4(mesh, *lanes4, k_max=32)),
        "v5": check("v5", sharded_merge_weave_v5(mesh, v5lanes, u5, u5)),
    }
    for name, d in digests.items():
        _expect(np.array_equal(d, digests["v1"]),
                f"{name}'s digests differ from v1's")
    _dryrun_maps(mesh, B)
    _dryrun_wave(mesh, B)


def _dryrun_maps(mesh, B: int) -> None:
    """The map rows: replica pairs of real maps as key-rooted forests
    through the sharded v4 and v5 map routes; each merged per-key weave
    equals the host merge's on rows 0, B/2 and B-1."""
    from ..collections.cmap import CausalMap, new_causal_map
    from ..ids import K
    from ..weaver import mapw

    base = new_causal_map()
    base = CausalMap(base.ct.evolve(site_id=_site("MAP"),
                                    uuid="dryrunMapUuid00000000"))
    for i in range(3):
        base = base.append(K(f"k{i}"), i)
    pairs = []
    for p in range(B):
        a = CausalMap(base.ct.evolve(site_id=_site("MA", p))).append(
            K(f"k{p % 4}"), f"a{p}")
        b = CausalMap(base.ct.evolve(site_id=_site("MB", p))).dissoc(
            K("k0")).append(K(f"x{p % 2}"), f"b{p}")
        pairs.append((a, b))
    lanes, meta = mapw.pair_rows([(a.ct.nodes, b.ct.nodes) for a, b in pairs])
    order, rank, _v, _d, _tv, _nc, n_ov = mapw.sharded_merge_map_weave(
        mesh, lanes)
    _expect(int(n_ov) == 0, "the v4 map rows overflowed")
    (rank5, _v5, _ov5, _d5, _tv5, _nc5, n_ov5), _u = (
        mapw.sharded_merge_map_weave_v5(mesh, lanes, meta["capacity"]))
    _expect(int(n_ov5) == 0, "the v5 map rows overflowed")
    order, rank, rank5 = (x.cpu().numpy() for x in (order, rank, rank5))
    for i in (0, B // 2, B - 1):
        a, b = pairs[i]
        want = a.merge(b).ct.weave
        got = mapw.merged_map_weave(lanes, meta, order, rank, i)
        got5 = mapw.merged_map_weave(lanes, meta, None, rank5, i)
        for k in want:
            _expect(got[k] == want[k], f"v4 map row {i} key {k} diverged")
            _expect(got5[k] == want[k], f"v5 map row {i} key {k} diverged")


def list_pairs(n_pairs: int, n_base: int, edit_a, edit_b) -> list:
    """``n_pairs`` replica pairs of one ``n_base``-item list (torch
    weaver) with fixed site ids, so every process that builds them
    interns their sites alike: pair ``p`` is ``(edit_a(p, a), edit_b(p,
    b))`` of two forks ``a``, ``b`` of the base."""
    from ..collections.clist import CausalList, new_causal_list

    base = new_causal_list(weaver="torch")
    base = CausalList(base.ct.evolve(site_id=_site("WAVE"),
                                     uuid="dryrunWaveUuid0000000"))
    base = base.extend([f"w{i}" for i in range(n_base)])
    return [(edit_a(p, CausalList(base.ct.evolve(site_id=_site("WA", p)))),
             edit_b(p, CausalList(base.ct.evolve(site_id=_site("WB", p)))))
            for p in range(n_pairs)]


def _dryrun_wave(mesh, B: int) -> None:
    """The wave row: ``merge_wave(mesh=)`` over real list replica pairs,
    B distinct digests equal to the unsharded wave's, ``merged(i)``
    equal to ``a.merge(b)`` on the first and last pair."""
    from ..collections.shared import causal_to_edn
    from .wave import merge_wave

    pairs = list_pairs(B, 24, lambda p, a: a.extend([f"wa{p}"]),
                       lambda p, b: b.conj(f"wb{p}"))
    res = merge_wave(pairs, mesh=mesh)
    _expect(not res.fallback, f"wave rows fell back: {res.fallback}")
    _expect(len(set(res.digest.tolist())) == B, "wave rows collapsed")
    _expect(np.array_equal(res.digest, merge_wave(pairs).digest),
            "the sharded wave's digests differ from the unsharded wave's")
    for i in (0, B - 1):
        a, b = pairs[i]
        _expect(causal_to_edn(res.merged(i)) == causal_to_edn(a.merge(b)),
                f"wave row {i} diverged")
