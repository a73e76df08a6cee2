"""Fleet convergence benchmark of the port: K divergent replicas into ONE
tree. A port of ``scripts/fleet_bench.py``.

    python -m cause_tpu_torch.fleet_bench            # on the card
    python -m cause_tpu_torch.fleet_bench --smoke    # 8 replicas
    python -m cause_tpu_torch.fleet_bench --cpu ...  # plain versions

Two measurements:

1. **Kernel-level** (device only): ``benchgen.fleet_lanes`` flattens the
   whole fleet into one ``[K*cap]`` lane row; the merge kernel's
   sort-dedupe union is K-ary for free, so one dispatch converges the
   entire fleet. This is the "1024 replicas into one tree" reading of
   the north star, through v5 (``torchw5.merge_weave_kernel_v5``) and
   v4 (``torchw4.merge_weave_kernel_v4``).
2. **API-level** (host union + one device reweave):
   ``CausalList.merge_many`` at a smaller K.

Prints one JSON line per measurement with the reference's keys,
``platform`` the device type (``cuda`` or ``cpu``), and ``card``, the
card's ``name, power.limit`` from ``nvidia-smi`` (null on the CPU).
Every kernel step ends in a copy of its ``[checksum, overflow]`` to the
host, which waits for the card; times are host-clock medians of 3 after
a warm call. Runs on the card unless ``--cpu`` asks for the plain
versions on the CPU: without a card it exits 2 with one line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .bench import card_name_power
from .device import claim_device
from .weaver.torchw4 import merge_weave_kernel_v4
from .weaver.torchw5 import merge_weave_kernel_v5


def _timed_with_overflow_doubling(step, budget: int):
    """Shared harness: warm/retry until the budget fits (``step``
    raises OverflowError), then report the 3-run median and the final
    budget actually used."""
    while True:
        try:
            step(budget)
            break
        except OverflowError:
            budget *= 2
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        step(budget)
        ts.append((time.perf_counter() - t0) * 1000)
    return float(np.median(ts)), budget


def _checked(rank, ovf, k: int):
    """The step's ``[checksum, overflow]`` on the host (float32 sum of
    the ranks, as the reference's); raises OverflowError(k) on an
    overflowed budget."""
    out = torch.stack([rank.to(torch.float32).sum(),
                       ovf.to(torch.float32)]).cpu().numpy()
    if out[1]:
        raise OverflowError(k)
    return out


def kernel_level(K: int, n_base: int, n_div: int, cap: int,
                 device="cuda") -> dict:
    from . import benchgen

    dev = torch.device(device)
    lanes = benchgen.fleet_lanes(
        n_replicas=K, n_base=n_base, n_div=n_div, capacity=cap,
        hide_every=8,
    )
    # runs scale with K (each replica contributes its suffix's runs;
    # a pair row counts two suffixes, so half of it per replica), and
    # the overflow loop below corrects any shortfall
    est = benchgen.estimate_pair_runs(
        {k: lanes[k][: 2 * cap] for k in benchgen.LANE_KEYS}
    )
    dl = benchgen.lanes_from_numpy(lanes, dev, keys=benchgen.LANE_KEYS4)
    args = [dl[k] for k in benchgen.LANE_KEYS4]

    def step(k):
        _o, r, _v, _c, ovf = merge_weave_kernel_v4(*args, k_max=k,
                                                   device=dev)
        return _checked(r, ovf, k)

    p50, k_max = _timed_with_overflow_doubling(
        step, max(1024, 1024 + (est * K) // 2)
    )
    return {
        "metric": f"fleet kernel-merge {K} replicas x "
                  f"{1 + n_base + n_div} nodes -> one tree",
        "value": round(p50, 1),
        "unit": "ms",
        "lanes": K * cap,
        "k_max": k_max,
        "platform": dev.type,
    }


def kernel_level_v5(K: int, n_base: int, n_div: int, cap: int,
                    device="cuda") -> dict:
    """The same fleet convergence through the v5 segment-union kernel:
    all K copies of the shared base dedupe wholesale, so token count is
    ~K * divergence instead of K * document."""
    from . import benchgen
    from .benchgen import LANE_KEYS5

    dev = torch.device(device)
    lanes = benchgen.fleet_lanes(
        n_replicas=K, n_base=n_base, n_div=n_div, capacity=cap,
        hide_every=8,
    )
    t0 = time.perf_counter()
    v5row = benchgen.v5_inputs(lanes, cap)
    marshal_ms = (time.perf_counter() - t0) * 1000
    tokens = benchgen.estimate_tokens(v5row)
    dl = benchgen.lanes_from_numpy(v5row, dev)
    args = [dl[k] for k in LANE_KEYS5]

    def step(k):
        rank, _vis, _c, ovf = merge_weave_kernel_v5(
            *args, u_max=k, k_max=k, device=dev
        )
        return _checked(rank, ovf, k)

    p50, u_max = _timed_with_overflow_doubling(
        step, benchgen.v5_token_budget(v5row)
    )
    return {
        "metric": f"fleet kernel-merge v5 {K} replicas x "
                  f"{1 + n_base + n_div} nodes -> one tree",
        "value": round(p50, 1),
        "unit": "ms",
        "lanes": K * cap,
        "tokens": int(tokens),
        "u_max": u_max,
        "marshal_ms": round(marshal_ms, 1),
        "platform": dev.type,
    }


def api_level(K: int, n_nodes: int) -> dict:
    """``merge_many`` of K replicas of an ``n_nodes`` list, each with 32
    nodes of its own, through the handles on the package device."""
    import cause_tpu_torch as c
    from .collections.clist import CausalList
    from .device import default_device
    from .ids import new_site_id

    base = c.clist(weaver="torch").extend(
        ["x"] * n_nodes
    )
    fleet = []
    for i in range(K):
        r = CausalList(base.ct.evolve(site_id=new_site_id()))
        r = r.extend([f"r{i}-{j}" for j in range(32)])
        fleet.append(r)

    fleet[0].merge_many(fleet[1:])  # warm: kernel builds, allocations
    t0 = time.perf_counter()
    merged = fleet[0].merge_many(fleet[1:])
    wall = (time.perf_counter() - t0) * 1000
    assert len(merged.ct.nodes) == len(base.ct.nodes) + K * 32
    return {
        "metric": f"API merge_many {K} replicas x {n_nodes}+32 nodes",
        "value": round(wall, 1),
        "unit": "ms",
        "platform": default_device().type,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fleet convergence benchmark of the port")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = claim_device(args.cpu, "fleet_bench")
    card = card_name_power(dev)

    def emit(rec):
        print(json.dumps(dict(rec, card=card)), flush=True)

    if args.smoke:
        emit(kernel_level_v5(K=8, n_base=800, n_div=100, cap=1024,
                             device=dev))
        emit(kernel_level(K=8, n_base=800, n_div=100, cap=1024,
                          device=dev))
        emit(api_level(K=8, n_nodes=1000))
    else:
        emit(kernel_level_v5(K=1024, n_base=9000, n_div=1000, cap=10240,
                             device=dev))
        emit(kernel_level(K=1024, n_base=9000, n_div=1000, cap=10240,
                          device=dev))
        emit(api_level(K=64, n_nodes=10000))
    return 0


if __name__ == "__main__":
    sys.exit(main())
