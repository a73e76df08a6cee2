"""API-level merge benchmarks on the port, as ``scripts/api_bench.py``
measures the JAX package: end to end through the public handles, every
host cost paid (``cause_tpu_torch.bench`` generates its lanes instead).

    python -m cause_tpu_torch.api_bench                 # one merge a weaver
    python -m cause_tpu_torch.api_bench --wave 1024     # a merge wave
    python -m cause_tpu_torch.api_bench --maps 64       # a map wave
    python -m cause_tpu_torch.api_bench --cpu ...       # plain versions

1. default: one ``CausalList.merge`` at 10k nodes per weaver (``pure``,
   ``native``, ``torch``), the device route split into host union, host
   marshal and the device weave.
2. ``--wave B``: a merge wave of B divergent replica pairs through
   ``parallel.merge_wave`` (the north-star path, ``BASELINE.json``
   config 5), split into host assembly (cached lanes, segment tables,
   budget), the device kernel with its digest and the digest's copy to
   the host, the same amortized over a burst of ``--burst`` waves, the
   whole wave, and one ``merged(i)`` materialization; then the rounds of
   a device-resident ``FleetSession``. ``--lazy`` mints lazy-weave
   replicas. ``BENCH_KERNEL`` (v5, v5w, v5f) picks the wave's pipeline,
   the knob ``merge_wave`` reads.
3. ``--maps K``: a batched map-forest merge of K replica pairs (the v4
   forest route), its host marshal beside its device kernel.

Prints one JSON line a measurement, with the reference's keys. Runs on
the card unless ``--cpu`` asks for the plain versions on the CPU: there
is no other CPU route, and without a card it exits 2 with one line.
Every device step ends in a copy to the host, which waits for the card.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .device import claim_device
from .ids import new_site_id


def timed(fn, reps=3):
    """Median ms of ``reps`` calls of ``fn`` after one warm call."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1000)
    return float(np.median(ts))


def build_pair(n_base: int, n_div: int, weaver: str):
    import cause_tpu_torch as c
    from .collections.clist import CausalList

    base = c.clist(weaver=weaver).extend(["x"] * n_base)
    a = CausalList(base.ct.evolve(site_id=new_site_id()))
    b = CausalList(base.ct.evolve(site_id=new_site_id()))
    a = a.extend([f"a{i}" for i in range(n_div)])
    b = b.extend([f"b{i}" for i in range(n_div)])
    return a, b


def wave_fleet(B: int, n_base: int, n_div: int, lazy: bool = False):
    """B divergent replica pairs of one ``n_base``-node list (config 5's
    shape: a tombstone after every 8 suffix values), minted on the host:
    the base is woven by the pure weaver and evolves to ``"torch"`` with
    its lane view built, which the replicas inherit and extend."""
    import cause_tpu_torch as c
    from .collections import clist as c_list
    from .collections.clist import CausalList
    from .weaver import lanecache

    ct = c.clist(weaver="pure", lazy=lazy).extend(["x"] * n_base).ct
    if lazy:
        ct = c_list.weave(ct)
    base = CausalList(ct.evolve(
        weaver="torch", lanes=lanecache.build_view(ct.nodes, ct.uuid)))
    pairs = []
    for p in range(B):
        def replica(tag):
            r = CausalList(base.ct.evolve(site_id=new_site_id()))
            vals = [f"{tag}{p}.{i}" for i in range(n_div)]
            for start in range(0, n_div, 8):
                r = r.extend(vals[start:start + 8])
                r = r.append(r.tail_id(), c.hide)
            return r

        pairs.append((replica("a"), replica("b")))
    return pairs


def wave_kernel() -> str:
    """The wave's pipeline from ``BENCH_KERNEL`` (v5 when unset)."""
    kernel = os.environ.get("BENCH_KERNEL", "").strip() or "v5"
    if kernel not in ("v5", "v5w", "v5f"):
        raise SystemExit(f"api_bench: BENCH_KERNEL must be "
                         f"v5/v5w/v5f, got {kernel!r}")
    return kernel


def wave_measure(pairs, dev, nodes: int, reps: int = 3, burst: int = 8,
                 kernel: str = "v5"):
    """The ``--wave`` measurements over ``pairs`` (``nodes`` a tree,
    tombstones left out, for the metric) on ``dev``: prints the session
    line and the wave line, returns the whole wave's ``WaveResult``."""
    from .benchgen import LANE_KEYS5, lanes_from_numpy, v5_token_budget
    from .parallel import merge_wave
    from .parallel.mesh import replica_digest
    from .parallel.session import FleetSession
    from .parallel.wave import WaveBuffers, _assemble_rows
    from .weaver import lanecache
    from .weaver.arrays import next_pow2

    if kernel == "v5f":
        from .weaver.torchw5f import batched_merge_weave_v5f as run
    else:
        from .weaver.torchw5 import batched_merge_weave_v5 as run
    B = len(pairs)

    # --- host side: view gathering + batch assembly + budget
    bufs = WaveBuffers()

    def host_assemble():
        views = [(lanecache.view_for(a.ct), lanecache.view_for(b.ct))
                 for a, b in pairs]
        cap = next_pow2(max(max(va.n, vb.n) for va, vb in views))
        lanes = _assemble_rows(views, cap, bufs=bufs)
        return lanes, v5_token_budget(lanes)

    t_host = timed(host_assemble, reps=reps)
    lanes, u_max = host_assemble()

    # --- device side: one wave's kernel and digest, and their copy
    t = lanes_from_numpy(lanes, dev)
    args = [t[k] for k in LANE_KEYS5]

    def dispatch():
        r, v, _c, ov = run(*args, u_max=u_max, k_max=u_max, device=dev)
        return replica_digest(args[0], args[1], r, v), ov

    def kernel_once():
        d, ov = dispatch()
        return int(d[0].cpu()), int(ov.sum().cpu())

    t_kernel = timed(kernel_once, reps=reps)

    def kernel_burst():
        # ``burst`` waves queued, one copy at the end
        outs = [dispatch()[0] for _ in range(burst)]
        return int(outs[-1][0].cpu())

    t_burst = timed(kernel_burst, reps=max(1, reps - 1)) / burst

    # --- the whole wave through the public API
    t_wave = timed(lambda: merge_wave(pairs, device=dev), reps=reps)
    res = merge_wave(pairs, device=dev)
    t_mat = timed(lambda: res.merged(0), reps=reps)

    # --- a device-resident session: the steady-state loop
    sess = FleetSession(pairs, device=dev)
    sess.wave()
    w = [0]

    def edit_all():
        w[0] += 1
        return [(x.conj(f"s{w[0]}x"), y.extend([f"s{w[0]}y"]))
                for x, y in sess.pairs]

    sess.update(edit_all())
    sess.wave()
    t_edits, t_rounds = [], []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        nxt = edit_all()
        t1 = time.perf_counter()
        sess.update(nxt)
        sess.wave()
        t2 = time.perf_counter()
        t_edits.append((t1 - t0) * 1000)
        t_rounds.append((t2 - t1) * 1000)
    print(json.dumps({
        "metric": "device-resident session round",
        "kernel": "v5",  # the session's resident splice is v5-only
        "pairs": B,
        "edit_all_replicas_ms": round(float(np.median(t_edits[1:])), 1),
        "delta_update_plus_wave_ms": round(
            float(np.median(t_rounds[1:])), 1),
        "unit": "ms",
        "platform": dev.type,
    }), flush=True)

    _, n_over = kernel_once()
    print(json.dumps({
        "metric": f"merge wave {B} pairs x {nodes}-node CausalLists "
                  "(API, cached lanes)",
        "host_assembly_ms": round(t_host, 1),
        "device_kernel_ms": round(t_kernel, 1),
        "device_kernel_amortized_ms": round(t_burst, 1),
        "whole_wave_ms": round(t_wave, 1),
        "materialize_one_pair_ms": round(t_mat, 2),
        "host_lt_kernel": bool(t_host < t_kernel),
        "u_max": int(u_max), "overflow_rows": n_over,
        "fallback_pairs": len(res.fallback),
        "kernel": kernel,
        "platform": dev.type, "unit": "ms",
    }), flush=True)
    return res


def wave_bench(args):
    kernel = wave_kernel()
    B, n_base, n_div = args.wave, args.n_base, args.n_div
    t0 = time.perf_counter()
    pairs = wave_fleet(B, n_base, n_div, lazy=args.lazy)
    build_s = time.perf_counter() - t0
    print(json.dumps({
        "metric": "wave setup (mint replicas, incl. incremental lane cache)",
        "pairs": B, "nodes_per_tree": n_base + n_div + 1,
        "value": round(build_s, 1), "unit": "s",
    }), flush=True)
    dev = claim_device(args.cpu, "api_bench")
    return wave_measure(pairs, dev, n_base + n_div + 1, reps=args.reps,
                        burst=args.burst, kernel=kernel)


def map_bench(args):
    """A batched map-forest merge of ``--maps`` replica pairs of one
    CausalMap through ``mapw.batched_merge_map_weave``."""
    import torch

    import cause_tpu_torch as c
    from .collections.cmap import CausalMap
    from .ids import K
    from .parallel.mesh import replica_digest
    from .weaver import mapw

    B = args.maps
    base = c.cmap()
    for i in range(args.n_keys):
        base = base.append(K(f"k{i}"), f"v{i}")
    pairs = []
    for p in range(B):
        a = CausalMap(base.ct.evolve(site_id=new_site_id()))
        b = CausalMap(base.ct.evolve(site_id=new_site_id()))
        for e in range(args.n_edits):
            a = a.append(K(f"k{(p + e) % args.n_keys}"), f"a{p}.{e}")
            b = b.append(K(f"x{e % 4}"), f"b{p}.{e}")
        pairs.append((a.ct.nodes, b.ct.nodes))

    dev = claim_device(args.cpu, "api_bench")
    t_marshal = timed(lambda: mapw.pair_rows(pairs), reps=args.reps)
    lanes, meta = mapw.pair_rows(pairs)
    hi = torch.from_numpy(lanes["hi"]).to(dev)
    lo = torch.from_numpy(lanes["lo"]).to(dev)

    def kernel():
        o, r, v, _c, ov = mapw.batched_merge_map_weave(lanes, device=dev)
        o = o.long()
        d = replica_digest(torch.gather(hi, 1, o), torch.gather(lo, 1, o),
                           r, v)
        if int(ov.sum().cpu()):
            raise RuntimeError("api_bench: the map wave overflowed")
        return int(d[0].cpu())

    t_kernel = timed(kernel, reps=args.reps)
    print(json.dumps({
        "metric": f"batched map merge, {B} replica pairs x "
                  f"{args.n_keys} keys + {args.n_edits} edits/side",
        "host_marshal_ms": round(t_marshal, 1),
        "device_kernel_ms": round(t_kernel, 1),
        "capacity": meta["capacity"],
        "platform": dev.type,
        "unit": "ms",
    }), flush=True)


def merge_bench(args):
    """One ``CausalList.merge`` a weaver, and the device route's split."""
    from .collections import shared as s
    from .weaver import torchw
    from .weaver.arrays import NodeArrays

    dev = claim_device(args.cpu, "api_bench")
    for weaver in ("pure", "native", "torch"):
        a, b = build_pair(args.n_base, args.n_div, weaver)
        p50 = timed(lambda: a.merge(b))
        print(json.dumps({
            "metric": f"CausalList.merge {args.n_base}+{args.n_div} nodes",
            "weaver": weaver,
            "value": round(p50, 1),
            "unit": "ms",
        }), flush=True)
        if weaver != "torch":
            continue
        union = s.union_nodes(a.ct, b.ct)
        t_union = timed(lambda: s.union_nodes(a.ct, b.ct))
        t_marshal = timed(lambda: NodeArrays.from_nodes_map(union.nodes))
        na = NodeArrays.from_nodes_map(union.nodes)
        # weave_arrays returns host arrays: each call waits for the card
        t_kernel = timed(lambda: torchw.weave_arrays(na, device=dev))

        def rebuild():
            rank, _ = torchw.weave_arrays(na, device=dev)
            order = np.argsort(rank[: na.capacity], kind="stable")
            return [na.nodes[i] for i in order[: na.n]]

        t_rebuild = timed(rebuild)
        print(json.dumps({
            "metric": "torch merge breakdown",
            "host_union_ms": round(t_union, 1),
            "host_marshal_ms": round(t_marshal, 1),
            "device_weave_ms": round(t_kernel, 1),
            "weave_plus_rebuild_ms": round(t_rebuild, 1),
            "platform": dev.type,
        }), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="API-level merge benchmarks on the port")
    ap.add_argument("--n-base", type=int, default=9_000)
    ap.add_argument("--n-div", type=int, default=1_000)
    ap.add_argument("--wave", type=int, default=0,
                    help="batched wave of this many replica pairs")
    ap.add_argument("--maps", type=int, default=0,
                    help="batched MAP merge of this many replica pairs")
    ap.add_argument("--n-keys", type=int, default=32)
    ap.add_argument("--n-edits", type=int, default=16)
    ap.add_argument("--burst", type=int, default=8,
                    help="pipelined waves per amortized measurement")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--lazy", action="store_true",
                    help="lazy-weave replicas: skip the per-op host "
                         "weave splice in the edit loop")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    # the wave and map modes mint their handles on the host before they
    # claim the device
    if args.maps:
        map_bench(args)
    elif args.wave:
        wave_bench(args)
    else:
        merge_bench(args)


if __name__ == "__main__":
    main()
