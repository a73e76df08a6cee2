"""The benchmark suite: the BASELINE configs (and a map-fleet row) as a
CLI, on the port.

The port's copy of ``cause_tpu.benchmarks``: every config is a named,
runnable benchmark with a JSON-line report (``config``, ``metric``,
``weaver``, ``value``, ``unit``), across weave backends where that makes
sense. The device configs run on the package default device, which only
``use_device`` changes: without a card they raise unless the caller
asked for the CPU.

    python -m cause_tpu_torch.benchmarks                  # all, defaults
    python -m cause_tpu_torch.benchmarks -c 1 -w native   # one config
    python -m cause_tpu_torch.benchmarks --profile DIR    # torch.profiler
                                                          # trace around
                                                          # device runs

Configs:
  1 CausalList append-only weave (single site, 1k char insertions)
  2 CausalList 3-site concurrent insert + hide tombstones
  3 CausalMap key overwrite + id-caused undo/redo tombstones
  4 CausalBase nested list-in-map rich-text doc
  5 batched merge of divergent CausalLists (the north star; device)
  6 map-fleet wave (key-rooted forests; v5 segment-union vs v4; device)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

from . import benchgen
from .cbase import new_causal_base
from .collections.clist import CausalList, new_causal_list
from .collections.cmap import new_causal_map
from .ids import K, new_site_id

__all__ = ["CONFIGS", "run_config", "main"]


def _timed(fn: Callable, reps: int = 3):
    """Best-of-reps wall time (seconds) and the last result."""
    best, out = float("inf"), None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def _profiled(profile_dir: Optional[str], dev, name: str):
    """A ``torch.profiler`` context over the timed reps of a device
    config that writes a Chrome trace ``{name}.json`` into
    ``profile_dir`` (CPU activity, and CUDA activity on the card), or a
    null context when ``profile_dir`` is None."""
    if not profile_dir:
        return contextlib.nullcontext()
    import torch

    @contextlib.contextmanager
    def ctx():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))

    return ctx()


def _text(n: int) -> str:
    """The shared config-1 payload (identical input for every variant)."""
    return ("abcdefgh" * (n // 8 + 1))[:n]


def config1_append_only(weaver: str, n: int = 1000, reps: int = 3) -> dict:
    """Single-site append-only list: n chars conj'd one at a time (the
    typing hot path, reference list.cljc:36-40)."""
    text = _text(n)

    def run():
        cl = new_causal_list(weaver=weaver)
        for ch in text:
            cl = cl.conj(ch)
        return cl

    secs, cl = _timed(run, reps)
    assert len(cl) == n
    return {
        "config": 1,
        "metric": f"append-only conj x{n}",
        "weaver": weaver,
        "value": round(n / secs, 1),
        "unit": "nodes/sec",
    }


def config1_append_lazy(n: int = 1000, reps: int = 3) -> dict:
    """Config 1 in lazy-weave mode: conj n chars with the weave
    deferred (O(1) tail hint + persistent stores), then ONE render at
    the end — the fleet-replica editing profile. The render is inside
    the timed region, so this is the honest type-then-read cost.

    Lazy mode's render is a full rebuild, so it pairs with a fast
    rebuild backend: native (C++ ranks) when available, else the torch
    weaver on the package default device — lazy+pure would just defer
    the same O(n^2) fold."""
    from . import native

    backend = ("native" if native.available() else "torch")
    text = _text(n)

    def run():
        cl = new_causal_list(weaver=backend, lazy=True)
        for ch in text:
            cl = cl.conj(ch)
        if len(cl) != n:  # the read IS the materialization; assert-free
            raise AssertionError(len(cl))  # so -O cannot skip it
        return cl

    secs, _cl = _timed(run, reps)
    return {
        "config": 1,
        "metric": f"lazy conj x{n} + one render",
        "weaver": f"lazy+{backend}",
        "value": round(n / secs, 1),
        "unit": "nodes/sec",
    }


def config1_bulk_extend(weaver: str, n: int = 1000, reps: int = 3) -> dict:
    """Config 1's paste variant: the same n chars as contiguous
    transaction runs via extend — the O(n+m) path."""
    text = _text(n)

    def run():
        return new_causal_list(weaver=weaver).extend(text)

    secs, cl = _timed(run, reps)
    assert len(cl) == n
    return {
        "config": 1,
        "metric": f"bulk extend x{n}",
        "weaver": weaver,
        "value": round(n / secs, 1),
        "unit": "nodes/sec",
    }


def config2_concurrent_hide(weaver: str, n_per_site: int = 120,
                            reps: int = 3) -> dict:
    """3 sites interleave inserts, hide every 5th node, then all three
    pairwise merges converge."""
    import random

    from .ids import HIDE

    def run():
        rng = random.Random(5)
        base = new_causal_list(*"seed", weaver=weaver)
        sites = [new_site_id() for _ in range(3)]
        replicas = [
            CausalList(base.ct.evolve(site_id=site)) for site in sites
        ]
        for step in range(n_per_site):
            for i, r in enumerate(replicas):
                nodes = list(r.ct.weave)
                cause = rng.choice(nodes)[0]
                ts = r.get_ts() + 1
                nid = (ts, sites[i], 0)
                if step % 5 == 4:
                    r = r.insert((nid, cause, HIDE))
                else:
                    r = r.insert((nid, cause, f"v{step}"))
                replicas[i] = r
        return replicas[0].merge(replicas[1]).merge(replicas[2])

    secs, m = _timed(run, reps)
    total_nodes = len(m.ct.nodes)
    return {
        "config": 2,
        "metric": f"3-site concurrent insert+hide, {total_nodes} nodes",
        "weaver": weaver,
        "value": round(total_nodes / secs, 1),
        "unit": "nodes/sec",
    }


def config3_map_undo_redo(weaver: str, n_keys: int = 40,
                          overwrites: int = 6, reps: int = 3) -> dict:
    """Map LWW overwrites plus id-caused h.hide/h.show tombstone churn
    (the map undo-by-id shape, reference map.cljc:283-288)."""
    from .ids import H_HIDE, H_SHOW

    def run():
        cm = new_causal_map(weaver=weaver)
        for k in range(n_keys):
            key = K(f"k{k}")
            for o in range(overwrites):
                cm = cm.assoc(key, f"v{o}")
        # undo/redo the latest overwrite of each key by id
        for node in list(cm):
            nid = node[0]
            cm = cm.append(nid, H_HIDE)
            cm = cm.append(nid, H_SHOW)
        return cm

    secs, cm = _timed(run, reps)
    total = len(cm.ct.nodes)
    return {
        "config": 3,
        "metric": f"map overwrite+undo/redo, {total} nodes",
        "weaver": weaver,
        "value": round(total / secs, 1),
        "unit": "nodes/sec",
    }


def config4_rich_text_base(weaver: str, paragraphs: int = 8,
                           para_len: int = 60, reps: int = 3) -> dict:
    """CausalBase rich-text doc: a map of paragraph-lists of chars, with
    transactions, edits, and undo/redo (the slate-eunoia shape)."""
    from .cbase import is_ref

    def run():
        cb = new_causal_base(weaver=weaver)
        # map of paragraphs; each paragraph is a nested char-list
        doc = {K(f"p{i}"): ["x" * para_len] for i in range(paragraphs)}
        cb = cb.transact([[None, None, doc]])
        root = cb.get_collection()
        # edit every paragraph (one tx each), then undo/redo the last
        for node in list(root):
            if is_ref(node[2]):
                cb = cb.transact([[node[2].uuid, None, "!"]])
        cb = cb.undo()
        return cb.redo()

    secs, cb = _timed(run, reps)
    total = sum(len(coll.ct.nodes) for coll in cb.cb.collections.values())
    return {
        "config": 4,
        "metric": f"base rich-text doc, {total} nodes",
        "weaver": weaver,
        "value": round(total / secs, 1),
        "unit": "nodes/sec",
    }


def config5_batched_merge(weaver: str = "torch", n_replicas: int = 64,
                          n_base: int = 800, n_div: int = 100,
                          cap: int = 1024, reps: int = 3,
                          k_max: Optional[int] = None,
                          kernel: str = "v4",
                          profile_dir: Optional[str] = None,
                          device=None) -> dict:
    """Batched device merge of divergent replicas (the north-star shape;
    sizes here are CLI defaults — the chip smoke runs the full 1024 x
    10k). ``k_max``: None = workload-derived budget, 0 = the
    uncompressed v1 kernel. ``kernel`` picks the compressed kernel
    ("v5" segment-union, "v4" marshal-resolved causes, "v4w" v4 with
    the Euler walk, "v3" sparse-irregular, or "v2" chain-compressed); v5
    consumes the LANE_KEYS5 lanes, v4/v4w LANE_KEYS4, the others
    LANE_KEYS. ``device``: the package default when None; without a
    card, CUDA raises. The timed step copies the ``[checksum,
    overflowed]`` pair to the host, which waits for the device."""
    from .benchgen import LANE_KEYS, LANE_KEYS4, LANE_KEYS5
    from .device import resolve_device

    dev = resolve_device(device)
    batch = benchgen.batched_pair_lanes(
        n_replicas=n_replicas, n_base=n_base, n_div=n_div,
        capacity=cap, hide_every=8,
    )
    u_max = 0
    if kernel == "v5" and k_max != 0:
        batch = dict(batch, **benchgen.batched_v5_inputs(batch, cap))
        lane_names = LANE_KEYS5
        u_max = benchgen.v5_token_budget(batch)
        if k_max is None:
            k_max = u_max
    else:
        lane_names = (
            LANE_KEYS4 if (kernel in ("v4", "v4w") and k_max != 0)
            else LANE_KEYS
        )
        if k_max is None:
            k_max = benchgen.pair_run_budget(batch)
    lanes = benchgen.lanes_from_numpy(batch, device=dev, keys=lane_names)
    args = [lanes[k] for k in lane_names]

    def step():
        out = benchgen.merge_wave_scalar(
            *args, k_max=k_max, kernel=kernel, u_max=u_max,
            device=dev).cpu().numpy()
        if k_max and out.shape and out[1]:
            raise RuntimeError("run budget overflow — raise k_max")
        return out

    step()  # warm
    with _profiled(profile_dir, dev, "config5"):
        secs, _ = _timed(step, reps)
    return {
        "config": 5,
        "metric": f"batched merge, {n_replicas} pairs x "
                  f"{1 + n_base + n_div}-node lists",
        "weaver": f"torch-{kernel}" if k_max else "torch-v1",
        "value": round(secs * 1000.0, 3),
        "unit": "ms",
    }


def config6_map_fleet(weaver: str = "torch", n_pairs: int = 64,
                      n_keys: int = 24, edits: int = 12,
                      reps: int = 3, kernel: str = "v5",
                      profile_dir: Optional[str] = None,
                      device=None) -> dict:
    """Map-fleet wave: batched merge of CausalMap replica pairs as
    key-rooted forests (the v5 segment-union route makes map fleets pay
    divergence, not node width — ``kernel="v4"`` measures the
    full-width route for comparison). ``device`` as config 5's."""
    import random as _random

    import cause_tpu_torch as _c

    from .collections.cmap import CausalMap
    from .device import resolve_device
    from .weaver import mapw

    dev = resolve_device(device)
    rng = _random.Random(1234)
    base = _c.cmap()
    for i in range(n_keys):
        base = base.append(_c.K(f"k{i}"), f"v{i}")
    pairs = []
    for p in range(n_pairs):
        a = CausalMap(base.ct.evolve(site_id=new_site_id()))
        b = CausalMap(base.ct.evolve(site_id=new_site_id()))
        for e in range(edits):
            a = a.append(_c.K(f"k{rng.randrange(n_keys + 4)}"),
                         f"a{p}.{e}")
            b = b.append(_c.K(f"k{rng.randrange(n_keys + 4)}"),
                         f"b{p}.{e}")
        pairs.append((a, b))

    def step():
        return mapw.merge_map_wave(pairs, kernel=kernel, device=dev)

    step()  # warm
    with _profiled(profile_dir, dev, f"config6-{kernel}"):
        secs, res = _timed(step, reps)
    assert not res.fallback
    return {
        "config": 6,
        "metric": f"map fleet wave, {n_pairs} pairs x "
                  f"~{1 + n_keys + n_keys + edits} nodes",
        "weaver": f"torch-{kernel}",
        "value": round(secs * 1000.0, 3),
        "unit": "ms",
    }


CONFIGS: Dict[int, Callable] = {
    1: config1_append_only,
    2: config2_concurrent_hide,
    3: config3_map_undo_redo,
    4: config4_rich_text_base,
    5: config5_batched_merge,
    6: config6_map_fleet,
}

# configs 1-4 exercise the host path; 5 and 6 are device-only
HOST_WEAVERS = ("pure", "native")


def run_config(num: int, weaver: str, profile_dir: Optional[str] = None) -> dict:
    fn = CONFIGS[num]
    if num in (5, 6):
        return fn(profile_dir=profile_dir)
    return fn(weaver)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-c", "--config", type=int, choices=sorted(CONFIGS),
                   help="run one config (default: all)")
    p.add_argument("-w", "--weaver", default=None, choices=HOST_WEAVERS,
                   help="weave backend for host configs")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace for device configs")
    args = p.parse_args(argv)

    from . import native

    nums = [args.config] if args.config else sorted(CONFIGS)
    for num in nums:
        if num == 5:
            print(json.dumps(run_config(num, "torch", args.profile)))
            continue
        if num == 6:
            # map fleet: the v5 segment-union route and the v4
            # full-width route, side by side
            print(json.dumps(config6_map_fleet(
                kernel="v5", profile_dir=args.profile)))
            print(json.dumps(config6_map_fleet(kernel="v4")))
            continue
        weavers = [args.weaver] if args.weaver else list(HOST_WEAVERS)
        for w in weavers:
            if w == "native" and not native.available():
                print(json.dumps({"config": num, "weaver": "native",
                                  "skipped": "native toolchain unavailable"}))
                continue
            print(json.dumps(run_config(num, w)))
            if num == 1:
                print(json.dumps(config1_bulk_extend(w)))
        if num == 1:
            # backend-independent row (picks native/torch itself)
            print(json.dumps(config1_append_lazy()))


if __name__ == "__main__":
    main()
