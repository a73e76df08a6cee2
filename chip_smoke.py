#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``cause_tpu_torch``) on one GPU.

    python3 chip_smoke.py

builds the port's CUDA kernels from ``cause_tpu_torch/csrc`` with nvcc,
holds each one against its plain PyTorch version on the card, drives the
north-star merge wave (1024 divergent replica pairs of 10k-node lists)
through the v5 pipeline and the fused v5f pipeline, the handle-level
``merge_wave`` API through both, the session, the merge tree and the
map-fleet wave, bases, sync rounds, the quarantined wave, the chaos
ladder and compaction, a served fleet of 32 tenants behind the
network transport, and checks that the kernels really
carried those paths (launch counts) and that the results are
bit-identical to the plain path on the card, to each other and to the
pure host weaver. Every comparison is exact: all outputs are integers or
flags.

Phases, one line each (times from CUDA events unless named host):

1. build: the nvcc build of every kernel source, in parallel;
2. kernels: every kernel call of one north-star v5 dispatch and of one
   v5f dispatch (K1, K2, K4 and v5f's own B1-B3 calls), captured at its
   real inputs on the plain path, plus edge cases (ragged widths, rows
   too wide for shared memory; for B1 the doubled-budget width P = 8192
   with two keys, keys whose composite spans more than 32 bits,
   INT32_MIN beside INT32_MAX, rows of equal keys; for B2 a chain and a
   star at K = 4096 and 8192, two interleaved chains, B = 1, a row on
   global scratch; for
   K1/K2/K4 the doubled-budget row u_max = 8192 on global scratch, Kp <
   P, an overflowing row compared on its flags, N not a multiple of
   128, B = 1, Kp = 256 below P and P = Kp = 256 at the radix form's
   lower width, rows that keep no token; for K1 alone P = 256 and 8192,
   a row of only padding, (hi, lo) composites wider than 32 bits,
   INT32_MIN beside INT32_MAX, long duplicate runs that count conflicts,
   U < P with links the clamps change, B = 1, and the network form's
   widths; for B3 N below 1024 and not a multiple of 4, 128 or 1024,
   rows with no kept token, tokens at lanes 0 and N - 1, a tile of 1024
   tokens, segments over several tiles, a covered lane whose lane + 1
   starts the next tile, S = 1, B = 1), kernel against plain version;
   kernel, plain and, for the sort, library (``torch.sort``) times, with
   one line per B1 site (its keys' composite bit count, kernel against
   ``torch.sort``), one per K1/K2/K4 launch (ms, bound ms, CTAs per SM
   of its form and of the network form at its width) and one for B3
   (ms, bound ms, CTAs per SM); ``--phases`` adds K1's, K2's and K4's
   split between load/store, scans and sorts in both forms;
3. north star: ``batched_pair_lanes`` -> ``batched_v5_inputs`` ->
   ``lanes_from_numpy`` -> ``batched_weave_digest`` on the card; launch
   counts of one dispatch, p50 of a few, against the plain path;
3f. north star v5f: the same batch through ``batched_merge_weave_v5f``
   and ``replica_digest``; launch counts of one dispatch, bit-identical
   to the plain v5f path and to phase 3's v5 outputs, p50 beside v5's;
4. api: ``tree_fleet_handles`` (64 replicas of a 10k-node list) ->
   ``merge_wave`` over 32 pairs and one ``weaver="torch"`` merge, then
   ``merge_wave`` again under ``BENCH_KERNEL=v5f``; launch counts,
   ``merged(i)`` against the pure merge, equal digests;
5. delta: ``delta_sweep_inputs`` at the north-star batch (1000 divergent
   ops a tree, N_w = 2048, then a steady-state round of 16, N_w = 64:
   B1's network form) -> ``batched_delta_weave`` on the card; launch
   counts of one delta dispatch (6/1/1), every kernel call of it against
   its plain version, timed, with its bound; digests bit-identical to
   the full arm's ``batched_weave_digest``; ``splice_ranks`` into the
   full arm's ranks with the divergent lanes cleared gives them back;
   the delta dispatch's p50 between two of the full arm's, and beside
   phase 3's; ``--profile`` adds a breakdown of both dispatches;
6. session: ``FleetSession`` over phase 4's 32 pairs, their lane caches
   built first: the first wave equals ``merge_wave``; the first round of
   edits re-uploads (a suffix that ends in a tombstone restructures its
   tree's segments, as in the reference: ``tests/test_torch_session.py``
   holds both packages to full, full, delta on this fleet's pattern);
   after the second round and ``update()`` the frontier holds and the
   next wave splices into the resident ranks (the delta path, read from
   the session's state) with digests equal to a fresh ``merge_wave``;
   that wave again on the plain versions, every kernel call of it held
   against its plain version and timed once a shape; ``merged(i)``
   against the pure merge; ``checkpoint()`` -> ``restore()`` through its
   digest gate on the card; upload, wave, window assembly and restore
   times;
7. tree: ``merge_tree_report`` over the 64 replicas: 6 levels, level 0
   full width and the rest delta, each level's path, window and time
   (from the report); the tree again on the plain versions, with the
   same levels and root, every kernel call of it held against its plain
   version on the card and timed once a shape (every level's window,
   down to B1's network form on global scratch); the root equals
   ``merge_many`` of the same handles; ``merge_all`` launches exactly
   the tree's kernels (not ``merge_many``'s) and gives the same root;
8. maps: a fleet of 256 map replica pairs built as
   ``benchmarks.config6_map_fleet`` builds its own, at a document
   service's size (1,024 keys written 4 times in the base, every 8th
   write hidden by an id-caused hide, 64 writes a side over 1,056 keys,
   every 8th hidden again: N = 16,384 forest lanes a row) through
   ``merge_map_wave``: launch counts (6/1/1 a dispatch, times the
   dispatches of the overflow retry), no row to the host merge, the
   same wave on the plain versions bit-identical with every kernel call
   held against its plain version and timed once a shape (each B1 call
   with its v5 site, width and form), ``merged(i)`` against the pure
   merge, the wave's p50 beside its marshal's and its bare dispatch's;
   then config 6's own wave (64 pairs, 24 keys, 12 writes a side) the
   same way; one ``weaver="torch"`` map of the base's size, reweave and
   merge against the pure weaver; fleets of 8 ``weaver="torch"`` sets
   and counters through ``merge_all`` against the pure fold;
9. bases and sync: ``sync_pair`` over phase 4's 32 ``weaver="torch"``
   pairs (one B = 1 device reweave a side: 6/1/1 launches each), every
   side equal to phase 4's ``merged(i)`` and the sides'
   ``content_digest``s equal, pair 0's round on the plain versions with
   every kernel call checked and timed, one ``sync_stream`` round over a
   socket pair between two threads, and one direction's reweave
   profiled (device kernels, busy share); a site quarantined in 2 pairs
   (``merge_wave`` sends them to the per-pair merge and dispatches the
   other 30, every ``merged(i)`` equal to phase 4's; the next sync round
   takes the full bag and readmits it); the chaos ladder on the card (a
   retried dispatch fault at the wave's seam, a session budget
   exhaustion that runs one wave full width, a tree budget exhaustion
   that bounces a level); a ``weaver="torch"`` base (a root map of a
   10,000-element list, a set and a counter, two replicas of 500
   transactions each, ``sync_base_pair``, ``undo``/``redo``, ``dumps`` ->
   ``loads`` reweaving every list-shaped collection on the card) against
   its ``weaver="pure"`` twin; ``gc.compact`` of a 10k-node list with a
   hidden tail against the pure weave of its nodes, and a sync round
   with its uncompacted peer.
10. serve: a served document fleet: 32 tenants, each a pair of
   ``weaver="torch"`` replicas of a fresh 10,000-element list (written
   in runs of 1,000), in a ``SyncService(batched=True)`` with
   ``ResidencyManager(capacity=16)`` (half the fleet spilled and
   restored under traffic), ``d_max=64`` and a WAL with
   ``fsync="batch"``, fronted by a ``ReplicationServer`` on loopback
   that 8 ``NetClient``s (4 tenants each) feed per-site deltas over
   the sockets: 6 rounds of zipf-hot offers (alpha 1.2, 1-16 ops a
   site), one tenant bursting 200 ops so it alone falls back to a
   full-width wave, each round ticked with the service's default drain
   (``d_max`` ops a tick) until its queue is empty; each tick's
   launches equal 6/1/1 times its bucket dispatches, full-width
   fallbacks, side applies and restores' reweaves; one bucket re-dispatched
   by the scheduler's own code on the kernels and on the plain path,
   every kernel call held against its plain version and timed
   (``torch.sort`` beside B1), and a one-tenant bucket's dispatch p50
   (the controller's floor); the same journal round by round through
   ``batched=False`` with equal digests; 4 tenants' ``materialize()``
   against the pure weaver's merge of their journals; evict/restore
   cycles with flat ``memory_allocated``; ``drain()`` ->
   ``SyncService.restore()`` with every ``converged_digest``
   bit-identical; the scrubber over the WAL and the checkpoint; the
   native weaver built and a 10k-node merge equal to the pure merge.

Phases 5-10 each reset the launch counts before they run (phase 10
reads them tick by tick) and read them after: a phase that did not
launch B1, B2 and B3 fails.

Before the last line it prints the card's ``name, power.limit`` (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
it) and one JSON object with a record per kernel. The last line is
``{"ok": true, "device": {...}}``. Any failed check exits non-zero
before the result lines; without a CUDA device the script exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

DEVICE = "cuda"
PAIRS = 1024      # north-star replica pairs
CAP, N_BASE, N_DIV = 10240, 9000, 1000  # north-star rows (lanes a tree)
N_DIV_STEADY = 16  # phase 5's steady-state round of edits (N_w = 64)
REPLICAS = 64     # API-phase replicas (32 pairs)
REPS = 5          # timed north-star dispatches
# phase 8's map fleet: pairs, keys, writes a key in the base, writes a side
MAP_PAIRS, MAP_KEYS, MAP_WRITES, MAP_EDITS = 256, 1024, 4, 64
MAP_SMALL = 64    # pairs of config 6's own wave (24 keys, 12 edits)
# phase 9's base: list elements, transactions a replica, and the hidden
# tail of its compaction
BASE_LIST, BASE_TX, COMPACT_TAIL = 10_000, 500, 100
# phase 10's served fleet: tenants (each a pair of replicas of a list of
# SERVE_LIST values written in runs of SERVE_RUN), residency capacity,
# the delta budget, rounds of offered load, clients, zipf-hot offers a
# round, the burst (ops, round, tenant), tenants held against the pure
# weaver, the seed
SERVE_TENANTS, SERVE_LIST, SERVE_RUN = 32, 10_000, 1_000
SERVE_CAPACITY, SERVE_DMAX, SERVE_ROUNDS, SERVE_CLIENTS = 16, 64, 6, 8
SERVE_OFFERS, SERVE_BURST, SERVE_BURST_ROUND, SERVE_BURST_TENANT = \
    24, 200, 2, 31
SERVE_ORACLE, SERVE_SEED = 4, 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
I32_MAX = int(np.iinfo(np.int32).max)

# the TPU kernels each CUDA kernel replaces (their pallas_call sites)
REPLACES = {
    "sort": "cause_tpu/weaver/pallas_sort.py:140",
    "euler_walk": "cause_tpu/weaver/pallas_ops.py:139",
    "fphase": "cause_tpu/weaver/pallas_fphase.py:211",
    "k1_sort_redirect": "cause_tpu/weaver/pallas_befuse.py:544",
    "k2_runs": "cause_tpu/weaver/pallas_befuse.py:580",
    "k4_rank_kills": "cause_tpu/weaver/pallas_befuse.py:656",
}
SOURCE = {
    "sort": "cause_tpu_torch/csrc/sort.cu",
    "euler_walk": "cause_tpu_torch/csrc/euler_walk.cu",
    "fphase": "cause_tpu_torch/csrc/fphase.cu",
    "k1_sort_redirect": "cause_tpu_torch/csrc/befuse_k1.cu",
    "k2_runs": "cause_tpu_torch/csrc/befuse_k2.cu",
    "k4_rank_kills": "cause_tpu_torch/csrc/befuse_k4.cu",
}
FUSED = ("k1_sort_redirect", "k2_runs", "k4_rank_kills")
# launches of one dispatch of each pipeline
V5_LAUNCHES = {"sort": 6, "euler_walk": 1, "fphase": 1}
V5F_LAUNCHES = {"sort": 2, "euler_walk": 1, "fphase": 1,
                "k1_sort_redirect": 1, "k2_runs": 1, "k4_rank_kills": 1}
# the v5 dispatch's sort sites, in call order (torchw5.py)
SORT_SITES = ("A segments", "C tokens", "E siblings", "E successor",
              "F lanes", "F coverage")
I32_MIN = int(np.iinfo(np.int32).min)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10, warm: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def timed_ms(torch, fn):
    """``(fn(), host ms)`` with the card synchronized on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t) * 1e3


def session_edit(pairs, rnd):
    """Phase 6's round of edits: two appends on one side, one on the
    other."""
    return [(a.conj(f"e{rnd}.{i}a").extend([f"e{rnd}.{i}b"]),
             b.conj(f"e{rnd}.{i}c")) for i, (a, b) in enumerate(pairs)]


def max_err(torch, got, want) -> int:
    """Largest absolute difference of two int/bool tensor tuples; a
    shape or dtype mismatch fails outright."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"shape/dtype {tuple(g.shape)} {g.dtype} != "
                 f"{tuple(w.shape)} {w.dtype}")
        d = (g.long() - w.long()).abs().max().item() if g.numel() else 0
        err = max(err, int(d))
    return err


def plain_fns():
    from cause_tpu_torch.weaver import befuse, bitonic, euler, fphase

    return {
        "sort": bitonic.sort_pairs_plain,
        "euler_walk": euler.euler_walk_plain,
        "fphase": fphase.fphase_expand_plain,
        "k1_sort_redirect": befuse.k1_sort_redirect_plain,
        "k2_runs": befuse.k2_runs_plain,
        "k4_rank_kills": befuse.k4_rank_kills_plain,
    }


@contextlib.contextmanager
def plain_path(record=None):
    """Route the kernel sites of the v5 pipeline (``torchw5``: sort, walk,
    expansion) and of the v5f pipeline (``torchw5f``: the same three and
    K1, K2, K4) to their plain PyTorch versions (the reference on the
    card), optionally recording every call's inputs. Restores the kernel
    wrappers on exit."""
    from cause_tpu_torch.weaver import torchw5, torchw5f

    plain = plain_fns()
    attr = {"sort": "sort_pairs", "euler_walk": "euler_walk",
            "fphase": "fphase_expand"}
    sites = [(torchw5, attr[n], n) for n in attr]
    sites += [(torchw5f, attr.get(n, n), n) for n in plain]
    saved = [(mod, a, getattr(mod, a)) for mod, a, _ in sites]

    def wrap(name):
        def call(*args, **kw):
            if record is not None:
                ops = args[0] if name == "sort" else args
                record.append((name, tuple(x.clone() for x in ops),
                               dict(kw)))
            return plain[name](*args, **kw)
        return call

    for mod, a, name in sites:
        setattr(mod, a, wrap(name))
    try:
        yield
    finally:
        for mod, a, fn in saved:
            setattr(mod, a, fn)


# ------------------------------------------------------------ kernels


def kernel_fns(name):
    from cause_tpu_torch.weaver import befuse, bitonic, euler, fphase

    kern = {
        "sort": bitonic.sort_pairs_cuda,
        "euler_walk": euler.euler_walk_cuda,
        "fphase": fphase.fphase_expand_cuda,
        "k1_sort_redirect": befuse.k1_sort_redirect_cuda,
        "k2_runs": befuse.k2_runs_cuda,
        "k4_rank_kills": befuse.k4_rank_kills_cuda,
    }
    return kern[name], plain_fns()[name]


def call_bytes(ops, outs) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    return sum(x.numel() * x.element_size() for x in tuple(ops) + outs)


def library_fn(torch, ops, num_keys):
    """One ``torch.sort`` call that orders the same rows: stable, on the
    first key, packed with the second into int64 for two-key sites. The
    payloads are not moved (the yardstick is the sort alone)."""
    if num_keys == 1:
        key = ops[0]
    else:
        key = (ops[0].long() << 32) + (ops[1].long() + (1 << 31))
    return lambda: torch.sort(key, dim=-1, stable=True)


def radix_bits(torch, ops, num_keys) -> list:
    """Per row, the bits of the radix path's composite key
    (``csrc/radix.cuh``): per key, the bit length of the largest code
    ``k - min`` with INT32_MAX (and the padding to the next power of
    two) mapped just above the largest other key."""
    B, n = ops[0].shape
    P = 1 << max(0, (n - 1).bit_length())
    total = torch.zeros(B, dtype=torch.int64, device=ops[0].device)
    for key in ops[:num_keys]:
        k = key.long()
        is_max = k == I32_MAX
        mx = torch.where(is_max, I32_MIN, k).max(dim=1).values
        top = torch.where(is_max.any(dim=1) | (P > n), mx + 1, mx) - \
            k.min(dim=1).values
        top = torch.where(is_max.all(dim=1), 0, top)
        total += sum((top >> b) > 0 for b in range(33))
    return total.tolist()


def check_call(torch, name, ops, kw, time_it: bool, flags_only=False):
    """Kernel against plain version on one call; ``flags_only`` (an
    overflowing row, whose other outputs the reference leaves
    unspecified) holds only the ``scal`` rows of the fused kernels to
    the plain version, after a launch that must not fault."""
    kern, plain = kernel_fns(name)
    if name == "sort":
        run = lambda f: f(ops, **kw)  # noqa: E731
    else:
        run = lambda f: f(*ops, **kw)  # noqa: E731
    got = run(kern)
    torch.cuda.synchronize()
    want = run(plain)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rec = {"err": max_err(torch, got, want)}
    if flags_only:
        rec["all_err"] = rec["err"]
        rec["err"] = max_err(torch, got[-1:], want[-1:])
    if time_it:
        rec["ms"] = cuda_ms(torch, lambda: run(kern))
        rec["plain_ms"] = cuda_ms(torch, lambda: run(plain))
        if name == "sort":
            rec["library_ms"] = cuda_ms(
                torch, library_fn(torch, ops, kw.get("num_keys", 1)))
        rec["bound_ms"] = bound_ms(call_bytes(ops, want))
    return rec


def edge_cases(torch, dev):
    """Inputs the north star does not reach: ragged widths, negative and
    duplicate keys with int32-max sentinels, rows too wide for shared
    memory (the global-scratch paths), unreached forest runs."""
    from cause_tpu_torch.weaver import befuse, euler

    rng = np.random.default_rng(20261016)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731

    def full(B, n):
        return rng.integers(I32_MIN, I32_MAX, size=(B, n), dtype=np.int64,
                            endpoint=True)

    def sort_key(kind, B, n):
        if kind == "narrow":      # duplicates, INT32_MAX sentinels
            x = rng.integers(-4, 5, size=(B, n))
            x[rng.random((B, n)) < 0.15] = I32_MAX
        elif kind == "full":      # two of these: a 64-bit composite
            x = full(B, n)
        elif kind == "extremes":  # INT32_MIN beside INT32_MAX
            x = rng.choice(np.array([I32_MIN, I32_MIN + 1, -1, 0, 1,
                                     I32_MAX - 1, I32_MAX]), size=(B, n))
        elif kind == "equal":     # zero passes (n = P: no padding)
            x = np.full((B, n), -77)
        else:                     # a sibling key: 15 bits of parent
            x = rng.integers(0, 2 * 8192 + 2, size=(B, n))
        return x.astype(np.int32)

    cases = []
    for B, n, n_ops, nk, kind in (
            (3, 1, 1, 1, "narrow"), (4, 300, 3, 2, "narrow"),
            (4, 1000, 9, 3, "narrow"), (2, 16384, 9, 3, "narrow"),
            (8, 4096, 7, 2, "narrow"), (2, 40, 9, 9, "narrow"),
            (4, 3000, 2, 1, "narrow"), (5, 256, 1, 1, "narrow"),
            (3, 200, 3, 2, "narrow"), (2, 8192, 3, 2, "sibling"),
            (2, 6000, 4, 2, "full"), (4, 4096, 3, 2, "full"),
            (4, 1000, 2, 1, "extremes"), (3, 4096, 3, 2, "equal"),
            (2, 2048, 2, 1, "equal")):
        ops = [sort_key(kind, B, n) if i < nk else
               full(B, n).astype(np.int32) for i in range(n_ops)]
        cases.append(("sort", f"B={B} n={n} ops={n_ops} keys={nk} {kind}",
                      tuple(T(x) for x in ops), {"num_keys": nk}))

    def shaped(shape, B, K):
        """Run tables of a chain (parent i - 1), a star (parent 0) or two
        interleaved chains (parent i - 2)."""
        par = np.full((B, K), -1, np.int64)
        par[:, 1:] = {"chain": np.arange(K - 1), "star": 0,
                      "two chains": np.maximum(np.arange(-1, K - 2), 0)}[
                          shape]
        parent_sort = np.where(par >= 0, par, K).astype(np.int32)
        order = np.argsort(parent_sort, axis=1, kind="stable").astype(
            np.int32)
        fc, ns = euler.link_children(T(order), T(parent_sort))
        w = rng.integers(0, 6, size=(B, K)).astype(np.int32)
        return fc, ns, T(par.astype(np.int32)), T(w)

    for shape, B, K in (("chain", 2, 4096), ("star", 2, 4096),
                        ("two chains", 2, 4096), ("chain", 1, 8192),
                        ("star", 1, 8192)):
        cases.append(("euler_walk", f"{shape} B={B} K={K}",
                      shaped(shape, B, K), {}))
    for B, K, n_valid in ((4, 64, 40), (2, 16384, 12000), (3, 300, 300),
                          (2, 32768, 30000), (1, 4096, 1)):
        parent_sort = np.full((B, K), K, np.int32)
        special = rng.random((B, K)) < 0.3
        w = np.zeros((B, K), np.int32)
        for r in range(B):
            parent_sort[r, 1:n_valid] = (
                rng.random(n_valid - 1) * np.arange(1, n_valid)).astype(
                    np.int32)
            w[r, :n_valid] = rng.integers(0, 6, size=n_valid)
        packed = parent_sort * 2 + (~special).astype(np.int32)
        head = np.arange(K, dtype=np.int32)
        order = np.stack([np.lexsort((-head, packed[r])) for r in range(B)])
        fc, ns = euler.link_children(T(order.astype(np.int32)),
                                     T(parent_sort))
        parent_up = T(np.where(parent_sort < K, parent_sort, -1).astype(
            np.int32))
        cases.append(("euler_walk", f"B={B} K={K} reached={n_valid}",
                      (fc, ns, parent_up, T(w)), {}))
    for B, N, U, S, kind in (
            (3, 1000, 64, 16, "random"), (2, 20480, 4096, 512, "random"),
            (4, 130, 300, 200, "random"), (2, 3001, 700, 40, "random"),
            (2, 20556, 4096, 512, "random"), (3, 4096, 256, 8, "no tokens"),
            (2, 5000, 300, 20, "ends"), (2, 4096, 2048, 30, "full tile"),
            (2, 6144, 200, 4, "long segments"), (2, 4099, 100, 10,
                                                   "tile-edge kill"),
            (2, 4096, 100, 10, "tile-edge kill"), (2, 2048, 50, 1, "random"),
            (1, 20480, 4096, 512, "random")):
        ops = fphase_inputs(rng, B, N, U, S, kind)
        if kind == "tile-edge kill" and not tile_edge_killed(torch, ops):
            fail("B3 edge case: no tile's last lane is killed by its next")
        cases.append(("fphase", f"{kind} B={B} N={N} U={U} S={S}",
                      tuple(T(x) for x in ops), {}))
    for tag, B, P, U, kind in (
            ("P=256", 4, 256, 256, "tokens"),
            ("P=8192", 2, 8192, 8192, "tokens"),
            ("a row of only padding", 3, 4096, 4096, "padding row"),
            ("composite > 32 bits", 3, 4096, 4096, "wide"),
            ("INT32_MIN beside INT32_MAX", 3, 1024, 1024, "extremes"),
            ("duplicate runs", 4, 4096, 4096, "dups"),
            ("U<P", 3, 2048, 1500, "tokens"),
            ("B=1", 1, 4096, 4096, "dups"),
            ("network form P=128", 3, 128, 100, "dups"),
            ("network form P=16384, global scratch", 1, 16384, 16384,
             "tokens")):
        ops = tuple(T(x) for x in k1_inputs(rng, B, P, U, kind))
        if kind == "wide" and min(radix_bits(torch, ops, 2)) <= 32:
            fail("K1 edge case 'composite > 32 bits' has narrower rows")
        if kind == "dups" and not bool((befuse.k1_sort_redirect_plain(
                *ops, U=U)[-1][:, 0] > 0).all()):
            fail("K1 edge case 'duplicate runs' counts no conflict")
        cases.append(("k1_sort_redirect", f"{tag}: B={B} P={P} U={U}", ops,
                      {"U": U}))
    return cases


def k1_inputs(rng, B, P, U, kind):
    """K1's eight [B, P] inputs: n tokens a row (the rest padding, hi =
    lo = INT32_MAX) with keys of the given kind, payloads, and cause /
    host links in [-1, P), so that links at or past U meet the clamps."""
    hi = np.full((B, P), I32_MAX, np.int64)
    lo = np.full((B, P), I32_MAX, np.int64)
    for r in range(B):
        n = int(rng.integers(U // 2, U + 1))
        if kind == "padding row" and r == 1:
            n = 0
        if kind == "wide":        # full-range keys: a 64-bit composite
            h = rng.integers(I32_MIN, I32_MAX, size=n, endpoint=True)
            lo_ = rng.integers(I32_MIN, I32_MAX, size=n, endpoint=True)
        elif kind == "extremes":  # INT32_MIN beside INT32_MAX in hi
            h = rng.choice(np.array([I32_MIN, I32_MIN + 1, -1, 0, 1,
                                     I32_MAX - 1, I32_MAX]), size=n)
            lo_ = rng.choice(np.array([I32_MIN, 0, 5, I32_MAX]), size=n)
        elif kind == "dups":      # few ids: long duplicate runs
            h = rng.integers(0, 4, size=n)
            lo_ = rng.integers(0, 6, size=n)
        else:                     # ids (site, counter) of a wave's rows
            h = rng.integers(0, 1 << 20, size=n)
            lo_ = rng.integers(0, 1 << 14, size=n)
        hi[r, :n], lo[r, :n] = h, lo_
    small = lambda a, b: rng.integers(a, b, size=(B, P))  # noqa: E731
    return (hi.astype(np.int32), lo.astype(np.int32),
            small(0, 4).astype(np.int32), small(1, 3).astype(np.int32),
            small(0, 2).astype(np.int32), small(0, 2 * P).astype(np.int32),
            small(-1, P).astype(np.int32), small(-1, P).astype(np.int32))


def fphase_inputs(rng, B, N, U, S, kind, tile=1024):
    """B3's seven inputs (lk, tb, cs, ce, vc, seg, fl) under phase F's
    invariants (token lanes distinct and ascending, N after; segments
    disjoint with ascending starts, start N / end 0 after), with the
    token lanes and segments of the given kind; the kinds bound to B3's
    tiles take their width ``tile``."""
    lk = np.full((B, U), N, np.int32)
    tb = np.zeros((B, U), np.int32)
    cs = np.full((B, S), N, np.int32)
    ce = np.zeros((B, S), np.int32)
    vc = rng.choice(np.array([0, 0, 0, 1, 2, 3], np.int32), size=(B, N))
    seg = np.sort(rng.integers(-1, max(N // 8, 1), size=(B, N)),
                  axis=1).astype(np.int32)
    fl = rng.integers(0, 4, size=(B, N)).astype(np.int32)
    for r in range(B):
        if kind == "no tokens":
            lanes = np.zeros(0, np.int64)
        elif kind == "full tile":  # every lane of the second tile
            extra = rng.choice(np.r_[0:tile, 2 * tile:N], size=U - tile,
                               replace=False)
            lanes = np.sort(np.r_[np.arange(tile, 2 * tile), extra])
        else:
            k = int(rng.integers(0, min(U, N) - 1))
            lanes = rng.choice(N, size=k, replace=False)
            if kind == "ends":  # at most U lanes with 0 and N - 1
                lanes = np.unique(np.r_[0, N - 1, lanes])
            lanes = np.sort(lanes)
        lk[r, :len(lanes)] = lanes
        tb[r, :len(lanes)] = rng.integers(0, N, size=len(lanes))
        if kind == "long segments":  # over several tiles
            mid = 5 * tile // 2
            segs = np.array([[5, mid], [mid + 3, mid + 4], [3 * tile, N - 1]])
        elif kind == "tile-edge kill":  # over the first two tile edges
            segs = np.array([[tile - 20, tile + 20],
                             [2 * tile - 20, 2 * tile + 20]])
        else:
            cuts = np.sort(rng.choice(np.arange(1, N),
                                      size=2 * min(S, N // 4),
                                      replace=False)).reshape(-1, 2)
            segs = cuts[rng.random(len(cuts)) < 0.6]
        segs = segs[:S]
        cs[r, :len(segs)], ce[r, :len(segs)] = segs[:, 0], segs[:, 1]
    if kind == "tile-edge kill":
        # a tile's last lane, visible but for the tombstone after it in
        # its segment (an ordinal no other lane has)
        for ln in (tile - 1, 2 * tile - 1):
            seg[:, ln:ln + 2] = 1 << 20
            vc[:, ln], vc[:, ln + 1] = 0, 1
            fl[:, ln] = 1
        tb[:, :] = 0
    return lk, tb, cs, ce, vc, seg, fl


def tile_edge_killed(torch, ops, tile=1024) -> bool:
    """Whether the plain version kills the first two tiles' last lanes
    for their next lane alone (a "tile-edge kill" case reaches the
    kernel's exchange across the tile edge)."""
    from cause_tpu_torch.weaver import fphase

    t = tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in ops)
    rank, vis = fphase.fphase_expand_plain(*t)
    N = ops[4].shape[1]
    return all(bool(((rank[:, ln] < N) & ~vis[:, ln]).all())
               for ln in (tile - 1, 2 * tile - 1))


def fused_edge_cases(torch, dev):
    """K1/K2/K4 calls the north star does not make, captured from small
    plain v5f dispatches: the doubled-budget retry's rows (u_max = 8192:
    K1 and K2 on global scratch), Kp < P, rows whose runs overflow
    k_max, N not a multiple of 128, one row. Each plain dispatch is also
    run on the kernels and compared: all outputs on rows that do not
    overflow, the overflow flags on all."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import benchgen
    from cause_tpu_torch.weaver.arrays import next_pow2

    cases = []
    for tag, shape, du, k_max in (
            ("u_max=8192", (2, 9000, 1000, 10240, 8), 8192, None),
            ("Kp<P", (8, 120, 40, 256, 8), 300, 0),
            ("Kp=256<P", (8, 120, 40, 256, 8), 600, 200),
            ("P=Kp=256", (3, 120, 40, 256, 8), 0, 0),
            ("overflow k_max=16", (4, 100, 60, 192, 4), 256, 16),
            ("N=144", (4, 30, 10, 72, 3), 0, 0),
            ("B=1", (1, 9000, 1000, 10240, 8), 0, 0)):
        B, nb, nd, cap, he = shape
        v5 = benchgen.batched_v5_inputs(
            benchgen.batched_pair_lanes(B, nb, nd, cap, hide_every=he), cap)
        need = next_pow2(benchgen.v5_token_budget(v5))
        u = du if du >= 1024 else need + du
        k = {None: u, 0: need}.get(k_max, k_max)
        lanes = benchgen.lanes_from_numpy(v5, dev)
        args = [lanes[x] for x in benchgen.LANE_KEYS5]
        rec = []
        with plain_path(record=rec):
            want = ct.batched_merge_weave_v5f(*args, u_max=u, k_max=k,
                                              device=dev)
        got = ct.batched_merge_weave_v5f(*args, u_max=u, k_max=k,
                                         device=dev)
        torch.cuda.synchronize()
        ovf = want[3]
        if tag.startswith("overflow") != bool(ovf.any()):
            fail(f"edge {tag}: overflow rows {ovf.tolist()}")
        if not torch.equal(got[3], ovf) or any(
                not torch.equal(g[~ovf], w[~ovf])
                for g, w in zip(got[:3], want[:3])):
            fail(f"v5f kernel path differs from the plain path ({tag})")
        desc = f"{tag}: B={B} N={2 * cap} U={u} k_max={k}"
        for name, ops, kw in rec:
            if name in FUSED:
                cases.append((name, desc, ops, kw,
                              tag.startswith("overflow")))
        if tag in ("P=Kp=256", "B=1"):
            cases += no_kept_rows(rec, desc, B - 1)
    return cases


def no_kept_rows(rec, desc, row):
    """K2 and K4 calls of a recorded v5f dispatch whose row ``row`` keeps
    no token (keep = 0 throughout): K4's run tables and bases come from
    the plain K2 and walk on the changed K2 inputs."""
    from cause_tpu_torch.weaver import befuse, euler

    _, ops2, kw2 = next(c for c in rec if c[0] == "k2_runs")
    _, ops4, kw4 = next(c for c in rec if c[0] == "k4_rank_kills")
    ops2 = list(ops2)
    ops2[3] = ops2[3].clone()
    ops2[3][row] = 0
    (fc, ns, parent_up, run_w, hc, h_w, run_id, glued, prev_kept,
     scal2) = befuse.k2_runs_plain(*ops2, **kw2)
    if int(scal2[row, 0]) != 0:
        fail(f"edge {desc}: row {row} without kept tokens has runs")
    base = euler.euler_walk_plain(fc, ns, parent_up, run_w)
    new4 = (base, hc, h_w, run_id, ops2[3], ops2[0], ops2[1], ops4[7],
            glued, prev_kept, ops4[10], scal2)
    tag = f"{desc}, row {row} keeps no token"
    return [("k2_runs", tag, tuple(ops2), kw2, False),
            ("k4_rank_kills", tag, new4, kw4, False)]


def profile_dispatch(torch, dispatch, out_dir: str, wall_ms: float,
                     reps: int = 2, tag: str = "v5") -> None:
    """``reps`` north-star dispatches under torch.profiler, read back from
    the Chrome trace it writes to ``out_dir``: device time per dispatch
    by kernel, the device's busy share of the unprofiled p50 wall time
    ``wall_ms``, and the share the port's own kernels take."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            dispatch()
        torch.cuda.synchronize()
    trace = os.path.join(out_dir, f"north_star_{tag}_dispatch.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        kern = [e for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel"]
    by = collections.defaultdict(lambda: [0, 0.0])
    for e in kern:
        by[e["name"].split("(")[0][:70]][0] += 1
        by[e["name"].split("(")[0][:70]][1] += e["dur"] / 1e3
    busy = sum(d for _, d in by.values()) / reps

    def port(name):
        return any(k in name for k in ("sort_rows_", "euler_walk_kernel",
                                       "fphase_row_kernel",
                                       "k1_radix_kernel", "k1_net_kernel",
                                       "k2_radix_kernel", "k2_net_kernel",
                                       "k4_radix_kernel", "k4_net_kernel"))

    ours = sum(d for name, (_, d) in by.items() if port(name)) / reps
    launches = [e for e in sorted(kern, key=lambda e: e["ts"])
                if port(e["name"])]
    first = launches[:len(launches) // reps]
    say(f"[profile {tag}] the port's launches in one dispatch, in order "
        f"(device ms): " + ", ".join(
            f"{e['name'].split('(')[0].replace('void ', '')} "
            f"{e['dur'] / 1e3:.4f}" for e in first))
    say(f"[profile {tag}] {len(kern) // reps} kernels per dispatch, device "
        f"busy {busy:.3f} ms = {100 * busy / wall_ms:.1f}% of the "
        f"{wall_ms:.3f} ms p50; the port's kernels {ours:.3f} ms = "
        f"{100 * ours / busy:.1f}% of the device time")
    for name, (n, d) in sorted(by.items(), key=lambda x: -x[1][1])[:15]:
        say(f"[profile {tag}] {d / reps:8.3f} ms {n // reps:5d} launches  "
            f"{name}")
    say(f"[profile {tag}] trace {trace}")


def fused_widths(name, ops, kw):
    """(P, Kp) of a K1, K2 or K4 call (K1: Kp = P)."""
    if name == "k1_sort_redirect":
        return ops[0].shape[1], ops[0].shape[1]
    if name == "k2_runs":
        return ops[0].shape[1], kw["Kp"]
    return ops[3].shape[1], ops[0].shape[1]


def ctas_per_sm(name, P=0, Kp=0, network=False) -> int:
    """CTAs an SM holds of a kernel: K1's, K2's or K4's at row width P
    (the radix form where the width takes it; ``network``: the network
    form, the first design), B3's at any width, from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    from cause_tpu_torch import kernels

    lib = kernels.library(name)
    if name == "fphase":
        n = lib.cause_fphase_ctas_per_sm()
    elif name == "k1_sort_redirect":
        n = lib.cause_k1_ctas_per_sm(P, int(network))
    else:
        fn = (lib.cause_k2_ctas_per_sm if name == "k2_runs"
              else lib.cause_k4_ctas_per_sm)
        n = fn(P, Kp, int(network))
    if n < 1:
        fail(f"{name}: occupancy query at P={P} Kp={Kp} returned {n}")
    return n


def k1_widths() -> None:
    """K1 at the wave's width (P = 4096) and its doubled-budget retry's
    (8192) runs its radix form in shared memory: no global scratch row."""
    from cause_tpu_torch import kernels

    lib = kernels.library("k1_sort_redirect")
    for P in (4096, 8192):
        words = lib.cause_k1_scratch_words(P)
        if words != 0:
            fail(f"k1_sort_redirect at P={P} takes {words} scratch words a "
                 f"row, not shared memory")
        say(f"[2 kernels] k1_sort_redirect at P={P}: radix form in shared "
            f"memory (no scratch row), CTAs per SM "
            f"{ctas_per_sm('k1_sort_redirect', P, P)} (the network form: "
            f"{ctas_per_sm('k1_sort_redirect', P, P, network=True)})")


def phase_split(torch, calls) -> None:
    """``--phases``: K1, K2 and K4 rebuilt with -DCAUSE_PHASE_CLOCKS
    (thread 0 of each block sums clock64() cycles between block barriers
    into load/compute/store, scans and sorts; befuse.cuh), in the radix
    form and, with -DCAUSE_FORCE_NETWORK, the network form, and run at
    the north star's K1, K2 and K4 calls. Prints each form's unstamped time
    (CUDA events), its cycle shares, and the shares applied to that
    time. The stamped builds add a barrier per mark, so only their shares
    are read."""
    import ctypes
    import subprocess as sp

    from cause_tpu_torch import kernels

    out = kernels.BUILD / "phases"
    out.mkdir(parents=True, exist_ok=True)
    forms = {"radix": ["CAUSE_PHASE_CLOCKS"],
             "network": ["CAUSE_PHASE_CLOCKS", "CAUSE_FORCE_NETWORK"],
             "network unstamped": ["CAUSE_FORCE_NETWORK"]}
    jobs = {}
    for name in FUSED:
        for form, defs in forms.items():
            so = out / f"lib{name}-{'-'.join(defs).lower()}.so"
            cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                   *[f"-D{d}" for d in defs], "-o", str(so),
                   str(kernels.CSRC / kernels.SOURCES[name])]
            jobs[name, form] = (so, sp.Popen(cmd, stdout=sp.PIPE,
                                             stderr=sp.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {key}: {log[-3000:]}")
        libs[key] = kernels.load(so)

    cycles = (ctypes.c_ulonglong * 3)()
    done = set()
    for name, ops, kw in calls:
        if name not in FUSED or name in done:
            continue
        done.add(name)
        kern, plain = kernel_fns(name)
        run = lambda: kern(*ops, **kw)  # noqa: E731
        want = plain(*ops, **kw)
        saved = kernels.library(name)
        ms = {"radix": cuda_ms(torch, run)}
        shares = {}
        try:
            kernels._LIBS[name] = libs[name, "network unstamped"]
            if max_err(torch, run(), want):
                fail(f"{name}: the network form disagrees with the plain "
                     f"version")
            ms["network"] = cuda_ms(torch, run)
            for form in ("radix", "network"):
                lib = kernels._LIBS[name] = libs[name, form]
                kernels.check(lib.cause_phase_cycles_take(
                    ctypes.addressof(cycles)), "phase clocks")
                if max_err(torch, run(), want):
                    fail(f"{name}: the stamped {form} form disagrees with "
                         f"the plain version")
                torch.cuda.synchronize()
                kernels.check(lib.cause_phase_cycles_take(
                    ctypes.addressof(cycles)), "phase clocks")
                tot = float(sum(cycles)) or 1.0
                shares[form] = [c / tot for c in cycles]
        finally:
            kernels._LIBS[name] = saved
        for form in ("radix", "network"):
            sh = shares[form]
            say(f"[phases] {name} {form} form: {ms[form]:.4f} ms (CUDA "
                f"events, unstamped); cycle shares load/store "
                f"{sh[0]:.3f}, scans {sh[1]:.3f}, sorts {sh[2]:.3f}; as "
                f"ms {sh[0] * ms[form]:.4f} / {sh[1] * ms[form]:.4f} / "
                f"{sh[2] * ms[form]:.4f}")


def device_kernels(torch, fn, reps: int = 2):
    """(kernels per call, device ms per call) of ``fn`` on the card, from a
    torch.profiler trace of ``reps`` calls."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            kern = [e for e in json.load(f)["traceEvents"]
                    if e.get("cat") == "kernel"]
    return len(kern) / reps, sum(e["dur"] for e in kern) / 1e3 / reps


def expect_launches(counts, want, what: str) -> None:
    """A phase's launch counts: exactly ``want`` (a dict) or, for a phase
    whose dispatch count depends on the data, at least one of each name
    in ``want`` and none of the others."""
    from cause_tpu_torch import kernels

    if isinstance(want, dict):
        exp = {name: want.get(name, 0) for name in kernels.SOURCES}
        if counts != exp:
            fail(f"{what}: launches {counts}, expected {exp}")
        return
    for name in kernels.SOURCES:
        if (counts[name] > 0) != (name in want):
            fail(f"{what}: launches {counts}, expected some of {want} "
                 f"and none of the others")


def b1_form(ops, num_keys: int) -> str:
    """B1's width P for rows of these operands and the form it takes
    there (``csrc/sort.cu``): radix at 256 <= P <= 8192 for one or two
    keys, else the network, in shared memory or on global scratch."""
    from cause_tpu_torch.weaver import bitonic

    P = 1 << max(0, (ops[0].shape[1] - 1).bit_length())
    if num_keys <= 2 and 256 <= P <= 8192:
        form = "radix"
    elif (num_keys + 1) * P * 4 > bitonic._smem_limit(ops[0].device.index):
        form = "network, global scratch"
    else:
        form = "network, shared memory"
    return f"P={P} {form}"


def check_recorded(torch, calls, tag: str) -> dict:
    """Every kernel call a path made (recorded under ``plain_path``)
    against its plain version on the card; the first call of each
    distinct kernel, shape and keyword set also timed against its plain
    version and its bound, one line each (a B1 call with its v5 site,
    its width and its form). Returns the timed calls' sums per
    kernel."""
    timed = set()
    per = {}
    n_sorts = 0
    for name, ops, kw in calls:
        site = ""
        if name == "sort":  # a v5 dispatch sorts its six sites in order
            site = (f" site {SORT_SITES[n_sorts % len(SORT_SITES)]} "
                    f"{b1_form(ops, kw.get('num_keys', 1))}")
            n_sorts += 1
        key = (name, tuple(tuple(x.shape) for x in ops),
               tuple(sorted(kw.items())))
        rec = check_call(torch, name, ops, kw, time_it=key not in timed)
        if rec["err"]:
            fail(f"{tag}: {name} at {[tuple(x.shape) for x in ops]} "
                 f"{kw or ''} disagrees with its plain version "
                 f"(max_abs_err {rec['err']})")
        if key in timed:
            continue
        timed.add(key)
        tot = per.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                    "bound_ms": 0.0})
        if name == "sort":
            tot.setdefault("library_ms", 0.0)
        for k in tot:
            tot[k] += rec[k]
        shapes = "x".join(str(d) for d in ops[0].shape)
        say(f"{tag}: {name}{site} {shapes} n_ops={len(ops)} {kw or ''}: "
            f"max_abs_err 0, ms {rec['ms']:.4f} plain_ms "
            f"{rec['plain_ms']:.4f} bound_ms {rec['bound_ms']:.4f}"
            + (f" library_ms {rec['library_ms']:.4f}"
               if name == "sort" else ""))
    say(f"{tag}: {len(calls)} kernel calls, each equal to its plain "
        f"version on the card ({len(timed)} distinct shapes timed)")
    return per


def kernel_sums_line(per) -> str:
    """``check_recorded``'s per-kernel sums as one line's text."""
    return "; ".join(
        f"{n} {v['ms']:.4f} ms, plain {v['plain_ms']:.4f}, bound "
        f"{v['bound_ms']:.6f}" + (f", torch.sort {v['library_ms']:.4f}"
                                  if "library_ms" in v else "")
        for n, v in per.items())


def phase_delta(torch, dev, ns_p50: float, p50, profile_dir=None) -> None:
    """Phase 5: the delta wave at the north-star batch, at N_DIV and at
    N_DIV_STEADY divergent ops a tree, each kernel call of one delta
    dispatch timed against its plain version and its bound."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import benchgen, kernels
    from cause_tpu_torch.weaver import torchwd
    from cause_tpu_torch.weaver.arrays import next_pow2

    names = ("rank_w", "visible_w", "digest", "overflow")
    for n_div in (N_DIV, N_DIV_STEADY):
        t0 = time.perf_counter()
        sw = benchgen.delta_sweep_inputs(PAIRS, N_BASE, n_div, CAP,
                                         hide_every=8)
        t1 = time.perf_counter()
        full = benchgen.lanes_from_numpy(sw["full"], dev)
        u = next_pow2(benchgen.v5_token_budget(sw["full"]))

        def full_dispatch():
            return ct.batched_weave_digest(
                *(full[k] for k in benchgen.LANE_KEYS5), u_max=u, k_max=u,
                device=dev)

        f_rank, f_vis, f_dig, f_ov = full_dispatch()
        if bool(f_ov.any()):
            fail(f"delta sweep's full arm overflowed (n_div={n_div})")
        win = benchgen.lanes_from_numpy(sw["window"], dev)
        wargs = [win[k] for k in benchgen.LANE_KEYS5]
        nw = 2 * sw["wcap"]
        tag = f"[5 delta] n_div={n_div} N_w={nw}"

        def delta():
            return ct.batched_delta_weave(
                *wargs, sw["prefix_digest"], sw["r0"], u_max=nw, k_max=nw,
                device=dev)

        calls = []
        with plain_path(record=calls):
            ref = delta()
        kernels.reset_launches()
        got = delta()
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        say(f"{tag}: window marshal {t1 - t0:.3f} s (host clock, numpy, "
            f"full arm included); launches in one delta dispatch: {counts}")
        expect_launches(counts, V5_LAUNCHES, f"{tag} dispatch")
        for nm, g, w in zip(names, got, ref):
            if not torch.equal(g, w):
                fail(f"{tag}: {nm} differs from the plain path")
        if bool(got[3].any()):
            fail(f"{tag}: the window overflowed")
        if not torch.equal(got[2], f_dig):
            fail(f"{tag}: delta digests differ from the full-width digests")
        # the splice: clear the divergent lanes of the full arm's ranks
        # and visibility, splice the window back, get the full arm back
        rf, vf = f_rank.clone(), f_vis.clone()
        s0 = N_BASE + 1
        for t in range(2):
            sl = slice(t * CAP + s0, t * CAP + s0 + n_div)
            rf[:, sl] = -1
            vf[:, sl] = ~vf[:, sl]
        torchwd.splice_ranks(rf, vf, got[0], got[1], sw["starts"],
                             sw["counts"], sw["r0"])
        if not (torch.equal(rf, f_rank) and torch.equal(vf, f_vis)):
            fail(f"{tag}: the splice does not give back the full-width "
                 f"ranks and visibility")
        per = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0} for name in V5_LAUNCHES}
        sites = iter(SORT_SITES)
        for name, ops, kw in calls:
            rec = check_call(torch, name, ops, kw, time_it=True)
            if rec["err"]:
                fail(f"{tag}: {name} kernel disagrees with its plain "
                     f"version")
            for k in per[name]:
                per[name][k] += rec.get(k, 0.0)
            shapes = "x".join(str(d) for d in ops[0].shape)
            site = f" site {next(sites, '?')}" if name == "sort" else ""
            say(f"{tag}: {name}{site} {shapes} n_ops={len(ops)} "
                f"{kw or ''}: max_abs_err 0, ms {rec['ms']:.4f} plain_ms "
                f"{rec['plain_ms']:.4f} bound_ms {rec['bound_ms']:.4f}"
                + (f" library_ms {rec['library_ms']:.4f}"
                   if name == "sort" else ""))
        delta()  # warm
        # the full arm and the window in turns, in this phase: the host's
        # speed drifts between phases
        f_p50, f_all = p50(full_dispatch)
        d_p50, d_all = p50(delta)
        f2_p50, f2_all = p50(full_dispatch)
        say(f"{tag}: digests bit-identical to the full arm's, rank_w / "
            f"visible_w / digest / overflow to the plain path, splice "
            f"exact; delta dispatch p50 {d_p50:.3f} ms, the full arm's "
            f"{f_p50:.3f} ms before it and {f2_p50:.3f} ms after it, "
            f"phase 3's {ns_p50:.3f} ms (host clock, synchronized, {REPS} "
            f"reps: {[round(t, 3) for t in d_all]} / "
            f"{[round(t, 3) for t in f_all]} / "
            f"{[round(t, 3) for t in f2_all]}); per kernel in one dispatch "
            + "; ".join(f"{n} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
                        f"plain {v['plain_ms']:.4f})"
                        for n, v in per.items()))
        if profile_dir:
            profile_dispatch(torch, delta, profile_dir, d_p50,
                             tag=f"delta{n_div}")
            profile_dispatch(torch, full_dispatch, profile_dir, f_p50,
                             tag=f"full{n_div}")
        del full, win, wargs, f_rank, f_vis, f_dig, ref, got, rf, vf


def phase_session(torch, pairs, wave_digest, p50) -> list:
    """Phase 6: a FleetSession over the API fleet's pairs, on the card:
    full wave, edit + update, delta wave, merged, checkpoint/restore.
    Returns the pairs with their lane caches built (phase 9's session
    starts from them)."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import kernels
    from cause_tpu_torch.collections import clist as c_list
    from cause_tpu_torch.collections.clist import CausalList
    from cause_tpu_torch.parallel.wave import assemble_delta_window

    # the API fleet's handles carry no lane cache (their base was woven
    # on the host), so every view would be rebuilt from the node dict;
    # one device reweave each gives them the cache an edited
    # weaver="torch" list keeps, which appends then extend in place
    pairs, warm_ms = timed_ms(torch, lambda: [
        tuple(CausalList(c_list.weave(h.ct)) for h in pair)
        for pair in pairs])
    kernels.reset_launches()
    sess, up_ms = timed_ms(torch, lambda: ct.FleetSession(pairs))
    d0, full_ms = timed_ms(torch, sess.wave)
    expect_launches(dict(kernels.launches), V5_LAUNCHES, "[6 session] "
                    "first wave")
    if not np.array_equal(d0, wave_digest):
        fail("[6 session] the first wave's digests differ from merge_wave's")
    if sess._delta is None:
        fail("[6 session] no delta frontier after the first wave")
    say(f"[6 session] {len(pairs)} pairs: lane caches {warm_ms:.3f} ms "
        f"(one device reweave a handle), upload {up_ms:.3f} ms, first "
        f"(full) wave {full_ms:.3f} ms (host clock, synchronized), digests "
        f"equal merge_wave's; frontier s={int(sess._delta['s'][0])} "
        f"w_cap={sess._delta['w_cap']}")

    # the first round of edits appends to a suffix that ends in a
    # tombstone, which restructures that tree's segments: update()
    # re-uploads and the wave runs full width, as the reference's does
    # (test_session_edit_after_tombstoned_tail_runs_full_once); the
    # second round extends plain chains and must ride the delta path
    pairs1 = session_edit(pairs, 1)
    sess.update(pairs1)
    path1 = "delta" if sess._delta is not None else "full"
    if not np.array_equal(sess.wave(), ct.merge_wave(pairs1).digest):
        fail("[6 session] round 1's digests differ from merge_wave's")
    pairs2 = session_edit(pairs1, 2)
    _, upd_ms = timed_ms(torch, lambda: sess.update(pairs2))
    if sess._delta is None:
        fail("[6 session] update() dropped the frontier: the next wave "
             "would run full width")
    resident = sess.last_rank
    kernels.reset_launches()
    d1, delta_ms = timed_ms(torch, sess.wave)
    counts = dict(kernels.launches)
    expect_launches(counts, V5_LAUNCHES, "[6 session] delta wave")
    if sess.last_rank is not resident:
        fail("[6 session] round 2's wave replaced the resident ranks: it "
             "ran full width, not the delta path")
    fresh = ct.merge_wave(pairs2)
    if not np.array_equal(d1, fresh.digest):
        fail("[6 session] round 2's digests differ from a fresh "
             "merge_wave of the edited pairs")
    # the same delta wave again under the plain versions, every kernel
    # call it makes held against them on the card
    calls = []
    with plain_path(record=calls):
        d_plain = sess.wave()
    if not np.array_equal(d_plain, d1):
        fail("[6 session] the delta wave's digests differ on the plain path")
    check_recorded(torch, calls, "[6 session] delta wave")
    d_p50, d_all = p50(sess.wave)
    # its host window assembly alone, from the same frontier
    dstate = sess._delta
    assembly = []
    for _ in range(REPS):
        t = time.perf_counter()
        assemble_delta_window(sess._views, dstate["s"], dstate["anchor"],
                              dstate["w_cap"], 2 * dstate["w_cap"])
        assembly.append((time.perf_counter() - t) * 1e3)
    f_p50, f_all = p50(sess._full_wave)
    checked = [0, len(pairs) - 1]
    for i in checked:
        a, b = pairs2[i]
        want = CausalList(a.ct.evolve(weaver="pure")).merge(
            CausalList(b.ct.evolve(weaver="pure")))
        got = sess.merged(i)
        if got.ct.weave != want.ct.weave or list(got) != list(want):
            fail(f"[6 session] merged({i}) differs from the pure merge")
    ck, ck_ms = timed_ms(torch, sess.checkpoint)
    restored, rs_ms = timed_ms(torch, lambda: ct.FleetSession.restore(ck))
    if restored._delta is None or not np.array_equal(
            restored._last_digest, sess._last_digest):
        fail("[6 session] restore lost the frontier or the digests")
    say(f"[6 session] round 1 took the {path1} path; round 2: update "
        f"{upd_ms:.3f} ms, wave on the delta "
        f"path {delta_ms:.3f} ms (launches {counts}; spliced into the "
        f"resident ranks), digests equal a fresh merge_wave; delta wave "
        f"p50 {d_p50:.3f} ms (its window assembly alone on the host "
        f"{float(np.median(assembly)):.3f} ms), full wave p50 "
        f"{f_p50:.3f} ms (host clock, "
        f"synchronized, {REPS} reps: {[round(t, 3) for t in d_all]} / "
        f"{[round(t, 3) for t in f_all]}); merged(i) for pairs {checked} "
        f"equal the pure merge; checkpoint {ck_ms:.3f} ms, restore "
        f"{rs_ms:.3f} ms through its digest gate on the card, frontier "
        f"kept")
    return pairs


def phase_tree(torch, hs):
    """Phase 7: the merge tree over the API fleet's replicas, per level;
    every kernel call of the tree against its plain version, the root
    against the plain path's and merge_many's, and merge_all's routing
    (its launches are the tree's). Returns the root."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import kernels
    from cause_tpu_torch.parallel import tree as tree_mod

    def strip(rep):
        return [{k: v for k, v in lv.items() if k != "ms"}
                for lv in rep["levels"]]

    kernels.reset_launches()
    t0 = time.perf_counter()
    root, rep = ct.merge_tree_report(hs)
    t1 = time.perf_counter()
    counts = dict(kernels.launches)
    expect_launches(counts, tuple(V5_LAUNCHES), "[7 tree]")
    paths = [lv["path"] for lv in rep["levels"]]
    want_paths = ["full"] + ["delta"] * (tree_mod.tree_rounds(len(hs)) - 1)
    if paths != want_paths:
        fail(f"[7 tree] level paths {paths}, expected {want_paths}")
    for lv in rep["levels"]:
        say(f"[7 tree] level {lv['level']}: {lv['path']}, {lv['pairs']} "
            f"pairs, {lv['byes']} byes, window {lv['window']}, "
            f"{lv['delta_ops']} divergent ops, digests agree "
            f"{lv['agreed']}: {lv['ms']:.3f} ms (host clock, through the "
            f"level's digest fetch)")
    # the same tree on the plain versions, every kernel call recorded
    calls = []
    with plain_path(record=calls):
        p_root, p_rep = ct.merge_tree_report(hs)
    if strip(p_rep) != strip(rep) or p_root.ct.weave != root.ct.weave \
            or p_root.ct.nodes != root.ct.nodes:
        fail("[7 tree] the tree's levels or root differ on the plain path")
    per = check_recorded(torch, calls, "[7 tree]")
    say("[7 tree] kernel sums over the tree's calls, one call a shape "
        "(CUDA events, mean of 10): " + kernel_sums_line(per))
    t2 = time.perf_counter()
    flat = hs[0].merge_many(hs[1:])
    t3 = time.perf_counter()
    if root.ct.weave != flat.ct.weave or root.ct.nodes != flat.ct.nodes:
        fail("[7 tree] the root differs from merge_many of the same "
             "handles")
    # merge_all must launch exactly what the tree launched, which is not
    # what merge_many launches
    kernels.reset_launches()
    hs[0].merge_many(hs[1:])
    flat_counts = dict(kernels.launches)
    kernels.reset_launches()
    routed = ct.merge_all(hs[0], *hs[1:])
    all_counts = dict(kernels.launches)
    if flat_counts == counts:
        fail(f"[7 tree] merge_many launches what the tree does "
             f"({counts}): the routing check cannot tell them apart")
    if all_counts != counts or routed.ct.weave != root.ct.weave:
        fail(f"[7 tree] merge_all did not route through the tree "
             f"(launches {all_counts}, the tree's {counts}) or its root "
             f"differs")
    say(f"[7 tree] {len(hs)} replicas in {len(paths)} levels: "
        f"{(t1 - t0) * 1e3:.3f} ms (host clock, root materialized); "
        f"launches {counts}; root ({len(root.ct.weave)} nodes) equals "
        f"the plain path's and merge_many's ({(t3 - t2) * 1e3:.3f} ms, "
        f"launches {flat_counts}); merge_all launched the tree's kernels "
        f"and gave the same root")
    return root


def map_fleet(n_pairs: int, n_keys: int, writes: int, edits: int,
              extra_keys: int, hide_every: int, seed: int = 1234):
    """A map fleet as ``benchmarks.config6_map_fleet`` builds its own:
    a base writing each of ``n_keys`` keys ``writes`` times, then
    ``n_pairs`` replica pairs at sites of their own, each side writing
    ``edits`` keys drawn from ``n_keys + extra_keys`` (new keys appear).
    With ``hide_every``, every such write of the base and of each side
    is followed by an id-caused ``hide`` of it (config 3's undo
    tombstones); no ``h.show`` of a hide, which is outside the forest
    domain. Pure-weaver handles; returns ``(base, pairs)``."""
    import random

    import cause_tpu_torch as ct
    from cause_tpu_torch.collections.cmap import CausalMap

    rng = random.Random(seed)
    count = [0]

    def write(h, key, value):
        h = h.append(ct.K(key), value)
        count[0] += 1
        if hide_every and count[0] % hide_every == 0:
            h = h.append((h.get_ts(), h.get_site_id(), 0), ct.hide)
        return h

    base = ct.cmap()
    base = CausalMap(base.ct.evolve(site_id="sMAPBASE00000",
                                    uuid="mapFleetSmokeUuid0000"))
    for w in range(writes):
        for i in range(n_keys):
            base = write(base, f"k{i}", f"v{i}.{w}")
    pairs = []
    for p in range(n_pairs):
        sides = []
        for t in "AB":
            h = CausalMap(base.ct.evolve(site_id=f"sM{t}{p:010d}"))
            count[0] = 0
            for e in range(edits):
                h = write(h, f"k{rng.randrange(n_keys + extra_keys)}",
                          f"{t}{p}.{e}")
            sides.append(h)
        pairs.append(tuple(sides))
    return base, pairs


def map_wave(torch, dev, tag: str, fleet_args, p50, card: str,
             profile_dir=None):
    """One map wave of phase 8 on the card: launch counts a dispatch
    (6/1/1, times the dispatches the overflow retry made), no fallback
    row; the same wave on the plain path bit-identical, every kernel
    call of it held against its plain version and timed once a shape;
    ``merged(i)`` against the pure merge; the wave's p50 beside its
    marshal's and its dispatch's (``profile_dir``: and a profile of the
    dispatch). Returns ``(base, pairs)``."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import kernels
    from cause_tpu_torch.weaver import mapw

    t0 = time.perf_counter()
    base, pairs = map_fleet(*fleet_args)
    t1 = time.perf_counter()
    kernels.reset_launches()
    res = ct.merge_map_wave(pairs)
    t2 = time.perf_counter()
    counts = dict(kernels.launches)
    n_disp = counts["fphase"]
    expect_launches(counts, {k: v * n_disp for k, v in V5_LAUNCHES.items()},
                    f"{tag} merge_map_wave ({n_disp} dispatches)")
    if n_disp < 1 or res.fallback or not res.digest_valid.all():
        fail(f"{tag}: {n_disp} dispatches, rows to the host merge "
             f"{res.fallback} (overflowed or outside the forest domain)")
    cap = res._meta["capacity"]
    sizes = [len(h.ct.nodes) for pair in pairs for h in pair]
    say(f"{tag}: {len(pairs)} pairs of maps of {min(sizes)}-{max(sizes)} "
        f"nodes ({len(res._meta['key_rank'])} keys), cap {cap}, N "
        f"{2 * cap} lanes a row, built in {t1 - t0:.3f} s; merge_map_wave "
        f"{(t2 - t1) * 1e3:.3f} ms (host clock, first call), {n_disp} "
        f"dispatch(es), launches {counts}, 0 rows to the host merge")
    calls = []
    with plain_path(record=calls):
        res_p = ct.merge_map_wave(pairs)
    for nm, g, w in (("rank", res._rank, res_p._rank),
                     ("visible", res._visible, res_p._visible),
                     ("digest", res.digest, res_p.digest)):
        if not np.array_equal(g, w):
            fail(f"{tag}: {nm} differs from the plain path")
    per = check_recorded(torch, calls, tag)
    checked = sorted({0, len(pairs) // 3, 2 * len(pairs) // 3,
                      len(pairs) - 1})
    for i in checked:
        a, b = pairs[i]
        want, got = a.merge(b), res.merged(i)
        if (got.causal_to_edn() != want.causal_to_edn()
                or got.ct.nodes != want.ct.nodes
                or got.ct.weave != want.ct.weave):
            fail(f"{tag}: merged({i}) differs from the pure merge")

    def marshal():
        lanes, meta = mapw.pair_rows([(a.ct.nodes, b.ct.nodes)
                                      for a, b in pairs])
        return (lanes, meta) + mapw.map_v5_inputs(lanes, meta["capacity"])

    m_times = []
    for _ in range(3):
        t = time.perf_counter()
        lanes, meta, v5b, u = marshal()
        m_times.append((time.perf_counter() - t) * 1e3)

    def dispatch():
        return mapw.batched_merge_map_weave_v5(lanes, cap, u_max=u, v5b=v5b,
                                               device=dev)

    (rank, _v, _c, ov), _u = dispatch()
    if bool(ov.any()) or not np.array_equal(rank.cpu().numpy(), res._rank):
        fail(f"{tag}: the bare dispatch overflowed or differs from the wave")
    d_p50, d_all = p50(dispatch)
    w_p50, w_all = p50(lambda: ct.merge_map_wave(pairs))
    say(f"{tag}: rank, visible and digests bit-identical to the plain path; "
        f"merged(i) for pairs {checked} equal the pure merge; wave p50 "
        f"{w_p50:.3f} ms ({[round(t, 3) for t in w_all]}), its marshal "
        f"(pair_rows + map_v5_inputs) p50 {float(np.median(m_times)):.3f} "
        f"ms ({[round(t, 3) for t in m_times]}), the dispatch (upload + v5 "
        f"at u_max = k_max = {u}) p50 {d_p50:.3f} ms "
        f"({[round(t, 3) for t in d_all]}) (host clock, synchronized; "
        f"{card}); kernels at one dispatch's calls: "
        + "; ".join(f"{n} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, "
                    f"plain {v['plain_ms']:.4f})" for n, v in per.items()))
    if profile_dir:
        profile_dispatch(torch, dispatch, profile_dir, d_p50,
                         tag=f"map{len(pairs)}")
    return base, pairs


def phase_maps(torch, dev, p50, card: str, profile_dir=None) -> None:
    """Phase 8: map fleets (the 256-pair document-service fleet and
    config 6's own small wave) through ``merge_map_wave`` on the card,
    one ``weaver="torch"`` map reweave and merge, and fleets of sets and
    counters through ``merge_all``."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import kernels
    from cause_tpu_torch.collections import cmap as c_map
    from cause_tpu_torch.collections.cmap import CausalMap
    from cause_tpu_torch.weaver import torchw

    kernels.reset_launches()
    base, pairs = map_wave(torch, dev, "[8 maps]", (
        MAP_PAIRS, MAP_KEYS, MAP_WRITES, MAP_EDITS, MAP_KEYS // 32, 8), p50,
        card, profile_dir)
    map_wave(torch, dev, "[8 maps, config 6]",
             (MAP_SMALL, 24, 1, 12, 4, 0), p50, card, profile_dir)
    counts = dict(kernels.launches)

    # one weaver="torch" map of the fleet's base size: reweave, merge
    tb = base.ct.evolve(weaver="torch")
    want = c_map.weave(base.ct).weave
    kernels.reset_launches()
    got, rw_ms = timed_ms(torch, lambda: torchw.refresh_map_weave(tb))
    if got.weave != want:
        fail("[8 maps] the torch reweave of the base differs from the pure "
             "weaver's")
    a, b = (CausalMap(h.ct.evolve(weaver="torch")) for h in pairs[0])
    merged, mg_ms = timed_ms(torch, lambda: a.merge(b))
    pure = pairs[0][0].merge(pairs[0][1])
    if merged.ct.weave != pure.ct.weave or merged.ct.nodes != pure.ct.nodes:
        fail("[8 maps] the torch map merge differs from the pure merge")
    say(f"[8 maps] weaver='torch' map of {len(base.ct.nodes)} nodes: "
        f"reweave {rw_ms:.3f} ms, merge of pair 0 {mg_ms:.3f} ms (host "
        f"clock, synchronized; PyTorch ops on the card, launches "
        f"{dict(kernels.launches)}), both equal the pure weaver's")

    # fleets of 8 weaver="torch" sets and counters through merge_all
    def fleet(make, edit, n=8):
        h = make()
        h = type(h)(h.ct.evolve(site_id="sSETBASE00000"))
        h = edit(h, -1)
        return [edit(type(h)(h.ct.evolve(site_id=f"sSR{i:010d}")), i)
                for i in range(n)]

    def set_edit(h, i):
        if i < 0:
            for j in range(2000):
                h = h.add(f"s{j}")
            return h
        for j in range(20):
            h = h.add(f"e{i}.{j}")
        return h.discard(f"s{i}").discard(f"e{i}.0")

    def counter_edit(h, i):
        for j in range(2000 if i < 0 else 20):
            h = h.increment(j % 7 - 2)
        return h if i < 0 else h.undo_delta(h.deltas()[-1][0])

    for name, make, edit in (
            ("sets", lambda: ct.cset(weaver="torch"), set_edit),
            ("counters", lambda: ct.ccounter(weaver="torch"), counter_edit)):
        hs = fleet(make, edit)
        kernels.reset_launches()
        got, ms = timed_ms(torch, lambda: ct.merge_all(hs[0], *hs[1:]))
        launched = dict(kernels.launches)
        for k, v in launched.items():
            counts[k] += v
        pure = type(hs[0])(hs[0].ct.evolve(weaver="pure"))
        for h in hs[1:]:
            pure = pure.merge(type(h)(h.ct.evolve(weaver="pure")))
        if got.causal_to_edn() != pure.causal_to_edn() \
                or got.ct.nodes != pure.ct.nodes:
            fail(f"[8 maps] merge_all of 8 torch {name} differs from the "
                 f"pure fold")
        say(f"[8 maps] merge_all of 8 weaver='torch' {name} "
            f"({len(got.ct.nodes)} nodes): {ms:.3f} ms (host clock), "
            f"launches {launched}, equal to the pure fold")
    expect_launches(counts, tuple(V5_LAUNCHES), "[8 maps]")


# ------------------------------------------------- 9. bases and sync


@contextlib.contextmanager
def launches_in():
    """The kernel launches made inside the block (a dict filled on
    exit), without resetting the counts of the phase around it."""
    from cause_tpu_torch import kernels

    before = dict(kernels.launches)
    out = {}
    yield out
    out.update({k: kernels.launches[k] - before[k] for k in before})


def bases_sync(torch, pairs, merged) -> dict:
    """Phase 9, step 1: ``sync_pair`` over phase 4's pairs (one device
    reweave a side), each side against phase 4's ``merged(i)``, the
    sides' ``content_digest``s equal; pair 0's round on the plain path
    with every kernel call checked; one ``sync_stream`` round over a
    socket pair; the B = 1 reweave's kernels and busy share. Returns
    ``check_recorded``'s per-kernel sums."""
    import socket
    import threading

    import cause_tpu_torch as ct
    from cause_tpu_torch import sync
    from cause_tpu_torch.weaver import torchw

    tag = "[9 bases] sync"
    fallbacks0 = torchw.pure_fallbacks
    ct.sync_pair(*pairs[-1])  # warm
    synced, times = [], []
    with launches_in() as counts:
        for a, b in pairs:
            out, ms = timed_ms(torch, lambda: ct.sync_pair(a, b))
            synced.append(out)
            times.append(ms)
    expect_launches(counts, {k: 2 * len(pairs) * v
                             for k, v in V5_LAUNCHES.items()}, tag)
    if torchw.pure_fallbacks != fallbacks0:
        fail(f"{tag}: a reweave went to the pure weaver")
    t0 = time.perf_counter()
    for i, (a2, b2) in enumerate(synced):
        if a2.ct.weave != merged[i] or b2.ct.weave != merged[i]:
            fail(f"{tag}: pair {i}'s synced weave differs from phase 4's "
                 f"merged({i})")
        if ct.content_digest(a2) != ct.content_digest(b2):
            fail(f"{tag}: pair {i}'s sides digest differently")
    check_ms = (time.perf_counter() - t0) * 1e3
    say(f"{tag}: {len(pairs)} sync_pair rounds on weaver='torch' pairs "
        f"(one device reweave a side): round p50 "
        f"{float(np.median(times)):.3f} ms, min {min(times):.3f}, max "
        f"{max(times):.3f} (host clock, synchronized); launches "
        f"{counts}; every side equals phase 4's merged(i) and the sides' "
        f"content_digests agree (checked in {check_ms:.0f} ms of host "
        f"time)")
    calls = []
    with plain_path(record=calls):
        pa, pb = ct.sync_pair(*pairs[0])
    if pa.ct.weave != merged[0] or pb.ct.weave != merged[0]:
        fail(f"{tag}: pair 0's round differs on the plain path")
    per = check_recorded(torch, calls, f"{tag} pair 0 round")

    # one round over a socket pair between two threads
    a, b = pairs[1]
    s1, s2 = socket.socketpair()
    out, errs = {}, {}

    def side(name, handle, sock):
        try:
            with sock, sock.makefile("rwb") as stream:
                out[name] = sync.sync_stream(handle, stream)
        except Exception as e:  # noqa: BLE001 - reported below
            errs[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=side, args=("a", a, s1)),
               threading.Thread(target=side, args=("b", b, s2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    torch.cuda.synchronize()
    st_ms = (time.perf_counter() - t0) * 1e3
    if errs or any(t.is_alive() for t in threads):
        fail(f"{tag}: the sync_stream round failed: {errs}")
    if out["a"].ct.weave != synced[1][0].ct.weave \
            or out["b"].ct.weave != synced[1][1].ct.weave:
        fail(f"{tag}: the sync_stream round differs from its sync_pair")
    say(f"{tag}: one sync_stream round over a socket pair (two threads, "
        f"pair 1): {st_ms:.3f} ms (host clock), both sides equal the "
        f"pair's sync_pair")

    # the B = 1 reweave of one direction: all its device kernels
    a, b = pairs[0]
    sh = sync.shadow(a, sync.delta_nodes(b, sync.version_vector(a)))

    def one():
        return a.merge_many([sh])

    one()
    with launches_in() as ours:
        _, wall = timed_ms(torch, one)
    n_k, dev_ms = device_kernels(torch, one)
    say(f"{tag}: one direction's reweave (B = 1, {len(a.ct.nodes)} + "
        f"{len(sh.ct.nodes)} nodes): {wall:.3f} ms (host clock), "
        f"{n_k:.0f} device kernels of which {sum(ours.values())} are the "
        f"port's ({ours}), {dev_ms:.3f} ms of device time (profile): "
        f"busy share {dev_ms / wall:.3f}")
    return per


def bases_quarantine(torch, pairs, res, merged) -> None:
    """Phase 9, step 2: a quarantined site in 2 of the pairs sends them
    to the per-pair merge; the rest dispatch as one batch; every
    ``merged(i)`` equals phase 4's; the next sync round with the
    quarantined replica takes the full bag and readmits it."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import sync
    from cause_tpu_torch.collections.clist import CausalList

    tag = "[9 bases] quarantine"
    q = pairs[0][0].ct.site_id
    # pair 1's first replica relabelled to the quarantined site (its
    # nodes, hence its merge, unchanged): the site stands in 2 pairs
    qpairs = list(pairs)
    qpairs[1] = (CausalList(pairs[1][0].ct.evolve(site_id=q)),
                 pairs[1][1])
    for _ in range(sync.QUARANTINE_AFTER):
        sync.note_reject(q)
    if not sync.is_quarantined(q):
        fail(f"{tag}: {sync.QUARANTINE_AFTER} rejects did not quarantine")
    with launches_in() as counts:
        rq, ms = timed_ms(torch, lambda: ct.merge_wave(qpairs))
    n = len(pairs)
    if rq.fallback != [0, 1] or rq.poisoned:
        fail(f"{tag}: fallback {rq.fallback}, poisoned {rq.poisoned}")
    if rq.digest_valid.tolist() != [False, False] + [True] * (n - 2):
        fail(f"{tag}: the device rows are not the other {n - 2} pairs")
    if not np.array_equal(rq.digest[2:], res.digest[2:]):
        fail(f"{tag}: the other pairs' digests differ from phase 4's")
    # one dispatch of the n - 2 rows, one device merge a quarantined pair
    expect_launches(counts, {k: 3 * v for k, v in V5_LAUNCHES.items()},
                    tag)
    for i in range(n):
        if rq.merged(i).ct.weave != merged[i]:
            fail(f"{tag}: merged({i}) differs from phase 4's")
    # the road back in: pair 0's next round goes to the full bag
    (a2, b2), s_ms = timed_ms(torch, lambda: ct.sync_pair(*pairs[0]))
    if sync.is_quarantined(q):
        fail(f"{tag}: the full-bag round did not readmit the site")
    if a2.ct.weave != merged[0] or b2.ct.weave != merged[0]:
        fail(f"{tag}: the full-bag round differs from phase 4's merge")
    sync.quarantine_reset()
    say(f"{tag}: site of pair 0 quarantined and standing in pairs 0 and "
        f"1: merge_wave {ms:.3f} ms (host clock), pairs [0, 1] to the "
        f"per-pair merge, the other {n - 2} in one dispatch (launches "
        f"{counts}: that dispatch and one device merge a quarantined "
        f"pair), every merged(i) equal to phase 4's; the next sync round "
        f"took the full bag ({s_ms:.3f} ms) and readmitted the site")


def bases_ladder(torch, pairs, res, cached, hs, tree_root) -> None:
    """Phase 9, step 3: the chaos ladder's seams on the card — a retried
    dispatch fault at the wave's seam, a session budget exhaustion (the
    wave runs full width) and a tree budget exhaustion (a level bounces
    to full width)."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import chaos

    tag = "[9 bases] ladder"

    def arm(site, mode):
        chaos.configure(plan={"seed": 9, "faults": [
            {"family": "dispatch", "site": site, "mode": mode, "at": [1]}]})

    arm("wave", "raise")
    with launches_in() as counts:
        r1, w_ms = timed_ms(torch, lambda: ct.merge_wave(pairs))
    inj = chaos.injected()
    chaos.reset()
    if [(r["site"], r["mode"]) for r in inj] != [("wave", "raise")]:
        fail(f"{tag}: injected {inj}")
    if not np.array_equal(r1.digest, res.digest) or r1.fallback \
            or not r1.digest_valid.all():
        fail(f"{tag}: the retried wave differs from phase 4's")
    # the fault fires before the dispatch: the retry is the one dispatch
    expect_launches(counts, V5_LAUNCHES, f"{tag} wave")

    sess = ct.FleetSession(cached)
    sess.wave()
    p1 = session_edit(cached, 1)
    sess.update(p1)
    sess.wave()
    p2 = session_edit(p1, 2)
    sess.update(p2)
    if sess._delta is None:
        fail(f"{tag}: no frontier before the exhausted session wave")
    arm("session", "exhaust")
    before = sess.last_rank
    d_full, s_ms = timed_ms(torch, sess.wave)
    inj = chaos.injected()
    chaos.reset()
    if [(r["site"], r["mode"]) for r in inj] != [("session", "exhaust")]:
        fail(f"{tag}: injected {inj}")
    if sess.last_rank is before:
        fail(f"{tag}: the exhausted session wave did not run full width")
    resident = sess.last_rank
    d_delta, d_ms = timed_ms(torch, sess.wave)
    if sess.last_rank is not resident:
        fail(f"{tag}: the next session wave did not ride the delta path")
    if not np.array_equal(d_full, d_delta) or not np.array_equal(
            d_full, ct.merge_wave(p2).digest):
        fail(f"{tag}: the exhausted wave's digests differ from the delta "
             f"wave's")

    arm("tree", "exhaust")
    (root, rep), t_ms = timed_ms(torch, lambda: ct.merge_tree_report(hs))
    inj = chaos.injected()
    chaos.reset()
    paths = [lv["path"] for lv in rep["levels"]]
    want = ["full", "full"] + ["delta"] * (len(paths) - 2)
    if paths != want or [r["site"] for r in inj] != ["tree"]:
        fail(f"{tag}: tree levels {paths} (expected {want}), injected "
             f"{inj}")
    if root.ct.weave != tree_root.ct.weave \
            or root.ct.nodes != tree_root.ct.nodes:
        fail(f"{tag}: the bounced tree's root differs from phase 7's")
    say(f"{tag}: a dispatch fault at the wave's seam, retried: merge_wave "
        f"{w_ms:.3f} ms, digests equal phase 4's, launches {counts}, one "
        f"record injected; a session budget exhaustion: that wave ran "
        f"full width ({s_ms:.3f} ms), the next rode the delta path "
        f"({d_ms:.3f} ms), digests equal; a tree budget exhaustion: "
        f"levels {paths} in {t_ms:.3f} ms (host clock), root equal to "
        f"phase 7's")


def base_replicas(weaver: str):
    """Phase 9, step 4's base: a root map holding a BASE_LIST-element
    list (written in transactions of 1,000), a set and a counter, made
    from a fixed uid seed (so a
    ``weaver="pure"`` twin gets the same uuids), forked into two
    replicas that each run BASE_TX transactions: an append to the list
    (every 8th a hide of the previous value), every 100th a set member,
    every 100th (another phase) a counter increment. The set's members
    and the counter's deltas are root-caused siblings, one segment each:
    kept few, they stay within the v5 rung's segment table (a quarter
    of the capacity, 16 at least), which a tree past it leaves for the
    pure weaver. Returns the two replicas after
    ``sync_base_pair``, replica A after ``undo`` and ``redo``, and the
    host time of the transactions."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import ids

    K = ct.K
    ids._rng.seed(20261017)
    cb = ct.transact(ct.base(weaver=weaver), [[None, None, {
        K("doc"): list(range(1000)), K("tags"): {"t"},
        K("votes"): ct.ccounter(1)}]])
    ids._rng.seed()
    root = ct.get_collection(cb)
    lu, su, cu = (root[K(k)].uuid for k in ("doc", "tags", "votes"))
    # the rest of the list in runs of 1,000: a node's tx index must fit
    # the device's PackSpec (13 bits), or the list leaves its domain
    for start in range(1000, BASE_LIST, 1000):
        tail = list(ct.get_collection(cb, lu))[-1][0]
        cb = ct.transact(cb, [[lu, tail, list(range(start, start + 1000))]])
    tail = list(ct.get_collection(cb, lu))[-1][0]
    t0 = time.perf_counter()
    reps = []
    for tag in ("A", "B"):
        r = ct.CausalBase(cb.cb.evolve(site_id=f"site{tag}".ljust(13, "_")))
        last = tail
        for i in range(BASE_TX):
            ts = r.cb.lamport_ts
            if i % 8 == 7:
                tx = [[lu, last, ct.hide]]
            else:
                tx = [[lu, last, 2 * i + (tag == "B")]]
            if i % 100 == 0:
                tx.append([su, None, {f"{tag}{i}"}])
            if i % 100 == 50:
                tx.append([cu, ct.root_id, 1])
            r = ct.transact(r, tx)
            if i % 8 != 7:
                last = (ts, r.cb.site_id, 0)
        reps.append(r)
    tx_ms = (time.perf_counter() - t0) * 1e3
    a, b = ct.sync_base_pair(*reps)
    return a, b, ct.redo(ct.undo(a)), tx_ms


def bases_base(torch) -> None:
    """Phase 9, step 4: a ``weaver="torch"`` base and its pure twin
    through the same transactions, ``sync_base_pair``, ``undo`` and
    ``redo``; ``dumps`` -> ``loads`` of both torch replicas reweaves
    every collection on the card; rendered values and per-collection
    ``content_digest``s equal the pure twin's."""
    import cause_tpu_torch as ct
    from cause_tpu_torch.weaver import torchw

    tag = "[9 bases] base"
    fallbacks0 = torchw.pure_fallbacks

    def digests(base):
        return {u: ct.content_digest(h)
                for u, h in base.cb.collections.items()}

    with launches_in() as sync_counts:
        (a, b, a_ur, tx_ms), t_ms = timed_ms(torch, lambda: base_replicas(
            "torch"))
    with launches_in() as load_counts:
        texts, dump_ms = timed_ms(torch, lambda: [ct.dumps(x)
                                                  for x in (a_ur, b)])
        loaded, load_ms = timed_ms(torch, lambda: [ct.loads(t)
                                                   for t in texts])
    t0 = time.perf_counter()
    pa, pb, pa_ur, p_tx_ms = base_replicas("pure")
    oracle_ms = (time.perf_counter() - t0) * 1e3
    if torchw.pure_fallbacks != fallbacks0:
        fail(f"{tag}: a reweave went to the pure weaver")
    if {h.ct.weaver for x in loaded for h in x.cb.collections.values()} \
            != {"torch"}:
        fail(f"{tag}: a loaded collection is not on the torch weaver")
    for name, got, want in (("A", a_ur, pa_ur), ("B", b, pb),
                            ("A loaded", loaded[0], pa_ur),
                            ("B loaded", loaded[1], pb)):
        if got.causal_to_edn() != want.causal_to_edn():
            fail(f"{tag}: replica {name} renders differently from the "
                 f"pure twin")
        if digests(got) != digests(want):
            fail(f"{tag}: replica {name}'s collections digest "
                 f"differently from the pure twin's")
    ea, eb = a.causal_to_edn(), b.causal_to_edn()
    if ea != eb:
        fail(f"{tag}: the synced replicas differ")
    # the sync: the list, the set and the counter, one reweave a side
    expect_launches(sync_counts, {k: 6 * v for k, v in
                                  V5_LAUNCHES.items()}, f"{tag} sync")
    # each load reweaves the list, the set and the counter on the card
    expect_launches(load_counts, {k: 6 * v for k, v in
                                  V5_LAUNCHES.items()}, f"{tag} loads")
    doc = ea[ct.K("doc")]
    say(f"{tag}: weaver='torch' base, root map of a {BASE_LIST}-element "
        f"list, a set and a counter; 2 replicas x {BASE_TX} transactions "
        f"({tx_ms:.0f} ms of host time), sync_base_pair, undo + redo on A: "
        f"{t_ms:.3f} ms (launches {sync_counts}); list {len(doc)} "
        f"values, set {len(ea[ct.K('tags')])} members, counter "
        f"{ea[ct.K('votes')]}; dumps {dump_ms:.3f} ms, loads {load_ms:.3f} "
        f"ms (every list-shaped collection reweaved on the card: launches "
        f"{load_counts}); renders and per-collection content_digests equal "
        f"the weaver='pure' twin's ({oracle_ms:.0f} ms of host time). Cut: "
        f"{BASE_TX} transactions a replica, not 1,000 (the pure twin's "
        f"replay and incremental sync)")


def bases_compaction(torch, pairs, merged) -> None:
    """Phase 9, step 5: ``gc.compact`` of a 10k-node ``weaver="torch"``
    list with a hidden tail; the compacted tree's device reweave against
    the pure weave of its nodes; a sync round with an uncompacted peer
    converges, on phase 4's nodes equal to phase 4's merge."""
    import cause_tpu_torch as ct

    tag = "[9 bases] compaction"
    a, b = pairs[2]
    visible = [n[0] for n in a]
    ah = a
    for nid in reversed(visible[-COMPACT_TAIL:]):
        ah = ah.append(nid, ct.hide)
    out, c_ms = timed_ms(torch, lambda: ct.compact(ah))
    st = ct.compact_stats(ah, out)
    if out is ah or st["dropped"] < 2 * COMPACT_TAIL:
        fail(f"{tag}: compaction dropped {st['dropped']} nodes")
    keep = out.ct.nodes
    # the pure weave of the compacted nodes: ah's weave (the pure
    # weaver's, spliced on the host) without the dropped tail
    if out.ct.weave != [n for n in ah.ct.weave if n[0] in keep]:
        fail(f"{tag}: the compacted tree's device reweave differs from "
             f"the pure weave of its nodes")
    if out.causal_to_edn() != ah.causal_to_edn():
        fail(f"{tag}: compaction changed the rendered list")
    (a2, b2), s_ms = timed_ms(torch, lambda: ct.sync_pair(out, b))
    if a2.ct.weave != b2.ct.weave:
        fail(f"{tag}: the sync round with the uncompacted peer diverged")
    full = ah.merge(b)
    if a2.ct.weave != [n for n in full.ct.weave if n[0] in a2.ct.nodes] \
            or a2.causal_to_edn() != full.causal_to_edn():
        fail(f"{tag}: the synced pair differs from the merge of the "
             f"uncompacted pair")
    p4 = {n[0] for n in merged[2]}
    if [n for n in a2.ct.weave if n[0] in p4] != \
            [n for n in merged[2] if n[0] in a2.ct.nodes]:
        fail(f"{tag}: on phase 4's nodes the synced pair differs from "
             f"phase 4's merge")
    say(f"{tag}: {len(ah.ct.nodes)}-node weaver='torch' list with its "
        f"last {COMPACT_TAIL} values hidden: compact {c_ms:.3f} ms (host "
        f"clock, one device reweave of the survivors), {st}; its weave "
        f"equals the pure weave of its nodes; sync_pair with the "
        f"uncompacted peer {s_ms:.3f} ms: both sides equal, the merge of "
        f"the uncompacted pair without the dropped nodes, and phase 4's "
        f"merge on its nodes")


def phase_bases(torch, pairs, res, cached, hs, tree_root) -> tuple:
    """Phase 9: bases, sync and compaction on the card (steps 1-5).
    Returns the phase's launch counts and ``check_recorded``'s sums."""
    from cause_tpu_torch import kernels

    t0 = time.perf_counter()
    merged = [res.merged(i).ct.weave for i in range(len(pairs))]
    say(f"[9 bases] phase 4's merged(i) for {len(pairs)} pairs: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms (host clock)")
    kernels.reset_launches()
    steps = {}
    per = {}
    for name, fn in (
            ("sync", lambda: per.update(bases_sync(torch, pairs, merged))),
            ("quarantine", lambda: bases_quarantine(torch, pairs, res,
                                                    merged)),
            ("ladder", lambda: bases_ladder(torch, pairs, res, cached, hs,
                                            tree_root)),
            ("base", lambda: bases_base(torch)),
            ("compaction", lambda: bases_compaction(torch, pairs, merged))):
        t = time.perf_counter()
        fn()
        steps[name] = time.perf_counter() - t
    counts = dict(kernels.launches)
    expect_launches(counts, tuple(V5_LAUNCHES), "[9 bases]")
    say("[9 bases] kernel sums over pair 0's round, one call a shape "
        "(CUDA events, mean of 10): " + "; ".join(
            f"{n} {v['ms']:.4f} ms, plain {v['plain_ms']:.4f}, bound "
            f"{v['bound_ms']:.6f}" for n, v in per.items()))
    say("[9 bases] steps: " + "; ".join(
        f"{name} {sec:.3f} s" for name, sec in steps.items())
        + f" (host clock); launches over the phase {counts}")
    return counts, per


# ------------------------------------------------------------ 10. serve


def serve_site(tag: str, i: int) -> str:
    """A fixed 13-character site id."""
    return f"s{tag}{i:0{12 - len(tag)}d}"



def serve_tenant(i: int):
    """Tenant ``i``: a fresh ``weaver="torch"`` list of SERVE_LIST values
    written in runs of SERVE_RUN (one transaction each, inside the
    PackSpec's tx bits), woven, as a replica pair of two sites with one
    divergent op each. A fresh clist per tenant: ``evolve()`` keeps the
    uuid, and the service keys tenants by it."""
    import cause_tpu_torch as ct
    from cause_tpu_torch.collections import clist as cl

    h = cl.CausalList(ct.clist(weaver="torch").ct.evolve(
        site_id=serve_site("T", i), uuid=f"serve-tenant-{i:04d}"))
    for k in range(SERVE_LIST // SERVE_RUN):
        h = h.extend([f"t{i}.{k}.{j}" for j in range(SERVE_RUN)])
    base = cl.CausalList(cl.weave(h.ct))
    base.ct.lanes.segments()
    a = cl.CausalList(base.ct.evolve(site_id=serve_site("A", i))).conj("A")
    b = cl.CausalList(base.ct.evolve(site_id=serve_site("B", i))).conj("B")
    return a, b, base.ct.weave[-1][0]


class ServeProducer:
    """One tenant's producer state on its client: two foreign sites
    whose deltas land on opposite sides of the pair (the service routes
    a foreign site by ``crc32(site) & 1``), each a chain of ops appended
    after its side's tail (as ``conj`` appends), with lamport stamps
    above every id the document holds, so every op is a lane append on
    its side and the pair stays inside the delta window's domain."""

    def __init__(self, i: int, tenant):
        import zlib

        a, b, _tail = tenant
        self.uuid = str(a.ct.uuid)
        self.sites = []
        j = 0
        while len(self.sites) < 2:
            st = f"c{i:03d}x{j:08d}"
            if zlib.crc32(st.encode()) & 1 == len(self.sites):
                self.sites.append(st)
            j += 1
        # each side's tail: its replica's divergent op, the newest id
        self.last = {st: max(h.ct.nodes)
                     for st, h in zip(self.sites, (a, b))}
        self.ts = max(n[0] for n in a.ct.nodes) + 1
        self.minted = 0

    def mint(self, site: str, n: int):
        ops = []
        for _ in range(n):
            self.ts += 1
            nid = (self.ts, site, 0)
            ops.append((nid, self.last[site], f"{site}.{self.ts}"))
            self.last[site] = nid
        self.minted += n
        return ops


def serve_offer(clients, owner, producers, rng, weights, rnd: int,
                burst: bool):
    """One round's offered load: SERVE_OFFERS zipf-hot draws (alpha 1.2)
    of a tenant, one of its two sites and 1-16 ops, queued on the
    tenant's client, plus one 200-op batch for the burst tenant; every
    client pumped until its outbound queue is empty (acked: journaled
    and queued in the service)."""
    for _ in range(SERVE_OFFERS):
        t = rng.choices(range(len(producers)), weights=weights)[0]
        p = producers[t]
        st = p.sites[rng.randrange(2)]
        if not clients[owner[t]].queue_ops(p.uuid, st,
                                           p.mint(st, rng.randint(1, 16))):
            fail(f"[10 serve] round {rnd}: the client shed an offer")
    if burst:
        p = producers[SERVE_BURST_TENANT]
        clients[owner[SERVE_BURST_TENANT]].queue_ops(
            p.uuid, p.sites[0], p.mint(p.sites[0], SERVE_BURST))
    deadline = time.monotonic() + 60.0
    for cl in clients:
        while cl.outbound_depth and time.monotonic() < deadline:
            cl.pump()
        if cl.outbound_depth:
            fail(f"[10 serve] round {rnd}: client {cl.client_id} could "
                 f"not ship its ops: {cl.status()}")


def serve_side_applies(entries) -> int:
    """The device reweaves a tick's apply step runs over the entries it
    drained: ``sync.apply_delta`` merges each touched side's coalesced
    delta into its ``weaver="torch"`` handle through one B = 1
    ``merge_many`` (6/1/1 launches), and every producer site here is
    foreign, so the service routes it to side ``crc32(site) & 1``."""
    import zlib

    return len({(e.uuid, zlib.crc32(e.site.encode()) & 1)
                for e in entries})


class ServeTicker:
    """Ticks a service as it ticks itself: ``tick()`` with its default
    drain, at most ``d_max`` ops a tick (``SyncService.run``), until the
    queue is empty. Records what each tick drained (the queue's
    ``drain``) and, when batched, how many tenants the scheduler sent
    to a full-width wave (its ``wave_fleet``), so every tick's launches
    can be held to 6/1/1 times its dispatches: bucket dispatches (or,
    unbatched, one wave a touched tenant), full-width fallbacks, side
    applies and two serde reweaves a restore."""

    def __init__(self, svc):
        self.svc = svc
        self.drained = []
        self.fallbacks = 0
        real_drain = svc.queue.drain

        def drain(*args, **kw):
            out = real_drain(*args, **kw)
            self.drained.append(out)
            return out

        svc.queue.drain = drain
        if svc.batched:
            sched = svc._scheduler
            real_wave = sched.wave_fleet

            def wave_fleet(sessions):
                out = real_wave(sessions)
                self.fallbacks += sched.last_fallbacks
                return out

            sched.wave_fleet = wave_fleet

    def until_empty(self, torch, tag: str) -> list:
        """Tick until the queue is empty; each tick's launches checked.
        Returns one dict a tick: its summary, host ms (synchronized),
        fallbacks, side applies, restores and launches."""
        svc = self.svc
        out = []
        while svc.queue.depth:
            r0, f0 = svc.residency.stats["restores"], self.fallbacks
            with launches_in() as counts:
                summary, ms = timed_ms(torch, svc.tick)
            t = {"summary": summary, "ms": ms,
                 "fallbacks": self.fallbacks - f0,
                 "applies": serve_side_applies(self.drained[-1]),
                 "restores": svc.residency.stats["restores"] - r0,
                 "counts": counts}
            waves = (summary["buckets"] + t["fallbacks"] if svc.batched
                     else summary["tenants"])
            # a restore decodes its two replicas, and serde reweaves a
            # weaver="torch" tree on the device: two B = 1 dispatches
            dispatches = waves + t["applies"] + 2 * t["restores"]
            expect_launches(counts, {n: dispatches * v for n, v
                                     in V5_LAUNCHES.items()},
                            f"{tag} tick ({summary['ops']} ops, "
                            f"{summary['buckets']} buckets, "
                            f"{t['fallbacks']} full-width fallbacks, "
                            f"{t['applies']} side applies, "
                            f"{t['restores']} restores)")
            out.append(t)
        return out


def serve_service(root: str, batched: bool):
    from cause_tpu_torch.serve import (IngestQueue, ResidencyManager,
                                       SyncService, WriteAheadLog)

    wal = WriteAheadLog(os.path.join(root, "wal"), fsync="batch")
    q = IngestQueue(max_ops=1 << 16, defer_frac=1.0, journal=wal)
    return SyncService(q, residency=ResidencyManager(
        capacity=SERVE_CAPACITY), checkpoint_dir=os.path.join(root, "ckpt"),
        d_max=SERVE_DMAX, batched=batched)


def serve_bucket_check(torch, dev, svc):
    """The largest resident bucket of the service, re-dispatched by the
    scheduler's own bucket code: once on the kernels (6/1/1 launches,
    the digests the tick gave), once on the plain path with every
    kernel call recorded and held against its plain version
    (``check_recorded``); then a one-tenant bucket's dispatch p50, the
    controller's dispatch floor. Returns the per-kernel sums, the
    bucket's shape and the floor."""
    from cause_tpu_torch.serve import BatchScheduler
    from cause_tpu_torch.weaver.arrays import next_pow2

    tag = "[10 serve] bucket"
    buckets = {w: u for w, u in svc.residency.buckets().items() if w}
    if not buckets:
        fail(f"{tag}: no resident tenant holds a delta frontier")
    wcap = max(buckets, key=lambda w: (len(buckets[w]), w))
    uuids = buckets[wcap]
    sessions = [svc.residency.get(u) for u in uuids]
    want = {u: s._last_digest.copy() for u, s in zip(uuids, sessions)}
    sched = BatchScheduler()

    def dispatch(group_uuids):
        group = [(u, svc.residency.get(u), None) for u in group_uuids]
        group = [(u, s, s.window_pack()) for u, s, _ in group]
        digests, fallback = {}, []
        sched._wave_bucket(wcap, group, digests, fallback, dev)
        if fallback:
            fail(f"{tag}: a row overflowed the bucket's window")
        return digests

    with launches_in() as counts:
        got = dispatch(uuids)
        torch.cuda.synchronize()
    expect_launches(counts, V5_LAUNCHES, f"{tag} w_cap={wcap}")
    for u in uuids:
        if not np.array_equal(got[u], want[u]):
            fail(f"{tag}: tenant {u}'s digest differs from its tick's")
    calls = []
    with plain_path(record=calls):
        got_plain = dispatch(uuids)
    for u in uuids:
        if not np.array_equal(got_plain[u], want[u]):
            fail(f"{tag}: tenant {u}'s plain-path digest differs")
    per = check_recorded(torch, calls, f"{tag} w_cap={wcap} x "
                                       f"{len(uuids)} tenants")
    one = uuids[:1]
    dispatch(one)  # warm
    times = [timed_ms(torch, lambda: dispatch(one))[1] for _ in range(10)]
    floor = float(np.median(times))
    say(f"{tag}: one-tenant bucket (w_cap={wcap}, 1 row padded to "
        f"{next_pow2(1)}) dispatch p50 "
        f"{floor:.3f} ms, min {min(times):.3f}, max {max(times):.3f} "
        f"(host clock, synchronized, 10 reps): the controller's dispatch "
        f"floor on this card")
    return per, (wcap, len(uuids)), floor


def serve_residency_cycles(torch, svc, uuids):
    """Evict/restore cycles with the residents at capacity: two disjoint
    groups of SERVE_CAPACITY tenants made resident in turn, three
    times; ``torch.cuda.memory_allocated()`` read with each group
    resident must not grow from one cycle to the next, and evicting
    every resident must hand its tensors back."""
    tag = "[10 serve] residency"
    groups = [uuids[:SERVE_CAPACITY], uuids[SERVE_CAPACITY:
                                            2 * SERVE_CAPACITY]]
    import gc

    mem = []
    t0 = time.perf_counter()
    r0, e0 = (svc.residency.stats["restores"],
              svc.residency.stats["evictions"])
    for _cycle in range(3):
        for g in groups:
            svc.residency.get_many(g)
            gc.collect()
            torch.cuda.synchronize()
            mem.append(torch.cuda.memory_allocated())
    wall = time.perf_counter() - t0
    first, last = mem[0::2], mem[1::2]
    if any(m > first[0] for m in first) or any(m > last[0] for m in last):
        fail(f"{tag}: memory_allocated grew across evict/restore cycles: "
             f"{mem}")
    for u in svc.residency.resident():
        svc.residency.evict(u)
    gc.collect()
    torch.cuda.synchronize()
    empty = torch.cuda.memory_allocated()
    if empty >= min(mem):
        fail(f"{tag}: evicting every resident released nothing "
             f"({empty} bytes allocated, {min(mem)} with residents)")
    say(f"{tag}: 3 cycles of two {SERVE_CAPACITY}-tenant groups "
        f"({svc.residency.stats['restores'] - r0} restores, "
        f"{svc.residency.stats['evictions'] - e0} evictions, "
        f"{wall:.3f} s host clock): memory_allocated with each group "
        f"resident {mem} bytes, flat; {empty} bytes with none resident")


def serve_oracle(svc, pairs, journal, uuids):
    """``materialize()`` of the given tenants against the pure weaver:
    the initial pair merged, then every journal record of the tenant
    applied, all on ``weaver="pure"``."""
    from cause_tpu_torch import serde, sync
    from cause_tpu_torch.collections.clist import CausalList

    for u in uuids:
        a, b = pairs[u]
        oracle = CausalList(a.ct.evolve(weaver="pure", lanes=None)).merge(
            CausalList(b.ct.evolve(weaver="pure", lanes=None)))
        for e in journal:
            if e["uuid"] == u:
                oracle = sync.apply_delta(
                    oracle, serde.decode_node_items(e["items"]))
        got = svc.materialize(u)
        if got.ct.weave != oracle.ct.weave or list(got) != list(oracle):
            fail(f"[10 serve] tenant {u} differs from the pure weaver's "
                 f"merge of its journal")


def phase_serve(torch, dev, card: str) -> tuple:
    """Phase 10: a served document fleet on the card. Returns the launch
    counts of the six rounds' ticks and the bucket dispatch's per-kernel
    sums."""
    import random
    import tempfile

    import cause_tpu_torch as ct
    from cause_tpu_torch import kernels
    from cause_tpu_torch.collections.clist import CausalList
    from cause_tpu_torch.net import NetClient, ReplicationServer
    from cause_tpu_torch.serve import SyncService, scrub
    from cause_tpu_torch.weaver import nativew

    tag = "[10 serve]"
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="serve-smoke-")
    root = tmp.name
    t0 = time.perf_counter()
    tenants = [serve_tenant(i) for i in range(SERVE_TENANTS)]
    t1 = time.perf_counter()
    svc = serve_service(os.path.join(root, "batched"), batched=True)
    uuids, pairs = [], {}
    with launches_in() as add_counts:
        for a, b, _tail in tenants:
            uuids.append(svc.add_tenant(a, b))
            pairs[uuids[-1]] = (a, b)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    expect_launches(add_counts, {k: SERVE_TENANTS * v
                                 for k, v in V5_LAUNCHES.items()},
                    f"{tag} add_tenant")
    say(f"{tag} {SERVE_TENANTS} tenants of {SERVE_LIST} elements built in "
        f"{t1 - t0:.3f} s; add_tenant (first full wave each, B = 1, "
        f"capacity {svc.residency.get(uuids[-1]).capacity}) "
        f"{(t2 - t1) * 1e3:.3f} ms in all (host clock); "
        f"{len(svc.residency.resident())} resident, "
        f"{len(svc.residency.spilled())} spilled")

    srv = ReplicationServer(svc).start()
    owner = {t: t // (SERVE_TENANTS // SERVE_CLIENTS)
             for t in range(SERVE_TENANTS)}
    clients = [NetClient("127.0.0.1", srv.port,
                         [uuids[t] for t in range(SERVE_TENANTS)
                          if owner[t] == c], client_id=f"smoke-{c}",
                         read_timeout_s=30.0)
               for c in range(SERVE_CLIENTS)]
    producers = [ServeProducer(i, tenants[i]) for i in range(SERVE_TENANTS)]
    rng = random.Random(SERVE_SEED)
    weights = [1.0 / ((i + 1) ** 1.2) for i in range(SERVE_TENANTS)]
    rng.shuffle(weights)  # the hot head is not tenant 0..k
    ticker = ServeTicker(svc)
    rounds = []
    boundaries = [svc.queue.journal._seq]
    kernels.reset_launches()
    try:
        for k in range(SERVE_ROUNDS):
            serve_offer(clients, owner, producers, rng, weights, k,
                        burst=(k == SERVE_BURST_ROUND))
            boundaries.append(svc.queue.journal._seq)
            ticks = ticker.until_empty(torch, f"{tag} round {k}")
            rounds.append(ticks)
            for t in ticks:
                sm = t["summary"]
                say(f"{tag} round {k}: tick of {sm['ops']} "
                    f"ops, {sm['tenants']} tenants, {sm['buckets']} bucket "
                    f"dispatches ({sm['batch_rows']} rows), "
                    f"{t['fallbacks']} full-width fallbacks, "
                    f"{t['applies']} B = 1 side applies, {t['restores']} "
                    f"restores; {t['ms']:.3f} ms (host clock, "
                    f"synchronized); launches {t['counts']}")
        # one more round of the same load under torch.profiler: the
        # device time its ticks hold (not among the timed ticks)
        serve_offer(clients, owner, producers, rng, weights, SERVE_ROUNDS,
                    burst=False)
        boundaries.append(svc.queue.journal._seq)
        prof_ticks = []
        (n_k, dev_ms), prof_ms = timed_ms(torch, lambda: device_kernels(
            torch, lambda: prof_ticks.extend(
                ticker.until_empty(torch, f"{tag} profiled round")),
            reps=1))
    finally:
        for cl in clients:
            cl.close()
        srv.stop()
    ticks = [t for r in rounds for t in r]
    tick_ms = [t["ms"] for t in ticks]
    tick_counts = {n: sum(t["counts"][n] for t in ticks)
                   for n in kernels.SOURCES}
    say(f"{tag} a profiled round: {len(prof_ticks)} ticks, {n_k:.0f} "
        f"device kernels, {dev_ms:.3f} ms of device time (profile) in "
        f"{prof_ms:.3f} ms (host clock, profiler on): busy share "
        f"{dev_ms / prof_ms:.4f}")
    if not sum(t["fallbacks"] for t in rounds[SERVE_BURST_ROUND]):
        fail(f"{tag}: the burst tenant's window never overflowed")
    if not any(t["summary"]["buckets"] > 1 for t in ticks):
        fail(f"{tag}: no tick dispatched more than one bucket")
    say(f"{tag} ticks (default drain, d_max = {SERVE_DMAX} ops): p50 "
        f"{float(np.median(tick_ms)):.3f} ms, p99 "
        f"{float(np.percentile(tick_ms, 99)):.3f} ms over {len(tick_ms)} "
        f"ticks of {SERVE_ROUNDS} rounds (host clock, synchronized): "
        f"{[round(t, 3) for t in tick_ms]}; ticks a round "
        f"{[len(r) for r in rounds]}; bucket dispatches a tick "
        f"{[t['summary']['buckets'] for t in ticks]}, touched tenants a "
        f"tick {[t['summary']['tenants'] for t in ticks]}, full-width "
        f"fallbacks a tick {[t['fallbacks'] for t in ticks]}, B = 1 side "
        f"applies a tick {[t['applies'] for t in ticks]}, restores a tick "
        f"{[t['restores'] for t in ticks]}; residency "
        f"{svc.residency.stats}")
    journal = list(svc.queue.journal.iter_from(0))
    if len(journal) != boundaries[-1]:
        fail(f"{tag}: the WAL replays {len(journal)} records of "
             f"{boundaries[-1]}")
    per, bucket_shape, floor = serve_bucket_check(torch, dev, svc)
    before = {u: svc.converged_digest(u) for u in uuids}

    # the same journal, round by round, through the per-tenant path
    svc_u = serve_service(os.path.join(root, "unbatched"), batched=False)
    for u in uuids:
        svc_u.add_tenant(*pairs[u])
    ticker_u = ServeTicker(svc_u)
    ticks_u = []
    for k in range(len(boundaries) - 1):
        for e in journal:
            if boundaries[k] < e["seq"] <= boundaries[k + 1]:
                adm = svc_u.queue.offer(e["uuid"], e["site"], e["items"])
                if not adm.admitted:
                    fail(f"{tag}: the per-tenant arm refused an op")
        ticks_u += ticker_u.until_empty(torch, f"{tag} per-tenant round {k}")
    for u in uuids:
        if svc_u.converged_digest(u) != before[u]:
            fail(f"{tag}: tenant {u}: batched and per-tenant ticks "
                 f"digest differently")
    counts_u = {n: sum(t["counts"][n] for t in ticks_u)
                for n in kernels.SOURCES}
    say(f"{tag} the journal replayed round by round through "
        f"batched=False: every tenant's digest equal ({len(ticks_u)} "
        f"ticks, {sum(t['summary']['tenants'] for t in ticks_u)} "
        f"per-tenant waves, launches {counts_u})")

    burst_uuid = uuids[SERVE_BURST_TENANT]
    sample = [burst_uuid] + rng.sample(
        [u for u in uuids if u != burst_uuid], SERVE_ORACLE - 1)
    t0 = time.perf_counter()
    serve_oracle(svc, pairs, journal, sample)
    say(f"{tag} materialize() of {len(sample)} tenants (the burst tenant "
        f"among them) equals the pure weaver's merge of its journal "
        f"({time.perf_counter() - t0:.3f} s host clock)")

    serve_residency_cycles(torch, svc, uuids)

    manifest, drain_ms = timed_ms(torch, svc.drain)
    svc2, restore_ms = timed_ms(torch, lambda: SyncService.restore(
        manifest))
    after = {u: svc2.converged_digest(u) for u in uuids}
    if after != before:
        bad = [u for u in uuids if after[u] != before[u]]
        fail(f"{tag}: drain -> restore changed digests of {bad}")
    say(f"{tag} drain {drain_ms:.3f} ms, restore ({SERVE_TENANTS} "
        f"sessions through the digest gate, journal replay above each "
        f"watermark) "
        f"{restore_ms:.3f} ms (host clock): every converged_digest "
        f"bit-identical")
    rep_w = scrub.scrub_wal(os.path.join(root, "batched", "wal"))
    rep_c = scrub.scrub_checkpoints(os.path.dirname(manifest))
    if not rep_w["clean"] or rep_c["errors"]:
        fail(f"{tag}: scrub found damage: wal {rep_w}, checkpoints "
             f"{rep_c}")
    say(f"{tag} scrub: WAL clean ({rep_w['records']} records, "
        f"{len(rep_w['segments'])} segments), checkpoints clean "
        f"({rep_c['packs_ok']} packs)")

    if not nativew.available():
        fail(f"{tag}: the native weaver did not build")
    a, b = pairs[uuids[0]]
    na = CausalList(a.ct.evolve(weaver="native", lanes=None))
    nb = CausalList(b.ct.evolve(weaver="native", lanes=None))
    t0 = time.perf_counter()
    nat = na.merge(nb)
    nat_ms = (time.perf_counter() - t0) * 1e3
    pure = CausalList(a.ct.evolve(weaver="pure", lanes=None)).merge(
        CausalList(b.ct.evolve(weaver="pure", lanes=None)))
    if nat.ct.weave != pure.ct.weave:
        fail(f"{tag}: the native merge differs from the pure merge")
    say(f"{tag} native weaver built; a {len(nat.ct.nodes)}-node merge "
        f"({nat_ms:.3f} ms host clock) equals the pure merge")
    ct.use_device(dev)
    svc2.close()
    svc_u.close()
    tmp.cleanup()
    say(f"{tag} bucket dispatch checked at w_cap={bucket_shape[0]} x "
        f"{bucket_shape[1]} tenants; one-tenant floor {floor:.3f} ms; "
        f"restore {restore_ms:.3f} ms; kernel sums over the bucket's "
        f"calls, one call a shape (CUDA events, mean of 10): "
        + kernel_sums_line(per)
        + f"; phase {time.perf_counter() - t_phase:.1f} s (host clock); "
        f"{card}")
    return tick_counts, per


# --------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile two north-star dispatches of each "
                         "pipeline (and of the delta and map waves) with "
                         "torch.profiler: top device ops, the device's "
                         "busy share, Chrome traces in DIR")
    ap.add_argument("--phases", action="store_true",
                    help="also split K2's and K4's time at the north star "
                         "between load/store, scans and sorts, in both "
                         "forms, from builds stamped with clock64()")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this smoke runs only on the card",
              flush=True)
        return 2

    import cause_tpu_torch as ct
    from cause_tpu_torch import benchgen, kernels
    from cause_tpu_torch.collections.clist import CausalList
    from cause_tpu_torch.parallel.mesh import replica_digest
    from cause_tpu_torch.weaver import torchw
    from cause_tpu_torch.weaver.arrays import next_pow2

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    card = gpu_name_power()
    say(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # ------------------------------------------------ 1. build
    t0 = time.perf_counter()
    kernels.build_all(verbose=True)
    say(f"[1 build] {len(kernels.SOURCES)} kernels built in "
        f"{time.perf_counter() - t0:.3f} s (host clock)")

    # ------------------------------------------------ north-star inputs
    cap, n_base, n_div = CAP, N_BASE, N_DIV
    t0 = time.perf_counter()
    batch = benchgen.batched_pair_lanes(PAIRS, n_base, n_div, cap,
                                        hide_every=8)
    v5 = benchgen.batched_v5_inputs(batch, cap)
    u_max = next_pow2(benchgen.v5_token_budget(v5))
    t1 = time.perf_counter()
    lanes = benchgen.lanes_from_numpy(v5, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    args5 = [lanes[k] for k in benchgen.LANE_KEYS5]
    B, N = lanes["hi"].shape
    S = lanes["sg_len"].shape[1]
    say(f"[marshal] B={B} N={N} S={S} u_max=k_max={u_max}: numpy "
        f"{t1 - t0:.3f} s, to card {t2 - t1:.3f} s (host clock)")

    def dispatch():
        return ct.batched_weave_digest(*args5, u_max=u_max, k_max=u_max,
                                       device=dev)

    def dispatch_f():
        r, v, _c, ov = ct.batched_merge_weave_v5f(
            *args5, u_max=u_max, k_max=u_max, device=dev)
        return r, v, replica_digest(args5[0], args5[1], r, v), ov

    # the plain paths on the card: the references, and the kernel inputs
    calls, calls_f = [], []
    with plain_path(record=calls):
        ref = dispatch()
    with plain_path(record=calls_f):
        ref_f = dispatch_f()
    torch.cuda.synchronize()
    for tag, r in (("v5", ref), ("v5f", ref_f)):
        if bool(r[3].any()):
            fail(f"north star overflowed on the plain {tag} path: rows "
                 f"{torch.nonzero(r[3]).flatten()[:8].tolist()}")

    # ------------------------------------------------ 2. kernels
    per = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                  "library_ms": 0.0, "err": 0}
           for name in kernels.SOURCES}
    # B1-B3 are timed at the v5 dispatch's calls, K1/K2/K4 at the v5f
    # dispatch's; v5f's own B1-B3 calls are checked, not timed
    timed = [(n, o, kw, True, "v5") for n, o, kw in calls] + [
        (n, o, kw, n in FUSED, "v5f") for n, o, kw in calls_f]
    sites = iter(SORT_SITES)
    for name, ops, kw, time_it, path in timed:
        rec = check_call(torch, name, ops, kw, time_it=time_it)
        shapes = "x".join(str(d) for d in ops[0].shape)
        line = (f"[2 kernels] {path} {name} {shapes} n_ops={len(ops)} "
                f"{kw or ''}: max_abs_err {rec['err']}")
        if time_it:
            line += (f" ms {rec['ms']:.4f} plain_ms {rec['plain_ms']:.4f}"
                     f" library_ms {rec.get('library_ms', float('nan')):.4f}"
                     f" bound_ms {rec['bound_ms']:.4f}")
            for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
                per[name][k] += rec.get(k, 0.0)
        say(line)
        if name in FUSED and time_it:
            P, Kp = fused_widths(name, ops, kw)
            say(f"[2 kernels] {name} launch at P={P} Kp={Kp}: ms "
                f"{rec['ms']:.4f} (CUDA events, mean of 10 calls), bound ms "
                f"{rec['bound_ms']:.4f}, CTAs per SM "
                f"{ctas_per_sm(name, P, Kp)} (the network form at this "
                f"width: {ctas_per_sm(name, P, Kp, network=True)})")
        if name == "k1_sort_redirect" and time_it:
            k1_widths()
        if name == "fphase" and time_it:
            say(f"[2 kernels] fphase launch at B={ops[4].shape[0]} "
                f"N={ops[4].shape[1]} U={ops[0].shape[1]} "
                f"S={ops[2].shape[1]}: ms {rec['ms']:.4f} (CUDA events, mean "
                f"of 10 calls), bound ms {rec['bound_ms']:.4f}, CTAs per SM "
                f"{ctas_per_sm(name)} (one CTA a row)")
        if name == "sort" and path == "v5":
            bits = radix_bits(torch, ops, kw.get("num_keys", 1))
            say(f"[2 kernels] B1 site {next(sites, '?')} {shapes} "
                f"n_ops={len(ops)} keys={kw.get('num_keys', 1)}: kernel "
                f"{rec['ms']:.4f} ms, torch.sort {rec['library_ms']:.4f} "
                f"ms, ratio {rec['ms'] / rec['library_ms']:.3f}; composite "
                f"bits per row {min(bits)}-{max(bits)} "
                f"({-(-max(bits) // 8)} passes at most)")
        per[name]["err"] = max(per[name]["err"], rec["err"])
        if rec["err"]:
            fail(f"{name} kernel disagrees with its plain version")
    if args.phases:
        phase_split(torch, calls_f)
    s5 = per["sort"]
    say(f"[2 kernels] B1 over the v5 sites: kernel {s5['ms']:.4f} ms, "
        f"torch.sort {s5['library_ms']:.4f} ms, ratio "
        f"{s5['ms'] / s5['library_ms']:.3f}")
    del calls, calls_f, timed
    edges = [(n, t, o, kw, False) for n, t, o, kw in edge_cases(torch, dev)]
    for name, tag, ops, kw, flags_only in edges + fused_edge_cases(torch,
                                                                    dev):
        rec = check_call(torch, name, ops, kw, time_it=False,
                         flags_only=flags_only)
        say(f"[2 kernels] edge {name} {tag}: max_abs_err {rec['err']}"
            + (f" (flags; all outputs {rec['all_err']})" if flags_only
               else ""))
        per[name]["err"] = max(per[name]["err"], rec["err"])
        if rec["err"]:
            fail(f"{name} kernel disagrees with its plain version ({tag})")
    del edges

    # ------------------------------------------------ 3. north star
    kernels.reset_launches()
    out = dispatch()
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    say(f"[3 north star] launches in one dispatch: {counts}")
    want = {name: V5_LAUNCHES.get(name, 0) for name in kernels.SOURCES}
    if counts != want:
        fail(f"north-star launches {counts}, expected {want}")
    names = ("rank", "visible", "digest", "overflow")
    for nm, g, w in zip(names, out, ref):
        if not torch.equal(g, w):
            fail(f"north star {nm} differs from the plain path")
    if bool(out[3].any()):
        fail("north star overflowed")
    main_launches = counts

    def p50(fn):
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return float(np.median(times)), times

    dispatch()  # warm
    k_p50, k_all = p50(dispatch)
    with plain_path():
        dispatch()
        p_p50, p_all = p50(dispatch)
    say(f"[3 north star] bit-identical to the plain path (rank, visible, "
        f"digest, overflow); dispatch p50 {k_p50:.3f} ms with the kernels, "
        f"{p_p50:.3f} ms plain (host clock, synchronized, {REPS} "
        f"reps: {[round(t, 3) for t in k_all]} / "
        f"{[round(t, 3) for t in p_all]})")
    if args.profile:
        profile_dispatch(torch, dispatch, args.profile, k_p50, tag="v5")
        dig_ms = cuda_ms(torch, lambda: replica_digest(
            args5[0], args5[1], out[0], out[1]))
        n_k, dev_ms = device_kernels(torch, lambda: replica_digest(
            args5[0], args5[1], out[0], out[1]))
        say(f"[profile v5] the digest (int32 replica_digest) at B={B} "
            f"N={N}: {dig_ms:.4f} ms (CUDA events, mean of 10), {n_k:.0f} "
            f"device kernels, {dev_ms:.4f} ms of device time (profile)")
    del ref

    # ------------------------------------------------ 3f. north star v5f
    kernels.reset_launches()
    out_f = dispatch_f()
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    say(f"[3f north star v5f] launches in one dispatch: {counts}")
    want = {name: V5F_LAUNCHES.get(name, 0) for name in kernels.SOURCES}
    if counts != want:
        fail(f"v5f north-star launches {counts}, expected {want}")
    fused_launches = counts
    for nm, g, w, w5 in zip(names, out_f, ref_f, out):
        if not torch.equal(g, w):
            fail(f"v5f north star {nm} differs from the plain v5f path")
        if not torch.equal(g, w5):
            fail(f"v5f north star {nm} differs from the v5 kernel path")
    if bool(out_f[3].any()):
        fail("v5f north star overflowed")
    dispatch_f()  # warm
    f_p50, f_all = p50(dispatch_f)
    with plain_path():
        dispatch_f()
        pf_p50, pf_all = p50(dispatch_f)
    say(f"[3f north star v5f] bit-identical to the plain v5f path and to "
        f"the v5 kernel path (rank, visible, digest, overflow); dispatch "
        f"p50 {f_p50:.3f} ms with the kernels (v5: {k_p50:.3f} ms), "
        f"{pf_p50:.3f} ms plain (host clock, synchronized, {REPS} reps: "
        f"{[round(t, 3) for t in f_all]} / "
        f"{[round(t, 3) for t in pf_all]})")
    if args.profile:
        profile_dispatch(torch, dispatch_f, args.profile, f_p50, tag="v5f")
    del out, out_f, ref_f, lanes, args5

    # ------------------------------------------------ 4. api
    t0 = time.perf_counter()
    hs = benchgen.tree_fleet_handles(REPLICAS, n_base, n_div,
                                     hide_every=8)
    pairs = [(hs[2 * i], hs[2 * i + 1]) for i in range(len(hs) // 2)]
    t1 = time.perf_counter()
    ct.use_device(dev)
    fallbacks0 = torchw.pure_fallbacks
    kernels.reset_launches()
    t2 = time.perf_counter()
    res = ct.merge_wave(pairs)
    t3 = time.perf_counter()
    merged0 = pairs[0][0].merge(pairs[0][1])  # weaver="torch" merge
    counts = dict(kernels.launches)
    say(f"[4 api] {len(hs)} replicas built in {t1 - t0:.3f} s; merge_wave "
        f"over {len(pairs)} pairs {(t3 - t2) * 1e3:.3f} ms (host clock, "
        f"first call); launches in merge_wave + one merge: {counts}")
    for name in V5_LAUNCHES:
        if counts[name] < 2:  # the wave's dispatch and the merge's
            fail(f"api path launched {name} {counts[name]} times")
    if torchw.pure_fallbacks != fallbacks0:
        fail("a tree went to the pure weaver on the api path")
    if res.fallback or res.poisoned or not res.digest_valid.all():
        fail(f"wave fell back {res.fallback} / poisoned {res.poisoned}")
    with plain_path():
        res_plain = ct.merge_wave(pairs)
    if not np.array_equal(res.digest, res_plain.digest):
        fail("merge_wave digests differ from the plain path")
    checked = sorted({0, len(pairs) // 2, len(pairs) - 1})
    pures = {}
    for i in checked:
        a, b = pairs[i]
        pure = pures[i] = CausalList(a.ct.evolve(weaver="pure")).merge(
            CausalList(b.ct.evolve(weaver="pure")))
        got = res.merged(i)
        if got.ct.weave != pure.ct.weave or list(got) != list(pure):
            fail(f"merge_wave pair {i} differs from the pure merge")
        if i == 0 and (merged0.ct.weave != pure.ct.weave
                       or list(merged0) != list(pure)):
            fail("weaver='torch' merge differs from the pure merge")
    say(f"[4 api] merged(i) for pairs {checked} and the torch merge of "
        f"pair 0 equal the pure merge ({len(pure.ct.weave)} nodes); "
        f"digests equal the plain path; 0 trees to the pure weaver")

    knob = os.environ.get("BENCH_KERNEL")
    os.environ["BENCH_KERNEL"] = "v5f"
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        res_f = ct.merge_wave(pairs)
        t1 = time.perf_counter()
        counts = dict(kernels.launches)
    finally:
        if knob is None:
            del os.environ["BENCH_KERNEL"]
        else:
            os.environ["BENCH_KERNEL"] = knob
    say(f"[4 api] BENCH_KERNEL=v5f: merge_wave over {len(pairs)} pairs "
        f"{(t1 - t0) * 1e3:.3f} ms (host clock); launches: {counts}")
    if res_f.kernel != "v5f":
        fail(f"merge_wave under BENCH_KERNEL=v5f ran {res_f.kernel!r}")
    for name in V5F_LAUNCHES:
        if counts[name] < 1:
            fail(f"v5f api path launched {name} {counts[name]} times")
    if res_f.fallback or res_f.poisoned or not res_f.digest_valid.all():
        fail(f"v5f wave fell back {res_f.fallback} / poisoned "
             f"{res_f.poisoned}")
    if not np.array_equal(res_f.digest, res.digest):
        fail("merge_wave digests under v5f differ from the v5 wave's")
    for i in checked:
        got = res_f.merged(i)
        if got.ct.weave != pures[i].ct.weave or list(got) != list(pures[i]):
            fail(f"v5f merge_wave pair {i} differs from the pure merge")
    say(f"[4 api] BENCH_KERNEL=v5f: kernel 'v5f', digests equal the v5 "
        f"wave's, merged(i) for pairs {checked} equal the pure merge")

    # ------------------------------------------------ 5. delta
    phase_delta(torch, dev, k_p50, p50, args.profile)

    # ------------------------------------------------ 6. session
    cached = phase_session(torch, pairs, res.digest, p50)

    # ------------------------------------------------ 7. tree
    tree_root = phase_tree(torch, hs)

    # ------------------------------------------------ 8. maps
    phase_maps(torch, dev, p50, card, args.profile)

    # ------------------------------------------------ 9. bases and sync
    bases_counts, bases_per = phase_bases(torch, pairs, res, cached, hs,
                                          tree_root)

    # ------------------------------------------------ 10. serve
    del res, cached, hs, tree_root, pairs
    serve_counts, serve_per = phase_serve(torch, dev, card)

    # ------------------------------------------------ result
    recs = []
    for name in kernels.SOURCES:
        p = per[name]
        recs.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name],
            "launches": (fused_launches if name in FUSED
                         else main_launches)[name],
            "max_abs_err": p["err"],
            "ms": p["ms"], "plain_ms": p["plain_ms"],
            "bound_ms": p["bound_ms"], "bound_by": "bytes",
            "library_ms": p["library_ms"] if name == "sort" else None,
            # phase 9's run (bases, sync, compaction) and its calls'
            # kernel time at their own shapes
            "bases_sync_launches": bases_counts[name],
            "bases_sync_ms": bases_per.get(name, {}).get("ms"),
            # phase 10's ticks of six rounds, and one bucket dispatch's
            # calls at their own shapes
            "serve_launches": serve_counts[name],
            "serve_ms": serve_per.get(name, {}).get("ms"),
            "serve_plain_ms": serve_per.get(name, {}).get("plain_ms"),
            "serve_bound_ms": serve_per.get(name, {}).get("bound_ms"),
            "serve_library_ms": serve_per.get(name, {}).get("library_ms"),
        })
    say(f"total {time.perf_counter() - t_start:.1f} s (host clock)")
    print(card, flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
