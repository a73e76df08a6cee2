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
network transport, the telemetry over those paths and shipped over the
wire to a collector, the older kernel generations (v1-v4) with the
device weaver's ladder, the benchmark CLI and the sharded steps,
wave and map routes over a one-rank NCCL mesh, the north-star benchmark
(``cause_tpu_torch.bench``) and its modes, the differential soak
(``cause_tpu_torch.soak``) and the fleet bench
(``cause_tpu_torch.fleet_bench``), the serving plane's acceptance
instruments (``cause_tpu_torch.serve_soak``, ``batched_smoke``,
``obs_off_pin``), the wire and ship plane's
(``cause_tpu_torch.journey_smoke``, ``net_soak``, ``ship_smoke``,
``ship_soak``), and checks that
the kernels really
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
   INT32_MIN beside INT32_MAX, rows of equal keys, and the wide form:
   B = 1 and 3 at n = 16,385, 65,536 and 131,072, 1,024 x 40,960, nine
   keys at P = 8192, 1, 2, 3 and 9 keys of every kind (rows of INT32_MAX
   only, full-range keys), each line naming its form; for B2 a chain and a
   star at K = 4096 and 8192, two interleaved chains, B = 1, rows too
   wide for shared memory, and B = 1-3 at K = 16,384-131,072 (the
   widest row form and the split form's widths, 4-32 blocks of
   splitters); for
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
   starts the next tile, S = 1, B = 1, and at B = 1-3 rows over several
   chunks of the chunk form, with a token on every chunk's first lane, a
   segment over two chunk edges and a kill across each), kernel against
   plain version; every B2 and B3 call also in each of its forms (row
   and split, row and chunk), each against the plain version, its line
   naming the form its rule gives (the north star's must be the row
   forms) and, where timed, each form's time;
   kernel, plain and, for the sort, library (``torch.sort``) times, with
   one line per B1 site (its keys' composite bit count, kernel against
   ``torch.sort``), one per K1/K2/K4 launch (ms, bound ms, CTAs per SM
   of its form and of the network form at its width) and one for B3
   (ms, bound ms, CTAs per SM); ``--phases`` adds K1's, K2's and K4's
   split between load/store, scans and sorts in both forms; ``--tiles``
   instead times B1's wide form at each tile width at the main path's
   wide shapes and exits; ``--forms`` instead times B2's and B3's forms
   at the north star's, the tree's and the fleet row's widths over B =
   1-256 (the crossovers of ``euler.walk_form`` and
   ``fphase.fphase_form``) and exits;
2a. A1 at the benchmark's shapes: the segment order of each cell's
   first batch (``pairs_full``, ``pairs_random``: 1,024 documents;
   ``fleet_converge``: its one row), inputs from the benchmark's own
   generator and marshal, B1's sort of the segments, then A1 against
   the plain chain (exact), with the kernel's, the plain chain's and
   B1's times (CUDA events), the bound (the contract,
   ``segorder.a1_contract``, at 3.35 TB/s) and the launches; ``--a1``
   runs only phases 1 and 2a and exits;
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
   up to B1's wide form at 131,072 lanes); the root equals
   ``merge_many`` of the same handles; ``merge_all`` launches exactly
   the tree's kernels (not ``merge_many``'s) and gives the same root;
8. maps: a fleet of 128 map replica pairs built as
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

11. telemetry: the port's ``obs`` on the card. Each path runs with
   telemetry off and then on, and must launch the same kernels the same
   number of times with bit-identical outputs: the API wave (v5, then
   v5f) over phase 4's 32 pairs, a ``FleetSession`` over them (a full
   wave, a round the reference also runs full, a delta round) and its
   ``converge()`` (the merge tree over the 64 replicas), and one
   offered round of phase 10's served fleet (32 tenants, capacity 16,
   its default drain) under a 1 ms lag SLO. With telemetry on: every
   ``wave.cost``'s dispatches against the B3 launches they ran (the
   reference's count: kernel + digest, delta + splice, one a tree level
   or a bucket); ``wave.digest`` and ``divergence`` against the digests
   (the API pairs diverge by construction; the tree's root level and
   every tenant wave agree, no incident); no op pending after
   ``converge()`` and after the served rounds; one ``live.alert`` per
   excursion of each rule; the controller's ``T_batch`` moving
   (``serve.control``), each tick's ``wave_dispatches`` above 0 where it
   dispatched a bucket; one ``devprof.program`` per dispatch identity,
   each with its dispatch's 6/1/1 (or v5f's) launches and the CUDA
   allocator's statistics; the memory gauge equal to
   ``memory_allocated``; the phase spans at the north star: one
   dispatch (kernel and digest) with telemetry on records ``v5.A`` ...
   ``v5.F`` and ``replica.digest`` once each, each with its ``dev_us``
   (CUDA events), and their sum within 25% of the same dispatch timed
   whole by CUDA events with telemetry off, in turns with it, a call of
   each a rep, so that both see the same host; the overhead on the wave
   and on the tick; the JSONL sidecar holding every record.
12. the wire: one offered round of phase 10's served fleet (32 tenants,
   capacity 16, ``d_max`` 64, 8 ``NetClient``s on the loopback
   ``ReplicationServer``, the zipf-hot offers and the 200-op burst, one
   heartbeat a client after the ticks), three times: telemetry off;
   telemetry on with ``CAUSE_TPU_OBS_SHIP`` naming a ``CollectorServer``
   in a process of its own (``chip_smoke.py --collector DIR``, started
   and stopped by the smoke); and on again under the chaos engine's ship
   faults (``dup`` and ``reorder``). The three runs launch the same
   kernels (B1, B2 and B3 among them) with the same ticks and converged
   digests. Each shipped run is held to exact accounting: the exporter
   ends with nothing dropped or unshipped, and the collector accepted
   each record once, missed none, and archived exactly the serving
   process's sidecar from the uplink's ``ship.attach`` on. In the
   collector's stream: every client's ``net.connect`` and the server's
   ``net.hello``, heartbeats on both sides, the ``net.admitted_ops``
   counter equal to the ops admitted, the ``net.connections`` gauge,
   nacks and sheds as counted, and one journey a queued batch linked
   from ``mint`` through ``send`` and ``recv`` to the tick's ``wave``,
   its tenant's ``wave.digest`` agreeing. ``python -m cause_tpu_torch.obs
   watch --collector HOST:PORT --once --json`` in a subprocess exits 0
   with the serve, net and ship sections and no alert but the lag burn;
   ``/metrics`` of ``watch --serve-port`` carries the ship, net and serve
   families. Prints the tick p50 and p99 without and with the uplink,
   the records and bytes shipped and the emit-to-admit lag.

13. the older generations: the north-star batch through the v1, v2, v3,
   v4 and v4w merge kernels (``torchw``, ``torchw3``, ``torchw4``) at
   ``pair_run_budget``: each dispatch's launches (3, 3 and 2 B1 sorts;
   v4 and v4w 2 B1 and one B2), 0 overflowed rows, order, rank,
   visibility and conflict bit-identical across the five (v1 the oracle)
   and each to its plain path with every kernel call held against its
   plain version and timed once a shape (B1's sites with P and form,
   ``torch.sort`` beside it), each generation's ``merge_wave_scalar``
   p50 of 3; the ladder: ``weaver="torch"`` handles of a 10,000-node
   list whose cursor jumps every 3 ops and of a 1,000-member set with
   every third member discarded (v1: one B1 sort), and of 10 pastes of
   1,000 whose deleted ends are undeleted later (v5 overflows its
   tokens, then v4), reweaved and merged with a twin, each equal to the
   pure weaver's with ``pure_fallbacks`` unchanged; config 6's own map
   wave through ``merge_map_wave(pairs, "v4")`` (2 B1, one B2), digests
   and every ``merged(i)`` equal to the v5 route's, bit-identical to its
   plain path; ``matrix_sort`` on v4's run-sort rows against B1.
14. the benchmark CLI: ``python -m cause_tpu_torch.benchmarks`` in a
   subprocess at its defaults (exit 0, one JSON record a line with the
   reference's keys, configs 1-4 under ``pure`` and ``native`` or its
   skip record, config 1's bulk and lazy rows, config 5 ``torch-v4``,
   config 6 ``torch-v5`` and ``torch-v4``); config 5 in-process at the
   north star through v5 and v4 (launches of each step: 6/1/1 and 2/1/0;
   every step's ``[checksum, overflowed]`` equal to the plain path's on
   the card, 0 overflowed rows, every kernel call of the plain step held
   against its plain version and timed), its reported ms beside phase
   3's and phase 13's p50s; ``--profile`` on config 5 (v4, and v5),
   whose torch.profiler traces name B1 and B2 (and B3).
15. the sharded path: ``make_mesh()`` on the card (world 1, NCCL; the
   group's start and its first collective timed); the north-star batch
   through ``sharded_merge_weave`` (v1 at k_max = 0, v2 and v3 at
   ``pair_run_budget``), ``sharded_merge_weave_v4`` and
   ``sharded_merge_weave_v5`` (v5 and v5f at phase 3's u_max): each
   step's launches equal to its unsharded dispatch's (3, 3 and 2 B1
   sorts; v4 2 B1 and one B2; v5 6/1/1; v5f 2/1/1 and K1, K2, K4), its
   rows and totals bit-identical to that dispatch and its digests to
   the v5 dispatch's, 0 overflowed rows and conflicts, bit-identical to
   its plain path with every kernel call held against its plain version
   and timed once a shape, and the p50 of 3 sharded steps beside 3
   unsharded dispatches, in turns; ``merge_wave(pairs, mesh)`` over phase
   4's 32 pairs under ``BENCH_KERNEL`` v5 and v5f (the unsharded wave's
   launches and digests, no fallback, every ``merged(i)`` equal to
   ``a.merge(b)``; v5w refused); both sharded map routes on config 6's
   map wave (64 pairs) equal to the batched routes; ``entry()``'s v4
   merge on the card equal to the CPU's; ``dryrun_multichip(4,
   device="cpu")`` in a subprocess over gloo ranks, and
   ``dryrun_multichip(1)`` over one NCCL rank on the card.
16. the north-star benchmark: ``cause_tpu_torch.bench.measure("cuda")``
   in this process at the north star, uncut, through v5 and then
   ``BENCH_KERNEL=v5f``: the artifact (kernel, platform ``cuda``, the
   card, the amortized p50 over its bursts, ``vs_target``), its
   single-wave p50 within 0.5-2x phase 3's (3f's) dispatch p50, the
   launches exactly 6/1/1 (v5f's six kernels) times the waves it ran
   (a warm wave, 3 timed singles, 3 bursts of 8), every wave's
   ``[checksum, overflowed]`` equal to a plain-path wave on the card and
   v5f's to v5's, the host's sync points in one wave (PyTorch's sync
   debug mode); a drift probe of phase 3's batch through the same
   scalar program, run after phase 3 and again here, then after a full
   collection and after the allocator's cache is emptied (20 waves one at a
   time: wall, host queueing, card span on CUDA events, the process's
   CPU share, the card's clock, power and temperature, a launch's and a
   Python loop's time); then, each a subprocess with
   telemetry on: ``python -m cause_tpu_torch.bench`` (its ledger row
   under ``gpu``), ``BENCH_DIV_SWEEP=10,500`` at full size (every
   level's digests agree), ``BENCH_TREE=16`` at 10,000 nodes (cut from
   64; root bit-identical to the flat fold in ``tree_rounds(16)``
   rounds), ``BENCH_LAG=64 BENCH_LIVE=1`` (no op pending), and
   ``python -m cause_tpu_torch.api_bench --wave 128 --lazy`` (no
   overflowed row, no pair off the card).
17. the soak and the fleet bench: ``cause_tpu_torch.soak.ROUNDS`` over
   seeds 0-119 in this process on the card (every kind 20 times, each
   round's own checks against the pure weaver; B1-B3 and K1, K2, K4 all
   launched; ``memory_reserved`` before and after), the same rounds on
   the plain path with every kernel call recorded and held against its
   plain version, each distinct shape timed once; beside the soup, in
   subprocesses, ``python -m cause_tpu_torch.soak --minutes 0.25
   --obs-out`` (exit 0, ``soak.done``'s rounds, a ``soak`` ledger row)
   and the chaos plan of ``tests/test_chaos.py:761-776`` through
   ``--chaos`` at doc 30 and 10,000 (exit 0, its 6 injections over four
   families, bit-identical
   convergence, no divergence incident, nothing quarantined, a ``chaos``
   ledger row); ``fleet_bench``'s v5 and v4 kernel levels at the full
   configuration (1,024 replicas of 10,001 nodes as one row of
   10,485,760 lanes: the overflow ladder, a warm and 3 timed steps), the
   last step's outputs bit-identical to the plain path on the card at the
   same row and budget, each kernel call of it held against its plain
   version and timed against its bound (and B1 against ``torch.sort``,
   B2 and B3 in each form they have: the fleet row takes the split and
   chunk forms; B2's split-form sublists counted, the longest and the
   mean), then its API level (``merge_many`` of 64 replicas of 10,000 +
   32 nodes); its three JSON lines with ``card``.
18. the serving plane's acceptance instruments: (a) in this process,
   ``serve_soak._mk_fleet`` at phase 10's served size (32 tenants of
   10,000 elements, capacity 16, ``d_max`` 64) and 4 of the soak's
   closed-loop calibration rounds (``serve_soak._calib_round``, seed 18)
   on the kernels (B1, B2 and B3 launched, K1, K2, K4 not), then the
   same rounds in a second service over the same pairs on the plain
   path with every kernel call recorded and held against its plain
   version (one call a kernel, row count and width class timed): the
   same admissions and every tenant's ``converged_digest`` equal;
   ``batched_smoke.one_tick`` (12 tenants) on the kernels and on the
   plain path (every call checked), each with the smoke's gates (2
   buckets, 2 dispatches in the tick, 0 fallbacks, every tenant agreed
   in the tick, batched digests equal to the unbatched arm's) and the
   two runs' digests equal; ``python -m cause_tpu_torch.obs_off_pin
   --check``; beside it, in subprocesses, (b) the reference CI's serve
   smoke and (c) its disk smoke (24 s, the committed disk plan) through
   ``python -m cause_tpu_torch.serve_soak``, each held to that CI
   step's checks (``obs watch --once``, ``obs ledger --check`` and, for
   the disk arm, ``python -m cause_tpu_torch.serve scrub``), and (d)
   the overload run at phase 10's size (``--rate-mult 2 --chaos crash
   --gate-dispatch``, 10 s, one warm calibration round): exit 0
   (both crashes survived, every shed evidenced, the dispatch collapse
   held, every tenant equal to the journal oracle), its numbers and the
   B1-B3 launches of its timed window beside the costmodel's
   dispatches.
19. the wire and ship plane's acceptance instruments: first, alone,
   the reference CI's journey smoke through ``python -m
   cause_tpu_torch.journey_smoke`` (a server on the card, a host-only
   client interpreter; ``obs journey --worst 3`` over the two streams
   with CI's three lines, the row's asserts, ``obs ledger --check``);
   then, (a) in this process, ``net_soak._mk_tenants`` at phase 10's
   served size (32 tenants of 10,000 elements) and a drive over a
   loopback ``ReplicationServer``: ``net_soak._frame_bench`` and 4
   rounds of one ``ClientDriver`` batch a client (seed 13, pumped from
   this thread), each round ticked until drained, on the kernels (B1,
   B2 and B3 launched) and again in a second service over the same
   pairs on the plain path with every kernel call recorded and held
   against its plain version (one call a kernel, row count and width
   class timed): equal admissions and ticks, every tenant's
   ``converged_digest`` equal, the two journals' batches equal, and
   both services' documents equal to ``net_soak._journal_oracle``;
   beside it, in subprocesses, (b) the reference CI's net smoke
   (``net_soak --seconds 8 --seed 13 --chaos
   measurements/net_plan_r13.json``, CI's Python block on its row and
   stream, ``obs watch --once`` with a ``net:`` line, ``obs ledger
   --check``, every planned fault fired), its ship smoke (the row's
   asserts, ``ledger --check``) and ``ship_soak`` at its defaults
   (exit 0, or a miss of its 1% overhead gate alone printed as a
   finding with its numbers), and (c) the net soak at the served size
   (32 clients, 10,000 elements, 2 host-only client interpreters, the
   committed plan): exit 0 (the journal oracle, every planned fault
   detected, the journey gate), CI's net checks, every planned fault
   fired, the B1-B3 launches of its run; the frame round trip,
   partition and crash MTTR, the journey's mint->converged ms, the
   ship soak's overhead, ``memory_reserved`` and the card's
   ``memory.used`` with the subprocesses beside.

Phases 5-19 each reset or read the launch counts around their runs
(phases 10-12 tick by tick) and read them after: a phase that did
not launch B1, B2 and B3 fails.

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
# phase 8's map fleet: pairs (cut from 256 to keep the smoke's time once
# phase 17 came: about 36 s less on an H100, PERF.md section 4), keys,
# writes a key in the base, writes a side
MAP_PAIRS, MAP_KEYS, MAP_WRITES, MAP_EDITS = 128, 1024, 4, 64
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
# phase 11's queue-only served rounds, off then on (cut from 2 to keep
# the smoke near 450 s once phase 12 came)
TELEMETRY_SERVE_ROUNDS = 1
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
    "seg_order": "none: the XLA glue of cause_tpu/weaver/jaxw5.py phase A",
}
SOURCE = {
    "sort": "cause_tpu_torch/csrc/sort.cu",
    "euler_walk": "cause_tpu_torch/csrc/euler_walk.cu",
    "fphase": "cause_tpu_torch/csrc/fphase.cu",
    "k1_sort_redirect": "cause_tpu_torch/csrc/befuse_k1.cu",
    "k2_runs": "cause_tpu_torch/csrc/befuse_k2.cu",
    "k4_rank_kills": "cause_tpu_torch/csrc/befuse_k4.cu",
    "seg_order": "cause_tpu_torch/csrc/seg_order.cu",
}
FUSED = ("k1_sort_redirect", "k2_runs", "k4_rank_kills")
# the forms of B1, B2 and B3 (bitonic.b1_form, euler.walk_form,
# fphase.fphase_form pick one; B1's by call, bitonic.b1_forms)
FORMS = {"euler_walk": ("row", "split"), "fphase": ("row", "chunk"),
         "sort": ("radix", "network", "cluster", "wide")}
# the forms the rules give the north star's B1, B2 and B3 calls
NORTH_STAR_FORMS = {"euler_walk": "row", "fphase": "row", "sort": "radix"}
# launches of one dispatch of each pipeline
V5_LAUNCHES = {"sort": 6, "euler_walk": 1, "fphase": 1, "seg_order": 1}
V5F_LAUNCHES = {"sort": 2, "euler_walk": 1, "fphase": 1,
                "k1_sort_redirect": 1, "k2_runs": 1, "k4_rank_kills": 1,
                "seg_order": 1}
# the v5 dispatch's sort sites, in call order (torchw5.py)
SORT_SITES = ("A segments", "C tokens", "E siblings", "E successor",
              "F lanes", "F coverage")
I32_MIN = int(np.iinfo(np.int32).min)


def fail(msg: str) -> None:
    """Print the failure on both streams (a caller that keeps only the
    end of stderr still reads why) and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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
    from cause_tpu_torch.weaver import (befuse, bitonic, euler, fphase,
                                        segorder)

    return {
        "sort": bitonic.sort_pairs_plain,
        "euler_walk": euler.euler_walk_plain,
        "fphase": fphase.fphase_expand_plain,
        "k1_sort_redirect": befuse.k1_sort_redirect_plain,
        "k2_runs": befuse.k2_runs_plain,
        "k4_rank_kills": befuse.k4_rank_kills_plain,
        "seg_order": segorder.seg_order_plain,
    }


@contextlib.contextmanager
def plain_path(record=None):
    """Route the kernel sites of the v5 pipeline (``torchw5``: sort, phase
    A's segment order, walk, expansion; v5f runs phase A there too), of
    the v5f pipeline (``torchw5f``: sort, walk, expansion and K1, K2,
    K4) and of the older generations (``torchw``, ``torchw3``:
    sort; ``torchw4``: sort, walk) to their plain PyTorch versions (the
    reference on the card), optionally recording every call's inputs.
    Restores the kernel wrappers on exit."""
    from cause_tpu_torch.weaver import (torchw, torchw3, torchw4, torchw5,
                                        torchw5f)

    plain = plain_fns()
    attr = {"sort": "sort_pairs", "euler_walk": "euler_walk",
            "fphase": "fphase_expand", "seg_order": "seg_order"}
    sites = [(torchw5, attr[n], n) for n in attr]
    sites += [(torchw5f, attr.get(n, n), n) for n in plain
              if n != "seg_order"]
    sites += [(torchw, "sort_pairs", "sort"), (torchw3, "sort_pairs", "sort"),
              (torchw4, "sort_pairs", "sort"),
              (torchw4, "euler_walk", "euler_walk")]
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
    from cause_tpu_torch.weaver import (befuse, bitonic, euler, fphase,
                                        segorder)

    kern = {
        "sort": bitonic.sort_pairs_cuda,
        "euler_walk": euler.euler_walk_cuda,
        "fphase": fphase.fphase_expand_cuda,
        "k1_sort_redirect": befuse.k1_sort_redirect_cuda,
        "k2_runs": befuse.k2_runs_cuda,
        "k4_rank_kills": befuse.k4_rank_kills_cuda,
        "seg_order": segorder.seg_order_cuda,
    }
    return kern[name], plain_fns()[name]


def call_bytes(ops, outs) -> int:
    """Bytes the function must move: each input read once, each output
    written once."""
    return sum(x.numel() * x.element_size() for x in tuple(ops) + outs)


def library_fn(torch, ops, num_keys):
    """One ``torch.sort`` call that orders the same rows: stable, on the
    first key, packed with the second into int64 for two-key sites; for
    more keys, each key's dense rank over the call (order-preserving)
    packed into one int64, or None when the ranks need more than 63
    bits. The payloads are not moved (the yardstick is the sort alone)."""
    if num_keys == 1:
        key = ops[0]
    elif num_keys == 2:
        key = (ops[0].long() << 32) + (ops[1].long() + (1 << 31))
    else:
        key = torch.zeros(ops[0].shape, dtype=torch.int64,
                          device=ops[0].device)
        bits = 0
        for k in reversed(ops[:num_keys]):  # least significant first
            vals, inv = torch.unique(k, sorted=True, return_inverse=True)
            key += inv.long() << bits
            bits += max(1, (len(vals) - 1).bit_length())
        if bits > 63:
            return None
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


def rule_form(torch, name, ops, kw=None) -> str:
    """The form B1, B2 or B3 takes on this call by its module's rule
    (``bitonic.b1_form``, ``euler.walk_form``, ``fphase.fphase_form``),
    as the wrapper picks it."""
    from cause_tpu_torch.weaver import bitonic, euler, fphase

    index = ops[0].device.index
    if name == "sort":
        return bitonic.b1_form(ops[0].shape[1], (kw or {}).get("num_keys", 1),
                               bitonic.b1_limits(index or 0))
    if name == "euler_walk":
        return euler.walk_form(ops[0].shape[1], euler._smem_limit(index))
    B, N = ops[4].shape
    return fphase.fphase_form(B, N, fphase._sms(index))


def forms_of(torch, name, ops, kw=None) -> tuple:
    """The forms B1, B2 or B3 has at this call's shape: B1's by
    ``bitonic.b1_forms``, B2's row form only where a row fits in shared
    memory."""
    from cause_tpu_torch.weaver import bitonic, euler

    index = ops[0].device.index
    if name == "sort":
        return bitonic.b1_forms(ops[0].shape[1], (kw or {}).get("num_keys", 1),
                                bitonic.b1_limits(index or 0))
    if name == "euler_walk" and euler.walk_form(
            ops[0].shape[1], euler._smem_limit(index)) != "row":
        return ("split",)
    return FORMS[name]


def forms_text(rec) -> str:
    """A B2 or B3 call's form by the rule, and each form's time when
    timed; empty for the other kernels."""
    if "form" not in rec:
        return ""
    times = rec.get("form_ms")
    return f" form {rec['form']}" + (" (" + ", ".join(
        f"{f} {ms:.4f} ms" for f, ms in times.items()) + ")" if times else "")


def check_call(torch, name, ops, kw, time_it: bool, flags_only=False,
               all_forms=True):
    """Kernel against plain version on one call; ``flags_only`` (an
    overflowing row, whose other outputs the reference leaves
    unspecified) holds only the ``scal`` rows of the fused kernels to
    the plain version, after a launch that must not fault. B1, B2 and B3
    run in the form their rule gives and, with ``all_forms``, again in
    each form they have at the shape (``forms_of``), each held against
    the plain version and, when timed, timed."""
    kern, plain = kernel_fns(name)
    if name == "sort":
        run = lambda f, **f_kw: f(ops, **kw, **f_kw)  # noqa: E731
    else:
        run = lambda f, **f_kw: f(*ops, **kw, **f_kw)  # noqa: E731
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
    if name in FORMS:
        rec["form"] = rule_form(torch, name, ops, kw)
    if name in FORMS and all_forms:
        for form in forms_of(torch, name, ops, kw):
            g = run(kern, form=form)
            torch.cuda.synchronize()
            g = g if isinstance(g, tuple) else (g,)
            rec["err"] = max(rec["err"], max_err(torch, g, want))
    if time_it:
        rec["ms"] = cuda_ms(torch, lambda: run(kern))
        rec["plain_ms"] = cuda_ms(torch, lambda: run(plain))
        if name == "sort":
            lib = library_fn(torch, ops, kw.get("num_keys", 1))
            rec["library_ms"] = cuda_ms(torch, lib) if lib else float("nan")
        if name in FORMS and all_forms:
            rec["form_ms"] = {
                form: cuda_ms(torch, lambda: run(kern, form=form))
                for form in forms_of(torch, name, ops, kw)}
        if name == "seg_order":  # of the lanes, the four a segment reads
            from cause_tpu_torch.weaver import segorder

            rec["bound_ms"] = bound_ms(segorder.a1_contract(ops, want))
        else:
            rec["bound_ms"] = bound_ms(call_bytes(ops, want))
    return rec


def edge_cases(torch, dev):
    """Inputs the north star does not reach: ragged widths, negative and
    duplicate keys with int32-max sentinels, rows too wide for shared
    memory (B1's wide form, the fused kernels' global-scratch paths),
    unreached forest runs."""
    from cause_tpu_torch.weaver import befuse, euler, fphase

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
        elif kind == "all_max":   # every key INT32_MAX: zero passes
            x = np.full((B, n), I32_MAX)
        else:                     # a sibling key: 15 bits of parent
            x = rng.integers(0, 2 * 8192 + 2, size=(B, n))
        return x.astype(np.int32)

    cases = []

    def sort_case(B, n, n_ops, nk, kind):
        ops = tuple(T(sort_key(kind, B, n)) if i < nk else
                    T(full(B, n).astype(np.int32)) for i in range(n_ops))
        cases.append(("sort", f"B={B} n={n} ops={n_ops} keys={nk} {kind} "
                      f"({b1_form(ops, nk)})", ops, {"num_keys": nk}))

    for B, n, n_ops, nk, kind in (
            (3, 1, 1, 1, "narrow"), (4, 300, 3, 2, "narrow"),
            (4, 1000, 9, 3, "narrow"), (2, 16384, 9, 3, "narrow"),
            (8, 4096, 7, 2, "narrow"), (2, 40, 9, 9, "narrow"),
            (4, 3000, 2, 1, "narrow"), (5, 256, 1, 1, "narrow"),
            (3, 200, 3, 2, "narrow"), (2, 8192, 3, 2, "sibling"),
            (2, 6000, 4, 2, "full"), (4, 4096, 3, 2, "full"),
            (4, 1000, 2, 1, "extremes"), (3, 4096, 3, 2, "equal"),
            (2, 2048, 2, 1, "equal")):
        sort_case(B, n, n_ops, nk, kind)

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

    # the last five at B = 1-3 at the row form's widest row and past it
    # (the split form's rows, over 4-32 blocks of 256 splitters)
    for shape, B, K in (("chain", 2, 4096), ("star", 2, 4096),
                        ("two chains", 2, 4096), ("chain", 1, 8192),
                        ("star", 1, 8192), ("chain", 1, 16384),
                        ("two chains", 2, 20000), ("star", 3, 40000),
                        ("two chains", 1, 131072), ("chain", 3, 65537)):
        cases.append(("euler_walk", f"{shape} B={B} K={K}",
                      shaped(shape, B, K), {}))
    for B, K, n_valid in ((4, 64, 40), (2, 16384, 12000), (3, 300, 300),
                          (2, 32768, 30000), (1, 4096, 1),
                          (1, 70000, 65000), (3, 24577, 24577)):
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
            (1, 20480, 4096, 512, "random"),
            # across the chunk form's edges (chunks of 4 tiles), B = 1-3
            (1, 12388, 300, 8, "chunk edges"),
            (2, 12389, 300, 8, "chunk edges"),
            (3, 32768, 600, 8, "chunk edges"),
            (1, 131072, 20000, 3000, "random"),
            (3, 40961, 8000, 900, "random"),
            (2, 8192, 2048, 100, "random")):
        chunk = (fphase.F_CHUNK_TILES * fphase.F_TILE
                 if kind == "chunk edges" else fphase.F_TILE)
        ops = fphase_inputs(rng, B, N, U, S, kind, chunk)
        if kind in ("tile-edge kill", "chunk edges") and \
                not tile_edge_killed(torch, ops, chunk):
            fail(f"B3 edge case: no {kind} lane is killed by its next")
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
    # B1 past 8,192 lanes (the cluster form): B = 1 and 3, the v1
    # sort-join's 1,024 x 40,960, nine keys at P = 8192, every key kind
    for B, n, n_ops, nk, kind in (
            (1, 16385, 3, 1, "narrow"), (3, 16385, 4, 2, "full"),
            (1, 16385, 9, 9, "extremes"), (3, 16385, 3, 3, "equal"),
            (1, 65536, 3, 1, "all_max"), (3, 65536, 5, 3, "full"),
            (1, 65536, 3, 2, "sibling"), (3, 65536, 9, 9, "narrow"),
            (1, 131072, 2, 1, "extremes"), (3, 131072, 4, 2, "narrow"),
            (1, 131072, 4, 3, "full"), (3, 131072, 3, 2, "all_max"),
            (3, 8192, 9, 9, "full"), (1024, 40960, 3, 2, "full"),
            (1024, 40960, 3, 1, "narrow")):
        sort_case(B, n, n_ops, nk, kind)
    # the cluster form at its edges: one lane past a CTA (8,193: two
    # CTAs of 4,096 lanes, the second of one lane), 16,385 and 65,536
    # (the most CTAs of 4,096) and 131,072 (the most of 8,192), B = 1 and
    # 3, nine keys at P = 8192, every key kind; then the wide form past
    # the cluster's reach, B = 1
    for B, n, n_ops, nk, kind in (
            (1, 8193, 3, 1, "narrow"), (3, 8193, 4, 2, "extremes"),
            (1, 8193, 9, 9, "all_max"), (3, 8193, 3, 2, "sibling"),
            (1, 16385, 5, 2, "all_max"), (3, 16385, 7, 2, "sibling"),
            (1, 65536, 4, 2, "extremes"), (3, 65536, 3, 1, "equal"),
            (1, 131072, 9, 9, "narrow"), (3, 131072, 5, 2, "full"),
            (1, 131072, 3, 1, "equal"), (3, 131072, 4, 3, "sibling"),
            (1, 8192, 9, 9, "extremes"), (3, 8192, 9, 9, "all_max"),
            (1, 8000, 9, 9, "sibling"),
            (1, 131073, 3, 2, "narrow"), (1, 131073, 9, 9, "extremes"),
            (1, 262144, 5, 2, "full"), (1, 262144, 3, 1, "all_max"),
            (1, 262144, 4, 3, "sibling"), (1, 1048577, 4, 2, "narrow"),
            (1, 1048577, 3, 1, "extremes"), (1, 1048577, 2, 1, "equal")):
        sort_case(B, n, n_ops, nk, kind)
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
    tiles take their width ``tile`` ("chunk edges": the chunk form's
    chunk of ``tile`` lanes: a token on every chunk's first lane, a
    segment over the first two chunk edges, and the lane before each of
    those edges visible but for a tombstone on the chunk's first lane)."""
    if kind == "chunk edges" and (N < 3 * tile + 3 or S < 2
                                  or U < -(-N // tile)):
        raise ValueError("chunk edges: N >= 3 chunks + 3, S >= 2 and a "
                         "token a chunk")
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
        elif kind == "chunk edges":
            starts = np.arange(0, N, tile)
            rest = np.setdiff1d(np.arange(N), starts)
            k = int(rng.integers(0, min(U - len(starts), len(rest)) + 1))
            lanes = np.sort(np.r_[starts, rng.choice(rest, size=k,
                                                     replace=False)])
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
        elif kind == "chunk edges":  # over two chunk edges, then short
            segs = np.array([[tile - 5, 2 * tile + 7],
                             [3 * tile - 3, min(3 * tile + 2, N)]])
        else:
            cuts = np.sort(rng.choice(np.arange(1, N),
                                      size=2 * min(S, N // 4),
                                      replace=False)).reshape(-1, 2)
            segs = cuts[rng.random(len(cuts)) < 0.6]
        segs = segs[:S]
        cs[r, :len(segs)], ce[r, :len(segs)] = segs[:, 0], segs[:, 1]
    if kind in ("tile-edge kill", "chunk edges"):
        # a tile's (chunk's) last lane, visible but for the tombstone
        # after it in its segment (an ordinal no other lane has)
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
        return any(k in name for k in ("sort_rows_", "euler_walk_",
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


# ``--tiles``: the wide B1 calls of the main path, as (B, n, operands,
# keys): the tree's upper levels (phase 7), the stage ladder's one-row
# calls (phase 13), the map dispatch's sites A and F (phase 8) and the
# older generations' id sort, sort-join and child sort (phases 13-15),
# with B = 16 and 32 beside the tree's 8 at 16,384 lanes
TILE_SHAPES = (
    (1, 16384, 2, 1), (1, 16384, 3, 2), (1, 16384, 4, 3), (1, 16384, 5, 2),
    (1, 131072, 2, 1), (1, 131072, 3, 1), (1, 131072, 3, 2),
    (1, 131072, 7, 2), (2, 65536, 3, 2), (2, 65536, 7, 2),
    (4, 32768, 3, 2), (4, 32768, 7, 2), (8, 16384, 2, 1), (8, 16384, 3, 2),
    (8, 16384, 7, 2), (16, 16384, 3, 2), (32, 16384, 3, 2),
    (256, 10384, 2, 1), (256, 10384, 3, 2), (1024, 20480, 7, 2),
    (1024, 20480, 4, 3), (1024, 40960, 3, 2))
# shapes of the main path's calls that the rule sends to the network form
# (P < 256, or three keys), which the cluster form can also take (rows,
# lanes, operands, keys): the wave's sites A, C, E and F at 1,024 rows,
# the tree's and the soup's rows, the ladder's three-key child sort
NETWORK_SHAPES = (
    (1024, 16, 3, 2), (1024, 16, 2, 1), (1024, 64, 7, 2), (1024, 64, 3, 2),
    (1024, 64, 3, 1), (1024, 64, 2, 1), (64, 128, 3, 2), (8, 128, 3, 2),
    (1, 128, 4, 3), (1, 128, 7, 2), (1, 2048, 4, 3))
# the B1 calls ``--tiles`` profiles launch by launch: (label, generation,
# index of the call among the generation's sorts)
PROFILED_SORTS = (("v4 id sort, fleet row", "v4 fleet", 0),
                  ("v5 site C, fleet row", "v5 fleet", 1),
                  ("v1 sort-join, north star", "v1 north star", 1))


def b1_real_calls(torch, dev) -> dict:
    """The B1 calls of one step of the fleet row (``fleet_bench``'s v4
    and v5 rows at ``FLEET``, through the overflow ladder) and of v1's
    north-star dispatch (1,024 pairs), each recorded once in call order:
    {generation: [(ops, num_keys), ...]}. Every call launches the
    kernel; the recorder keeps a copy of the inputs of the first call of
    each shape, operand count and key count."""
    from cause_tpu_torch import benchgen, fleet_bench
    from cause_tpu_torch.weaver import torchw, torchw4, torchw5

    out = {}

    def recorder(gen, real):
        def call(ops, num_keys=1):
            calls = out.setdefault(gen, [])
            key = (tuple(ops[0].shape), len(ops), num_keys)
            if key not in {(tuple(o[0].shape), len(o), k) for o, k in calls}:
                calls.append((tuple(x.clone() for x in ops), num_keys))
            return real(ops, num_keys)
        return call

    runs = (("v4 fleet", torchw4,
             lambda: fleet_bench.kernel_level(**FLEET, device=dev)),
            ("v5 fleet", torchw5,
             lambda: fleet_bench.kernel_level_v5(**FLEET, device=dev)))
    for gen, mod, run in runs:
        real = mod.sort_pairs
        mod.sort_pairs = recorder(gen, real)
        try:
            run()
        finally:
            mod.sort_pairs = real
    batch = benchgen.batched_pair_lanes(PAIRS, N_BASE, N_DIV, CAP,
                                        hide_every=8)
    a1 = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(
        dev, dtype=torch.bool if k == "valid" else torch.int32)
        for k in benchgen.LANE_KEYS]
    real = torchw.sort_pairs
    torchw.sort_pairs = recorder("v1 north star", real)
    try:
        torchw.batched_merge_weave(*a1, device=dev)
    finally:
        torchw.sort_pairs = real
    torch.cuda.synchronize()
    return out


def b1_launch_profile(torch, label: str, ops, nk: int, reps: int = 3):
    """Every device launch of one B1 call (memsets included) under
    torch.profiler, in order, with its device ms (mean of ``reps``
    calls after one warm call), printed one line a call."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from cause_tpu_torch.weaver import bitonic

    bitonic.sort_pairs_cuda(ops, nk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            bitonic.sort_pairs_cuda(ops, nk)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            evs = sorted((e for e in json.load(f)["traceEvents"]
                          if e.get("cat") in ("kernel", "gpu_memset")),
                         key=lambda e: e["ts"])
    per = len(evs) // reps
    rows = []
    for i in range(per):
        name = evs[i]["name"].split("(")[0].replace("void ", "")
        name = name.split("<")[0] + ("<...>" if "<" in name else "")
        ms = sum(evs[i + r * per]["dur"] for r in range(reps)) / reps / 1e3
        rows.append((name, ms))
    shape = "x".join(map(str, ops[0].shape))
    say(f"[tiles profile] {label} {shape} n_ops={len(ops)} keys={nk}: "
        f"{per} launches, device {sum(ms for _, ms in rows):.4f} ms: "
        + ", ".join(f"{n} {ms:.4f}" for n, ms in rows)
        + f" (torch.profiler, mean of {reps} calls)")


def b1_variants(n: int, nk: int, limits) -> list:
    """Every (form, lanes a CTA) B1 can run rows of ``n`` lanes and
    ``nk`` keys in on this card: the radix and network forms where they
    take the row, the cluster form at each CTA width whose cluster the
    card co-schedules."""
    from cause_tpu_torch.weaver import bitonic

    out = []
    for form in bitonic.b1_forms(n, nk, limits):
        if form == "cluster":
            out += [(form, lanes) for lanes, most in limits.clusters
                    if -(-n // lanes) <= min(most, bitonic.CLUSTER_MAX)]
        else:
            out.append((form, 0))
    return out


CLUSTER_PHASES = ("ranges and plan", "loads", "ranking", "counts",
                  "barrier 1", "offsets", "stage and stores", "barrier 2",
                  "gather")


def cluster_clocks(torch, dev, real) -> None:
    """``--tiles``: where the cluster form's time goes, from a build of
    ``sort.cu`` with -DCAUSE_CLUSTER_CLOCKS (thread 0's clock64() cycles
    between the kernel's marks, summed over its CTAs): v1's sort-join at
    the north star and synthetic rows of the tree's and the ladder's
    shapes, at both CTA widths, each share of the cycles printed."""
    import ctypes
    import subprocess as sp

    from cause_tpu_torch import kernels
    from cause_tpu_torch.weaver import bitonic

    so = kernels.BUILD / "libsort-clocks.so"
    out = sp.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS,
                  "-DCAUSE_CLUSTER_CLOCKS", "-o", str(so),
                  str(kernels.CSRC / kernels.SOURCES["sort"])],
                 capture_output=True, text=True)
    if out.returncode:
        fail(f"nvcc sort.cu -DCAUSE_CLUSTER_CLOCKS: {out.stdout[-3000:]}")
    lib, rule_lib = kernels.load(so), kernels.library("sort")
    rng = np.random.default_rng(20261018)
    calls = [("v1 sort-join", *real["v1 north star"][1])]
    for B, n in ((1, 16384), (8, 16384), (256, 10384), (1, 131072)):
        ops = tuple(torch.from_numpy(rng.integers(0, 2 * n, size=(B, n))
                                     .astype(np.int32)).to(dev)
                    for _ in range(2)) + (
            torch.arange(n, dtype=torch.int32, device=dev)
            .expand(B, n).contiguous(),)
        calls.append(("synthetic", ops, 2))
    cycles = (ctypes.c_ulonglong * len(CLUSTER_PHASES))()
    kernels._LIBS["sort"] = lib
    try:
        for label, ops, nk in calls:
            for lanes in bitonic.CLUSTER_LANES:
                if -(-ops[0].shape[1] // lanes) > bitonic.CLUSTER_MAX:
                    continue
                run = lambda: bitonic.sort_pairs_cuda(  # noqa: E731
                    ops, nk, form="cluster", lanes=lanes)
                run()
                torch.cuda.synchronize()
                kernels.check(lib.cause_cluster_cycles_take(cycles), "clocks")
                ms = cuda_ms(torch, run, warm=0)
                kernels.check(lib.cause_cluster_cycles_take(cycles), "clocks")
                total = sum(cycles) or 1
                say(f"[tiles clocks] {label} "
                    f"{'x'.join(map(str, ops[0].shape))} n_ops={len(ops)} "
                    f"keys={nk}, {lanes} lanes a CTA: {ms:.4f} ms in the "
                    f"clocked build; " + ", ".join(
                        f"{nm} {100 * c / total:.1f}%"
                        for nm, c in zip(CLUSTER_PHASES, cycles)))
    finally:
        kernels._LIBS["sort"] = rule_lib


def tile_sweep(torch, dev, card: str, real=None, rounds: int = 5) -> None:
    """``--tiles``: B1 at ``TILE_SHAPES``, at ``NETWORK_SHAPES`` and at
    every distinct call of ``real`` (``b1_real_calls``: the fleet row's
    and v1's), in every form and CTA width it can take (``b1_variants``),
    beside ``torch.sort`` and the byte bound. Synthetic keys are drawn from [0, 2n), about the
    bits of the main path's lane and base keys; the payloads are lane
    numbers. Every variant's result is held bit-equal to the plain
    version. The times are CUDA events, the mean of 10 calls a round,
    ``rounds`` rounds of every variant in turn; the median is printed,
    with the rule's pick and the fastest variant."""
    from cause_tpu_torch.weaver import bitonic

    limits = bitonic.b1_limits(dev.index or 0)
    rng = np.random.default_rng(20261017)
    shapes = [(f"synthetic {B}x{n}", None, B, n, n_ops, nk)
              for B, n, n_ops, nk in TILE_SHAPES + NETWORK_SHAPES]
    for gen, calls in (real or {}).items():
        shapes += [(gen, (ops, nk), *ops[0].shape, len(ops), nk)
                   for ops, nk in calls if ops[0].shape[1] > 8192]
    picks = {}
    for label, call, B, n, n_ops, nk in shapes:
        if call is None:
            ops = tuple(
                torch.from_numpy(rng.integers(0, 2 * n, size=(B, n))
                                 .astype(np.int32)).to(dev) if i < nk else
                torch.arange(n, dtype=torch.int32, device=dev)
                .expand(B, n).contiguous() for i in range(n_ops))
        else:
            ops = call[0]
        want = bitonic.sort_pairs_plain(ops, nk)
        lib_call = library_fn(torch, ops, nk)
        variants = b1_variants(n, nk, limits)
        times = {v: [] for v in variants}
        times["torch.sort"] = []
        for _ in range(rounds):
            for form, lanes in variants:
                run = lambda: bitonic.sort_pairs_cuda(  # noqa: E731
                    ops, nk, form=form, lanes=lanes or None)
                if max_err(torch, run(), want):
                    fail(f"tiles: {label} keys={nk} in {form} at {lanes} "
                         f"lanes disagrees with the plain version")
                times[(form, lanes)].append(cuda_ms(torch, run, warm=1))
            if lib_call:
                times["torch.sort"].append(cuda_ms(torch, lib_call, warm=1))
        med = {k: float(np.median(v)) if v else float("nan")
               for k, v in times.items()}
        rule = bitonic.b1_form(n, nk, limits)
        lanes = bitonic.cluster_lanes(n, limits) if rule == "cluster" else 0
        best = min(variants, key=lambda v: med[v])
        picks[best[0]] = picks.get(best[0], 0) + 1
        say(f"[tiles] {label} n_ops={n_ops} keys={nk}: "
            + ", ".join(f"{f}{f' {lanes_}' if lanes_ else ''} "
                        f"{med[(f, lanes_)]:.4f} ms" for f, lanes_ in variants)
            + f", torch.sort {med['torch.sort']:.4f} ms, bound "
            f"{bound_ms(call_bytes(ops, want)):.4f} ms; the rule: {rule} "
            f"{lanes} ({med[(rule, lanes)]:.4f} ms), fastest "
            f"{best[0]} {best[1]} (CUDA events, median of {rounds} rounds "
            f"of 10 calls, in turns)")
        del ops, want
    say(f"[tiles] fastest form by shape count: {picks}; limits {limits}; "
        f"{card}")


# --forms: B2 at the north star's K, the tree's widest row form, its
# split levels and the fleet row's (v5); B3 at the north star's N, the
# tree's widest level and the fleet row, its chunk form also from
# builds of fphase.cu at other chunk lengths; B from 1 to 256 while a
# shape holds at most FORM_SWEEP_LANES lanes
FORM_SWEEP_B = (1, 2, 4, 8, 16, 32, 64, 128, 256)
FORM_SWEEP_K = (4096, 16384, 32768, 65536, 1_152_002)
FORM_SWEEP_N = (20480, 131072, 10_485_760)
FORM_SWEEP_CHUNKS = (1, 2, 8, 16)
FORM_SWEEP_LANES = 1 << 26


def chunk_builds() -> dict:
    """``fphase.cu`` built with -DCAUSE_F_CHUNK_TILES=c for each c of
    ``FORM_SWEEP_CHUNKS`` (one nvcc each, all started together), and the
    default build under its own length: chunk tiles -> library."""
    import subprocess as sp

    from cause_tpu_torch import kernels
    from cause_tpu_torch.weaver import fphase

    out = kernels.BUILD / "chunks"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for c in FORM_SWEEP_CHUNKS:
        so = out / f"libfphase-chunk{c}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS,
               f"-DCAUSE_F_CHUNK_TILES={c}", "-o", str(so),
               str(kernels.CSRC / kernels.SOURCES["fphase"])]
        jobs[c] = (so, sp.Popen(cmd, stdout=sp.PIPE, stderr=sp.STDOUT,
                                text=True))
    libs = {fphase.F_CHUNK_TILES: kernels.library("fphase")}
    for c, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc fphase.cu chunk {c}: {log[-3000:]}")
        libs[c] = kernels.load(so)
    return dict(sorted(libs.items()))


def form_sweep(torch, dev, card: str, reps: int = 5) -> None:
    """``--forms``: B2's row and split forms (the row form only where a
    row fits in shared memory) and B3's row form and chunk form (at
    several chunk lengths, ``chunk_builds``) on the same calls, at
    ``FORM_SWEEP_K``/``FORM_SWEEP_N`` and B in ``FORM_SWEEP_B``: every
    form's result held bit-equal to the plain version, then each timed
    (CUDA events, the mean of ``reps`` calls after one warm-up), beside
    the form the rule gives. A row is made once with numpy (B2: a random
    forest of K runs, every run valid; B3: ``fphase_inputs``' random
    kind with U = N / 8 and S = N / 64) and repeated B times on the
    card."""
    from cause_tpu_torch import kernels
    from cause_tpu_torch.weaver import euler, fphase

    rng = np.random.default_rng(20261018)
    sms = fphase._sms(dev.index)
    smem = euler._smem_limit(dev.index)
    on = lambda x, B: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x)).to(dev).expand(B, -1).contiguous()
    for K in FORM_SWEEP_K:
        parent_sort = np.r_[K, (rng.random(K - 1) * np.arange(1, K))
                            .astype(np.int64)].astype(np.int32)[None]
        w = rng.integers(0, 6, size=(1, K)).astype(np.int32)
        order = np.argsort(parent_sort, axis=1, kind="stable").astype(
            np.int32)
        par = np.where(parent_sort < K, parent_sort, -1).astype(np.int32)
        for B in FORM_SWEEP_B:
            if B * K > FORM_SWEEP_LANES:
                break
            fc, ns = euler.link_children(on(order, B), on(parent_sort, B))
            ops = (fc, ns, on(par, B), on(w, B))
            want = euler.euler_walk_plain(*ops)
            times = {}
            for form in forms_of(torch, "euler_walk", ops):
                run = lambda: euler.euler_walk_cuda(*ops, form=form)  # noqa: E731
                if max_err(torch, (run(),), (want,)):
                    fail(f"[forms] euler_walk {form} B={B} K={K} "
                         f"disagrees with the plain version")
                times[form] = cuda_ms(torch, run, reps=reps, warm=1)
            say(f"[forms] euler_walk B={B} K={K}: " + ", ".join(
                f"{f} {ms:.4f} ms" for f, ms in times.items())
                + f"; the rule: {euler.walk_form(K, smem)}, fastest "
                f"{min(times, key=times.get)}")
            del fc, ns, ops, want
    libs = chunk_builds()
    try:
        for N in FORM_SWEEP_N:
            row = fphase_inputs(rng, 1, N, max(2, N // 8), max(2, N // 64),
                                "random")
            for B in FORM_SWEEP_B:
                if B * N > FORM_SWEEP_LANES:
                    break
                ops = tuple(on(x, B) for x in row)
                want = fphase.fphase_expand_plain(*ops)
                times = {}
                for c, lib in libs.items():
                    kernels._LIBS["fphase"] = lib
                    forms = ("row", "chunk") if c == fphase.F_CHUNK_TILES \
                        else ("chunk",)
                    for form in forms:
                        if form == "chunk" and c >= -(-N // fphase.F_TILE):
                            continue
                        run = lambda: fphase.fphase_expand_cuda(  # noqa: E731
                            *ops, form=form)
                        tag = form if form == "row" else f"chunk {c}"
                        if max_err(torch, run(), want):
                            fail(f"[forms] fphase {tag} B={B} N={N} "
                                 f"disagrees with the plain version")
                        times[tag] = cuda_ms(torch, run, reps=reps, warm=1)
                say(f"[forms] fphase B={B} N={N}: " + ", ".join(
                    f"{f} {ms:.4f} ms" for f, ms in times.items())
                    + f"; the rule: {fphase.fphase_form(B, N, sms)}, "
                    f"fastest {min(times, key=times.get)}")
                del ops, want
    finally:
        kernels._LIBS["fphase"] = libs[fphase.F_CHUNK_TILES]
    say(f"[forms] {card}")


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


A1_CELLS = ("pairs_full", "pairs_random", "fleet_converge")


def a1_cell_args(torch, dev, cell_name: str):
    """A1's operands at a benchmark cell's first batch (its first row of
    the fleet), as ``torchw5._v5_ab`` makes them: the benchmark's
    generator and the port's marshal, B1's sort of the segments."""
    from cause_tpu_torch import benchgen
    from cause_tpu_torch.weaver import bitonic
    from weavebench import cells, gen
    from weavebench.entries.common import marshal

    cell = cells.resolve(cell_name)
    cfg, mix = cell["config"], cell["mix"]
    rng = gen.rng_for(2 ** 31 + 7, 0)
    if "replicas" in cfg:
        v5 = marshal(gen.fleet_row(rng, cfg, mix), cfg["capacity"])
        v5 = {k: np.asarray(v)[None] for k, v in v5.items()}
    else:
        v5 = marshal(gen.pair_batch(rng, cfg, mix), cfg["capacity"])
    t = benchgen.lanes_from_numpy(v5, dev)
    B, S = t["sg_len"].shape
    kh = torch.where(t["sg_valid"], t["sg_min_hi"], I32_MAX)
    kl = torch.where(t["sg_valid"], t["sg_min_lo"], I32_MAX)
    sidx = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    sort_ops = (kh, kl, sidx.contiguous())
    s_mh, s_ml, s_src = bitonic.sort_pairs(sort_ops, num_keys=2)
    args = (t["hi"], t["lo"], t["cci"], t["vc"], s_mh, s_ml, s_src,
            *(t[k] for k in ("sg_max_hi", "sg_max_lo", "sg_len",
                             "sg_lane0", "sg_dense", "sg_tail_special",
                             "sg_valid", "sg_vsum")))
    return args, sort_ops


def phase_a1(torch, dev, card: str) -> dict:
    """Phase 2a: A1 at each benchmark cell's shape against the plain
    chain, timed beside the chain and B1's sort of the same segments.
    Returns the timings a cell."""
    from cause_tpu_torch import kernels
    from cause_tpu_torch.weaver import bitonic, segorder

    out = {}
    for name in A1_CELLS:
        t0 = time.perf_counter()
        args, sort_ops = a1_cell_args(torch, dev, name)
        B, N = args[0].shape
        S = args[4].shape[1]
        want = segorder.seg_order_plain(*args)
        before = kernels.launches["seg_order"]
        got = segorder.seg_order(*args)
        torch.cuda.synchronize()
        if kernels.launches["seg_order"] != before + 1:
            fail(f"[2a A1] {name}: seg_order launched "
                 f"{kernels.launches['seg_order'] - before} kernels")
        for field, x, w in zip(segorder.SegOrder._fields, got, want):
            if not torch.equal(x, w):
                fail(f"[2a A1] {name}: {field} differs from the plain chain")
        rec = {"ms": cuda_ms(torch, lambda: segorder.seg_order_cuda(*args))}
        rec["plain_ms"] = cuda_ms(torch, lambda: segorder.seg_order_plain(
            *args), reps=3, warm=1)
        rec["sort_ms"] = cuda_ms(torch, lambda: bitonic.sort_pairs(
            sort_ops, num_keys=2))
        rec["bytes"] = segorder.a1_contract(args, want)
        rec["bound_ms"] = bound_ms(rec["bytes"])
        rec.update(B=B, N=N, S=S, launches=1)
        out[name] = rec
        say(f"[2a A1] {name}: B={B} N={N} S={S}: kernel {rec['ms']:.4f} "
            f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bytes']:,} "
            f"contract bytes at 3.35 TB/s: "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}%), plain chain "
            f"{rec['plain_ms']:.4f} ms, B1's sort {rec['sort_ms']:.4f} ms; "
            f"1 launch; every output equal to the plain chain; "
            f"{time.perf_counter() - t0:.1f} s host ({card})")
        del args, sort_ops, want, got
        torch.cuda.empty_cache()
    return out


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
    there, by the module's own rule (``bitonic.b1_form``: radix, network,
    cluster or wide)."""
    from cause_tpu_torch.weaver import bitonic

    n = ops[0].shape[1]
    P = 1 << max(0, (n - 1).bit_length())
    form = bitonic.b1_form(
        n, num_keys, bitonic.b1_limits(ops[0].device.index or 0))
    return f"P={P} {form}"


def check_recorded(torch, calls, tag: str, sites=SORT_SITES,
                   timed=None) -> dict:
    """Every kernel call a path made (recorded under ``plain_path``)
    against its plain version on the card; the first call of each
    distinct kernel, shape and keyword set (not yet in ``timed``, which
    the caller may share between paths) also timed against its plain
    version and its bound, one line each (a B1 call with its site, its
    width, its form and its time over ``torch.sort``'s: ``sites`` names
    a dispatch's sorts in call order, the v5 dispatch's by default). Returns the timed calls' sums
    per kernel."""
    timed = set() if timed is None else timed
    per = {}
    taken = {}
    n_sorts = n_timed = 0
    for name, ops, kw in calls:
        site = ""
        if name == "sort":  # a dispatch sorts its sites in order
            site = (f" site {sites[n_sorts % len(sites)]} "
                    f"{b1_form(ops, kw.get('num_keys', 1))}")
            n_sorts += 1
        key = (name, tuple(tuple(x.shape) for x in ops),
               tuple(sorted(kw.items())))
        # the first call of a key also runs B2's and B3's every form; B1
        # runs its every form on the first call of each (rows, P, keys)
        fkey = key
        if name == "sort":  # shaped as a key, for TimedPerWidth too
            n = ops[0].shape[1]
            fkey = ("sort forms",
                    ((ops[0].shape[0], 1 << max(0, (n - 1).bit_length())),),
                    (("num_keys", kw.get("num_keys", 1)),))
        first = key not in timed
        rec = check_call(torch, name, ops, kw, time_it=first,
                         all_forms=fkey not in timed)
        timed.add(fkey)
        if rec["err"]:
            fail(f"{tag}: {name} at {[tuple(x.shape) for x in ops]} "
                 f"{kw or ''} disagrees with its plain version "
                 f"(max_abs_err {rec['err']})")
        if "form" in rec:
            forms = taken.setdefault(name, {})
            forms[rec["form"]] = forms.get(rec["form"], 0) + 1
        if key in timed:
            continue
        timed.add(key)
        n_timed += 1
        tot = per.setdefault(name, {"ms": 0.0, "plain_ms": 0.0,
                                    "bound_ms": 0.0})
        if name == "sort":
            tot.setdefault("library_ms", 0.0)
        for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if k in tot:
                tot[k] += rec[k]
        for form, ms in rec.get("form_ms", {}).items():
            tot.setdefault("form_ms", {}).setdefault(form, 0.0)
            tot["form_ms"][form] += ms
        shapes = "x".join(str(d) for d in ops[0].shape)
        say(f"{tag}: {name}{site} {shapes} n_ops={len(ops)} {kw or ''}: "
            f"max_abs_err 0, ms {rec['ms']:.4f} plain_ms "
            f"{rec['plain_ms']:.4f} bound_ms {rec['bound_ms']:.4f}"
            + (f" library_ms {rec['library_ms']:.4f} ms/library_ms "
               f"{rec['ms'] / rec['library_ms']:.3f}"
               if name == "sort" else "") + forms_text(rec))
    say(f"{tag}: {len(calls)} kernel calls, each equal to its plain "
        f"version on the card ({n_timed} distinct shapes timed); B1, B2 "
        f"and B3 also in each form; forms by the rules {taken}")
    return per


def kernel_sums_line(per) -> str:
    """``check_recorded``'s per-kernel sums as one line's text."""
    return "; ".join(
        f"{n} {v['ms']:.4f} ms, plain {v['plain_ms']:.4f}, bound "
        f"{v['bound_ms']:.6f}" + (f", torch.sort {v['library_ms']:.4f}"
                                  if "library_ms" in v else "")
        + "".join(f", {f} form {ms:.4f}"
                  for f, ms in v.get("form_ms", {}).items())
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
        # the host's waits, with the splice's coordinates on the card
        # (as the bench's sweep holds them)
        on = {k: torch.as_tensor(sw[k], device=dev)
              for k in ("starts", "counts", "r0")}
        pdig = torch.as_tensor(sw["prefix_digest"].view(np.int32),
                               device=dev)
        d_sync = sync_points(torch, lambda: ct.batched_delta_weave(
            *wargs, pdig, on["r0"], u_max=nw, k_max=nw, device=dev))
        s_sync = sync_points(torch, lambda: torchwd.splice_ranks(
            rf, vf, got[0], got[1], on["starts"], on["counts"], on["r0"]))
        say(f"{tag}: the host waits for the card {len(d_sync)} times in "
            f"one delta dispatch {sorted(set(d_sync))} and {len(s_sync)} "
            f"times in its splice {sorted(set(s_sync))}")
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
                   if name == "sort" else "") + forms_text(rec))
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
                burst: bool, tag: str = "[10 serve]"):
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
            fail(f"{tag} round {rnd}: the client shed an offer")
    if burst:
        p = producers[SERVE_BURST_TENANT]
        clients[owner[SERVE_BURST_TENANT]].queue_ops(
            p.uuid, p.sites[0], p.mint(p.sites[0], SERVE_BURST))
    deadline = time.monotonic() + 60.0
    for cl in clients:
        while cl.outbound_depth and time.monotonic() < deadline:
            cl.pump()
        if cl.outbound_depth:
            fail(f"{tag} round {rnd}: client {cl.client_id} could "
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

            def wave_fleet(sessions, **kw):
                out = real_wave(sessions, **kw)
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
    return tick_counts, per, tenants


# ------------------------------------------------------------ 11. telemetry


def obs_fresh(out: str = "") -> None:
    """The port's telemetry reset to a clean, disabled state (every
    layer: events, counters, monitors, cost windows, devprof's seen
    identities), streaming to ``out`` once enabled."""
    from cause_tpu_torch import obs
    from cause_tpu_torch.obs import costmodel, devprof, semantic

    obs.configure(enabled=False, out=out, ring_size=1 << 20, reset=True)
    semantic.reset()
    costmodel.reset()
    devprof.reset()


def obs_twin(torch, tag: str, run):
    """``run()`` with telemetry off, then on: the two results, the
    launches of each and the events of the on run. Fails unless both
    runs launched the same kernels the same number of times."""
    from cause_tpu_torch import kernels, obs

    obs.configure(enabled=False)
    with launches_in() as off_counts:
        off, off_ms = timed_ms(torch, run)
    obs.configure(enabled=True)
    i0 = len(obs.events())
    with launches_in() as on_counts:
        on, on_ms = timed_ms(torch, run)
    obs.configure(enabled=False)
    evs = obs.events()[i0:]
    if on_counts != off_counts:
        fail(f"{tag}: telemetry changed the launches: off {off_counts}, "
             f"on {on_counts}")
    if not any(on_counts[n] for n in V5_LAUNCHES):
        fail(f"{tag}: the path launched no B1-B3 kernel: {on_counts}")
    return off, on, on_counts, evs, off_ms, on_ms


def fields_of(evs, name, **match):
    return [e["fields"] for e in evs if e.get("ev") == "event"
            and e.get("name") == name
            and all(e["fields"].get(k) == v for k, v in match.items())]


def same(torch, a, b) -> bool:
    """Bit identity of nested results: tensors, arrays and plain data."""
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(torch, x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(torch, a[k], b[k]) for k in a))
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype \
            and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and np.array_equal(a, b)
    return a == b


def check_wave_costs(tag: str, costs, fphase: int, per_dispatch: int):
    """The cost model's dispatch count against the kernels': every
    counted dispatch here runs B3 once, and the reference's accounting
    counts ``per_dispatch`` records for it (kernel + digest, or delta
    weave + rank splice: 2; a tree level or a bucket: 1)."""
    got = sum(f["dispatches"] for f in costs)
    if not costs or got != per_dispatch * fphase:
        fail(f"{tag}: wave.cost dispatches {[f['dispatches'] for f in costs]}"
             f" (sum {got}) against {fphase} B3 launches x {per_dispatch}")


def phase_telemetry(torch, dev, card: str, pairs, v5, u_max: int,
                    k_p50: float, tenants) -> dict:
    """Phase 11: the port's telemetry on the card. Returns the
    telemetry-on runs' launch counts."""
    import random
    import tempfile

    import cause_tpu_torch as ct
    from cause_tpu_torch import kernels, obs, serde
    from cause_tpu_torch.obs import devprof, lag, perfetto
    from cause_tpu_torch.parallel.session import FleetSession

    tag = "[11 telemetry]"
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="obs-smoke-")
    sidecar = os.path.join(tmp.name, "obs.jsonl")
    obs_fresh(sidecar)
    obs.set_platform(dev)
    total = {n: 0 for n in kernels.SOURCES}

    def add(counts):
        for n in total:
            total[n] += counts[n]

    # ---- the API wave, v5 then v5f, off against on
    def api(kernel):
        def run():
            os.environ["BENCH_KERNEL"] = kernel
            try:
                res = ct.merge_wave(pairs)
            finally:
                os.environ.pop("BENCH_KERNEL", None)
            return res.rank, res.visible, res.digest, res.kernel
        return run

    for kernel in ("v5", "v5f"):
        off, on, counts, evs, off_ms, on_ms = obs_twin(
            torch, f"{tag} api {kernel}", api(kernel))
        add(counts)
        if not same(torch, off, on):
            fail(f"{tag} api {kernel}: ranks, visibility or digests "
                 f"differ with telemetry on")
        costs = fields_of(evs, "wave.cost", source="wave")
        if len(costs) != 1:
            fail(f"{tag} api {kernel}: {len(costs)} wave.cost events")
        check_wave_costs(f"{tag} api {kernel}", costs, counts["fphase"], 2)
        (dig,) = fields_of(evs, "wave.digest", source="wave")
        distinct = len(set(int(d) for d in on[2]))
        if dig["distinct"] != distinct or dig["agreed"] != (distinct == 1):
            fail(f"{tag} api {kernel}: wave.digest {dig} against "
                 f"{distinct} distinct digests")
        incidents = fields_of(evs, "divergence", source="wave")
        if len(incidents) != (0 if distinct == 1 else 1):
            fail(f"{tag} api {kernel}: {len(incidents)} divergence "
                 f"incidents for {distinct} distinct digests")
        say(f"{tag} api {kernel}: merge_wave over {len(pairs)} pairs "
            f"bit-identical with telemetry on (launches {counts}); one "
            f"wave.cost of {costs[0]['dispatches']} dispatches; "
            f"wave.digest {distinct} distinct of {len(pairs)} (the pairs "
            f"diverge by construction: one incident); host ms off "
            f"{off_ms:.3f} on {on_ms:.3f} (first calls)")

    # ---- two session rounds (full, then delta) and the tree over the
    # session's replicas, off against on
    def session_run():
        sess = FleetSession(pairs)
        digs = [sess.wave()]
        cur = pairs
        for rnd in (1, 2):
            cur = session_edit(cur, rnd)
            sess.update(cur)
            digs.append(sess.wave())
        root = sess.converge()
        return digs, sess.last_rank, sess.last_visible, root.ct.weave

    uuid = str(pairs[0][0].ct.uuid)
    off, on, counts, evs, off_ms, on_ms = obs_twin(
        torch, f"{tag} session + tree", session_run)
    add(counts)
    if not same(torch, off, on):
        fail(f"{tag} session: digests, resident ranks, visibility or the "
             f"converged root differ with telemetry on")
    s_costs = fields_of(evs, "wave.cost", source="session")
    t_costs = fields_of(evs, "wave.cost", source="tree")
    paths = [f["path"] for f in s_costs]
    if len(s_costs) != 3 or "full" not in paths or "delta" not in paths:
        fail(f"{tag} session: wave.cost paths {paths}")
    levels = fields_of(evs, "tree.level")
    if len(t_costs) != len(levels) or t_costs[0]["path"] != "full":
        fail(f"{tag} tree: {len(t_costs)} wave.cost for {len(levels)} "
             f"levels, paths {[f['path'] for f in t_costs]}")
    if any(f["dispatches"] != 2 for f in s_costs) or any(
            f["dispatches"] < 1 for f in t_costs):
        fail(f"{tag}: session/tree dispatch counts "
             f"{[f['dispatches'] for f in s_costs]} / "
             f"{[f['dispatches'] for f in t_costs]}")
    check_wave_costs(f"{tag} session + tree", s_costs + t_costs,
                     counts["fphase"] + len(s_costs), 1)
    tree_digest = fields_of(evs, "wave.digest", source="tree")
    if not tree_digest[-1].get("agreed") or fields_of(
            evs, "divergence", source="tree"):
        fail(f"{tag} tree: the root level disagreed or minted an "
             f"incident: {tree_digest[-1]}")
    pending = lag.pending_ops(uuid)
    resolved = fields_of(evs, "lag.window")
    if pending or not resolved or not resolved[-1]["converged"]:
        fail(f"{tag}: {pending} ops still pending after converge "
             f"({len(resolved)} lag windows)")
    say(f"{tag} session: 3 waves (paths {paths}) and converge() over "
        f"{2 * len(pairs)} replicas ({len(levels)} tree levels, paths "
        f"{[f['path'] for f in t_costs]}) bit-identical with telemetry "
        f"on (launches {counts}); wave.cost dispatches session "
        f"{[f['dispatches'] for f in s_costs]}, tree "
        f"{[f['dispatches'] for f in t_costs]}; root level agreed, no "
        f"divergence incident; {resolved[-1]['converged_total']} ops "
        f"converged, 0 pending; host ms off {off_ms:.3f} on {on_ms:.3f}")

    # ---- offered rounds of the served fleet, the lag SLO out of
    # reach (1 ms): the controller must move
    def serve_run(root):
        def run():
            svc = serve_service(root(), batched=True)
            uuids = [svc.add_tenant(a, b) for a, b, _tail in tenants]
            producers = [ServeProducer(i, tenants[i])
                         for i in range(len(tenants))]
            rng = random.Random(SERVE_SEED)
            weights = [1.0 / ((i + 1) ** 1.2) for i in range(len(tenants))]
            rng.shuffle(weights)
            ticker = ServeTicker(svc)
            t_batch0 = svc.controller.t_batch_ms
            firing, ticks = [], []
            for k in range(TELEMETRY_SERVE_ROUNDS):
                for _ in range(SERVE_OFFERS):
                    t = rng.choices(range(len(producers)), weights=weights)[0]
                    p = producers[t]
                    st = p.sites[rng.randrange(2)]
                    ops = p.mint(st, rng.randint(1, 16))
                    items = serde.encode_node_items(
                        {o[0]: (o[1], o[2]) for o in ops})
                    if not svc.queue.offer(p.uuid, st, items).admitted:
                        fail(f"{tag} serve: an offer was refused")
                for t in ticker.until_empty(torch, f"{tag} serve round {k}"):
                    ticks.append(t)
                    if svc._live is not None:
                        firing.append({r.spec: r.firing
                                       for r in svc._live.monitor.rules})
            digests = {u: svc.converged_digest(u) for u in uuids}
            moved = (t_batch0, svc.controller.t_batch_ms)
            svc.close()
            return digests, ticks, firing, moved
        return run

    n_root = iter(range(2))
    lag.set_slo(1.0)
    off, on, counts, evs, off_ms, on_ms = obs_twin(
        torch, f"{tag} serve",
        serve_run(lambda: os.path.join(tmp.name, f"serve{next(n_root)}")))
    lag.set_slo(None)
    add(counts)
    (dig_off, ticks_off, _f, moved_off), (dig_on, ticks_on, firing,
                                          moved_on) = off, on
    if dig_off != dig_on:
        fail(f"{tag} serve: tenant digests differ with telemetry on")
    keys = ("ops", "tenants", "depth", "buckets", "batch_rows")
    if [{k: t["summary"][k] for k in keys} for t in ticks_off] != \
            [{k: t["summary"][k] for k in keys} for t in ticks_on]:
        fail(f"{tag} serve: the ticks drained or dispatched differently")
    if moved_off[0] != moved_off[1]:
        fail(f"{tag} serve: T_batch moved with telemetry off")
    control = fields_of(evs, "serve.control")
    if moved_on[1] == moved_on[0] or not control:
        fail(f"{tag} serve: T_batch stayed at {moved_on[0]} ms under an "
             f"unmeetable SLO ({len(control)} serve.control events)")
    wd = [t["summary"]["wave_dispatches"] for t in ticks_on]
    buckets = [t["summary"]["buckets"] for t in ticks_on]
    if any(t["summary"]["wave_dispatches"] for t in ticks_off) or \
            not all(w > 0 for w, b in zip(wd, buckets) if b) or not any(wd):
        fail(f"{tag} serve: wave_dispatches off "
             f"{[t['summary']['wave_dispatches'] for t in ticks_off]}, on "
             f"{wd} (buckets {buckets})")
    b_costs = fields_of(evs, "wave.cost", path="batched")
    if len(b_costs) != sum(buckets) or any(f["dispatches"] != 1
                                           for f in b_costs):
        fail(f"{tag} serve: {len(b_costs)} batched wave.cost events for "
             f"{sum(buckets)} bucket dispatches")
    alerts = fields_of(evs, "live.alert")
    for spec in (firing[0] if firing else {}):
        rises = sum(1 for i, f in enumerate(firing)
                    if f[spec] and (i == 0 or not firing[i - 1][spec]))
        got = sum(1 for a in alerts if a.get("rule") == spec)
        if got != rises:
            fail(f"{tag} serve: rule {spec}: {got} live.alert events for "
                 f"{rises} excursions")
    burn = [a for a in alerts if str(a.get("rule", "")).startswith("burn")]
    if not burn:
        fail(f"{tag} serve: no burn alert under a 1 ms SLO")
    serve_uuids = list(dig_on)
    if any(lag.pending_ops(u) for u in serve_uuids):
        fail(f"{tag} serve: ops pending after the fleet drained its queue")
    agreed = fields_of(evs, "wave.digest", source="session")
    if not agreed or not all(f["agreed"] for f in agreed) or fields_of(
            evs, "divergence", source="session"):
        fail(f"{tag} serve: a tenant wave disagreed or minted an incident")
    tick_off = [t["ms"] for t in ticks_off]
    tick_on = [t["ms"] for t in ticks_on]
    say(f"{tag} serve: {len(tenants)} tenants, {TELEMETRY_SERVE_ROUNDS} "
        f"offered round(s), "
        f"{len(ticks_on)} ticks, digests and tick shapes bit-identical "
        f"with telemetry on (launches {counts}); T_batch "
        f"{moved_on[0]:.3f} -> {moved_on[1]:.3f} ms in {len(control)} "
        f"serve.control changes (lag SLO 1 ms); wave_dispatches a tick "
        f"{wd} (buckets {buckets}); {len(b_costs)} batched wave.cost of 1 "
        f"dispatch each; live.alert {sorted(a['rule'] for a in alerts)}, "
        f"one per excursion; 0 ops pending; every tenant wave agreed")
    ratios = [b / a for a, b in zip(tick_off, tick_on)]
    say(f"{tag} overhead: tick p50 off {float(np.median(tick_off)):.3f} "
        f"ms, on {float(np.median(tick_on)):.3f} ms (host clock, "
        f"synchronized, {len(tick_off)} / {len(tick_on)} ticks: "
        f"{[round(t, 3) for t in tick_off]} / "
        f"{[round(t, 3) for t in tick_on]}); the same tick on / off, "
        f"median {float(np.median(ratios)):.3f}, range "
        f"{min(ratios):.3f}-{max(ratios):.3f}; {card}")

    # ---- devprof on the card
    programs = fields_of(obs.events(), "devprof.program")
    idents = [tuple(sorted((k, v) for k, v in f.items()
                           if k not in ("site", "launches", "cost",
                                        "memory")))
              for f in programs]
    if not programs or len(set(idents)) != len(idents):
        fail(f"{tag} devprof: {len(programs)} devprof.program events, "
             f"{len(set(idents))} identities")
    for f in programs:
        want = V5F_LAUNCHES if f["pipeline"] == "v5f" else V5_LAUNCHES
        got = {k: v for k, v in f["launches"].items() if v}
        if got != want or "memory" not in f or "flops" in f["cost"]:
            fail(f"{tag} devprof.program {f}: launches {got}, expected "
                 f"{want}, with the allocator's memory and no flops")
    a0 = torch.cuda.memory_allocated(dev)
    obs.configure(enabled=True)
    sample = devprof.sample_device_memory("smoke", dev)
    obs.configure(enabled=False)
    a1 = torch.cuda.memory_allocated(dev)
    gauges = {e["name"]: e["value"] for e in obs.events()
              if e.get("ev") == "gauge"}
    if not (a0 == sample["device_bytes_in_use"] == a1
            == gauges["devprof.device_bytes_in_use.smoke"]):
        fail(f"{tag} devprof: gauge {sample} against memory_allocated "
             f"{a0} / {a1}")
    sites = {n.rsplit(".", 1)[-1] for n in gauges
             if n.startswith("devprof.device_bytes_in_use.")}
    for site in ("wave", "session", "batch", "smoke"):
        if site not in sites:
            fail(f"{tag} devprof: no memory gauge at {site} ({sites})")
    say(f"{tag} devprof: {len(programs)} devprof.program events, one per "
        f"dispatch identity ({sorted({(f['site'], f['pipeline']) for f in programs})}), "
        f"launches per first dispatch 6/1/1 (v5, delta) and 2/1/1/1/1/1 "
        f"(v5f); memory gauge {sample['device_bytes_in_use']} B == "
        f"memory_allocated; gauged at {sorted(sites)}")

    # ---- the phase spans at the north star: phase 3's dispatch (kernel
    # and digest) with telemetry on, whose v5.A-v5.F and replica.digest
    # spans time their work on the card (CUDA events), in turns with the
    # same dispatch timed whole by CUDA events with telemetry off, a call
    # of each a rep: the host's speed drifts over a run, so the phases'
    # sum is held against the dispatch timed beside it (phase 3's p50 is
    # printed too). Phase 3 timed its dispatch before the earlier phases
    # filled the heap with handles; freezing that heap keeps Python's
    # full collections from scanning it in the middle of a timed call
    import gc

    from cause_tpu_torch import benchgen

    lanes = benchgen.lanes_from_numpy(v5, dev)
    args = [lanes[k] for k in benchgen.LANE_KEYS5]

    def dispatch():
        return ct.batched_weave_digest(*args, u_max=u_max, k_max=u_max,
                                       device=dev)

    phase_names = [f"v5.{x}" for x in "ABCDEF"] + ["replica.digest"]
    dispatch()
    torch.cuda.synchronize(dev)
    gc.collect()
    gc.freeze()
    sums, whole, per_phase = [], [], {n: [] for n in phase_names}
    try:
        for _ in range(3 * REPS):
            obs.configure(enabled=True)
            seen = max((e.get("id", 0) for e in obs.events()), default=0)
            dispatch()
            torch.cuda.synchronize(dev)
            got = [e for e in obs.events() if e.get("ev") == "span"
                   and e.get("id", 0) > seen and e["name"] in phase_names]
            obs.configure(enabled=False)
            if sorted(e["name"] for e in got) != sorted(phase_names) or \
                    any("dev_us" not in e for e in got):
                fail(f"{tag} phase spans: one dispatch recorded "
                     f"{[(e['name'], e.get('dev_us')) for e in got]}")
            for e in got:
                per_phase[e["name"]].append(e["dev_us"] * 1e-3)
            sums.append(sum(e["dev_us"] for e in got) * 1e-3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dispatch()
            end.record()
            end.synchronize()
            whole.append(start.elapsed_time(end))
    finally:
        obs.configure(enabled=False)
        gc.unfreeze()
    s_p50, d_p50 = float(np.median(sums)), float(np.median(whole))
    if abs(s_p50 - d_p50) > 0.25 * d_p50:
        fail(f"{tag} phase spans: the sum of v5.A-v5.F and replica.digest "
             f"dev_us, p50 {s_p50:.3f} ms, is not within 25% of the "
             f"dispatch timed in turns with it, p50 {d_p50:.3f} ms "
             f"({[round(t, 3) for t in sums]} / "
             f"{[round(t, 3) for t in whole]}; phase 3's {k_p50:.3f} ms)")
    say(f"{tag} phase spans at the north star ({v5['hi'].shape[0]} rows, "
        f"u_max {u_max}; dev_us from CUDA events, p50 of {3 * REPS}, the "
        f"older heap frozen): "
        + ", ".join(f"{n} {float(np.median(v)):.3f} ms"
                    for n, v in per_phase.items())
        + f"; their sum {s_p50:.3f} ms against the dispatch timed whole "
        f"in turns with it, {d_p50:.3f} ms (CUDA events, telemetry off): "
        f"{s_p50 / d_p50:.3f}; against phase 3's {k_p50:.3f} ms (host "
        f"clock): {s_p50 / k_p50:.3f}; {card}")

    # ---- the sidecar: what was streamed folds like the ring (read
    # first: the ring's read resolves and streams every open span)
    ring = obs.events()
    streamed = perfetto.load_jsonl(sidecar)
    if len(streamed) != len(ring):
        fail(f"{tag}: the sidecar holds {len(streamed)} records, the ring "
             f"{len(ring)}")

    # ---- the overhead on the wave: merge_wave v5, off and on alternately,
    # every record streamed to the sidecar (one write a record)
    offs, ons = [], []
    try:
        for _ in range(REPS):
            for flag, acc in ((False, offs), (True, ons)):
                obs.configure(enabled=flag)
                acc.append(timed_ms(torch, lambda: ct.merge_wave(pairs))[1])
    finally:
        obs.configure(enabled=False)
    say(f"{tag} overhead: merge_wave over {len(pairs)} pairs p50 off "
        f"{float(np.median(offs)):.3f} ms, on {float(np.median(ons)):.3f} "
        f"ms (host clock, synchronized, {REPS} reps each, alternated, "
        f"streamed to the sidecar: {[round(t, 3) for t in offs]} / "
        f"{[round(t, 3) for t in ons]}); {card}")
    obs_fresh()
    tmp.cleanup()
    say(f"{tag} {len(streamed)} records streamed to the sidecar; phase "
        f"{time.perf_counter() - t_phase:.1f} s (host clock); {card}")
    return total


# ------------------------------------------------------------ 12. the wire

# phase 12: the clients' heartbeat interval (each pings once after the
# round's ticks), the ship faults of the second run, and the alerts the
# collector's default rules may fire on this traffic (its ops wait out
# ticks of hundreds of ms against the 100 ms lag SLO)
WIRE_HEARTBEAT_S = 1.0
WIRE_CHAOS = {"seed": 12, "faults": [
    {"family": "ship", "site": "obs.ship", "mode": "dup", "at": [2, 6, 11]},
    {"family": "ship", "site": "obs.ship", "mode": "reorder",
     "at": [4, 9]}]}
WIRE_ALERTS = ("burn>2",)
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def collector_child(out: str) -> int:
    """``--collector DIR``: a ``CollectorServer`` in a process of its own
    (the fleet's topology: the collector's fold and archive stay off the
    serving interpreter), archiving under DIR/wal, its port written to
    DIR/port, serving until its standard input closes."""
    from cause_tpu_torch.obs.collector import CollectorServer

    srv = CollectorServer(dir=os.path.join(out, "wal")).start()
    with open(os.path.join(out, "port.tmp"), "w") as f:
        f.write(str(srv.port))
    os.replace(os.path.join(out, "port.tmp"), os.path.join(out, "port"))
    try:
        sys.stdin.read()
    finally:
        srv.stop()
    return 0


def no_obs_env() -> dict:
    return {k: v for k, v in os.environ.items()
            if not k.startswith("CAUSE_TPU_OBS")}


class CollectorProcess:
    """Phase 12's collector: ``collector_child`` started by the smoke and
    stopped by it; ``snap()`` asks it for its snapshot over its socket,
    as the dashboard does; ``records()`` reads its archive once it has
    stopped."""

    def __init__(self, root: str, tag: str):
        os.makedirs(root)
        self.root, self.tag = root, tag
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(REPO_ROOT, "chip_smoke.py"),
             "--collector", root],
            stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, env=no_obs_env(), cwd=REPO_ROOT)
        path = os.path.join(root, "port")
        deadline = time.monotonic() + 120.0
        while not os.path.exists(path):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.stop()
                fail(f"{tag}: the collector process did not start: "
                     f"{self.proc.stderr.read().decode()[-2000:]}")
            time.sleep(0.05)
        with open(path) as f:
            self.port = int(f.read())

    def snap(self) -> dict:
        from cause_tpu_torch import sync
        from cause_tpu_torch.net import transport

        fs = transport.dial("127.0.0.1", self.port, site="smoke.snap",
                            read_timeout_s=30.0)
        try:
            sync.send_frame(fs, {"op": "snap"})
            reply = transport.recv_msg(fs, 30.0)
        finally:
            fs.close()
        if reply.get("op") != "snap":
            fail(f"{self.tag}: the collector answered {reply.get('op')!r}")
        return reply["snapshot"]

    def stop(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()

    def records(self) -> dict:
        """The archive: ``{"host:pid:epoch": [(admit ts_us, record)]}``."""
        from cause_tpu_torch.serve import wal

        path = os.path.join(self.root, "wal")
        out = {}
        for _no, name in wal.list_segments(path):
            for kind, rec in wal.scan_segment_file(os.path.join(path, name)):
                if kind == "rec":
                    out.setdefault(rec["uuid"], []).extend(
                        (rec["ts_us"], r) for r in rec["items"])
        return out


def wire_round(torch, root: str, tenants, tag: str) -> dict:
    """One offered round of phase 10's served fleet over the wire: a
    fresh ``SyncService`` (batched, capacity 16, ``d_max`` 64, a WAL)
    with the 32 tenants, the loopback ``ReplicationServer`` fed by 8
    ``NetClient``s, SERVE_OFFERS zipf-hot offers and the 200-op burst,
    ticked at the default drain until the queue is empty, then one
    heartbeat a client. The service's uplink (``svc._ship``) is armed
    by its construction when telemetry is on and CAUSE_TPU_OBS_SHIP is
    set; ``close()`` flushes it."""
    import random

    from cause_tpu_torch import obs
    from cause_tpu_torch.net import NetClient, ReplicationServer

    t0 = time.perf_counter()
    svc = serve_service(root, batched=True)
    exp = svc._ship
    if obs.enabled() and os.environ.get("CAUSE_TPU_OBS_SHIP") \
            and exp is None:
        fail(f"{tag}: the service armed no uplink")
    uuids = [svc.add_tenant(a, b) for a, b, _tail in tenants]
    wall = {"build": time.perf_counter() - t0}
    srv = ReplicationServer(svc).start()
    n = len(tenants)
    owner = {t: t // (n // SERVE_CLIENTS) for t in range(n)}
    clients = [NetClient("127.0.0.1", srv.port,
                         [uuids[t] for t in range(n) if owner[t] == c],
                         client_id=f"wire-{c}", read_timeout_s=30.0,
                         heartbeat_s=WIRE_HEARTBEAT_S)
               for c in range(SERVE_CLIENTS)]
    producers = [ServeProducer(i, tenants[i]) for i in range(n)]
    rng = random.Random(SERVE_SEED)
    weights = [1.0 / ((i + 1) ** 1.2) for i in range(n)]
    rng.shuffle(weights)
    ticker = ServeTicker(svc)
    try:
        with launches_in() as counts:
            t0 = time.perf_counter()
            serve_offer(clients, owner, producers, rng, weights, 0,
                        burst=True, tag=tag)
            t_offered = time.monotonic()
            wall["offer"] = time.perf_counter() - t0
            ticks = ticker.until_empty(torch, f"{tag} round")
            wall["ticks"] = time.perf_counter() - t0 - wall["offer"]
            time.sleep(max(0.0, WIRE_HEARTBEAT_S
                           - (time.monotonic() - t_offered)))
            for cl in clients:
                cl.pump()
        # the tenants the round served, and whatever else is resident
        # (a spilled tenant's digest would cost a restore)
        t0 = time.perf_counter()
        served = {e.uuid for d in ticker.drained for e in d}
        check = [u for u in uuids
                 if u in served or u in svc.residency.resident()]
        out = {"digests": {u: svc.converged_digest(u) for u in check},
               "ticks": ticks, "counts": counts, "exp": exp,
               "clients": [dict(cl.stats) for cl in clients],
               "server": dict(srv.stats),
               "minted": sum(p.minted for p in producers), "wall": wall}
        wall["digests"] = time.perf_counter() - t0
        if obs.enabled():
            obs.flush()  # the counters record ships with the rest
    finally:
        t0 = time.perf_counter()
        for cl in clients:
            cl.close()
        srv.stop()
        svc.close()
        wall["close"] = time.perf_counter() - t0
    return out


def shipped_round(torch, root: str, name: str, tenants, port: int,
                  tag: str) -> dict:
    """``wire_round`` with telemetry on, streaming to a sidecar and
    shipping to the collector on ``port``; adds the sidecar's records."""
    from cause_tpu_torch import obs
    from cause_tpu_torch.obs import perfetto

    sidecar = os.path.join(root, f"{name}.jsonl")
    obs_fresh(sidecar)
    os.environ["CAUSE_TPU_OBS_SHIP"] = f"127.0.0.1:{port}"
    obs.configure(enabled=True)
    try:
        r = wire_round(torch, os.path.join(root, name), tenants,
                       f"{tag} {name}")
    finally:
        obs.configure(enabled=False)
        os.environ.pop("CAUSE_TPU_OBS_SHIP", None)
    r["sidecar"] = perfetto.load_jsonl(sidecar)
    return r


def check_shipped(tag: str, r: dict, archive: dict, origins) -> list:
    """Exact accounting of one shipped run: the exporter ended with
    nothing unshipped or dropped; the collector accepted, missed
    nothing, and holds exactly the records the serving process's
    sidecar holds from the uplink's ``ship.attach`` to the last
    shipped one. Returns ``[(admit ts_us, record)]`` of the origin."""
    exp = r["exp"]
    st = exp.stats
    org = [o for o in origins if o["pid"] == exp.pid
           and o["epoch"] == exp.epoch]
    got = archive.get(f"{exp.origin_host}:{exp.pid}:{exp.epoch}", [])
    if st["unshipped"] or exp.total_dropped() or len(org) != 1:
        fail(f"{tag}: exporter {st}, dropped {exp.total_dropped()}, "
             f"{len(org)} origin rows")
    (org,) = org
    if not (len(got) == org["accepted"] == org["watermark"]
            == st["acked_seq"]) or org["missed"]:
        fail(f"{tag}: the collector archived {len(got)} records, "
             f"accepted {org['accepted']} (watermark {org['watermark']}, "
             f"missed {org['missed']}) against {st['acked_seq']} acked")
    keys = [json.dumps(x, sort_keys=True) for x in r["sidecar"]]
    shipped = [json.dumps(x, sort_keys=True) for _ts, x in got]
    start = next((i for i, x in enumerate(r["sidecar"])
                  if x.get("name") == "ship.attach"), None)
    if start is None or not shipped or shipped[-1] not in keys:
        fail(f"{tag}: the sidecar has no ship.attach or not the last "
             f"shipped record")
    end = len(keys) - 1 - keys[::-1].index(shipped[-1])
    if sorted(shipped) != sorted(keys[start:end + 1]):
        fail(f"{tag}: the collector's {len(shipped)} records differ from "
             f"the sidecar's {end + 1 - start} from ship.attach on")
    return got


def check_wire_events(tag: str, r: dict, recs) -> dict:
    """The net layer's evidence in the collector's stream: every client's
    connect and the server's hello, heartbeats on both sides, the
    admitted-ops counter, the connection gauge, nacks and sheds exactly
    as the server and clients counted them; and one journey per queued
    batch, linked from its mint through send and recv to the tick's
    wave, whose tenant reached an agreeing ``wave.digest``."""
    from collections import Counter

    from cause_tpu_torch.obs import journey

    evs = [e for e in recs if e.get("ev") == "event"]
    names = Counter(e["name"] for e in evs)
    sides = Counter(e["fields"].get("side") for e in evs
                    if e["name"] == "net.heartbeat")
    flushed = [e for e in recs if e.get("ev") == "counters"]
    counters = flushed[-1]["counters"] if flushed else {}
    nacks = r["server"]["nacks"]
    shed = sum(c["shed_ops"] for c in r["clients"])
    gauges = {e["name"] for e in recs if e.get("ev") == "gauge"}
    problems = []
    if names["net.hello"] != SERVE_CLIENTS \
            or names["net.connect"] != SERVE_CLIENTS:
        problems.append(f"hello {names['net.hello']}, connect "
                        f"{names['net.connect']}")
    if sides["client"] < SERVE_CLIENTS or sides["server"] < SERVE_CLIENTS:
        problems.append(f"heartbeats {dict(sides)}")
    if counters.get("net.admitted_ops") != r["server"]["admitted_ops"] \
            or r["server"]["admitted_ops"] != r["minted"]:
        problems.append(f"net.admitted_ops {counters.get('net.admitted_ops')}"
                        f" against {r['server']['admitted_ops']} admitted, "
                        f"{r['minted']} minted")
    if "net.connections" not in gauges:
        problems.append("no net.connections gauge")
    if names["net.nack"] != nacks or sum(
            e["fields"]["ops"] for e in evs if e["name"] == "net.shed") \
            != shed:
        problems.append(f"{names['net.nack']} net.nack for {nacks} nacks, "
                        f"net.shed against {shed} shed ops")
    fold = journey.JourneyFold(retain_all=True)
    fold.feed_many(recs)
    mints = [e["fields"] for e in evs if e["name"] == "xtrace.hop"
             and e["fields"]["hop"] == "mint"
             and str(e["fields"].get("client", "")).startswith("wire-")]
    agreed = {e["fields"]["uuid"] for e in evs
              if e["name"] == "wave.digest" and e["fields"].get("agreed")}
    batches = SERVE_OFFERS + 1
    if len(mints) != batches:
        problems.append(f"{len(mints)} minted traces for {batches} batches")
    need = ("mint", "send", "recv", "admit", "journal", "tick", "wave")
    hops, orphans = Counter(), 0
    for m in mints:
        j = fold.journey(m["trace"])
        got = [h["hop"] for h in j["hops"]] if j else []
        hops.update(set(got))
        orphans += j["orphans"] if j else 1
        if not j or [h for h in need if h not in got] \
                or m["uuid"] not in agreed:
            problems.append(f"trace {m['trace']}: hops {got}, tenant "
                            f"{m['uuid']} agreed {m['uuid'] in agreed}")
            break
    if orphans:
        problems.append(f"{orphans} orphan hops")
    if problems:
        fail(f"{tag}: " + "; ".join(problems))
    return {"events": names, "heartbeats": dict(sides),
            "admitted": counters.get("net.admitted_ops"),
            "journeys": len(mints), "hops": dict(hops), "nacks": nacks,
            "shed": shed}


def check_dashboard(tag: str, port: int) -> str:
    """``watch --collector --once --json`` in a subprocess: exit 0, the
    serve, net and ship sections active and rendered, no alert outside
    WIRE_ALERTS; then ``watch --serve-port`` in a subprocess, whose
    ``/metrics`` must carry the ship, net and serve families."""
    import socket
    import urllib.request

    from cause_tpu_torch.obs import watch

    addr = f"127.0.0.1:{port}"
    out = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.obs", "watch",
         "--collector", addr, "--once", "--json"],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT,
        env=no_obs_env())
    if out.returncode:
        fail(f"{tag}: watch --once exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    doc = json.loads(out.stdout)
    snap, alerts = doc["snapshot"], doc["alerts"]
    text = watch.render(snap, alerts, [addr])
    lines = {ln.split(":")[0].strip() for ln in text.splitlines()}
    missing = [s for s in ("serve", "net", "ship")
               if not (snap.get(s) or {}).get("active") or s not in lines]
    extra = [a["rule"] for a in alerts if a["rule"] not in WIRE_ALERTS]
    if missing or extra or snap["alerts_total"] > len(alerts):
        fail(f"{tag}: watch --once: sections missing {missing}, alerts "
             f"{[a['rule'] for a in alerts]} ({snap['alerts_total']} in "
             f"all; expected only {WIRE_ALERTS})")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "cause_tpu_torch.obs", "watch",
         "--collector", addr, "--serve-port", str(mport), "--json",
         "--interval", "0.25", "--duration", "120"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        env=no_obs_env(), cwd=REPO_ROOT)
    families = ("cause_tpu_live_ship_", "cause_tpu_live_net_",
                "cause_tpu_live_serve_")
    body = ""
    try:
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                body = urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/metrics", timeout=10
                ).read().decode()
            except OSError:
                body = ""
            if all(f in body for f in families):
                break
            time.sleep(0.25)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    if not all(f in body for f in families):
        fail(f"{tag}: /metrics lacks {[f for f in families if f not in body]}"
             f": {body[:500]!r} {proc.stderr.read().decode()[-1000:]}")
    return (f"watch --once: sections {sorted(lines & {'serve', 'net', 'ship'})}"
            f", alerts {[a['rule'] for a in alerts]}; /metrics "
            f"{len(body.splitlines())} lines with the ship, net and serve "
            f"families")


def tick_line(r) -> str:
    ms = [t["ms"] for t in r["ticks"]]
    return (f"p50 {float(np.median(ms)):.3f} ms, p99 "
            f"{float(np.percentile(ms, 99)):.3f} ms over {len(ms)} ticks "
            f"{[round(t, 3) for t in ms]}")


def phase_wire(torch, dev, card: str, tenants) -> dict:
    """Phase 12: one offered round of phase 10's fleet over the wire,
    telemetry off and then shipped to a collector process, then again
    under ship faults. Returns the shipped run's launch counts."""
    import tempfile

    from cause_tpu_torch import chaos

    tag = "[12 wire]"
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="wire-smoke-")
    col = CollectorProcess(os.path.join(tmp.name, "collector"), tag)
    t_col = time.perf_counter() - t_phase
    try:
        obs_fresh()
        off = wire_round(torch, os.path.join(tmp.name, "off"), tenants,
                         f"{tag} off")
        on = shipped_round(torch, tmp.name, "on", tenants, col.port, tag)
        origins_on = col.snap()["origins"]
        t0 = time.perf_counter()
        dash = check_dashboard(tag, col.port)
        t_dash = time.perf_counter() - t0
        chaos.configure(plan=WIRE_CHAOS, enabled=True)
        try:
            faulty = shipped_round(torch, tmp.name, "faults", tenants,
                                   col.port, tag)
            injected = [f["mode"] for f in chaos.injected()
                        if f["family"] == "ship"]
        finally:
            chaos.reset()
        snap = col.snap()
    finally:
        col.stop()
        obs_fresh()
    keys = ("ops", "tenants", "depth", "buckets", "batch_rows")
    for name, r in (("on", on), ("faults", faulty)):
        if r["counts"] != off["counts"]:
            fail(f"{tag} {name}: launches {r['counts']} against "
                 f"{off['counts']} with telemetry off")
        if r["digests"] != off["digests"]:
            fail(f"{tag} {name}: tenant digests differ from the run with "
                 f"telemetry off")
        if [{k: t["summary"][k] for k in keys} for t in r["ticks"]] != \
                [{k: t["summary"][k] for k in keys} for t in off["ticks"]]:
            fail(f"{tag} {name}: the ticks drained or dispatched "
                 f"differently")
    if not all(off["counts"][n] for n in V5_LAUNCHES):
        fail(f"{tag}: the round launched no B1-B3 kernel: {off['counts']}")
    archive = col.records()
    got_on = check_shipped(f"{tag} on", on, archive, origins_on)
    got_f = check_shipped(f"{tag} faults", faulty, archive,
                          snap["origins"])
    ev = check_wire_events(f"{tag} on", on, [x for _ts, x in got_on])
    check_wire_events(f"{tag} faults", faulty, [x for _ts, x in got_f])
    (org_f,) = [o for o in snap["origins"]
                if o["epoch"] == faulty["exp"].epoch]
    if sorted(set(injected)) != ["dup", "reorder"] \
            or not org_f["dup_records"] or snap["ship"]["unexplained_gaps"]:
        fail(f"{tag} faults: injected {injected}, the collector skipped "
             f"{org_f['dup_records']} duplicate records, "
             f"{snap['ship']['unexplained_gaps']} unexplained gaps")
    lags = [(adm - x["ts_us"]) / 1e3 for adm, x in got_on
            if isinstance(x.get("ts_us"), int)]
    nbytes = sum(len(json.dumps(x)) for _ts, x in got_on)
    exp = on["exp"]
    say(f"{tag} one offered round of {len(tenants)} tenants over the "
        f"wire ({SERVE_CLIENTS} clients, {SERVE_OFFERS} zipf-hot offers + "
        f"the {SERVE_BURST}-op burst, {on['minted']} ops), telemetry off, "
        f"shipped, and shipped under ship faults: the same launches "
        f"{off['counts']}, tick shapes and converged digests (the "
        f"{len(off['digests'])} tenants served or resident) in all three")
    say(f"{tag} host s a run (build = service + add_tenant, offer, ticks, "
        f"digests, close): "
        + "; ".join(f"{n} " + ", ".join(f"{k} {v:.2f}" for k, v
                                          in r["wall"].items())
                    for n, r in (("off", off), ("on", on),
                                 ("faults", faulty)))
        + f"; the collector process started in {t_col:.2f} s, the "
        f"dashboard checks {t_dash:.2f} s (host clock); {card}")
    say(f"{tag} ticks without the uplink {tick_line(off)}; with it "
        f"{tick_line(on)}; under ship faults {tick_line(faulty)} (host "
        f"clock, synchronized); {card}")
    say(f"{tag} shipped {len(got_on)} records ({nbytes} bytes of JSON) in "
        f"{exp.stats['sent_frames']} frames to the collector process, "
        f"every one accepted once: 0 missed, 0 dropped, 0 unshipped, the "
        f"set equal to the sidecar's from ship.attach on; emit to admit "
        f"p50 {float(np.median(lags)):.3f} ms, p99 "
        f"{float(np.percentile(lags, 99)):.3f} ms, max {max(lags):.3f} ms "
        f"(host clock); {card}")
    say(f"{tag} net evidence: {ev['events']['net.hello']} net.hello, "
        f"{ev['events']['net.connect']} net.connect, heartbeats "
        f"{ev['heartbeats']}, net.admitted_ops {ev['admitted']}, "
        f"{ev['nacks']} nacks, {ev['shed']} shed ops; {ev['journeys']} "
        f"journeys, each linked mint -> send -> recv -> admit -> journal "
        f"-> tick -> wave with its tenant's agreeing wave.digest, 0 "
        f"orphan hops")
    say(f"{tag} {dash}")
    say(f"{tag} ship faults {injected}: the collector skipped "
        f"{org_f['dup_records']} duplicate records and healed the "
        f"reordered frames ({len(got_f)} records accepted once, 0 missed, "
        f"0 unexplained gaps); phase {time.perf_counter() - t_phase:.1f} s "
        f"(host clock); {card}")
    tmp.cleanup()
    return on["counts"]



# --------------------------------------------------------------- main


# ------------------------------------------- 13. the older generations

# phase 13: the north-star pairs through v1-v4 (v1-v3's are cut first
# when the phase runs long; v4 always takes all of them), the ladder's
# trees (a list of appends whose cursor jumps every LADDER_JUMP ops; a
# set of LADDER_SET adds with every third discarded; LADDER_PASTES runs
# of LADDER_PASTE characters whose deleted ends are undeleted later),
# and the timed reps of each generation's scalar program
GEN_PAIRS = 1024
LADDER_LIST, LADDER_JUMP, LADDER_SET = 10_000, 3, 1_000
LADDER_PASTES, LADDER_PASTE = 10, 1_000
GEN_REPS = 3
# launches of one dispatch of each generation, and its sorts in call
# order (torchw, torchw3, torchw4)
GEN_LAUNCHES = {
    "v1": {"sort": 3}, "v2": {"sort": 3}, "v3": {"sort": 2},
    "v4": {"sort": 2, "euler_walk": 1}, "v4w": {"sort": 2, "euler_walk": 1},
}
GEN_SITES = {
    "v1": ("v1 id sort", "v1 sort-join", "v1 child sort"),
    "v2": ("v2 id sort", "v2 sort-join", "v2 run sort"),
    "v3": ("v3 id sort", "v3 run sort"),
    "v4": ("v4 id sort", "v4 run sort"),
    "v4w": ("v4w id sort", "v4w run sort"),
}
LADDER_SITE, LADDER_TWIN = "sLADDER000000", "sLADDERTWIN00"


def add_sums(total, per) -> None:
    """Add ``check_recorded``'s per-kernel sums into ``total``."""
    for kern, v in per.items():
        tot = total.setdefault(kern, {})
        for k, x in v.items():
            if isinstance(x, dict):  # B2's and B3's sums by form
                forms = tot.setdefault(k, {})
                for f, ms in x.items():
                    forms[f] = forms.get(f, 0.0) + ms
            else:
                tot[k] = tot.get(k, 0.0) + x


def ladder_trees():
    """Phase 13's ladder trees (pure-weaver handles, lazy lists), with
    the rung the ladder must take: ``{name: (handle, rung)}``. Built as
    ``tests/test_torch_ladder.py`` builds them, at full size."""
    import random

    import cause_tpu_torch as ct
    from cause_tpu_torch.collections import clist as c_list

    def fresh_list():
        h = c_list.CausalList(c_list.new_causal_tree("pure", lazy=True))
        return type(h)(h.ct.evolve(site_id=LADDER_SITE,
                                   uuid="ladderTreeUuid0000000"))

    rng = random.Random(5)
    h = fresh_list()
    ids, cursor = [ct.root_id], ct.root_id
    for i in range(LADDER_LIST):
        if i and i % LADDER_JUMP == 0:
            cursor = ids[rng.randrange(len(ids))]
        h = h.append(cursor, f"v{i}")
        cursor = (h.ct.lamport_ts, LADDER_SITE, 0)
        ids.append(cursor)
    jump = h

    h = ct.cset()
    h = type(h)(h.ct.evolve(site_id=LADDER_SITE,
                            uuid="ladderTreeUuid0000000"))
    for i in range(LADDER_SET):
        h = h.add(f"m{i}")
    for i in range(0, LADDER_SET, 3):
        h = h.discard(f"m{i}")
    discards = h

    h = fresh_list()
    prev_hide = None
    for r in range(LADDER_PASTES):
        cause = ct.root_id
        for i in range(LADDER_PASTE):
            h = h.append(cause, f"r{r}.{i}")
            cause = (h.ct.lamport_ts, LADDER_SITE, 0)
        h = h.append(cause, ct.hide)
        hide = (h.ct.lamport_ts, LADDER_SITE, 0)
        if prev_hide is not None:
            h = h.append(prev_hide, ct.h_show)
        prev_hide = hide
    return {
        f"list of {LADDER_LIST} appends, cursor jump every {LADDER_JUMP}":
            (jump, "v1"),
        f"set of {LADDER_SET} adds, every third discarded": (discards, "v1"),
        f"{LADDER_PASTES} pastes of {LADDER_PASTE}, ends undeleted later":
            (h, "v4"),
    }


def gen_north_star(torch, dev, batch, timed):
    """Phase 13, step 1: the north-star batch through v1, v2, v3, v4 and
    v4w on the card: each dispatch's launches, 0 overflowed rows, the
    five bit-identical (v1 the oracle), each bit-identical to its plain
    path with every kernel call checked and timed once a shape, and the
    p50 of each generation's ``merge_wave_scalar``. Returns the phase's
    launches, ``check_recorded``'s sums, v4's recorded calls and the
    scalar p50s (ms, host clock) by generation."""
    from cause_tpu_torch import benchgen, kernels
    from cause_tpu_torch.weaver import torchw, torchw3, torchw4

    tag = "[13 generations]"
    k_max = benchgen.pair_run_budget(batch)
    B = batch["hi"].shape[0]
    cut = min(GEN_PAIRS, B)

    def upload(keys, rows):
        return [torch.from_numpy(np.ascontiguousarray(batch[k][:rows])).to(
            dev, dtype=torch.bool if k == "valid" else torch.int32)
            for k in keys]

    a1 = upload(benchgen.LANE_KEYS, cut)
    a4 = upload(benchgen.LANE_KEYS4, B)
    runs = {
        "v1": (lambda: torchw.batched_merge_weave(*a1, device=dev), a1, 0),
        "v2": (lambda: torchw.batched_merge_weave_v2(
            *a1, k_max=k_max, device=dev), a1, k_max),
        "v3": (lambda: torchw3.batched_merge_weave_v3(
            *a1, k_max=k_max, device=dev), a1, k_max),
        "v4": (lambda: torchw4.batched_merge_weave_v4(
            *a4, k_max=k_max, device=dev), a4, k_max),
        "v4w": (lambda: torchw4.batched_merge_weave_v4(
            *a4, k_max=k_max, euler="walk", device=dev), a4, k_max),
    }
    counts = {n: 0 for n in kernels.SOURCES}
    per, outs, v4_calls = {}, {}, []
    for name, (run, args, _k) in runs.items():
        with launches_in() as got:
            out, ms = timed_ms(torch, run)
        expect_launches(got, GEN_LAUNCHES[name], f"{tag} {name}")
        for k, v in got.items():
            counts[k] += v
        if name != "v1" and bool(out[4].any()):
            fail(f"{tag} {name}: {int(out[4].sum())} rows overflowed "
                 f"k_max={k_max}")
        outs[name] = out[:4]
        say(f"{tag} {name}: B={args[0].shape[0]} M={args[0].shape[1]} "
            f"k_max={k_max}: first dispatch {ms:.3f} ms (host clock, "
            f"synchronized), launches {got}, 0 overflowed rows")
        calls = []
        with plain_path(record=calls):
            ref = run()
        for nm, g, w in zip(("order", "rank", "visible", "conflict"),
                            out, ref):
            if not torch.equal(g, w):
                fail(f"{tag} {name}: {nm} differs from the plain path")
        add_sums(per, check_recorded(torch, calls, f"{tag} {name}",
                                     sites=GEN_SITES[name], timed=timed))
        if name == "v4":
            v4_calls = calls
        del ref, calls
    for name in ("v2", "v3", "v4", "v4w"):
        for nm, g, w in zip(("order", "rank", "visible", "conflict"),
                            outs[name], outs["v1"]):
            if not torch.equal(g[:cut], w):
                fail(f"{tag} {name}: {nm} differs from v1's")
    say(f"{tag} order, rank, visible and conflict bit-identical across v1, "
        f"v2, v3, v4 and v4w (first {cut} rows) and each to its plain path "
        f"on the card; conflicts {int(outs['v1'][3].sum())}")
    del outs

    # each generation's timed program: the scalar, p50 of GEN_REPS
    p50s = {}
    for name, (_run, args, k) in runs.items():
        def scalar():
            return benchgen.merge_wave_scalar(
                *args, k_max=k, kernel=name, device=dev).cpu()
        val = scalar()  # warm
        times = [timed_ms(torch, scalar)[1] for _ in range(GEN_REPS)]
        p50s[name] = float(np.median(times))
        say(f"{tag} merge_wave_scalar {name} at B={args[0].shape[0]}: "
            f"p50 {float(np.median(times)):.3f} ms "
            f"({[round(t, 3) for t in times]}; host clock, synchronized), "
            f"value {val.tolist()}")
    if cut < B:
        say(f"{tag} CUT: v1-v3 ran {cut} of {B} pairs (GEN_PAIRS) to keep "
            f"the phase near 60 s; v4 and v4w ran all {B}")
    return counts, per, v4_calls, p50s


def gen_ladder(torch, timed):
    """Phase 13, step 2: the ladder's trees as ``weaver="torch"``
    handles on the card: the reweave and the merge with a twin each take
    the rung the tree needs (launches: v1 one B1 sort, v4 v5's 6/1/1
    and its A1 launch, then 2/1/0), equal the pure weaver's weave and
    merge, and leave ``pure_fallbacks`` where it was; the reweave again
    on the plain path, every kernel call of it checked and timed once a
    shape. Returns the launches and ``check_recorded``'s sums."""
    from cause_tpu_torch.collections import clist as c_list
    from cause_tpu_torch.weaver import torchw

    tag = "[13 ladder]"
    want_launches = {"v1": {"sort": 1},
                     "v4": {"sort": 8, "euler_walk": 2, "fphase": 1,
                            "seg_order": 1}}
    sites = {"v1": ("ladder v1 child sort",),
             "v4": SORT_SITES + ("ladder v4 id sort", "ladder v4 run sort")}
    counts, per = {}, {}
    t0 = time.perf_counter()
    trees = ladder_trees()
    say(f"{tag} {len(trees)} trees built in {time.perf_counter() - t0:.1f} "
        f"s (host clock)")
    fallbacks0 = torchw.pure_fallbacks
    for name, (h, rung) in trees.items():
        t0 = time.perf_counter()
        pure_ct = c_list.weave(h.ct.evolve(weaver="pure", lazy_weave=False))
        pure = type(h)(pure_ct)
        twin = type(h)(pure_ct.evolve(site_id=LADDER_TWIN))
        twin = twin.add("twin") if hasattr(twin, "add") else \
            twin.conj("twin")
        want_m = pure.merge(twin)
        pure_s = time.perf_counter() - t0
        with launches_in() as got:
            woven, rw_ms = timed_ms(torch, lambda: torchw.refresh_list_weave(
                h.ct.evolve(weaver="torch", lazy_weave=False)))
        expect_launches(got, want_launches[rung], f"{tag} {name} reweave")
        if woven.weave != pure_ct.weave:
            fail(f"{tag} {name}: the device reweave differs from the pure "
                 f"weave")
        a = type(h)(pure_ct.evolve(weaver="torch"))
        b = type(h)(twin.ct.evolve(weaver="torch"))
        with launches_in() as got_m:
            merged, mg_ms = timed_ms(torch, lambda: a.merge(b))
        expect_launches(got_m, want_launches[rung], f"{tag} {name} merge")
        if merged.get_weave() != want_m.get_weave() \
                or merged.causal_to_edn() != want_m.causal_to_edn():
            fail(f"{tag} {name}: the device merge differs from the pure "
                 f"merge")
        for k in set(got) | set(got_m):
            counts[k] = counts.get(k, 0) + got.get(k, 0) + got_m.get(k, 0)
        calls = []
        with plain_path(record=calls):
            woven_p = torchw.refresh_list_weave(
                h.ct.evolve(weaver="torch", lazy_weave=False))
        if woven_p.weave != woven.weave:
            fail(f"{tag} {name}: the reweave differs from the plain path")
        add_sums(per, check_recorded(torch, calls, f"{tag} {name}",
                                     sites=sites[rung], timed=timed))
        say(f"{tag} {name}: {len(h.ct.nodes)} nodes, rung {rung}; reweave "
            f"{rw_ms:.3f} ms, merge with a twin {mg_ms:.3f} ms (host clock, "
            f"synchronized), launches {got} each; both equal the pure "
            f"weaver's ({pure_s:.1f} s on the host)")
    if torchw.pure_fallbacks != fallbacks0:
        fail(f"{tag} a tree went to the pure weaver")
    say(f"{tag} 0 trees to the pure weaver")
    return counts, per


def gen_map_v4(torch, dev, timed):
    """Phase 13, step 3: config 6's own map wave through the v4 route:
    launches a dispatch, ``merged(i)`` and digests equal to the v5
    route's, the plain path bit-identical with every kernel call checked
    and timed, the wave's p50."""
    import cause_tpu_torch as ct

    tag = "[13 maps v4]"
    _base, pairs = map_fleet(MAP_SMALL, 24, 1, 12, 4, 0)
    res5 = ct.merge_map_wave(pairs, device=dev)
    with launches_in() as got:
        res4, ms = timed_ms(torch, lambda: ct.merge_map_wave(
            pairs, "v4", device=dev))
    expect_launches(got, {"sort": 2, "euler_walk": 1}, f"{tag} wave")
    if res4.fallback or not res4.digest_valid.all():
        fail(f"{tag} rows to the host merge: {res4.fallback}")
    if not np.array_equal(res4.digest, res5.digest):
        fail(f"{tag} digests differ from the v5 route's")
    for i in range(len(pairs)):
        if res4.merged(i).ct.weave != res5.merged(i).ct.weave:
            fail(f"{tag} merged({i}) differs from the v5 route's")
    calls = []
    with plain_path(record=calls):
        res_p = ct.merge_map_wave(pairs, "v4", device=dev)
    for nm, g, w in (("order", res4._order, res_p._order),
                     ("rank", res4._rank, res_p._rank),
                     ("visible", res4._visible, res_p._visible),
                     ("digest", res4.digest, res_p.digest)):
        if not np.array_equal(g, w):
            fail(f"{tag} {nm} differs from the plain path")
    per = check_recorded(torch, calls, tag,
                         sites=("map v4 id sort", "map v4 run sort"),
                         timed=timed)
    times = [timed_ms(torch, lambda: ct.merge_map_wave(
        pairs, "v4", device=dev))[1] for _ in range(GEN_REPS)]
    N = res4._rank.shape[1]
    say(f"{tag} {len(pairs)} pairs, N={N} lanes a row, k_max={N}: first "
        f"wave {ms:.3f} ms, p50 {float(np.median(times)):.3f} ms "
        f"({[round(t, 3) for t in times]}; host clock, synchronized), "
        f"launches {got}; digests and all {len(pairs)} merged(i) equal the "
        f"v5 route's")
    return got, per


def gen_matrix_sort(torch, v4_calls):
    """Phase 13, step 4: ``matrix_sort`` on the card on v4's recorded
    contracted-sort rows, against B1 on the same rows."""
    from cause_tpu_torch.weaver.bitonic import sort_pairs_cuda
    from cause_tpu_torch.weaver.matsort import matrix_sort

    sorts = [(ops, kw) for name, ops, kw in v4_calls if name == "sort"]
    ops, kw = sorts[-1]  # the run sort, after the id sort
    got = matrix_sort(ops, **kw)
    want = sort_pairs_cuda(ops, **kw)
    err = max_err(torch, got, want)
    if err:
        fail(f"[13 matrix_sort] differs from B1 (max_abs_err {err})")
    ms = cuda_ms(torch, lambda: matrix_sort(ops, **kw), reps=3, warm=1)
    say(f"[13 matrix_sort] v4 run-sort rows {tuple(ops[0].shape)} "
        f"n_ops={len(ops)} {kw}: equal to B1 (max_abs_err 0), {ms:.4f} ms "
        f"(CUDA events, mean of 3)")


def phase_generations(torch, dev, card: str, batch) -> tuple:
    """Phase 13: the older weaver generations (v1-v4), the ladder, the
    v4 map route and ``matrix_sort`` on the card. Returns the phase's
    launches, ``check_recorded``'s per-kernel sums and each generation's
    ``merge_wave_scalar`` p50."""
    from cause_tpu_torch import kernels

    t_phase = time.perf_counter()
    timed = set()
    counts, per, v4_calls, p50s = gen_north_star(torch, dev, batch, timed)
    for got, step_per in (gen_ladder(torch, timed),
                          gen_map_v4(torch, dev, timed)):
        for k, v in got.items():
            counts[k] += v
        add_sums(per, step_per)
    gen_matrix_sort(torch, v4_calls)
    del v4_calls
    expect_launches(counts, tuple(V5_LAUNCHES), "[13 generations]")
    say(f"[13 generations] launches over the phase {counts}; kernels at "
        f"the phase's distinct shapes: {kernel_sums_line(per)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s (host clock); {card}")
    return {n: counts.get(n, 0) for n in kernels.SOURCES}, per, p50s


# ------------------------------------------- 14. the benchmark CLI

# phase 14: config 5's timed reps at the north star (each run is one
# warm step and BENCH_REPS timed ones), the CLI's own time limit, and the
# keys of a benchmark record and of the native skip record
BENCH_REPS = 3
BENCH_CLI_TIMEOUT = 600
BENCH_KEYS = {"config", "metric", "weaver", "value", "unit"}
BENCH_SKIP_KEYS = {"config", "weaver", "skipped"}
# the B1-B3 kernels' names in a torch.profiler trace (csrc/)
BENCH_KERNEL_NAMES = {"sort": "sort_rows_", "euler_walk": "euler_walk_",
                      "fphase": "fphase_row_kernel"}
# launches of one config-5 step of each kernel, and its sorts in order
BENCH_LAUNCHES = {"v5": V5_LAUNCHES, "v4": GEN_LAUNCHES["v4"]}
BENCH_SITES = {"v5": SORT_SITES, "v4": GEN_SITES["v4"]}


def bench_cli() -> list:
    """Phase 14, step (a): ``python -m cause_tpu_torch.benchmarks`` in a
    subprocess with every config at its defaults: exit 0, one JSON
    record a line with the reference's keys, configs 1-4 under ``pure``
    and ``native`` (or native's skip record), config 1's bulk and lazy
    rows, one config 5 row (``torch-v4``) and config 6's two
    (``torch-v5``, ``torch-v4``). Returns the records."""
    tag = "[14 benchmarks cli]"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.benchmarks"], cwd=root,
        capture_output=True, text=True, timeout=BENCH_CLI_TIMEOUT)
    secs = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"{tag} exited {out.returncode}: {out.stderr[-2000:]}")
    recs = bench_cli_rows(out.stdout)
    say(f"{tag} {len(recs)} records, each with the reference's keys; "
        f"configs 1-4 under pure and native (or its skip record), config "
        f"1's bulk and lazy rows, config 5 torch-v4, config 6 torch-v5 and "
        f"torch-v4; {secs:.1f} s (host clock, the subprocess's start "
        f"included)")
    return recs


def bench_cli_rows(stdout: str) -> list:
    """The CLI's records from its output, each checked: one JSON object
    a line with the reference's keys, and the rows ``bench_cli`` names,
    in the CLI's order."""
    tag = "[14 benchmarks cli]"
    recs = []
    for line in stdout.strip().splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            fail(f"{tag} a line is not JSON: {line!r}")
        if set(rec) not in (BENCH_KEYS, BENCH_SKIP_KEYS):
            fail(f"{tag} a record's keys {sorted(rec)} are not the "
                 f"reference's")
        recs.append(rec)
        say(f"{tag} {json.dumps(rec)}")
    rows = [(r["config"], r["weaver"], r.get("metric", "skipped").split(
        " x")[0].split(",")[0]) for r in recs]
    native_skipped = any("skipped" in r for r in recs)
    want = []
    for num in (1, 2, 3, 4):
        for w in ("pure", "native"):
            if w == "native" and native_skipped:
                want.append((num, w, "skipped"))
                continue
            name = {1: "append-only conj", 2: "3-site concurrent insert+hide",
                    3: "map overwrite+undo/redo",
                    4: "base rich-text doc"}[num]
            want.append((num, w, name))
            if num == 1:
                want.append((1, w, "bulk extend"))
        if num == 1:
            want.append((1, "lazy+native" if not native_skipped
                         else "lazy+torch", "lazy conj"))
    want += [(5, "torch-v4", "batched merge"),
             (6, "torch-v5", "map fleet wave"),
             (6, "torch-v4", "map fleet wave")]
    if rows != want:
        fail(f"{tag} rows {rows}, expected {want}")
    if any(r.get("value", 1) <= 0 for r in recs):
        fail(f"{tag} a record's value is not positive")
    return recs


def bench_north_star(torch, dev, kernel: str, timed) -> tuple:
    """Phase 14, step (b): config 5 in-process at the north star (1,024
    pairs of 10,000-node lists) with ``kernel``: the launches of each
    step (a warm step and ``BENCH_REPS`` timed), every step's
    ``[checksum, overflowed]`` equal to one plain-path step on the card
    with 0 overflowed rows, and every kernel call of that plain step
    held against its plain version. Returns (record, launches, the
    per-kernel sums of ``check_recorded``)."""
    from cause_tpu_torch import benchgen, benchmarks

    tag = f"[14 benchmarks config 5 {kernel}]"
    steps = []
    real = benchgen.merge_wave_scalar

    def recorded(*args, **kw):
        out = real(*args, **kw)
        steps.append((args, kw, out.clone()))
        return out

    benchgen.merge_wave_scalar = recorded
    try:
        with launches_in() as got:
            rec = benchmarks.config5_batched_merge(
                n_replicas=PAIRS, n_base=N_BASE, n_div=N_DIV, cap=CAP,
                reps=BENCH_REPS, kernel=kernel, device=dev)
    finally:
        benchgen.merge_wave_scalar = real
    n = 1 + BENCH_REPS
    if len(steps) != n:
        fail(f"{tag} {len(steps)} steps, expected {n}")
    expect_launches(got, {k: v * n for k, v in
                          BENCH_LAUNCHES[kernel].items()},
                    f"{tag} {n} steps")
    args, kw, _out = steps[0]
    calls = []
    with plain_path(record=calls):
        want = real(*args, **kw)
    torch.cuda.synchronize()
    for i, (_a, _k, out) in enumerate(steps):
        if not torch.equal(out, want):
            fail(f"{tag} step {i}'s [checksum, overflowed] "
                 f"{out.tolist()} differs from the plain path's "
                 f"{want.tolist()}")
    if int(want[1]) != 0:
        fail(f"{tag} {int(want[1])} rows overflowed")
    per = check_recorded(torch, calls, tag, sites=BENCH_SITES[kernel],
                         timed=timed)
    B, M = args[0].shape
    say(f"{tag} B={B} M={M} k_max={kw['k_max']} u_max={kw['u_max']}: "
        f"{n} steps, launches {got} ({BENCH_LAUNCHES[kernel]} a step); "
        f"every step's [checksum, overflowed] {want.tolist()} equals the "
        f"plain path's on the card (exact), 0 overflowed rows; reported "
        f"{rec['value']:.3f} ms ({rec['weaver']}, best of {BENCH_REPS}, "
        f"host clock, the copy to the host included)")
    return rec, got, per


def bench_profile(torch) -> None:
    """Phase 14, step (c): ``--profile DIR`` on config 5 (the CLI's v4)
    and on config 5 with ``kernel="v5"`` at the CLI's default size: each
    writes a torch.profiler trace, and the kernels of its path appear in
    it by name (B1 and B2; B1, B2 and B3)."""
    import tempfile

    from cause_tpu_torch import benchmarks

    tag = "[14 benchmarks profile]"
    with tempfile.TemporaryDirectory() as tmp:
        benchmarks.main(["-c", "5", "--profile", os.path.join(tmp, "v4")])
        benchmarks.config5_batched_merge(
            kernel="v5", profile_dir=os.path.join(tmp, "v5"))
        for kernel, want in (("v4", ("sort", "euler_walk")),
                             ("v5", ("sort", "euler_walk", "fphase"))):
            trace = os.path.join(tmp, kernel, "config5.json")
            with open(trace) as f:
                names = [e["name"] for e in json.load(f)["traceEvents"]
                         if e.get("cat") == "kernel"]
            seen = {k: sum(BENCH_KERNEL_NAMES[k] in nm for nm in names)
                    for k in want}
            if not all(seen.values()):
                fail(f"{tag} config 5 {kernel}'s trace lacks a kernel of "
                     f"its path: {seen}")
            say(f"{tag} config 5 {kernel}: the trace holds {len(names)} "
                f"device kernels; of the port's, by name: {seen}")


def phase_benchmarks(torch, dev, card: str, k_p50: float,
                     gen_p50: dict) -> tuple:
    """Phase 14: the benchmark CLI in a subprocess, config 5 at the north
    star through v5 and v4 (its reported ms beside phase 3's dispatch
    p50 ``k_p50`` and phase 13's scalar p50s ``gen_p50``), and
    ``--profile``. Returns the phase's launches (step b) and
    ``check_recorded``'s per-kernel sums."""
    from cause_tpu_torch import kernels

    t_phase = time.perf_counter()
    bench_cli()
    timed, counts, per = set(), {n: 0 for n in kernels.SOURCES}, {}
    for kernel in ("v5", "v4"):
        rec, got, step_per = bench_north_star(torch, dev, kernel, timed)
        for k, v in got.items():
            counts[k] += v
        add_sums(per, step_per)
        beside = (f"phase 13's merge_wave_scalar v4 p50 "
                  f"{gen_p50['v4']:.3f} ms" if kernel == "v4" else
                  f"phase 3's v5 dispatch p50 {k_p50:.3f} ms (no scalar)")
        say(f"[14 benchmarks] config 5 {kernel} at the north star: "
            f"{rec['value']:.3f} ms beside {beside}")
    bench_profile(torch)
    say(f"[14 benchmarks] launches over step (b) {counts}; kernels at the "
        f"phase's distinct shapes: {kernel_sums_line(per)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s (host clock); {card}")
    return counts, per


# ------------------------------------------- 15. the sharded path

# phase 15: timed reps of each sharded step and of its unsharded
# dispatch (taken in turns), the dry run's CPU ranks (run in a
# subprocess) and that subprocess's time limit
SHARD_REPS = 3
SHARD_DRYRUN_RANKS = 4
SHARD_DRYRUN_TIMEOUT = 600
# launches of one step of each generation, and its sorts in call order
SHARD_STEPS = ("v1", "v2", "v3", "v4", "v5", "v5f")
SHARD_LAUNCHES = {**{n: GEN_LAUNCHES[n] for n in SHARD_STEPS[:4]},
                  "v5": V5_LAUNCHES, "v5f": V5F_LAUNCHES}
SHARD_SITES = {**{n: GEN_SITES[n] for n in SHARD_STEPS[:4]},
               "v5": SORT_SITES, "v5f": ("A segments", "F coverage")}
# the per-row outputs a sharded step leads with, and the outputs of its
# unsharded dispatch, by name
SHARD_ROWS = {**dict.fromkeys(SHARD_STEPS[:4], ("order", "rank", "visible")),
              "v5": ("rank", "visible", "overflow"),
              "v5f": ("rank", "visible", "overflow")}
SHARD_UNSHARDED = {
    "v1": ("order", "rank", "visible", "conflict"),
    **dict.fromkeys(("v2", "v3", "v4"),
                    ("order", "rank", "visible", "conflict", "overflow")),
    "v5": ("rank", "visible", "digest", "overflow"),
    "v5f": ("rank", "visible", "digest", "overflow", "conflict"),
}


def shard_mesh(torch, dev):
    """Phase 15, step (a): ``make_mesh()`` on the card (world 1, NCCL)
    and the communicator's first collective, each timed."""
    import torch.distributed as dist

    from cause_tpu_torch.parallel import make_mesh

    tag = "[15 sharded]"
    mesh, start_ms = timed_ms(torch, make_mesh)
    x = torch.ones(1, dtype=torch.int32, device=dev)
    _, first_ms = timed_ms(torch, lambda: dist.all_reduce(
        x, group=mesh.get_group()))
    _, next_ms = timed_ms(torch, lambda: dist.all_reduce(
        x, group=mesh.get_group()))
    if (dist.get_backend() != "nccl" or mesh.size() != 1
            or mesh.device_type != "cuda" or int(x) != 1):
        fail(f"{tag} make_mesh(): backend {dist.get_backend()}, world "
             f"{mesh.size()}, device type {mesh.device_type}, sum {int(x)}")
    say(f"{tag} make_mesh(): backend {dist.get_backend()}, world "
        f"{mesh.size()}, axis {mesh.mesh_dim_names}; group start "
        f"{start_ms:.3f} ms, first all_reduce {first_ms:.3f} ms (the "
        f"NCCL communicator's start), the next {next_ms:.3f} ms (host "
        f"clock, synchronized)")
    return mesh


def shard_steps(torch, dev, mesh, batch, v5, u_max):
    """Phase 15, step (b): the north-star batch through every sharded
    step at world 1 (v1 at k_max = 0; v2, v3 and v4 at
    ``pair_run_budget``; v5 and v5f at ``u_max``). Each step launches
    what its unsharded dispatch launches (the table), gives its order
    (v1-v4), rank, visibility, overflow and totals bit-identical to that
    dispatch and digests equal to the v5 dispatch's, 0 overflowed rows
    and conflicts, and is bit-identical to its plain path with every
    kernel call checked; p50s of the sharded step and of the unsharded
    dispatch, taken in turns. Returns the launches and
    ``check_recorded``'s sums."""
    import cause_tpu_torch as ct
    from cause_tpu_torch import benchgen, kernels
    from cause_tpu_torch.parallel import mesh as pm
    from cause_tpu_torch.weaver import torchw, torchw3, torchw4

    tag = "[15 sharded]"
    k_max = benchgen.pair_run_budget(batch)

    def upload(keys):
        return [torch.from_numpy(np.ascontiguousarray(batch[k])).to(
            dev, dtype=torch.bool if k == "valid" else torch.int32)
            for k in keys]

    a1, a4 = upload(benchgen.LANE_KEYS), upload(benchgen.LANE_KEYS4)
    t5 = benchgen.lanes_from_numpy(v5, dev)
    args5 = [t5[k] for k in benchgen.LANE_KEYS5]

    def v5f_unsharded():
        r, v, c, ov = ct.batched_merge_weave_v5f(
            *args5, u_max=u_max, k_max=u_max, device=dev)
        return r, v, pm.replica_digest(args5[0], args5[1], r, v), ov, c

    # name: (sharded step, its unsharded dispatch)
    steps = {
        "v1": (lambda: pm.sharded_merge_weave(mesh, *a1),
               lambda: torchw.batched_merge_weave(*a1, device=dev)),
        "v2": (lambda: pm.sharded_merge_weave(mesh, *a1, k_max, "v2"),
               lambda: torchw.batched_merge_weave_v2(*a1, k_max=k_max,
                                                     device=dev)),
        "v3": (lambda: pm.sharded_merge_weave(mesh, *a1, k_max, "v3"),
               lambda: torchw3.batched_merge_weave_v3(*a1, k_max=k_max,
                                                      device=dev)),
        "v4": (lambda: pm.sharded_merge_weave_v4(mesh, *a4, k_max),
               lambda: torchw4.batched_merge_weave_v4(*a4, k_max=k_max,
                                                      device=dev)),
        "v5": (lambda: pm.sharded_merge_weave_v5(mesh, t5, u_max, u_max),
               lambda: ct.batched_weave_digest(*args5, u_max=u_max,
                                               k_max=u_max, device=dev)),
        "v5f": (lambda: pm.sharded_merge_weave_v5(mesh, t5, u_max, u_max,
                                                  "v5f"), v5f_unsharded),
    }
    counts = {n: 0 for n in kernels.SOURCES}
    per, digests, timed = {}, {}, set()
    for name in SHARD_STEPS:
        sharded, unsharded = steps[name]
        with launches_in() as got:
            out, ms = timed_ms(torch, sharded)
        expect_launches(got, SHARD_LAUNCHES[name], f"{tag} {name} step")
        with launches_in() as got_u:
            ref = unsharded()
        if got_u != got:
            fail(f"{tag} {name}: the step launched {got}, its unsharded "
                 f"dispatch {got_u}")
        for k, v in got.items():
            counts[k] += v
        got_rows = dict(zip(SHARD_ROWS[name], out[:3]))
        want = dict(zip(SHARD_UNSHARDED[name], ref))
        if name == "v5":
            digests["unsharded v5"] = want["digest"]
        for nm, g in got_rows.items():
            if not torch.equal(g, want[nm]):
                fail(f"{tag} {name}: {nm} differs from the unsharded "
                     f"dispatch's")
        totals = [int(t) for t in out[4:]]
        want_totals = [int(want[k].sum()) if k in want else 0
                       for k in ("visible", "conflict", "overflow")]
        if totals != want_totals or totals[1] or totals[2]:
            fail(f"{tag} {name}: totals (visible, conflicts, overflow) "
                 f"{totals}, the unsharded dispatch's {want_totals}; 0 "
                 f"conflicts and 0 overflowed rows expected")
        del ref, want, got_rows
        calls = []
        with plain_path(record=calls):
            plain = sharded()
        for i, (g, w) in enumerate(zip(out, plain)):
            if not torch.equal(g, w):
                fail(f"{tag} {name}: output {i} differs from the plain "
                     f"path")
        del plain
        add_sums(per, check_recorded(torch, calls, f"{tag} {name}",
                                     sites=SHARD_SITES[name], timed=timed))
        del calls
        digests[name] = out[3]
        del out
        ts, tu = [], []
        for _ in range(SHARD_REPS):
            ts.append(timed_ms(torch, sharded)[1])
            tu.append(timed_ms(torch, unsharded)[1])
        ps, pu = float(np.median(ts)), float(np.median(tu))
        say(f"{tag} {name}: B={a1[0].shape[0]} launches {got} (the "
            f"unsharded dispatch's), bit-identical to it and to the plain "
            f"path; totals {totals}; first step {ms:.3f} ms; p50 sharded "
            f"{ps:.3f} ms, unsharded {pu:.3f} ms, difference "
            f"{ps - pu:+.3f} ms ({[round(t, 3) for t in ts]} / "
            f"{[round(t, 3) for t in tu]}; host clock, synchronized, "
            f"{SHARD_REPS} reps in turns)")
    want = digests["unsharded v5"]
    for name in SHARD_STEPS:
        if not torch.equal(digests[name], want):
            fail(f"{tag} {name}: digests differ from the v5 dispatch's")
    say(f"{tag} the digests of all six steps equal the unsharded v5 "
        f"dispatch's (batched_weave_digest): {len(set(want.tolist()))} "
        f"distinct of {want.shape[0]}")
    return counts, per


def shard_wave(torch, mesh, pairs, wave_digest):
    """Phase 15, step (c): ``merge_wave(pairs, mesh)`` over the API
    wave's pairs under ``BENCH_KERNEL`` v5 and v5f: the unsharded wave's
    launches and digests (phase 4's), no fallback, every ``merged(i)``
    equal to ``a.merge(b)``; v5w refused under the mesh."""
    import cause_tpu_torch as ct

    tag = "[15 sharded wave]"
    merges = [a.merge(b) for a, b in pairs]
    knob = os.environ.get("BENCH_KERNEL")
    try:
        for kernel in ("v5", "v5f"):
            os.environ["BENCH_KERNEL"] = kernel
            with launches_in() as got_u:
                res_u, ms_u = timed_ms(torch, lambda: ct.merge_wave(pairs))
            with launches_in() as got:
                res, ms = timed_ms(torch, lambda: ct.merge_wave(pairs,
                                                                mesh))
            expect_launches(got, tuple(V5_LAUNCHES)
                            + (FUSED if kernel == "v5f" else ()),
                            f"{tag} {kernel}")
            if got != got_u:
                fail(f"{tag} {kernel}: launches {got}, the unsharded "
                     f"wave's {got_u}")
            if res.kernel != kernel or res.fallback or res.poisoned \
                    or not res.digest_valid.all():
                fail(f"{tag} {kernel}: kernel {res.kernel!r}, fallback "
                     f"{res.fallback}, poisoned {res.poisoned}")
            if not (np.array_equal(res.digest, res_u.digest)
                    and np.array_equal(res.digest, wave_digest)):
                fail(f"{tag} {kernel}: digests differ from the unsharded "
                     f"wave's")
            for i, m in enumerate(merges):
                got_i = res.merged(i)
                if got_i.ct.weave != m.ct.weave or list(got_i) != list(m):
                    fail(f"{tag} {kernel}: merged({i}) differs from "
                         f"a.merge(b)")
            say(f"{tag} BENCH_KERNEL={kernel}: {len(pairs)} pairs, "
                f"launches {got} (the unsharded wave's), digests equal the "
                f"unsharded wave's and phase 4's, 0 fallbacks, all "
                f"{len(pairs)} merged(i) equal a.merge(b); wave {ms:.3f} "
                f"ms sharded, {ms_u:.3f} ms unsharded (host clock, "
                f"synchronized, one call each)")
        os.environ["BENCH_KERNEL"] = "v5w"
        try:
            ct.merge_wave(pairs, mesh)
        except ValueError as err:
            say(f"{tag} BENCH_KERNEL=v5w under the mesh raises: {err}")
        else:
            fail(f"{tag} BENCH_KERNEL=v5w ran under the mesh")
    finally:
        if knob is None:
            os.environ.pop("BENCH_KERNEL", None)
        else:
            os.environ["BENCH_KERNEL"] = knob


def shard_maps(torch, dev, mesh):
    """Phase 15, step (d): config 6's own map wave's forest rows (64
    pairs) through both sharded map routes, equal to the batched
    routes, with their launches; merged rows against the pure merge."""
    from cause_tpu_torch.weaver import mapw

    tag = "[15 sharded maps]"
    _base, pairs = map_fleet(MAP_SMALL, 24, 1, 12, 4, 0)
    lanes, meta = mapw.pair_rows([(a.ct.nodes, b.ct.nodes)
                                  for a, b in pairs])
    cap = meta["capacity"]
    with launches_in() as got4:
        out4 = mapw.sharded_merge_map_weave(mesh, lanes)
    with launches_in() as got4u:
        ref4 = mapw.batched_merge_map_weave(lanes, device=dev)
    with launches_in() as got5:
        out5, u5 = mapw.sharded_merge_map_weave_v5(mesh, lanes, cap)
    with launches_in() as got5u:
        ref5, u5u = mapw.batched_merge_map_weave_v5(lanes, cap, device=dev)
    expect_launches(got4, {"sort": 2, "euler_walk": 1}, f"{tag} v4")
    expect_launches(got5, V5_LAUNCHES, f"{tag} v5")
    if got4 != got4u or got5 != got5u or u5 != u5u:
        fail(f"{tag} launches {got4}/{got5} (budget {u5}), the batched "
             f"routes' {got4u}/{got5u} (budget {u5u})")
    for route, got, want in (("v4", out4[:3], ref4[:3]),
                             ("v5", out5[:3], (ref5[0], ref5[1], ref5[3]))):
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.equal(g, w):
                fail(f"{tag} {route}: output {i} differs from the batched "
                     f"route's")
    host = [x.cpu().numpy() for x in out4[:3]]
    if not np.array_equal(out4[3].cpu().numpy().view(np.uint32),
                          mapw.map_row_digest(lanes, *host)):
        fail(f"{tag} v4: digests differ from the host digest twin")
    if int(out4[6]) or int(out5[6]) or int(out4[5]) or int(out5[5]):
        fail(f"{tag} overflowed or conflicting rows")
    rank5 = out5[0].cpu().numpy()
    for i in sorted({0, len(pairs) // 2, len(pairs) - 1}):
        a, b = pairs[i]
        want = a.merge(b).ct.weave
        for order, rank in ((host[0], host[1]), (None, rank5)):
            if mapw.merged_map_weave(lanes, meta, order, rank, i) != want:
                fail(f"{tag} merged row {i} differs from the pure merge")
    say(f"{tag} {len(pairs)} pairs, N={lanes['hi'].shape[1]}: "
        f"sharded_merge_map_weave launches {got4}, "
        f"sharded_merge_map_weave_v5 (u_max {u5}) {got5}, each equal to "
        f"its batched route's (and its launches); rows 0, mid and last "
        f"equal the pure merge")
    return {k: got4[k] + got5[k] for k in got4}


def shard_entry(torch):
    """Phase 15, step (e): ``entry()``'s v4 merge on the card, against
    the same call on the CPU."""
    from cause_tpu_torch.parallel.entry import entry

    tag = "[15 entry]"
    fn, args = entry()
    with launches_in() as got:
        out, ms = timed_ms(torch, lambda: fn(*args))
    expect_launches(got, {"sort": 2, "euler_walk": 1}, tag)
    cfn, cargs = entry(device="cpu")
    want = cfn(*cargs)
    for i, (g, w) in enumerate(zip(out, want)):
        if g.device.type != "cuda" or not torch.equal(g.cpu(), w):
            fail(f"{tag} output {i} on the card differs from the CPU's")
    say(f"{tag} fn(*args) on {args[0].device}: {ms:.3f} ms (host clock, "
        f"first call), launches {got}, equal to the CPU's outputs")
    return got


def shard_dryrun_start() -> Beside:
    """Phase 15, step (f), started: ``dryrun_multichip`` over 4 gloo
    ranks on the CPU in a subprocess, beside the phase's steps on the
    card."""
    prog = ("from cause_tpu_torch.parallel.entry import dryrun_multichip; "
            f"dryrun_multichip({SHARD_DRYRUN_RANKS}, device='cpu'); "
            "print('dryrun ok')")
    return Beside("[15 dryrun]", [sys.executable, "-c", prog],
                  SHARD_DRYRUN_TIMEOUT)


def shard_dryrun(torch, run: Beside) -> None:
    """Phase 15, step (f): the gloo dry run of ``shard_dryrun_start``
    collected (exit 0), then ``dryrun_multichip`` over one NCCL rank on
    the card."""
    from cause_tpu_torch.parallel.entry import dryrun_multichip

    tag = run.tag
    run.collect()
    if "dryrun ok" not in run.stdout:
        fail(f"{tag} dryrun_multichip({SHARD_DRYRUN_RANKS}, device='cpu') "
             f"printed no result: {run.stderr[-2000:]}")
    say(f"{tag} dryrun_multichip({SHARD_DRYRUN_RANKS}, device='cpu'): "
        f"gloo ranks, exit 0 in {run.secs:.1f} s (host clock, the "
        f"subprocess's start included, beside the steps)")
    t0 = time.perf_counter()
    dryrun_multichip(1)
    say(f"{tag} dryrun_multichip(1) on the card: one NCCL rank, passed in "
        f"{time.perf_counter() - t0:.1f} s (host clock, the rank's start "
        f"included)")


def phase_sharded(torch, dev, card: str, batch, v5, u_max: int, pairs,
                  wave_digest) -> tuple:
    """Phase 15: the sharded path at world 1 on the card: the mesh, the
    six sharded steps at the north star, the sharded wave, the sharded
    map routes, ``entry()`` and the dry run. Returns step (b)'s
    launches and ``check_recorded``'s per-kernel sums."""
    import torch.distributed as dist

    from cause_tpu_torch import kernels

    t_phase = time.perf_counter()
    gloo = shard_dryrun_start()
    try:
        mesh = shard_mesh(torch, dev)
        counts, per = shard_steps(torch, dev, mesh, batch, v5, u_max)
        shard_wave(torch, mesh, pairs, wave_digest)
        other = shard_maps(torch, dev, mesh)
        for k, v in shard_entry(torch).items():
            other[k] += v
        shard_dryrun(torch, gloo)
    finally:
        gloo.stop()
    dist.destroy_process_group()
    expect_launches({k: counts[k] + other[k] for k in kernels.SOURCES},
                    tuple(kernels.SOURCES), "[15 sharded]")
    say(f"[15 sharded] launches over step (b) {counts}; kernels at the "
        f"phase's distinct shapes: {kernel_sums_line(per)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s (host clock); {card}")
    return counts, per


# ------------------------------------------- 16. the north-star benchmark

# phase 16: the modes the benchmark runs as subprocesses (the divergence
# levels; the tree's replicas, cut from 64 to keep the smoke's time; the
# lag fleet), the api wave's pairs (256, the largest of 1,024 / 512 /
# 256 whose handle build takes under 60 s on a host CPU, cut to 128 to
# keep the smoke's time once phase 17 came: about 10 s less on an H100,
# PERF.md section 4), each subprocess's time
# limit, and the reps of the drift probe
BENCH16_SWEEP = "10,500"
BENCH16_TREE = 16
BENCH16_LAG = 64
API_WAVE_PAIRS = 128
BENCH16_TIMEOUT = 600
DRIFT_REPS = 20


@contextlib.contextmanager
def bench_env(**env):
    """The benchmark's variables for the block: every ``BENCH_*`` and
    telemetry variable of this process cleared, then ``env`` set; all
    restored after."""
    mine = [k for k in os.environ
            if k.startswith(("BENCH_", "CAUSE_TPU_OBS", "CAUSE_TPU_LEDGER"))]
    saved = {k: os.environ.pop(k) for k in mine}
    os.environ.update(env)
    try:
        yield
    finally:
        for k in env:
            os.environ.pop(k, None)
        os.environ.update(saved)


def sync_points(torch, fn) -> list:
    """Where ``fn`` makes the host wait for the card: for each
    synchronizing CUDA call it makes (PyTorch's sync debug mode warns at
    each), the innermost frame of the port that made it, as
    ``file:line``."""
    import traceback
    import warnings

    pkg = os.path.join(REPO_ROOT, "cause_tpu_torch")
    sites = []

    def record(message, category, filename, lineno, file=None, line=None):
        # a wait with no frame of the port is the debug mode's own reset
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg)]
        if "synchroniz" in str(message) and ours:
            sites.append(f"{os.path.relpath(ours[-1].filename, REPO_ROOT)}:"
                         f"{ours[-1].lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def smi_sample() -> str:
    """The card's SM clock, power draw and temperature now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_probes(torch) -> str:
    """Two fixed pieces of host work, timed: 2,000 launches of a
    one-element add on the card (synchronized; µs a launch) and a pure
    Python loop (ms), each the best of 3."""
    x = torch.zeros(1, device="cuda")
    launch, py = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            x.add_(1)
        torch.cuda.synchronize()
        launch.append((time.perf_counter() - t0) * 1e6 / 2000)
        t0 = time.perf_counter()
        sum(i * i for i in range(200_000))
        py.append((time.perf_counter() - t0) * 1e3)
    return (f"a launch {min(launch):.2f} us, a Python loop "
            f"{min(py):.3f} ms")


def drift_probe(torch, tag: str, fn) -> float:
    """``DRIFT_REPS`` waves of ``fn`` one at a time: the host's time to
    queue the wave, its time to the end of the wait, the card's span
    between two events around it (CUDA events), and this process's CPU
    time over the probe against its wall, beside the card's clock, power
    and temperature before and after, the threads alive, the objects the
    garbage collector tracks, the caching allocator's reserved bytes and
    ``host_probes``. A wave whose queueing takes nearly its whole wall is
    bound by the host. Returns the wall p50."""
    import gc
    import threading

    probes = host_probes(torch)
    smi0 = smi_sample()
    queue, wall, span = [], [], []
    cpu0, w0 = time.process_time(), time.perf_counter()
    for _ in range(DRIFT_REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        queue.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        span.append(e0.elapsed_time(e1))
    cpu_share = (time.process_time() - cpu0) / (time.perf_counter() - w0)
    smi1 = smi_sample()

    def stats(xs):
        return (f"min {min(xs):.3f} p50 {float(np.median(xs)):.3f} max "
                f"{max(xs):.3f}")

    threads = sorted(t.name for t in threading.enumerate())
    say(f"{tag} drift probe, {DRIFT_REPS} waves one at a time: wall "
        f"{stats(wall)} ms, host queueing {stats(queue)} ms, card span "
        f"{stats(span)} ms (CUDA events); this process's CPU time "
        f"{100 * cpu_share:.1f}% of the probe's wall; clock, power, "
        f"temperature before [{smi0}] after [{smi1}]; {len(threads)} "
        f"threads {threads[:12]}; {len(gc.get_objects())} objects tracked "
        f"by gc; {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved by "
        f"the allocator; {probes}")
    return float(np.median(wall))


def bench_headline(torch, card: str, kernel: str, p50_ms: float,
                   want: dict):
    """Phase 16, steps (a) and (b): ``bench.measure("cuda")`` in this
    process at the north star, uncut, with ``BENCH_KERNEL=kernel``:
    the artifact (kernel, platform, card, value, ``vs_target``), its
    single-wave p50 within 0.5-2x the phase-3 dispatch p50 ``p50_ms``,
    the launches exactly ``want`` times its waves (a warm wave, the
    timed singles, the bursts), every wave's ``[checksum, overflowed]``
    equal and equal to a plain-path wave on the card with 0 overflowed
    rows. Then the host's sync points in one wave.
    Returns (artifact, launches, the last wave's output)."""
    from cause_tpu_torch import bench, benchgen, kernels

    tag = f"[16 bench {kernel}]"
    real = benchgen.merge_wave_scalar
    outs, first = [], []

    def recorded(*args, **kw):
        out = real(*args, **kw)
        if not first:
            first.append((args, kw))
        outs.append(out)
        return out

    benchgen.merge_wave_scalar = recorded
    try:
        with bench_env(**({"BENCH_KERNEL": kernel} if kernel != "v5"
                          else {})):
            kernels.reset_launches()
            t0 = time.perf_counter()
            rec = bench.measure("cuda")
            secs = time.perf_counter() - t0
            counts = dict(kernels.launches)
    finally:
        benchgen.merge_wave_scalar = real
    say(f"{tag} artifact {json.dumps(rec)}; {secs:.1f} s in measure() "
        f"(host clock, the marshal included)")
    waves = 1 + rec["reps"] + rec["burst_reps"] * rec["waves_per_burst"]
    if rec["kernel"] != kernel or rec["platform"] != "cuda":
        fail(f"{tag} ran {rec['kernel']!r} on {rec['platform']!r}")
    if rec["card"] != card:
        fail(f"{tag} card {rec['card']!r}, expected {card!r}")
    if len(outs) != waves:
        fail(f"{tag} {len(outs)} waves, the artifact counts {waves}")
    expect_launches(counts, {k: v * waves for k, v in want.items()},
                    f"{tag} {waves} waves")
    ratio = rec["single_dispatch_ms"] / p50_ms
    if not 0.5 <= ratio <= 2.0:
        fail(f"{tag} single-wave p50 {rec['single_dispatch_ms']} ms is "
             f"{ratio:.2f}x phase 3's {p50_ms:.3f} ms")
    # vs_target is the target over the unrounded p50
    if not rec["value"] > 0 or abs(
            rec["vs_target"] - 100.0 / rec["value"]) > 1e-2:
        fail(f"{tag} value {rec['value']} / vs_target {rec['vs_target']}")
    args, kw = first[0]
    with plain_path():
        plain = real(*args, **kw)
    torch.cuda.synchronize()
    for i, out in enumerate(outs):
        if not torch.equal(out, plain):
            fail(f"{tag} wave {i}'s [checksum, overflowed] {out.tolist()} "
                 f"differs from the plain path's {plain.tolist()}")
    if int(plain[1]) != 0:
        fail(f"{tag} {int(plain[1])} rows overflowed")
    syncs = sync_points(torch, lambda: real(*args, **kw))
    say(f"{tag} {waves} waves, launches {counts} ({want} a wave); every "
        f"wave's [checksum, overflowed] {plain.tolist()} equals the plain "
        f"path's on the card; single p50 {rec['single_dispatch_ms']:.3f} ms "
        f"= {ratio:.2f}x phase 3's {p50_ms:.3f} ms, amortized "
        f"{rec['value']:.3f} ms (host clock); the host waits for the card "
        f"{len(syncs)} times in one wave"
        + (f" at {sorted(set(syncs))}" if syncs else "")
        + f"; {card}")
    return rec, counts, plain


def bench_cli16(tag: str, module: str, args=(), **env) -> list:
    """``python -m module args`` from the checkout's root with only the
    benchmark variables ``env`` set: exit 0 within ``BENCH16_TIMEOUT``.
    Returns its stdout's JSON lines."""
    root = os.path.dirname(os.path.abspath(__file__))
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("BENCH_", "CAUSE_TPU_OBS",
                                 "CAUSE_TPU_LEDGER"))}
    full.update(env)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=root,
                         env=full, capture_output=True, text=True,
                         timeout=BENCH16_TIMEOUT)
    secs = time.perf_counter() - t0
    if out.returncode != 0:
        fail(f"{tag} exited {out.returncode}: {out.stdout[-1000:]} "
             f"{out.stderr[-2000:]}")
    lines = []
    for line in out.stdout.strip().splitlines():
        try:
            lines.append(json.loads(line))
        except json.JSONDecodeError:
            fail(f"{tag} a line is not JSON: {line!r}")
    for line in out.stderr.strip().splitlines():
        if line.startswith("bench: ") and "->" not in line:
            say(f"{tag} {line}")
    say(f"{tag} {secs:.1f} s (host clock, the subprocess's start "
        f"included); last line {json.dumps(lines[-1])}")
    return lines


def bench_modes(card: str, k_value: float, tmp: str) -> None:
    """Phase 16, step (c): the benchmark's entry points as a user runs them,
    each a subprocess with telemetry on, a sidecar and a ledger in
    ``tmp``: the headline (beside this process's amortized p50
    ``k_value``; its ledger row under ``gpu``), the divergence sweep
    (every level's digests agree), the tree (bit-identical to the fold
    in ``tree_rounds(n)`` rounds), lag with the live monitor (no op
    pending), and ``api_bench --wave`` (no overflow, no pair off the
    card)."""
    from cause_tpu_torch.obs import ledger
    from cause_tpu_torch.parallel.tree import tree_rounds

    led = os.path.join(tmp, "ledger.jsonl")

    def run(mode: str, **env):
        return bench_cli16(
            f"[16 bench {mode}]", "cause_tpu_torch.bench", CAUSE_TPU_OBS="1",
            CAUSE_TPU_OBS_OUT=os.path.join(tmp, f"{mode}.jsonl"),
            CAUSE_TPU_LEDGER=led, **env)[-1]

    rec = run("cli")
    if rec["platform"] != "cuda" or rec["kernel"] != "v5" or \
            rec["card"] != card or not rec["value"] > 0:
        fail(f"[16 bench cli] artifact {rec}")
    rows = [r for r in ledger.load(led) if r["kind"] == "bench"]
    if len(rows) != 1 or rows[0]["platform"] != ledger.CHIP_PLATFORM or \
            rows[0]["quarantined"]:
        fail(f"[16 bench cli] ledger rows {rows}")
    say(f"[16 bench cli] a fresh process: amortized {rec['value']:.3f} ms, "
        f"single {rec['single_dispatch_ms']:.3f} ms; this process late in "
        f"the smoke: amortized {k_value:.3f} ms; one {ledger.CHIP_PLATFORM} "
        f"row in the ledger")

    rec = run("sweep", BENCH_DIV_SWEEP=BENCH16_SWEEP)
    want = sorted(int(x) for x in BENCH16_SWEEP.split(","))
    if [lv["level_ops"] for lv in rec["levels"]] != want or not (
            rec["digest_agreed"]
            and all(lv["digest_agreed"] for lv in rec["levels"])):
        fail(f"[16 bench sweep] levels {rec['levels']}")
    for lv in rec["levels"]:
        say(f"[16 bench sweep] level {lv['level_ops']} (window {lv['wcap']} "
            f"a side): full p50 {lv['full_p50_ms']} ms, amortized "
            f"{lv['full_amortized_ms']}; delta p50 {lv['delta_p50_ms']}, "
            f"amortized {lv['delta_amortized_ms']}; delta/full "
            f"{lv['delta_over_full']}; digests agree")

    rec = run("tree", BENCH_TREE=str(BENCH16_TREE))
    (fl,) = rec["fleets"]
    if not (rec["bit_identical"] and fl["bit_identical"]) or \
            fl["rounds"] != tree_rounds(BENCH16_TREE):
        fail(f"[16 bench tree] {fl}")
    say(f"[16 bench tree] {BENCH16_TREE} replicas x {fl['doc']} nodes: "
        f"{fl['rounds']} rounds {fl['paths']}, tree p50 "
        f"{fl['tree_p50_ms']} ms (reps {fl['tree_reps_ms']}) against the "
        f"fold's {fl['fold_ms']} ms, {fl['tree_over_fold']}; root "
        f"bit-identical")

    rec = run("lag", BENCH_LAG=str(BENCH16_LAG), BENCH_LIVE="1")
    (fl,) = rec["fleets"]
    if fl["pending"] != 0 or not fl["ops_converged"] > 0:
        fail(f"[16 bench lag] {fl}")
    say(f"[16 bench lag] {BENCH16_LAG} replicas x {fl['doc']} nodes, "
        f"{fl['rounds']} rounds: {fl['ops_converged']} ops converged, 0 "
        f"pending; p50 {fl['p50_ms']} ms, p99 {fl['p99_ms']}, SLO "
        f"{fl['slo_ms']} ms {fl['verdict']}; live monitor "
        f"{fl['live']['overhead_pct']}% of the wave rounds' wall")
    rows = ledger.load(led)
    kinds = sorted({r["kind"] for r in rows})
    if any(r["platform"] != ledger.CHIP_PLATFORM for r in rows if
           r["kind"] != "bench") or kinds != ["bench", "lag", "live",
                                              "sweep", "tree"]:
        fail(f"[16 bench] ledger kinds {kinds}")

    lines = bench_cli16("[16 api_bench wave]", "cause_tpu_torch.api_bench",
                        ("--wave", str(API_WAVE_PAIRS), "--lazy"))
    setup, session, wave = lines
    if wave["overflow_rows"] or wave["fallback_pairs"] or \
            wave["kernel"] != "v5" or wave["platform"] != "cuda":
        fail(f"[16 api_bench wave] {wave}")
    say(f"[16 api_bench wave] {API_WAVE_PAIRS} pairs: handle build "
        f"{setup['value']} s; host assembly {wave['host_assembly_ms']} ms, "
        f"kernel + digest + copy {wave['device_kernel_ms']} ms (amortized "
        f"{wave['device_kernel_amortized_ms']}), whole wave "
        f"{wave['whole_wave_ms']} ms, one merged(i) "
        f"{wave['materialize_one_pair_ms']} ms; session round "
        f"{session['delta_update_plus_wave_ms']} ms; {card}")


def phase_bench(torch, card: str, k_p50: float, f_p50: float, probe,
                early_ms: float) -> dict:
    """Phase 16: the drift probe on ``probe`` (phase 3's batch through
    ``merge_wave_scalar``, probed after phase 3 at ``early_ms``) again
    late in the run, after a full collection, and after the allocator's
    cache was emptied too;
    the north-star benchmark (``cause_tpu_torch.bench``) in this process
    at the north star through v5 and v5f (phase 3's and 3f's dispatch p50s
    ``k_p50``, ``f_p50``); then its modes and ``api_bench --wave`` as
    subprocesses. Returns the launches of the two in-process runs."""
    import gc
    import tempfile

    from cause_tpu_torch import kernels

    t_phase = time.perf_counter()
    late_ms = drift_probe(torch, "[16 drift late]", probe)
    gc.collect()
    collected_ms = drift_probe(torch, "[16 drift late, collected]", probe)
    torch.cuda.empty_cache()
    emptied_ms = drift_probe(torch, "[16 drift late, cache emptied]", probe)
    say(f"[16 drift] the same wave's wall p50: {early_ms:.3f} ms after "
        f"phase 3, {late_ms:.3f} ms now, {collected_ms:.3f} ms after a "
        f"full collection, {emptied_ms:.3f} ms after the allocator's "
        f"cache was emptied too; {card}")
    counts = {n: 0 for n in kernels.SOURCES}
    v5, got, out5 = bench_headline(torch, card, "v5", k_p50, V5_LAUNCHES)
    for k, v in got.items():
        counts[k] += v
    _v5f, got, out5f = bench_headline(torch, card, "v5f", f_p50,
                                      V5F_LAUNCHES)
    for k, v in got.items():
        counts[k] += v
    if not torch.equal(out5, out5f):
        fail(f"[16 bench] v5f's [checksum, overflowed] {out5f.tolist()} "
             f"differs from v5's {out5.tolist()}")
    with tempfile.TemporaryDirectory() as tmp:
        bench_modes(card, v5["value"], tmp)
    say(f"[16 bench] launches over steps (a) and (b) {counts}; phase "
        f"{time.perf_counter() - t_phase:.1f} s (host clock); {card}")
    return counts


class Beside:
    """A subprocess started now from the checkout's root, with no
    ``BENCH_``/``CAUSE_TPU_`` knob of this process (``env`` adds its
    own), waited for by a thread of its own: its seconds end when it
    exits, not when it is collected, and work of this process runs
    beside it. ``collect`` fails past ``timeout`` seconds from its start
    or on a non-zero exit; ``stop`` kills it if it still runs."""

    def __init__(self, tag: str, cmd, timeout: float, env=None):
        import threading

        self.tag, self.timeout = tag, timeout
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith(("BENCH_", "CAUSE_TPU_"))}
        self.env.update(env or {})
        self.stdout = self.stderr = ""
        self.secs = None
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=REPO_ROOT, env=self.env,
                                     text=True, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE,
                                     stdin=subprocess.DEVNULL)
        self._thread = threading.Thread(target=self._wait, daemon=True)
        self._thread.start()

    def _wait(self):
        self.stdout, self.stderr = self.proc.communicate()
        self.secs = time.perf_counter() - self.t0

    def wait(self) -> "Beside":
        """Its exit, whatever the code; fails past ``timeout``."""
        self._thread.join(max(0.0, self.timeout
                              - (time.perf_counter() - self.t0)))
        if self._thread.is_alive():
            self.stop()
            fail(f"{self.tag} ran past {self.timeout} s")
        return self

    def collect(self) -> "Beside":
        self.wait()
        if self.proc.returncode != 0:
            fail(f"{self.tag} exited {self.proc.returncode}: "
                 f"{self.stdout[-4000:]} {self.stderr[-3000:]}")
        return self

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self._thread.join()


# ------------------------------------------------------- 17. soak, fleet

# phase 17: the soup's rounds (a multiple of 6, so every kind runs
# SOAK_ROUNDS / 6 times), the CLI's minutes (cut from 0.5 to 0.25 once
# phase 18 came, for time), the chaos plan of
# tests/test_chaos.py:761-776 and the doc of its second run (10,000,
# the largest of 10,000 / 2,000 / 500, not cut), the fleet bench's full
# configuration and its API level
SOAK_ROUNDS = 120
SOAK_CLI_MINUTES = 0.25
SOAK_TIMEOUT = 300
CHAOS_PLAN = {
    "seed": 11, "replicas": 8, "rounds": 4, "doc": 30,
    "faults": [
        {"family": "payload", "site": "sync.delta", "mode": "corrupt",
         "at": [3]},
        {"family": "payload", "site": "sync.delta", "mode": "truncate",
         "at": [20]},
        {"family": "dispatch", "site": "session", "mode": "raise",
         "at": [2]},
        {"family": "dispatch", "site": "session", "mode": "exhaust",
         "at": [3]},
        {"family": "crash", "site": "session", "at": [2]},
        {"family": "stall", "site": "session", "ms": 120, "at": [4]},
    ],
}
CHAOS_DOC = 10_000
FLEET = {"K": 1024, "n_base": 9000, "n_div": 1000, "cap": 10240}
FLEET_API = {"K": 64, "n_nodes": 10_000}
FLEET_STEPS = {
    "v5": ("kernel_level_v5", "merge_weave_kernel_v5",
           ("rank", "visible", "conflict", "overflow"), SORT_SITES),
    "v4": ("kernel_level", "merge_weave_kernel_v4",
           ("order", "rank", "visible", "conflict", "overflow"),
           GEN_SITES["v4"]),
}


def soak_soup(torch, timed) -> tuple:
    """Phase 17 (a): ``soak.ROUNDS`` over seeds 0 .. SOAK_ROUNDS - 1 in
    this process on the card, then again on the plain path with every
    kernel call recorded and held against its plain version. Returns the
    launches of the kernel run and the timed calls' sums."""
    import random

    from cause_tpu_torch import kernels, soak

    def soup():
        kinds = {}
        for seed in range(SOAK_ROUNDS):
            kind = soak.ROUNDS[seed % len(soak.ROUNDS)]
            kind(random.Random(seed))
            kinds[kind.__name__] = kinds.get(kind.__name__, 0) + 1
        torch.cuda.synchronize()
        return kinds

    reserved0 = torch.cuda.memory_reserved()
    kernels.reset_launches()
    t0 = time.perf_counter()
    kinds = soup()
    secs = time.perf_counter() - t0
    counts = dict(kernels.launches)
    reserved1 = torch.cuda.memory_reserved()
    expect_launches(counts, tuple(kernels.SOURCES), "[17 soak]")
    say(f"[17 soak] {SOAK_ROUNDS} rounds clean on the card in {secs:.1f} s "
        f"(host clock), kinds {kinds}; launches {counts}; "
        f"memory_reserved {reserved0} -> {reserved1} bytes")
    calls = []
    t0 = time.perf_counter()
    with plain_path(record=calls):
        soup()
    say(f"[17 soak] the same rounds on the plain path in "
        f"{time.perf_counter() - t0:.1f} s (host clock), {len(calls)} "
        f"kernel calls recorded")
    per = check_recorded(torch, calls, "[17 soak]", sites=("soup",),
                         timed=timed)
    say(f"[17 soak] {kernel_sums_line(per)}")
    return counts, per


def soak_cli_start(tag: str, tmp: str, args) -> Beside:
    """``python -m cause_tpu_torch.soak args --obs-out`` started in a
    subprocess, its ledger in ``tmp``."""
    out = os.path.join(tmp, f"{tag}.jsonl")
    run = Beside(f"[17 {tag}]", [sys.executable, "-m",
                                 "cause_tpu_torch.soak", *args,
                                 "--obs-out", out], SOAK_TIMEOUT,
                 env={"CAUSE_TPU_LEDGER": os.path.join(
                     tmp, f"{tag}.ledger.jsonl")})
    run.out = out
    return run


def soak_cli(run: Beside) -> tuple:
    """A run of ``soak_cli_start`` collected: exit 0 within SOAK_TIMEOUT.
    Returns its stdout's lines, its sidecar's records, its ledger's rows
    and its seconds."""
    from cause_tpu_torch.obs import perfetto

    run.collect()
    with open(run.env["CAUSE_TPU_LEDGER"]) as f:
        rows = [json.loads(x) for x in f if x.strip()]
    return (run.stdout.strip().splitlines(), perfetto.load_jsonl(run.out),
            rows, run.secs)


def soak_chaos_start(tmp: str, doc: int) -> Beside:
    """Phase 17 (c): the chaos plan at ``doc`` through the CLI, started."""
    path = os.path.join(tmp, f"plan{doc}.json")
    with open(path, "w") as f:
        json.dump(dict(CHAOS_PLAN, doc=doc), f)
    run = soak_cli_start(f"chaos{doc}", tmp, ["--chaos", path])
    run.doc = doc
    return run


def soak_chaos(run: Beside) -> float:
    """Phase 17 (c): a run of ``soak_chaos_start`` collected: exit 0,
    the plan's 6 injections over its four families, bit-identical
    convergence, no divergence incident, nothing quarantined, a ``chaos``
    ledger row. Returns its seconds."""
    doc, tag = run.doc, f"chaos{run.doc}"
    _lines, evs, rows, secs = soak_cli(run)
    injects = fields_of(evs, "chaos.inject")
    fams = {e["family"] for e in injects}
    if len(injects) != 6 or fams != {"payload", "dispatch", "crash",
                                      "stall"}:
        fail(f"[17 {tag}] injections {injects}")
    done = fields_of(evs, "chaos.done")
    if not done or done[-1]["converged_bit_identical"] is not True \
            or done[-1]["divergence_incidents"] \
            or done[-1]["quarantined_final"]:
        fail(f"[17 {tag}] chaos.done {done}")
    if [r.get("kind") for r in rows] != ["chaos"]:
        fail(f"[17 {tag}] ledger rows {rows}")
    d = done[-1]
    say(f"[17 {tag}] doc {doc}: exit 0 in {secs:.1f} s (host clock, the "
        f"subprocess's start included, beside the soup); injected "
        f"{d['injected']}, detected {d['detected']}, restores "
        f"{d['recovery'].get('restores')}, bit-identical, 0 incidents, "
        f"nothing quarantined, MTTR {d['mttr_ms']} ms, ledger row "
        f"{rows[0]['platform']}")
    return secs


def walk_sublists(torch, fc, ns, parent) -> tuple:
    """B2's split form's ruling set on ``[B, K]`` tables, its splitters
    picked as ``csrc/euler_walk.cu``'s ``split_hash`` picks them:
    (splitters a row, the longest and the mean sublist over the rows'
    splitters in the tour), a sublist's length being the slots a thread
    walks from its splitter to the next or to the tour's end, one
    dependent load each. Found on the card by pointer jumping over the
    tour's successors."""
    from cause_tpu_torch.weaver import euler

    B, K = fc.shape
    two_k = 2 * K
    M = 1 << (two_k - 1).bit_length()
    mask, r = M - 1, (M.bit_length() - 1 + 1) // 2
    a = ((M * 0x9E3779B9) >> 32) | 1
    c = (0x85EBCA6B & mask) | 1
    n_split = max(1, M >> euler.WALK_LOG_STRIDE)
    dev = fc.device
    i = torch.arange(K, device=dev, dtype=torch.int64)
    f, s, p = fc.long(), ns.long(), parent.long()
    succ = torch.cat([
        torch.where(f < 0, K + i, torch.where(f < K, f, two_k)),
        torch.where(s >= 0, torch.where(s < K, s, two_k),
                    torch.where((p >= 0) & (p < K), K + p, two_k))], 1)
    slot = torch.arange(two_k + 1, device=dev, dtype=torch.int64)
    x = (slot * a) & mask
    x ^= x >> r
    x = (x * c) & mask
    x ^= x >> r
    stops = ((x * a) & mask) < n_split  # a splitter's slot, or END
    stops[two_k] = True
    # a step to the next slot, or to the sink (slot 2K) after a walk's
    # last slot
    nxt = torch.cat([torch.where(stops[succ], two_k, succ),
                     torch.full((B, 1), two_k, device=dev,
                                dtype=torch.int64)], 1)
    dist = torch.ones_like(nxt)
    dist[:, two_k] = 0
    for _ in range(two_k.bit_length() + 1):
        dist = dist + dist.gather(1, nxt)
        nxt = nxt.gather(1, nxt)
    lengths = dist[:, :two_k][:, stops[:two_k]]
    return n_split, int(lengths.max()), float(lengths.float().mean())


def soak_fleet(torch, dev, card: str, timed) -> tuple:
    """Phase 17 (d): ``fleet_bench`` at its full configuration in this
    process: for v5 and v4 the one row of K * cap lanes through the
    overflow ladder and the timed steps, the last step's outputs against
    the plain path's on the card at the same row and budget, every kernel
    call of that step held against its plain version and timed; then
    ``api_level``. Returns the launches of the kernel-level runs and the
    timed calls' sums."""
    from cause_tpu_torch import fleet_bench, kernels

    counts = {n: 0 for n in kernels.SOURCES}
    per = {}
    for kernel, (level, name, outs, sites) in FLEET_STEPS.items():
        fn = getattr(fleet_bench, name)
        last = {}

        def keep(*args, **kw):
            out = fn(*args, **kw)
            last.update(args=args, kw=kw, out=out)
            return out

        kernels.reset_launches()
        setattr(fleet_bench, name, keep)
        try:
            rec = getattr(fleet_bench, level)(**FLEET, device=dev)
        finally:
            setattr(fleet_bench, name, fn)
        torch.cuda.synchronize()
        got = dict(kernels.launches)
        for n in counts:
            counts[n] += got[n]
        say(json.dumps(dict(rec, card=card)))
        calls = []
        with plain_path(record=calls):
            want = fn(*last["args"], **last["kw"])
        torch.cuda.synchronize()
        for nm, g, w in zip(outs, last["out"], want):
            if not torch.equal(g, w):
                fail(f"[17 fleet {kernel}] {nm} differs from the plain "
                     f"path at {last['kw']}")
        if bool(last["out"][-1]):
            fail(f"[17 fleet {kernel}] the last step overflowed")
        budget = {k: v for k, v in last["kw"].items() if k != "device"}
        say(f"[17 fleet {kernel}] one row of {last['args'][0].numel()} "
            f"lanes at {budget}: {', '.join(outs)} bit-identical to "
            f"the plain path on the card; launches over the ladder and the "
            f"timed steps {got}")
        add_sums(per, check_recorded(torch, calls, f"[17 fleet {kernel}]",
                                     sites=sites, timed=timed))
        for name, ops, _ in calls:
            if name == "euler_walk":
                n_split, longest, mean = walk_sublists(torch, *ops[:3])
                say(f"[17 fleet {kernel}] B2's split form's ruling set at "
                    f"{'x'.join(map(str, ops[0].shape))}: {n_split} "
                    f"splitters a row, sublists of {mean:.1f} slots on "
                    f"average and {longest} at most (the dependent loads "
                    f"of a thread's walk, each walked twice)")
        del last, want, calls
    rec = fleet_bench.api_level(**FLEET_API)
    say(json.dumps(dict(rec, card=card)))
    return counts, per


def phase_soak(torch, dev, card: str) -> tuple:
    """Phase 17: the differential soak (``cause_tpu_torch.soak``) and the
    fleet bench (``cause_tpu_torch.fleet_bench``) on the card. Returns
    the soup's launches, the fleet's launches and the fleet's timed
    calls' sums."""
    import tempfile

    t_phase = time.perf_counter()
    timed = set()
    runs = []
    # the CLI runs go beside the soup (none of them is timed against
    # another), and are collected before the fleet bench times its steps
    with tempfile.TemporaryDirectory() as tmp:
        try:
            runs.append(soak_cli_start(
                "soak", tmp, ["--minutes", str(SOAK_CLI_MINUTES)]))
            runs += [soak_chaos_start(tmp, doc)
                     for doc in (CHAOS_PLAN["doc"], CHAOS_DOC)]
            soup_counts, _ = soak_soup(torch, timed)
            lines, evs, rows, secs = soak_cli(runs[0])
            done = fields_of(evs, "soak.done")
            if not done or not done[-1]["rounds"] \
                    or not lines[-1].startswith(
                        f"soak finished: {done[-1]['rounds']} rounds "
                        f"clean"):
                fail(f"[17 soak cli] soak.done {done}, last line "
                     f"{lines[-1:]}")
            if [r.get("kind") for r in rows] != ["soak"]:
                fail(f"[17 soak cli] ledger rows {rows}")
            say(f"[17 soak cli] --minutes {SOAK_CLI_MINUTES}: exit 0 in "
                f"{secs:.1f} s (host clock, the subprocess's start "
                f"included, beside the soup), {done[-1]['rounds']} rounds "
                f"clean, ledger row {rows[0]['platform']}")
            for run in runs[1:]:
                soak_chaos(run)
        finally:
            for run in runs:
                run.stop()
    fleet_counts, fleet_per = soak_fleet(torch, dev, card, timed)
    expect_launches(fleet_counts, tuple(V5_LAUNCHES), "[17 fleet]")
    say(f"[17 fleet] {kernel_sums_line(fleet_per)}; {card}")
    say(f"[17 soak] phase {time.perf_counter() - t_phase:.1f} s (host "
        f"clock); {card}")
    return soup_counts, fleet_counts, fleet_per


# phase 18: serve_soak's calibration rounds in this process at phase 10's
# served size (the seed and rounds), batched_smoke's tenants, the flags
# of the reference CI's serve and disk smokes (.github/workflows/ci.yml)
# and of the overload run at phase 10's tenants and documents. The
# overload run's window is cut from 20 s to 10 and its warm calibration
# rounds from 4 to 1, for time: at 20 s and 4 the run took 213 s on an
# H100 (PERF.md section 4); tenants and documents are never cut
SOAK18_SEED, SOAK18_ROUNDS = 18, 4
BATCHED_TENANTS = 12
CI_SERVE = ["--tenants", "4", "--capacity", "4", "--doc", "100",
            "--d-max", "64", "--seconds", "6", "--rate-mult", "0.5",
            "--seed", "12"]
CI_DISK = ["--tenants", "4", "--capacity", "4", "--doc", "100",
           "--d-max", "64", "--seconds", "24", "--rate-mult", "1",
           "--seed", "15", "--chaos", "disk",
           "--disk-plan", "measurements/disk_plan_r15.json"]
OVERLOAD = ["--tenants", str(SERVE_TENANTS), "--capacity",
            str(SERVE_CAPACITY), "--doc", str(SERVE_LIST), "--d-max",
            str(SERVE_DMAX), "--seconds", "10", "--calib-ticks", "1",
            "--rate-mult", "2", "--chaos", "crash", "--gate-dispatch",
            "--seed", str(SOAK18_SEED)]
SERVE_SOAK_TIMEOUT = 600
# the overload run's CLI, with the kernel launches of its timed window
# (from the generator's start to its join) printed after main returns
SOAK_WINDOW = """\
import json, sys
from cause_tpu_torch import chaos, kernels, serve_soak
window = {}
start, join = serve_soak.Generator.start, serve_soak.Generator.join
def started(self):
    kernels.reset_launches()
    start(self)
def joined(self, *args, **kw):
    window.update(kernels.launches)
    join(self, *args, **kw)
serve_soak.Generator.start = started
serve_soak.Generator.join = joined
rc = serve_soak.main(sys.argv[1:])
print("timed-window launches " + json.dumps(window), flush=True)
chaos.reset()
sys.exit(rc)
"""


class TimedPerWidth(set):
    """``check_recorded``'s ``timed`` set, keyed by kernel, rows, the
    first operand's width rounded up to a power of two and keywords, so
    that a served document growing op by op times one call a width
    class, not every call (every call is still held to its plain
    version)."""

    @staticmethod
    def _key(key):
        name, shapes, kw = key
        n = shapes[0][-1]
        return (name, shapes[0][0], 1 << max(0, (n - 1).bit_length()), kw)

    def __contains__(self, key):
        return set.__contains__(self, self._key(key))

    def add(self, key):
        set.add(self, self._key(key))


def soak_start(tmp: str, tag: str, args, code=None) -> Beside:
    """``python -m cause_tpu_torch.serve_soak args --obs-out`` (or
    ``python -c code args ...``) started, its ledger at
    ``tmp/<tag>.ledger.jsonl``."""
    out = os.path.join(tmp, f"{tag}.jsonl")
    cmd = ([sys.executable, "-c", code] if code else
           [sys.executable, "-m", "cause_tpu_torch.serve_soak"])
    run = Beside(f"[18 {tag}]", cmd + list(args) + ["--obs-out", out],
                 SERVE_SOAK_TIMEOUT, env={"CAUSE_TPU_LEDGER": os.path.join(
                     tmp, f"{tag}.ledger.jsonl")})
    run.out = out
    return run


def soak_finish(run: Beside) -> Beside:
    """A run of ``soak_start`` collected: exit 0 within
    SERVE_SOAK_TIMEOUT, its last line ``serve soak: clean``. Adds its
    stdout's lines, its ledger's rows and its sidecar's records."""
    from cause_tpu_torch.obs import perfetto

    run.collect()
    run.lines = run.stdout.strip().splitlines()
    if not any(x.startswith("serve soak: clean") for x in run.lines[-2:]):
        fail(f"{run.tag} did not end clean: {run.stdout[-4000:]}")
    with open(run.env["CAUSE_TPU_LEDGER"]) as f:
        run.rows = [json.loads(x) for x in f if x.strip()]
    run.evs = perfetto.load_jsonl(run.out)
    return run


def port_cli(tag: str, module: str, args, env=None) -> str:
    """``python -m module args`` from the checkout's root: exit 0 within
    two minutes. Returns its stdout."""
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO_ROOT,
                       env=env, capture_output=True, text=True, timeout=120,
                       stdin=subprocess.DEVNULL)
    if p.returncode != 0:
        fail(f"[18 {tag}] python -m {module} {' '.join(args)} exited "
             f"{p.returncode}: {p.stdout[-2000:]} {p.stderr[-2000:]}")
    return p.stdout


def event_names(evs) -> set:
    return {e.get("name") for e in evs if e.get("ev") == "event"}


def soak_calibration(torch, tmp: str, pairs) -> tuple:
    """Phase 18 (a): serve_soak's calibration rounds (``_calib_round``,
    SOAK18_ROUNDS of them from seed SOAK18_SEED, as the soak draws them)
    over ``pairs`` in a service of phase 10's shape on the kernels, then
    in a second service over the same pairs, with fresh producer states
    and the same draws, on the plain path with every kernel call
    recorded and held against its plain version. Returns the kernel
    run's launches and the timed calls' sums."""
    import random

    from cause_tpu_torch import kernels, serve_soak
    from cause_tpu_torch.serve import (IngestQueue, ResidencyManager,
                                       SyncService, WriteAheadLog)

    tag = "[18 serve soak] calibration"

    def service(root):
        wal = WriteAheadLog(os.path.join(root, "wal"), fsync="batch")
        svc = SyncService(IngestQueue(max_ops=256, journal=wal),
                          residency=ResidencyManager(capacity=SERVE_CAPACITY),
                          checkpoint_dir=os.path.join(root, "ckpt"),
                          d_max=SERVE_DMAX, watchdog_s=5.0, batched=True)
        tenants = [serve_soak._Tenant(svc.add_tenant(a, b), a, b)
                   for a, b in pairs]
        torch.cuda.synchronize()
        return svc, tenants

    def rounds(svc, tenants):
        rng = random.Random(SOAK18_SEED ^ 0x5EED)
        weights = serve_soak._zipf_weights(len(tenants), 1.2)
        t0 = time.perf_counter()
        admitted = [serve_soak._calib_round(svc, tenants, rng, weights, k)
                    for k in range(SOAK18_ROUNDS)]
        torch.cuda.synchronize()
        return admitted, time.perf_counter() - t0

    svc_k, ten_k = service(os.path.join(tmp, "calib_kernels"))
    kernels.reset_launches()
    adm_k, secs_k = rounds(svc_k, ten_k)
    counts = dict(kernels.launches)
    expect_launches(counts, tuple(V5_LAUNCHES), tag)
    dig_k = {t.uuid: svc_k.converged_digest(t.uuid) for t in ten_k}
    ticks_k, res_k = svc_k.ticks, dict(svc_k.residency.stats)
    svc_k.close()
    del svc_k
    say(f"{tag}: {SOAK18_ROUNDS} rounds of {3 * len(pairs)} offers over "
        f"{len(pairs)} tenants of {SERVE_LIST} elements (capacity "
        f"{SERVE_CAPACITY}, d_max {SERVE_DMAX}) on the kernels in "
        f"{secs_k:.1f} s (host clock): {sum(adm_k)} offers admitted "
        f"{adm_k}, {ticks_k} ticks, {sum(adm_k) / secs_k:.1f} batch/s, "
        f"residency {res_k}; launches {counts}")

    svc_p, ten_p = service(os.path.join(tmp, "calib_plain"))
    calls = []
    with plain_path(record=calls):
        adm_p, secs_p = rounds(svc_p, ten_p)
    dig_p = {t.uuid: svc_p.converged_digest(t.uuid) for t in ten_p}
    svc_p.close()
    del svc_p
    if adm_p != adm_k:
        fail(f"{tag}: the plain run admitted {adm_p}, the kernels {adm_k}")
    if dig_p != dig_k:
        bad = sorted(u for u in dig_k if dig_p.get(u) != dig_k[u])
        fail(f"{tag}: converged digests differ on the plain path: {bad}")
    say(f"{tag}: the same rounds on the plain path in {secs_p:.1f} s (host "
        f"clock), {len(calls)} kernel calls recorded; every tenant's "
        f"converged_digest equal to the kernel run's")
    per = check_recorded(torch, calls, tag, sites=("calib",),
                         timed=TimedPerWidth())
    say(f"{tag}: {kernel_sums_line(per)}")
    return counts, per


def soak_batched(torch, tmp: str) -> dict:
    """Phase 18 (a): ``batched_smoke.one_tick`` over BATCHED_TENANTS
    tenants with telemetry on, once on the kernels and once on the plain
    path with every kernel call recorded and held against its plain
    version, both arms from the same seeded site ids; then the smoke's
    gates on each run. Returns the kernel run's launches."""
    from cause_tpu_torch import batched_smoke, ids, obs
    from cause_tpu_torch.obs import perfetto

    n = BATCHED_TENANTS
    digests = {}
    for arm in ("kernels", "plain"):
        tag = f"[18 batched {arm}]"
        out = os.path.join(tmp, f"batched_{arm}.jsonl")
        obs_fresh(out)
        obs.configure(enabled=True, out=out)
        ids._rng.seed(SOAK18_SEED)  # both arms build the same tenants
        calls = []
        path = (plain_path(record=calls) if arm == "plain"
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with launches_in() as counts, path:
            dig_b, dig_u, rec, tenants = batched_smoke.one_tick(
                os.path.join(tmp, f"batched_{arm}"), n)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        obs.flush()
        obs_fresh()
        evs = perfetto.load_jsonl(out)
        tick_b = fields_of(evs, "serve.tick")[0]
        if rec["tenants"] != n or not (rec["wave_dispatches"]
                                       == rec["buckets"] == 2):
            fail(f"{tag}: the batched tick {rec}")
        if tick_b["fallbacks"] or tick_b["wave_dispatches"] != 2 \
                or tick_b["batch_rows"] < n:
            fail(f"{tag}: the batched tick's event {tick_b}")
        if dig_b != dig_u:
            fail(f"{tag}: batched and unbatched digests differ")
        agreed, seen = set(), 0
        for e in evs:
            if e.get("ev") != "event":
                continue
            if e.get("name") == "serve.tick":
                seen += 1
                if seen == 2:
                    break
            if e.get("name") == "wave.digest" and e["fields"].get("agreed"):
                agreed.add(e["fields"]["uuid"])
        missing = {t["uuid"] for t in tenants} - agreed
        if missing:
            fail(f"{tag}: tenants without an agreed wave.digest: "
                 f"{sorted(missing)}")
        digests[arm] = dig_b
        if arm == "kernels":
            kernel_counts = counts
            expect_launches(counts, tuple(V5_LAUNCHES), tag)
        else:
            check_recorded(torch, calls, tag)
        say(f"{tag}: {n} tenants, {rec['buckets']} buckets, "
            f"{rec['wave_dispatches']} dispatches in one tick "
            f"({tick_b['batch_rows']} rows), 0 fallbacks, every tenant "
            f"agreed in the tick, batched digests equal to the unbatched "
            f"arm's; {secs:.2f} s (host clock); launches {counts}")
    if digests["plain"] != digests["kernels"]:
        fail("[18 batched] the plain path's digests differ from the "
             "kernels'")
    return kernel_counts


def soak_ci_serve(run: Beside) -> None:
    """Phase 18 (b): the reference CI's serve-smoke checks on the port's
    run."""
    tag = "[18 ci serve]"
    watch = port_cli("ci serve", "cause_tpu_torch.obs",
                     ["watch", run.out, "--once"], env=run.env)
    if "serve: " not in watch:
        fail(f"{tag}: watch --once printed no serve line: {watch[-2000:]}")
    rows = [r for r in run.rows if r.get("kind") == "serve"]
    if len(rows) != 1:
        fail(f"{tag}: serve rows {rows}")
    s = rows[0]["serve"]
    p99 = s["p99_ms"]
    if s["sheds"] != 0 or s["crashes"] != 0 \
            or s["restore_bit_identical"] is not True or p99 is None \
            or not np.isfinite(p99) or p99 <= 0 \
            or s["max_depth"] > s["max_ops"]:
        fail(f"{tag}: the serve row {s}")
    names = event_names(run.evs)
    if "serve.tick" not in names or "serve.drain" not in names \
            or "serve.shed" in names:
        fail(f"{tag}: serve events "
             f"{sorted(n for n in names if str(n).startswith('serve.'))}")
    port_cli("ci serve", "cause_tpu_torch.obs",
             ["ledger", "--ledger", run.env["CAUSE_TPU_LEDGER"], "--check"],
             env=run.env)
    say(f"{tag} {' '.join(CI_SERVE)}: exit 0 in {run.secs:.1f} s (host "
        f"clock, the subprocess's start included, beside phase 18's "
        f"in-process part); measured "
        f"{s['steady_per_s']} batch/s, offered {s['offered_per_s']}; "
        f"{s['admitted_ops']} ops admitted, 0 sheds, lag p50 "
        f"{s['p50_ms']} ms p99 {p99} ms, max depth {s['max_depth']}, "
        f"restore bit-identical; serve.tick and serve.drain in the "
        f"stream, no serve.shed; watch --once prints serve:; ledger "
        f"--check exit 0 ({rows[0]['platform']}, {rows[0]['card']})")


def soak_ci_disk(run: Beside) -> None:
    """Phase 18 (c): the reference CI's disk-smoke checks on the port's
    run, the offline scrubber on its surviving state."""
    tag = "[18 ci disk]"
    state = run.out + ".state"
    port_cli("ci disk", "cause_tpu_torch.serve",
             ["scrub", "--wal", f"{state}/wal", "--retired",
              f"{state}/wal_retired", "--checkpoint", f"{state}/ckpt"],
             env=run.env)
    watch = port_cli("ci disk", "cause_tpu_torch.obs",
                     ["watch", run.out, "--once"], env=run.env)
    if "wal: " not in watch:
        fail(f"{tag}: watch --once printed no wal line: {watch[-2000:]}")
    with open(os.path.join(REPO_ROOT, CI_DISK[-1])) as f:
        plan = json.load(f)
    modes = {s.get("mode") for s in plan["faults"] if s["family"] == "disk"}
    if modes != {"torn", "bitrot", "enospc", "fsync", "rename"} or not any(
            s["family"] == "crash" and s["site"] == "serve.wal.gc"
            for s in plan["faults"]):
        fail(f"{tag}: the committed plan {plan}")
    rows = [r for r in run.rows if r.get("kind") == "disk"]
    if len(rows) != 1:
        fail(f"{tag}: disk rows {rows}")
    d = rows[0]["disk"]["disk"]
    if not all(d["checks"].values()) or not (
            d["gc_cycles"] >= 3 or d["checks"]["disk_bounded"]
            == "skipped: insufficient_gc_cycles") \
            or d["scrub"]["clean"] is not True \
            or rows[0]["disk"]["restore_bit_identical"] is not True:
        fail(f"{tag}: the disk row {rows[0]['disk']}")
    names = event_names(run.evs)
    for need in ("serve.disk", "serve.gc", "serve.shed"):
        if need not in names:
            fail(f"{tag}: no {need} in the stream")
    port_cli("ci disk", "cause_tpu_torch.obs",
             ["ledger", "--ledger", run.env["CAUSE_TPU_LEDGER"], "--check"],
             env=run.env)
    s = rows[0]["disk"]
    say(f"{tag} {' '.join(CI_DISK)}: exit 0 in {run.secs:.1f} s (host "
        f"clock); measured {s['steady_per_s']} batch/s, floor "
        f"{s['floor_ms']} ms a wave; injected {d['injected_by_mode']} + "
        f"{d['gc_crashes_injected']} mid-GC crash, durability sheds "
        f"{d['durability_sheds_by_reason']}, serve.disk "
        f"{d['serve_disk_events_by_op']}; {d['gc_cycles']} GC cycles "
        f"(extension {d['extension_s']} s), live WAL {d['final_live_bytes']} "
        f"bytes; every check {d['checks']}; scrub clean "
        f"({d['scrub']}), restore bit-identical; serve scrub exit 0, "
        f"watch --once prints wal:, ledger --check exit 0")


def soak_overload(run: Beside, card: str) -> None:
    """Phase 18 (d): the overload run at phase 10's served size: its own
    gates (exit 0: both crashes survived, every shed evidenced, the
    dispatch collapse held, every tenant bit-identical to the journal
    oracle); its numbers, and the B1 launches of its timed window beside
    the costmodel's dispatches."""
    tag = "[18 overload]"
    rows = [r for r in run.rows if r.get("kind") == "serve"]
    if len(rows) != 1:
        fail(f"{tag}: serve rows {rows}")
    s = rows[0]["serve"]
    if s["crashes"] < 2 or not any(x.startswith(
            "serve soak: dispatch collapse held") for x in run.lines):
        fail(f"{tag}: crashes {s['crashes']}, lines {run['lines'][-6:]}")
    window = next((json.loads(x.split(" ", 2)[2]) for x in run.lines
                   if x.startswith("timed-window launches ")), None)
    if not window or not all(window[n] for n in V5_LAUNCHES):
        fail(f"{tag}: timed-window launches {window}")
    disp = s["dispatch"]
    # the gate's bound without its restore allowance: whether the
    # collapse held on the waves alone
    bare = disp["buckets"] + 3 * disp["fallbacks"] + disp["ticks_touched"]
    say(f"{tag} {' '.join(OVERLOAD)}: exit 0 in {run.secs:.1f} s (host "
        f"clock, the fleet's build and the calibration included, beside "
        f"phase 18's in-process part and CI's smokes); "
        f"measured {s['steady_per_s']} batch/s, floor {s['floor_ms']} ms a "
        f"wave, offered {s['offered_per_s']} batch/s ({s['offered']} "
        f"offers, {s['gen_refused']} refused); {s['admitted_ops']} ops "
        f"admitted in {s['ticks']} ticks; lag p50 {s['p50_ms']} ms p99 "
        f"{s['p99_ms']} ms; sheds {s['sheds']} by rung {s['shed_by_rung']}, "
        f"all evidenced; {s['crashes']} crashes survived, MTTR "
        f"{s['mttr_ms']} ms; dispatches {disp['wave_dispatches']} against "
        f"{disp['buckets']} buckets, {disp['fallbacks']} fallbacks, "
        f"{disp['restores']} restores over {disp['ticks_touched']} touched "
        f"ticks ({disp['tenant_touches']} tenant touches; the bound without "
        f"the restores' allowance {bare}, held: "
        f"{disp['wave_dispatches'] <= bare}); the timed "
        f"window's launches {window}: B1 {window['sort']} = "
        f"{window['sort'] / 6:g} six-sort dispatches (the costmodel's "
        f"bucket waves plus the uncounted B = 1 side applies and serde "
        f"reweaves); every tenant bit-identical to the journal oracle; "
        f"{card}")


def phase_serve_soak(torch, dev, card: str) -> tuple:
    """Phase 18: the serving plane's acceptance instruments on the card
    (``cause_tpu_torch.serve_soak``, ``batched_smoke``, ``obs_off_pin``).
    The overload run and CI's serve and disk smokes run in subprocesses
    beside the in-process part. Returns the calibration's launches on the
    kernels and its timed calls' sums."""
    import tempfile

    from cause_tpu_torch import serve_soak

    t_phase = time.perf_counter()
    runs = []
    # the overload run's calibration and window price the card and the
    # host as the in-process part shares them; its offered 2x is twice
    # what it measured so
    with tempfile.TemporaryDirectory(prefix="serve-soak-") as tmp:
        try:
            runs.append(soak_start(tmp, "overload", OVERLOAD,
                                   code=SOAK_WINDOW))
            runs.append(soak_start(tmp, "ci_serve", CI_SERVE))
            runs.append(soak_start(tmp, "ci_disk", CI_DISK))
            t0 = time.perf_counter()
            pairs = serve_soak._mk_fleet(SERVE_TENANTS, SERVE_LIST)
            torch.cuda.synchronize()
            say(f"[18 serve soak] serve_soak._mk_fleet({SERVE_TENANTS}, "
                f"{SERVE_LIST}) in {time.perf_counter() - t0:.1f} s (host "
                f"clock)")
            counts, per = soak_calibration(torch, tmp, pairs)
            del pairs
            soak_batched(torch, tmp)
            pin = port_cli("obs-off pin", "cause_tpu_torch.obs_off_pin",
                           ["--check"])
            say(f"[18 obs-off pin] {pin.strip()}")
            a_secs = time.perf_counter() - t_phase
            overload, ci_serve, ci_disk = [soak_finish(r) for r in runs]
            soak_ci_serve(ci_serve)
            soak_ci_disk(ci_disk)
            soak_overload(overload, card)
        finally:
            # a failed check exits with the smokes still running: stop
            # them before their directory goes
            for run in runs:
                run.stop()
    say(f"[18 serve soak] phase {time.perf_counter() - t_phase:.1f} s (host "
        f"clock; the in-process part {a_secs:.1f} s, beside it the CI "
        f"smokes {ci_serve.secs:.1f} and {ci_disk.secs:.1f} s and the "
        f"overload run {overload.secs:.1f} s); {card}")
    return counts, per


# -------------------------------------------------- 19. the wire soak

# phase 19: (a) the in-process drive at phase 10's served size (never
# cut): WIRE_ROUNDS rounds of one ClientDriver batch a client, seeded
# from WIRE_SEED, and WIRE_FRAMES frames of net_soak._frame_bench; (b)
# the reference CI's net, journey and ship smokes at CI's flags and
# ship_soak at its defaults; (c) the net soak at the served size
# through the CLI. Its window and mint cadence come from a run at 40 s
# on an NVIDIA H100 80GB HBM3 (PERF.md section 4): client 2's 9th
# delta frame went at 4.1 s, the crash (tick 10) at 8.4 s and its
# restore took 14.5 s, so 30 s holds every fault of the committed plan
# and outlasts the restore; a mint a second keeps the oracle's replay
# at about 800 journal entries
WIRE_SEED, WIRE_ROUNDS, WIRE_FRAMES = 13, 4, 50
NET_PLAN = "measurements/net_plan_r13.json"
CI_NET = ["--seconds", "8", "--seed", "13", "--chaos", NET_PLAN]
SERVED_NET = ["--clients", str(SERVE_TENANTS), "--doc", str(SERVE_LIST),
              "--proc-clients", "2", "--chaos", NET_PLAN, "--seed", "13",
              "--seconds", "30", "--mint-every", "1.0"]
WIRE_SOAK_TIMEOUT = 600
# the served net soak's CLI, with the kernel launches of its whole run
# printed after main returns
NET_RUN = """\
import json, sys
from cause_tpu_torch import chaos, kernels, net_soak
kernels.reset_launches()
rc = net_soak.main(sys.argv[1:])
print("run launches " + json.dumps(dict(kernels.launches)), flush=True)
chaos.reset()
sys.exit(rc)
"""


def wire_start(tmp: str, tag: str, module: str, args, flag="--obs-out",
               code=None) -> Beside:
    """``python -m module args flag tmp/<tag>`` (or ``python -c code
    ...``) started from the checkout's root beside this process, its
    ledger at ``tmp/<tag>.ledger.jsonl``; ``flag`` names its sidecar or
    scratch prefix."""
    out = os.path.join(tmp, tag)
    cmd = ([sys.executable, "-c", code] if code else
           [sys.executable, "-m", module])
    run = Beside(f"[19 {tag}]", cmd + list(args) + [flag, out],
                 WIRE_SOAK_TIMEOUT, env={"CAUSE_TPU_LEDGER": os.path.join(
                     tmp, f"{tag}.ledger.jsonl")})
    run.out = out
    return run


def wire_finish(run: Beside, clean: str) -> Beside:
    """A run of ``wire_start`` collected: exit 0 within
    WIRE_SOAK_TIMEOUT, a line starting ``clean``. Adds its stdout's
    lines and its ledger's rows."""
    run.collect()
    run.lines = run.stdout.strip().splitlines()
    if not any(x.startswith(clean) for x in run.lines):
        fail(f"{run.tag} did not end clean: {run.stdout[-4000:]}")
    with open(run.env["CAUSE_TPU_LEDGER"]) as f:
        run.rows = [json.loads(x) for x in f if x.strip()]
    return run


def wire_row(run: Beside, kind: str) -> dict:
    rows = [r for r in run.rows if r.get("kind") == kind]
    if len(rows) != 1:
        fail(f"{run.tag}: {kind} rows {rows}")
    return rows[0]


def wire_drive(torch, tmp: str, tag: str, pairs, record=None) -> dict:
    """Phase 19 (a), one run: a service of the net soak's shape (capacity
    = the fleet, ``d_max`` 32, a journal) over ``pairs``, a loopback
    ``ReplicationServer``, ``net_soak._frame_bench`` and WIRE_ROUNDS
    rounds in which each of ``net_soak.ClientDriver``'s clients (one a
    tenant, site ids seeded from WIRE_SEED, threads never started)
    mints one batch and pumps it from this thread, each round ticked
    until drained; under ``plain_path(record=...)`` when ``record`` is
    a list. Returns the run's launches, digests, ticks, frame round trip,
    seconds, journal path and the service (open, for ``materialize``)."""
    import threading

    from cause_tpu_torch import ids, kernels, net_soak
    from cause_tpu_torch.net import ReplicationServer
    from cause_tpu_torch.serve import (IngestJournal, IngestQueue,
                                       ResidencyManager, SyncService)

    root = os.path.join(tmp, tag)
    journal = os.path.join(root, "ingest.jsonl")
    os.makedirs(root)
    queue = IngestQueue(max_ops=256, defer_frac=1.0,
                        journal=IngestJournal(journal))
    svc = SyncService(queue, residency=ResidencyManager(capacity=len(pairs)),
                      checkpoint_dir=os.path.join(root, "ckpt"), d_max=32)
    uuids = [svc.add_tenant(a, b) for a, b in pairs]
    srv = ReplicationServer(svc).start()
    ids._rng.seed(WIRE_SEED)  # both runs mint the same sites and ops
    drivers = [net_soak.ClientDriver(i, srv.port, u, WIRE_SEED, 0.0,
                                     threading.Event())
               for i, u in enumerate(uuids)]
    path = (plain_path(record=record) if record is not None
            else contextlib.nullcontext())
    ticks = 0

    def drain():
        nonlocal ticks
        while queue.depth or queue.deferred:
            svc.tick()
            ticks += 1

    t0 = time.perf_counter()
    with launches_in() as counts, path:
        frame_rt = net_soak._frame_bench(srv.port, uuids[0], WIRE_FRAMES)
        drain()
        for _ in range(WIRE_ROUNDS):
            for d in drivers:
                if not d.client.queue_ops(d.uuid, d.site, d._mint_batch()):
                    fail(f"[19 wire drive] {tag}: client {d.idx} shed")
                d.client.pump()
                if d.client.outbound_depth:
                    fail(f"[19 wire drive] {tag}: client {d.idx} left "
                         f"{d.client.outbound_depth} ops unacked")
            drain()
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    digests = {u: svc.converged_digest(u) for u in uuids}
    for d in drivers:
        d.client.close()
    srv.stop()
    return {"counts": counts, "digests": digests, "ticks": ticks,
            "frame_rt": frame_rt, "secs": secs, "journal": journal,
            "svc": svc, "uuids": uuids,
            "minted": sum(d.minted for d in drivers),
            "stats": dict(srv.stats)}


def wire_drives(torch, tmp: str) -> tuple:
    """Phase 19 (a): ``net_soak._mk_tenants`` at phase 10's served size,
    ``wire_drive`` on the kernels (B1-B3 launched, K1, K2, K4 not), then
    in a second service over the same pairs on the plain path with every
    kernel call recorded and held against its plain version (one call a
    kernel, row count and width class timed): equal admissions, every
    tenant's converged digest equal, and both services' documents equal
    to ``net_soak._journal_oracle`` of the first run's journal, whose
    entries equal the second's. Returns the kernel run's launches and
    the timed calls' sums."""
    from cause_tpu_torch import chaos, net_soak
    from cause_tpu_torch.serve import IngestJournal

    tag = "[19 wire drive]"

    class Keyed:
        def add_tenant(self, a, b):
            return str(a.ct.uuid)

    t0 = time.perf_counter()
    uuids, pairs_init = net_soak._mk_tenants(Keyed(), SERVE_TENANTS,
                                             SERVE_LIST)
    pairs = [pairs_init[u] for u in uuids]
    torch.cuda.synchronize()
    say(f"{tag}: net_soak._mk_tenants({SERVE_TENANTS}, {SERVE_LIST}) in "
        f"{time.perf_counter() - t0:.1f} s (host clock); memory_reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
    k = wire_drive(torch, tmp, "kernels", pairs)
    expect_launches(k["counts"], tuple(V5_LAUNCHES), tag)
    fr = k["frame_rt"]
    say(f"{tag}: on the kernels, {WIRE_FRAMES} frames of _frame_bench "
        f"(round trip mean {fr['mean_ms']} ms, p50 {fr['p50_ms']}, max "
        f"{fr['max_ms']}) and {WIRE_ROUNDS} rounds of one batch from each "
        f"of {SERVE_TENANTS} clients ({k['minted']} ops minted, "
        f"{k['stats']['admitted_ops']} admitted over the wire) in "
        f"{k['ticks']} ticks, {k['secs']:.1f} s (host clock); launches "
        f"{k['counts']}")
    calls = []
    p = wire_drive(torch, tmp, "plain", pairs, record=calls)
    # frames and heartbeats follow the wall clock (the clients' pings)
    same = ("admitted_ops", "acks", "nacks", "dup_frames", "ooo_frames",
            "poison_nacks")
    if any(p["stats"][x] != k["stats"][x] for x in same) \
            or p["ticks"] != k["ticks"]:
        fail(f"{tag}: the plain run admitted {p['stats']} in {p['ticks']} "
             f"ticks, the kernels {k['stats']} in {k['ticks']}")
    if p["digests"] != k["digests"]:
        bad = sorted(u for u in k["digests"]
                     if p["digests"].get(u) != k["digests"][u])
        fail(f"{tag}: converged digests differ on the plain path: {bad}")

    def entries(path):
        jr = IngestJournal(path)
        out = [(e["uuid"], e["site"], e["items"]) for e in jr.iter_from(0)]
        jr.close()
        return out

    if entries(p["journal"]) != entries(k["journal"]):
        fail(f"{tag}: the two runs' journals hold different batches")
    t0 = time.perf_counter()
    with chaos.suspended():
        oracle, n = net_soak._journal_oracle(pairs_init, k["journal"])
        for run in (k, p):
            bad = [u for u in run["uuids"] if not net_soak._doc_equal(
                run["svc"].materialize(u), oracle[u])]
            if bad:
                fail(f"{tag}: tenants {bad} differ from the journal oracle")
    for run in (k, p):
        run["svc"].close()
    say(f"{tag}: the same drive on the plain path in {p['secs']:.1f} s (host "
        f"clock), {len(calls)} kernel calls recorded; every tenant's "
        f"converged_digest equal to the kernel run's, the journals' "
        f"{n} batches equal, and both runs' {len(uuids)} documents equal "
        f"to net_soak._journal_oracle ({time.perf_counter() - t0:.1f} s)")
    per = check_recorded(torch, calls, tag, sites=("wire",),
                         timed=TimedPerWidth())
    say(f"{tag}: {kernel_sums_line(per)}")
    return k["counts"], per


def wire_ci_net(run: Beside) -> dict:
    """Phase 19 (b): the reference CI's net-smoke checks on the port's
    run: its Python block on the row and the sidecar, ``obs watch
    --once`` with a ``net:`` line, ``obs ledger --check``."""
    from cause_tpu_torch.obs import perfetto

    tag = run.tag
    watch = port_cli("ci net", "cause_tpu_torch.obs",
                     ["watch", run.out, "--once"], env=run.env)
    if "net: " not in watch:
        fail(f"{tag}: watch --once printed no net line: {watch[-2000:]}")
    with open(os.path.join(REPO_ROOT, NET_PLAN)) as f:
        plan = json.load(f)

    def planned(mode):
        return sum(len(s.get("at") or ()) for s in plan["faults"]
                   if s["family"] == "net" and s.get("mode") == mode)

    dups, partitions = planned("dup"), planned("partition")
    if dups < 1 or partitions < 1:
        fail(f"{tag}: the committed plan {plan}")
    row = wire_row(run, "net")
    n = row["net"]
    if n["dup_frames"] != dups or n["minted_ops"] <= 0 \
            or n["acked_ops"] + n["dup_acked_ops"] \
            + n["resumed_skipped_ops"] != n["minted_ops"] \
            or n["minted_ops_missing"] or n["client_shed_ops"] \
            or n["crashes"] != 1 or n["reconnects"] < 1 \
            or n["dial_failures"] < partitions \
            or n["partition_mttr_mean_ms"] is None:
        fail(f"{tag}: the net row {n}")
    evs = perfetto.load_jsonl(run.out)
    names = event_names(evs)
    for need in ("net.connect", "net.reconnect", "net.heartbeat",
                 "net.dup_frame", "sync.reject"):
        if need not in names:
            fail(f"{tag}: no {need} in the stream")
    n_dup = len(fields_of(evs, "net.dup_frame"))
    if n_dup != dups:
        fail(f"{tag}: {n_dup} net.dup_frame events, {dups} planned")
    port_cli("ci net", "cause_tpu_torch.obs",
             ["ledger", "--ledger", run.env["CAUSE_TPU_LEDGER"], "--check"],
             env=run.env)
    run.evs = evs
    return row


def wire_faults(run: Beside) -> list:
    """Each injection of the committed plan's ``at`` schedule, from the
    run's ``chaos.inject`` events, in order: ``(mode, site, seq, ms
    after the first client connect)``; fails when one is missing."""
    with open(os.path.join(REPO_ROOT, NET_PLAN)) as f:
        plan = json.load(f)
    want = {(s.get("mode", s["family"]) if s["family"] != "crash"
             else "", s["site"], n)
            for s in plan["faults"] for n in s.get("at") or ()}
    t0 = min(e["ts_us"] for e in run.evs if e.get("name") == "net.connect")
    got = [(f["mode"], f["site"], f["seq"], (f["ts_us"] - t0) / 1e3)
           for f in fields_of(run.evs, "chaos.inject")]
    missing = want - {g[:3] for g in got}
    if missing:
        fail(f"{run.tag}: planned faults that never fired: "
             f"{sorted(missing)}; fired {got}")
    return got


def wire_ci_journey(run: Beside) -> dict:
    """Phase 19 (b): the reference CI's journey-smoke checks: ``obs
    journey --worst 3`` over both streams with CI's three lines, the
    row's asserts, ``obs ledger --check``."""
    tag = run.tag
    rep = port_cli("ci journey", "cause_tpu_torch.obs",
                   ["journey", "--worst", "3", run.out, run.out + ".client"],
                   env=run.env)
    for need in ("0 orphan hop(s)", "per-hop decomposition",
                 "clock (ref pid"):
        if need not in rep:
            fail(f"{tag}: obs journey printed no {need!r}: {rep[-2000:]}")
    row = wire_row(run, "journey")
    j = row["journey"]
    if j["processes"] != 2 or j["orphan_hops"] or j["clock_edges"] < 1 \
            or not j["total_ms"] or j["total_ms"] <= 0:
        fail(f"{tag}: the journey row {j}")
    port_cli("ci journey", "cause_tpu_torch.obs",
             ["ledger", "--ledger", run.env["CAUSE_TPU_LEDGER"], "--check"],
             env=run.env)
    return row


def wire_ci_ship(run: Beside) -> dict:
    """Phase 19 (b): the reference CI's ship-smoke checks: the row's
    asserts and ``obs ledger --check``."""
    row = wire_row(run, "ship")
    s = row["ship"]
    if s["producers"] != 2 or s["orphan_hops"] \
            or s["missed"] != s["evidenced_drops"] or s["dup_skipped"] <= 0:
        fail(f"{run.tag}: the ship row {s}")
    port_cli("ci ship", "cause_tpu_torch.obs",
             ["ledger", "--ledger", run.env["CAUSE_TPU_LEDGER"], "--check"],
             env=run.env)
    return row


def wire_ship_soak(run: Beside) -> str:
    """Phase 19 (b): ``ship_soak`` at its defaults: exit 0 with its
    fleet, data-plane and overhead lines and a ``ship`` row that ``obs
    ledger --check`` passes. An exit on the 1% overhead gate alone (the
    fleet and data-plane phases clean) is a finding, printed with its
    numbers; the gate stays as it is. Returns the line to print."""
    run.wait()
    lines = run.stdout.strip().splitlines()
    miss = [x for x in run.stderr.splitlines()
            if "AssertionError: exporter overhead" in x]
    if run.proc.returncode and miss and any(
            x.startswith("ship soak: data plane bit-identical")
            for x in lines):
        return (f"FINDING: the 1% exporter-overhead gate missed "
                f"({miss[-1].split(': ', 1)[1]}); the fleet and data-plane "
                f"phases clean: {lines[-3:]}")
    run = wire_finish(run, "ship soak: clean")
    s = wire_row(run, "ship")["ship"]
    port_cli("ship soak", "cause_tpu_torch.obs",
             ["ledger", "--ledger", run.env["CAUSE_TPU_LEDGER"], "--check"],
             env=run.env)
    return (f"exit 0 in {run.secs:.1f} s (host clock): {s['journeys']} "
            f"journeys, {s['accepted']} accepted, {s['missed']} missed == "
            f"{s['evidenced_drops']} evidenced, {s['faults_injected']} "
            f"faults; data-plane digest {s['dataplane_digest']} bit-identical "
            f"under full partition; exporter overhead {s['overhead_pct']}% "
            f"(per-pair median; base {s['median_base_ms']} ms, shipped "
            f"{s['median_ship_ms']} ms); ledger --check exit 0")


def wire_served(run: Beside, card: str) -> dict:
    """Phase 19 (c): the net soak at the served size: exit 0 (the
    journal oracle, every planned fault detected, the journey gate),
    CI's net checks on its row and stream, the journey row, every fault
    of the plan fired; its numbers and the B1-B3 launches of its run."""
    row = wire_ci_net(run)
    faults = wire_faults(run)
    if "journey" not in row:
        fail(f"{run.tag}: no journey summary in the row")
    launches = next((json.loads(x.split(" ", 2)[2]) for x in run.lines
                     if x.startswith("run launches ")), None)
    if not launches or not all(launches[n] for n in V5_LAUNCHES):
        fail(f"{run.tag}: run launches {launches}")
    n, j = row["net"], row["journey"]
    say(f"{run.tag} {' '.join(SERVED_NET)}: exit 0 in {run.secs:.1f} s "
        f"(host clock, the fleet's build included, beside phase 19's "
        f"in-process part); {n['ticks']} ticks, {n['minted_ops']} ops "
        f"minted, {n['journal_entries']} journal entries; frame round trip "
        f"{n['frame_rt']}; {n['reconnects']} reconnects, "
        f"{n['dial_failures']} failed dials, {n['dup_frames']} duplicates "
        f"suppressed exactly; partition MTTR mean "
        f"{n['partition_mttr_mean_ms']} ms {n['partition_mttr_ms']}; crash "
        f"MTTR {n['crash_mttr_ms']} ms; journeys {j}; faults fired "
        f"(mode, site, call, ms after the first connect) {faults}; the "
        f"run's launches {launches}; {card}")
    return launches


def phase_wire_soak(torch, dev, card: str) -> tuple:
    """Phase 19: the wire and ship plane's acceptance instruments on the
    card (``cause_tpu_torch.journey_smoke``, ``net_soak``,
    ``ship_smoke``, ``ship_soak``). CI's journey smoke runs first, alone
    (its causal-order gate rests on one clock sample, ROADMAP C.7); the
    other CLIs then run in subprocesses beside the in-process drive.
    Returns the drive's launches on the kernels and its timed calls'
    sums."""
    import tempfile

    t_phase = time.perf_counter()
    runs = []
    with tempfile.TemporaryDirectory(prefix="wire-soak-") as tmp:
        try:
            journey = wire_start(tmp, "ci_journey",
                                 "cause_tpu_torch.journey_smoke", [])
            runs.append(journey)
            wire_finish(journey, "journey smoke: clean")
            jrow = wire_ci_journey(journey)
            say(f"[19 ci journey]: exit 0 in {journey.secs:.1f} s (host "
                f"clock, alone); trace {jrow['journey']['trace']} over 2 "
                f"processes, {jrow['journey']['hops']} hops, 0 orphans, "
                f"{jrow['journey']['clock_edges']} clock edge(s), "
                f"mint->converged {jrow['journey']['total_ms']} ms; obs "
                f"journey --worst 3 prints CI's three lines; ledger --check "
                f"exit 0 ({jrow['platform']}, {jrow['card']})")
            t_b = time.perf_counter()
            served = wire_start(tmp, "served", "", SERVED_NET,
                                code=NET_RUN)
            ci_net = wire_start(tmp, "ci_net", "cause_tpu_torch.net_soak",
                                CI_NET)
            ship = wire_start(tmp, "ci_ship", "cause_tpu_torch.ship_smoke",
                              [], flag="--out")
            soak = wire_start(tmp, "ship_soak", "cause_tpu_torch.ship_soak",
                              [], flag="--out")
            runs += [served, ci_net, ship, soak]
            counts, per = wire_drives(torch, tmp)
            a_secs = time.perf_counter() - t_b
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip()
            say(f"[19 wire soak] after (a): memory_reserved "
                f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB in this "
                f"process; the card's memory.used {smi} with the "
                f"subprocesses beside it")
            wire_finish(ci_net, "net soak: clean")
            row = wire_ci_net(ci_net)
            n = row["net"]
            faults = wire_faults(ci_net)
            say(f"[19 ci net] {' '.join(CI_NET)}: exit 0 in "
                f"{ci_net.secs:.1f} s (host clock, beside (a)); "
                f"{n['minted_ops']} ops, {n['ticks']} ticks, frame round "
                f"trip {n['frame_rt']}; {n['dup_frames']} dups == planned, "
                f"{n['reconnects']} reconnects, {n['dial_failures']} failed "
                f"dials, partition MTTR mean {n['partition_mttr_mean_ms']} "
                f"ms, crash MTTR {n['crash_mttr_ms']} ms; faults fired "
                f"{faults}; net.* events and sync.reject in the stream, "
                f"watch --once prints net:, ledger --check exit 0 "
                f"({row['platform']}, {row['card']})")
            wire_finish(ship, "ship smoke: clean")
            s = wire_ci_ship(ship)["ship"]
            say(f"[19 ci ship]: exit 0 in {ship.secs:.1f} s (host clock); "
                f"{s['accepted']} accepted, {s['missed']} missed == "
                f"{s['evidenced_drops']} evidenced, {s['dup_skipped']} wire "
                f"dups skipped, 0 orphan hops, {s['clock_edges']} clock "
                f"edges; ledger --check exit 0")
            say(f"[19 ship soak]: {wire_ship_soak(soak)}")
            wire_finish(served, "net soak: clean")
            served_counts = wire_served(served, card)
        finally:
            # a failed check exits with the runs still going: stop them
            # before their directory goes
            for run in runs:
                run.stop()
    say(f"[19 wire soak] phase {time.perf_counter() - t_phase:.1f} s (host "
        f"clock; CI's journey smoke alone {journey.secs:.1f} s, then the "
        f"in-process part {a_secs:.1f} s, beside it the served net soak "
        f"{served.secs:.1f} s, CI's net and ship smokes {ci_net.secs:.1f} "
        f"and {ship.secs:.1f} s, ship_soak {soak.secs:.1f} s); launches "
        f"(a) {counts}, (c) {served_counts}; {card}")
    return counts, per


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
    ap.add_argument("--tiles", action="store_true",
                    help="only profile B1's launches at three of the main "
                         "path's calls and time B1 in every form and CTA "
                         "width at the main path's shapes past 8,192 "
                         "lanes and those the rule sends to the network "
                         "form, then exit")
    ap.add_argument("--forms", action="store_true",
                    help="only time B2's row and split forms and B3's row "
                         "and chunk forms at the north star's, the "
                         "tree's and the fleet row's widths over B = 1 to "
                         "256, then exit")
    ap.add_argument("--a1", action="store_true",
                    help="only check and time A1 at the benchmark cells' "
                         "shapes (phase 2a), then exit")
    ap.add_argument("--collector", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.collector:
        # phase 12's collector process, started by the smoke itself
        return collector_child(args.collector)

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
    if args.tiles:
        real = b1_real_calls(torch, dev)
        for label, gen, i in PROFILED_SORTS:
            ops, nk = real[gen][i]
            b1_launch_profile(torch, label, ops, nk)
        tile_sweep(torch, dev, card, real)
        cluster_clocks(torch, dev, real)
        return 0
    if args.forms:
        form_sweep(torch, dev, card)
        return 0
    if args.a1:
        phase_a1(torch, dev, card)
        return 0

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
        say(line + forms_text(rec))
        if name in FORMS and rec["form"] != NORTH_STAR_FORMS[name] and (
                name != "sort" or path == "v5"):
            fail(f"the north star's {path} {name} call takes the "
                 f"{rec['form']} form, not {NORTH_STAR_FORMS[name]}")
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
                f"{ctas_per_sm(name)} ({rec['form']} form)")
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
               else "") + forms_text(rec)
            + (f", each of {'/'.join(forms_of(torch, name, ops, kw))} too"
               if name in FORMS
               else ""))
        per[name]["err"] = max(per[name]["err"], rec["err"])
        if rec["err"]:
            fail(f"{name} kernel disagrees with its plain version ({tag})")
    del edges

    # ------------------------------------------------ 2a. A1, the cells
    a1_cells = phase_a1(torch, dev, card)

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
    # the drift probe's wave: this batch through the bench's scalar
    # program, probed now and again in phase 16
    def probe():
        return benchgen.merge_wave_scalar(*args5, k_max=u_max, kernel="v5",
                                          u_max=u_max, device=dev)

    probe()
    early_ms = drift_probe(torch, "[3 drift]", probe)
    del out, out_f, ref_f, lanes

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
    wave_digest = res.digest
    del res, cached, hs, tree_root
    serve_counts, serve_per, tenants = phase_serve(torch, dev, card)

    # ------------------------------------------------ 11. telemetry
    obs_counts = phase_telemetry(torch, dev, card, pairs, v5, u_max, k_p50,
                                 tenants)

    # ------------------------------------------------ 12. the wire
    wire_counts = phase_wire(torch, dev, card, tenants)
    del tenants

    # ------------------------------------------------ 13. generations
    gen_counts, gen_per, gen_p50 = phase_generations(torch, dev, card,
                                                     batch)

    # ------------------------------------------------ 14. benchmarks
    bench_counts, bench_per = phase_benchmarks(torch, dev, card, k_p50,
                                               gen_p50)

    # ------------------------------------------------ 15. sharded path
    shard_counts, shard_per = phase_sharded(torch, dev, card, batch, v5,
                                            u_max, pairs, wave_digest)
    del batch, pairs

    # ------------------------------------------------ 16. the bench
    bench16_counts = phase_bench(torch, card, k_p50, f_p50, probe, early_ms)

    # ------------------------------------------------ 17. soak, fleet
    soak_counts, fleet_counts, fleet_per = phase_soak(torch, dev, card)

    # ------------------------------------------------ 18. serve soak
    serve_soak_counts, serve_soak_per = phase_serve_soak(torch, dev, card)

    # ------------------------------------------------ 19. wire soak
    wire_soak_counts, wire_soak_per = phase_wire_soak(torch, dev, card)

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
            # phase 11's telemetry-on runs (the api wave twice, the
            # session and its tree, the served round; the phase spans'
            # dispatches excluded)
            "telemetry_launches": obs_counts[name],
            # phase 12's shipped wire round (the served fleet's round
            # over the sockets with telemetry on, shipped to a collector)
            "wire_launches": wire_counts[name],
            # phase 13's runs (v1-v4 at the north star, the ladder's
            # reweaves and merges, the v4 map wave), and its calls'
            # kernel time at their own shapes
            "generations_launches": gen_counts[name],
            "generations_ms": gen_per.get(name, {}).get("ms"),
            "generations_plain_ms": gen_per.get(name, {}).get("plain_ms"),
            "generations_bound_ms": gen_per.get(name, {}).get("bound_ms"),
            "generations_library_ms": gen_per.get(name, {}).get(
                "library_ms"),
            # phase 14's config 5 at the north star (v5 and v4, four
            # steps each), and its calls' kernel time at their own shapes
            "benchmarks_launches": bench_counts[name],
            "benchmarks_ms": bench_per.get(name, {}).get("ms"),
            "benchmarks_plain_ms": bench_per.get(name, {}).get("plain_ms"),
            "benchmarks_bound_ms": bench_per.get(name, {}).get("bound_ms"),
            "benchmarks_library_ms": bench_per.get(name, {}).get(
                "library_ms"),
            # phase 15's sharded steps at the north star (v1-v5f, one
            # step each), and its calls' kernel time at their own shapes
            "sharded_launches": shard_counts[name],
            "sharded_ms": shard_per.get(name, {}).get("ms"),
            "sharded_plain_ms": shard_per.get(name, {}).get("plain_ms"),
            "sharded_bound_ms": shard_per.get(name, {}).get("bound_ms"),
            "sharded_library_ms": shard_per.get(name, {}).get(
                "library_ms"),
            # phase 16's benchmark in this process at the north star (v5,
            # then BENCH_KERNEL=v5f: 28 waves each)
            "bench_launches": bench16_counts[name],
            # phase 17's soup of SOAK_ROUNDS rounds on the kernels, and the
            # fleet bench's kernel levels (v5 and v4 at one row of
            # 10,485,760 lanes: the overflow ladder, a warm and 3 timed
            # steps each) with the last step's calls at their own shapes
            "soak_launches": soak_counts[name],
            "fleet_launches": fleet_counts[name],
            "fleet_ms": fleet_per.get(name, {}).get("ms"),
            "fleet_plain_ms": fleet_per.get(name, {}).get("plain_ms"),
            "fleet_bound_ms": fleet_per.get(name, {}).get("bound_ms"),
            "fleet_library_ms": fleet_per.get(name, {}).get("library_ms"),
            # phase 18's serve_soak calibration rounds on the kernels (32
            # tenants of 10,000 elements), and their calls' kernel time,
            # one call a kernel, row count and width class
            "serve_soak_launches": serve_soak_counts[name],
            "serve_soak_ms": serve_soak_per.get(name, {}).get("ms"),
            "serve_soak_plain_ms": serve_soak_per.get(name, {}).get(
                "plain_ms"),
            "serve_soak_bound_ms": serve_soak_per.get(name, {}).get(
                "bound_ms"),
            "serve_soak_library_ms": serve_soak_per.get(name, {}).get(
                "library_ms"),
            # phase 19's in-process wire drive on the kernels (32 tenants
            # of 10,000 elements over the loopback server), and its
            # calls' kernel time, one call a kernel, row count and width
            # class
            "wire_soak_launches": wire_soak_counts[name],
            "wire_soak_ms": wire_soak_per.get(name, {}).get("ms"),
            "wire_soak_plain_ms": wire_soak_per.get(name, {}).get(
                "plain_ms"),
            "wire_soak_bound_ms": wire_soak_per.get(name, {}).get(
                "bound_ms"),
            "wire_soak_library_ms": wire_soak_per.get(name, {}).get(
                "library_ms"),
        })
    for rec in recs:
        if rec["name"] == "seg_order":
            # phase 2a's calls at the benchmark cells' shapes
            rec["benchmark_cells"] = a1_cells
    say(f"total {time.perf_counter() - t_start:.1f} s (host clock)")
    print(card, flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
