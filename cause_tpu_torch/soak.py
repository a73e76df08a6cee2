"""Long-running differential soak of the port: random CRDT op soups across
every backend and the round-3 machinery (lane caches, incremental
segments, waves, sessions, map forests), checked against the pure oracle
after every step. Runs until --minutes elapses; any failure prints the
(seed, kind) repro pair and exits 1. A port of ``scripts/soak.py``.

    python -m cause_tpu_torch.soak [--minutes 60] [--seed0 0]
    python -m cause_tpu_torch.soak --cpu ...     # plain versions

Runs on the card unless ``--cpu`` asks for the plain versions on the
CPU: without a card and without ``--cpu`` it exits 2 with one line.
Every round draws from ``random.Random(seed)`` in the reference's
order, so a ``(seed, kind)`` pair takes the same draws in both packages
(site ids stay random in both, as ``new_site_id`` mints them).

Chaos mode: ``python -m cause_tpu_torch.soak --chaos plan.json
--obs-out chaos.jsonl`` runs a SEEDED FAULT SCHEDULE over an N-replica
fleet instead of the timed soup — payload corruption on the sync mesh,
dispatch failures / budget exhaustion / stalls on the wave session,
crash-and-restart through the serde checkpoint — and gates:

- **bit-identical convergence**: the faulted fleet's converged root
  (device tree) must equal a fault-free pure-oracle fold replaying
  the same ops with chaos suspended (nodes, weave and EDN equal),
  and no document may carry the chaos corruption marker;
- **every injected fault detected**: payload injects >= sync.reject
  events, dispatch raises >= recovery.retry, budget exhausts >=
  budget-exhaustion ladder steps, crashes >= recovery.restore, and
  stalls measured in the wave wall;
- **zero unrecovered faults / zero unquarantined divergence**: the
  fleet report over the sidecar must show no divergence incidents
  and an empty final quarantine set.

A clean run lands a ``--kind chaos`` row in the port's ledger
(``obs.ledger.default_path()``; value = mean-time-to-reconverge ms;
extra = injected/detected counts and the recovery-path histogram).
Exit 4 = convergence mismatch, exit 5 = undetected fault, exit 3 = a
lag SLO breach (``--slo-ms``) or a lag gate that measured nothing.

Plan schema (JSON)::

    {"seed": 11, "replicas": 8, "rounds": 6, "doc": 40,
     "faults": [
       {"family": "payload",  "site": "sync.delta",
        "mode": "corrupt|truncate|duplicate|reorder|drop",
        "at": [3], "prob": 0.0, "times": 0},
       {"family": "dispatch", "site": "session",
        "mode": "raise|exhaust", "at": [2]},
       {"family": "crash",    "site": "session", "at": [3]},
       {"family": "stall",    "site": "session", "ms": 150,
        "at": [5]}]}

``at`` indexes each spec's own per-site invocation counter (see
``cause_tpu_torch.chaos``); the same plan always injects the same faults
at the same points.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import numpy as np

import cause_tpu_torch as c
from . import K
from .collections import clist as c_list
from .collections.clist import CausalList
from .collections.cmap import CausalMap
from .ids import ROOT_ID, new_site_id
from .parallel import merge_wave
from .parallel.session import FleetSession
from .weaver import mapw
from .weaver.arrays import NodeArrays
from .weaver.segments import SEG_KEYS, tree_segments


def check_view(ct):
    view = ct.lanes
    if view is None:
        return
    assert view.n == len(ct.nodes)
    na_c = view.node_arrays()
    na_f = NodeArrays.from_nodes_map(ct.nodes)
    assert na_c.nodes == na_f.nodes
    n = na_f.n
    assert np.array_equal(na_c.cause_idx[:n], na_f.cause_idx[:n])
    assert np.array_equal(na_c.vclass[:n], na_f.vclass[:n])
    segs = view.arena.seg_cache.get(view.n)
    if segs is not None:
        hi, lo = na_c.id_lanes()
        ref = tree_segments(hi, lo, na_c.cause_idx, na_c.vclass, n)
        for key in SEG_KEYS:
            assert np.array_equal(np.asarray(segs[key]),
                                  np.asarray(ref[key])), key


def list_round(rng):
    cl = CausalList(c_list.weave(
        c.clist(weaver="torch").extend(
            [f"s{i}" for i in range(rng.randrange(1, 60))]
        ).ct
    ))
    cl.ct.lanes.segments()
    pure = CausalList(cl.ct.evolve(weaver="pure"))
    if rng.random() < 0.5:
        # half the rounds run the device handle in lazy-weave mode:
        # stale weaves + tail hints must stay observationally equal to
        # the eager pure oracle through every op and serde round-trip
        cl = CausalList(cl.ct.evolve(lazy_weave=True))
    fork = None
    for step in range(rng.randrange(4, 25)):
        op = rng.randrange(8)
        if op == 0:
            vals = [f"v{step}.{j}" for j in range(rng.randrange(1, 7))]
            cl, pure = cl.extend(vals), pure.extend(vals)
        elif op == 1:
            cl, pure = cl.conj(f"c{step}"), pure.conj(f"c{step}")
        elif op == 2:
            cl, pure = cl.cons(f"f{step}"), pure.cons(f"f{step}")
        elif op == 3 and len(cl.get_weave()) > 2:
            target = rng.choice(cl.get_weave()[1:])[0]
            cl = cl.append(target, c.hide)
            pure = pure.append(target, c.hide)
        elif op == 4:
            fork = CausalList(
                cl.ct.evolve(site_id=new_site_id())
            ).extend([f"fk{step}"])
        elif op == 5 and fork is not None:
            cl = cl.merge(fork)
            pure = CausalList(pure.merge(
                CausalList(fork.ct.evolve(weaver="pure"))
            ).ct.evolve(weaver="pure"))
            fork = None
        elif op == 6:
            nid = (rng.randrange(0, 3), new_site_id(), 0)
            node = (nid, ROOT_ID, f"mid{step}")
            try:
                cl, pure = cl.insert(node), pure.insert(node)
            except c.CausalError:
                pass
        else:
            blob = c.dumps(cl)
            cl = c.loads(blob)
        check_view(cl.ct)
        assert c.causal_to_edn(cl) == c.causal_to_edn(pure), "render"


def wave_round(rng):
    # the reference's bucketed sizes, kept so that a seed takes the same
    # draws in both packages
    n_base = rng.choice((14, 30, 60))
    base = CausalList(c_list.weave(
        c.clist(weaver="torch").extend(["w"] * n_base).ct
    ))
    base.ct.lanes.segments()
    pairs = []
    for p in range(rng.randrange(2, 6)):
        a = CausalList(base.ct.evolve(site_id=new_site_id()))
        b = CausalList(base.ct.evolve(site_id=new_site_id()))
        for _ in range(rng.randrange(1, 5)):
            a = a.conj(f"a{p}") if rng.random() < 0.5 else a.extend(
                [f"ae{p}"]
            )
            b = b.conj(f"b{p}") if rng.random() < 0.5 else b.extend(
                [f"be{p}"]
            )
        if rng.random() < 0.4:
            b = b.append(list(b)[-1][0], c.hide)
        pairs.append((a, b))
    sess = FleetSession(pairs)
    for rnd in range(rng.randrange(1, 4)):
        d = sess.wave()
        res = merge_wave(sess.pairs)
        # digests compare only where the wave computed one on device:
        # a row outside merge_wave's sampled token budget legitimately
        # falls back (digest_valid False) while the session's larger
        # headroom budget still runs it on device
        assert np.array_equal(d[res.digest_valid],
                              res.digest[res.digest_valid]), \
            "session vs wave digest"
        for i in res.fallback:
            a, b = sess.pairs[i]
            assert (c.causal_to_edn(sess.merged(i))
                    == c.causal_to_edn(a.merge(b))), "fallback row"
        i = rng.randrange(len(pairs))
        a, b = sess.pairs[i]
        assert (c.causal_to_edn(sess.merged(i))
                == c.causal_to_edn(a.merge(b))), "materialization"
        nxt = []
        for a, b in sess.pairs:
            if rng.random() < 0.3 and len(list(a)) > 1:
                a = a.append(rng.choice(list(a))[0], c.hide)
            else:
                a = a.conj("x")
            nxt.append((a, b.extend(["y"])))
        sess.update(nxt)
    # fleet-wide convergence closes the round: the pairs diverge from
    # each other (each edited its own soup), so pairwise wave digests
    # legitimately disagree across rows — the merge tree's final level
    # is where every replica agrees on ONE digest, which is also where
    # the convergence-lag tracer resolves this round's ops
    root = sess.converge()
    acc = sess.pairs[0][0]
    for h in [x for pair in sess.pairs for x in pair][1:]:
        acc = acc.merge(h)
    assert (c.causal_to_edn(root) == c.causal_to_edn(acc)), "converge"


def map_round(rng):
    base = c.cmap()
    keys = [K(f"k{i}") for i in range(rng.randrange(2, 8))]
    for k in keys:
        base = base.append(k, "v")
    pairs = []
    for p in range(rng.randrange(2, 5)):
        a = CausalMap(base.ct.evolve(site_id=new_site_id()))
        b = CausalMap(base.ct.evolve(site_id=new_site_id()))
        for _ in range(rng.randrange(1, 6)):
            ka = rng.choice(keys + [K(f"n{p}")])
            a = a.dissoc(ka) if rng.random() < 0.25 else a.append(
                ka, f"a{p}"
            )
            kb = rng.choice(keys)
            b = b.append(kb, f"b{p}")
        if rng.random() < 0.4:
            k0 = rng.choice([k_ for k_ in keys if a.ct.weave.get(k_)])
            target = a.ct.weave[k0][1][0]
            a = a.append(target, c.hide)
        pairs.append((a, b))
    lanes, meta = mapw.pair_rows([(x.ct.nodes, y.ct.nodes)
                                  for x, y in pairs])
    o, r, v, _c_, ov = mapw.batched_merge_map_weave(lanes)
    assert not bool(ov.cpu().any())
    o, r = o.cpu().numpy(), r.cpu().numpy()
    for i, (x, y) in enumerate(pairs):
        got = mapw.merged_map_weave(lanes, meta, o, r, i)
        ref = x.merge(y).ct.weave
        for k in ref:
            assert got[k] == ref[k], ("map", i, k)


def base_round(rng):
    """CausalBase soup: nested maps/lists/sets/counters, random
    transactions, undo/redo walks, serde round-trips, replica sync."""
    from . import cbase as b
    from . import serde, sync
    from .collections.ccounter import CausalCounter
    from .collections.cset import CausalSet

    cb = b.transact_(b.new_cb(), [[None, None, {
        K("doc"): ["hello", {K("meta"): "m"}],
        K("tags"): {"a", "b"},
        K("votes"): c.ccounter(rng.randrange(0, 9)),
    }]])
    undone = 0
    for step in range(rng.randrange(4, 16)):
        op = rng.randrange(6)
        try:
            if op == 0:
                set_uuid = next(u for u, h in cb.collections.items()
                                if isinstance(h, CausalSet))
                cb = b.transact_(cb, [[set_uuid, None,
                                       {f"t{step}", f"u{step}"}]])
            elif op == 1:
                ctr_uuid = next(u for u, h in cb.collections.items()
                                if isinstance(h, CausalCounter))
                cb = b.transact_(cb, [[ctr_uuid, c.root_id,
                                       rng.randrange(-3, 4) or 1]])
            elif op == 2:
                cb = b.transact_(cb, [[cb.root_uuid, K(f"k{step}"),
                                       [step, str(step)]]])
            elif op == 3 and cb.history:
                cb = b.undo_(cb)
                undone += 1
            elif op == 4 and undone:
                cb = b.redo_(cb)
                undone -= 1
            else:
                cb = serde.loads(serde.dumps(b.CausalBase(cb))).cb
        except c.CausalError:
            pass  # guards (nothing-to-undo etc.) are legal outcomes
        b.cb_to_edn(cb)  # must always render
    ra = b.CausalBase(cb.evolve(site_id="siteA________"))
    rb = b.CausalBase(cb.evolve(site_id="siteB________"))
    ra = b.CausalBase(b.transact_(ra.cb, [[ra.cb.root_uuid, K("ra"), 1]]))
    rb = b.CausalBase(b.transact_(rb.cb, [[rb.cb.root_uuid, K("rb"), 2]]))
    sa, sb = sync.sync_base_pair(ra, rb)
    assert b.cb_to_edn(sa.cb) == b.cb_to_edn(sb.cb), "base sync diverged"


def _rand_node(rng, handle, site_id):
    """The reference fuzzer's node mint (list_test.cljc:15-29 twin):
    random existing cause, random value incl. specials, fresh ts."""
    ct = handle.ct
    value = rng.choice(
        ["x", "y", 1, None, c.hide, c.h_hide, c.h_show])
    cause = rng.choice(list(ct.nodes.keys()))
    yarn = ct.yarns.get(site_id)
    yarn_ts = yarn[-1][0][0] if yarn else 0
    return c.node(1 + max(cause[0], yarn_ts), site_id, cause, value)


def gc_round(rng):
    """Random churn + compact (with and without a stability frontier) —
    the rendered document must never change, the compacted tree must
    keep merging/syncing."""
    from . import sync
    from .gc import compact, stability_frontier

    cl = c.clist(*[str(i) for i in range(rng.randrange(1, 12))])
    sites = [new_site_id() for _ in range(2)]
    for _ in range(rng.randrange(5, 25)):
        cl = cl.insert(_rand_node(rng, cl, rng.choice(sites)))
    before = c.causal_to_edn(cl)
    out = compact(cl)
    assert c.causal_to_edn(out) == before, "gc changed the document"
    peer = CausalList(cl.ct.evolve(site_id=new_site_id())).conj("P")
    a, b = sync.sync_pair(out, peer)
    assert c.causal_to_edn(a) == c.causal_to_edn(b), "gc sync diverged"
    f = stability_frontier(sync.version_vector(cl),
                           sync.version_vector(peer))
    out2 = compact(cl, stable_vv=f)
    assert c.causal_to_edn(out2) == before, "frontier gc changed doc"


V5F_CAP, V5F_U = 64, 128  # v5f_round's row capacity a tree, token budget


def v5f_row(rng):
    """``v5f_round``'s input: a random replica pair (the reference
    fuzzer's node mints on both sides) as one ``benchgen.v5_inputs`` row
    of ``V5F_CAP`` lanes a tree, or None when a tree outgrows it."""
    from . import benchgen
    from .weaver.arrays import SiteInterner

    cap = V5F_CAP
    sites = [new_site_id() for _ in range(3)]
    ra = c.clist(*[str(i) for i in range(rng.randrange(1, 15))])
    rb = CausalList(ra.ct.evolve(site_id=sites[2]))
    for _ in range(rng.randrange(0, 12)):
        ra = ra.insert(_rand_node(rng, ra, sites[0]))
    for _ in range(rng.randrange(0, 12)):
        rb = rb.insert(_rand_node(rng, rb, sites[1]))
    if max(len(ra.ct.nodes), len(rb.ct.nodes)) > cap:
        return None
    interner = SiteInterner(
        nid[1] for h in (ra, rb) for nid in h.ct.nodes)
    rows = []
    for t, h in enumerate((ra, rb)):
        na = NodeArrays.from_nodes_map(h.ct.nodes, cap, interner)
        hi, lo = na.id_lanes()
        cci = np.where(na.cause_idx >= 0,
                       na.cause_idx + t * cap, -1).astype(np.int32)
        rows.append({"hi": hi, "lo": lo, "cci": cci,
                     "vc": na.vclass, "valid": na.valid})
    row = {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}
    return benchgen.v5_inputs(row, cap, s_max=cap)


def v5f_round(rng):
    """The fused token pipeline against v5, bit for bit, on a random
    replica pair at a fixed row capacity, on the run's device: on the
    card v5 launches B1-B3 and v5f K1, K2 and K4 with them."""
    from . import benchgen
    from .benchgen import LANE_KEYS5
    from .device import default_device
    from .weaver.torchw5 import merge_weave_kernel_v5
    from .weaver.torchw5f import merge_weave_kernel_v5f

    v5row = v5f_row(rng)
    if v5row is None:
        return  # a tree must fit the row's capacity
    dev = default_device()
    lanes = benchgen.lanes_from_numpy(v5row, dev)
    args = [lanes[k] for k in LANE_KEYS5]
    u = V5F_U
    base = merge_weave_kernel_v5(*args, u_max=u, k_max=u, device=dev)
    got = merge_weave_kernel_v5f(*args, u_max=u, k_max=u, device=dev)
    for x, y, name in zip(base, got,
                          ("rank", "visible", "conflict", "overflow")):
        assert np.array_equal(x.cpu().numpy(), y.cpu().numpy()), name


ROUNDS = (list_round, wave_round, map_round, base_round, gc_round,
          v5f_round)


def _platform() -> str:
    """The platform tag of the run's device (``gpu`` or ``cpu``)."""
    from .device import default_device
    from .obs.core import platform_of

    return platform_of(default_device())


def _append_soak_ledger_row(args, done: int, seed: int) -> None:
    """The run-of-record row: a completed soak lands in the port's
    ledger (``--kind soak`` — deterministic counters gate, wall time
    never does) with its sidecar's counter digest. Best-effort and
    obs-on only: a ledger failure must never fail a clean soak."""
    from . import obs
    from .obs import ledger

    if not (args.obs_out and obs.enabled()):
        return
    try:
        row = ledger.ingest_record(
            {
                "platform": _platform(),
                "metric": "soak rounds clean",
                "value": None,
                "kernel": "soak",
                # duration partitions the trajectory: a 60-minute
                # soak's counter totals only gate against other
                # 60-minute soaks
                "config": f"minutes={args.minutes:g}",
                "smoke": False,
            },
            source=f"soak seed0={args.seed0} rounds={done} "
                   f"last_seed={seed}",
            obs_jsonl=args.obs_out,
            kind="soak",
        )
        print(f"soak: ledger row ({row['platform']}) -> "
              f"{ledger.default_path()}", flush=True)
    except Exception as e:  # noqa: BLE001 - best-effort ledger append
        print(f"soak: ledger append skipped ({type(e).__name__}: {e})",
              flush=True)


def _lag_gate(args) -> int:
    """The soak's convergence-lag regression gate (``--slo-ms``):
    aggregate the sidecar's ``lag.window`` records, land a ``--kind
    lag`` ledger row (best-effort, like the soak row), and return the
    exit code — nonzero on an SLO breach, so a soak IS a lag gate.
    Ops that never waved (list/map/gc rounds) stay pending and are
    reported, never judged."""
    from .obs import lag, ledger
    from .obs.perfetto import load_jsonl

    summary = lag.lag_summary(load_jsonl(args.obs_out),
                              slo_ms_override=args.slo_ms)
    print(lag.render(summary), flush=True)
    try:
        conv = summary["converged"]
        ledger.ingest_record(
            {
                "platform": _platform(),
                "metric": "soak op convergence lag p99",
                "value": conv["p99_ms"],
                "kernel": "soak",
                "config": f"minutes={args.minutes:g}",
                "smoke": False,
            },
            source=f"soak-lag seed0={args.seed0}",
            kind="lag",
            extra={"lag": {"ops_converged": summary["ops_converged"],
                           "pending": summary["pending"],
                           "p50_ms": conv["p50_ms"],
                           "p99_ms": conv["p99_ms"],
                           "slo": summary["slo"]}},
        )
    except Exception as e:  # noqa: BLE001 - best-effort ledger append
        print(f"soak: lag ledger append skipped "
              f"({type(e).__name__}: {e})", flush=True)
    verdict = summary["slo"]["verdict"]
    if verdict == "BREACH":
        print(f"soak: SLO BREACH — "
              f"{100 * summary['slo']['attainment']:.1f}% of ops "
              f"converged within {summary['slo']['target_ms']:g} ms "
              f"(goal {100 * lag.SLO_GOAL:.0f}%)", flush=True)
        return 3
    if verdict is None:
        # a lag gate that measured nothing must fail loudly, not
        # certify an SLO it never observed
        print("soak: --slo-ms given but no ops converged — nothing "
              "to gate", flush=True)
        return 3
    return 0


# ------------------------------------------------------- chaos mode


def _chaos_fleet(n_replicas: int, doc: int):
    """The chaos fleet: ``n_replicas`` distinct-site device replicas of
    one document (the sync mesh), a symmetric 4-pair FleetSession of
    the same document (the wave/dispatch/crash surface), and pure
    -weaver mirrors of both that replay the same ops with chaos
    suspended — the fault-free oracle trajectory."""
    from . import chaos

    base = CausalList(c_list.weave(
        c.clist(weaver="torch").extend([f"w{i}" for i in range(doc)]).ct
    ))
    base.ct.lanes.segments()
    sites = [new_site_id() for _ in range(n_replicas + 2)]
    mesh = [CausalList(base.ct.evolve(site_id=s)) for s in
            sites[:n_replicas]]
    with chaos.suspended():
        pure_base = base.ct.evolve(weaver="pure", lanes=None)
        mesh_mirror = [CausalList(pure_base.evolve(site_id=s))
                       for s in sites[:n_replicas]]
        pa = CausalList(pure_base.evolve(site_id=sites[-2])).conj("A")
        pb = CausalList(pure_base.evolve(site_id=sites[-1])).conj("B")
    sa = CausalList(base.ct.evolve(site_id=sites[-2])).conj("A")
    sb = CausalList(base.ct.evolve(site_id=sites[-1])).conj("B")
    return mesh, mesh_mirror, sa, sb, pa, pb


def _mttr_ms(events) -> float:
    """Mean time from each ``chaos.inject`` to the next AGREED
    ``wave.digest`` — the reconvergence latency of the faulted
    fleet. Faults with no later agreed wave count against the last
    record (they never reconverged; the convergence gate catches
    that separately)."""
    injects = []
    agreed = []
    last_ts = 0
    for e in events:
        ts = e.get("ts_us")
        if not isinstance(ts, (int, float)):
            continue
        last_ts = max(last_ts, int(ts))
        if e.get("ev") != "event":
            continue
        if e.get("name") == "chaos.inject":
            injects.append(int(ts))
        elif e.get("name") == "wave.digest" \
                and (e.get("fields") or {}).get("agreed"):
            agreed.append(int(ts))
    if not injects:
        return 0.0
    lags = []
    for t0 in injects:
        nxt = next((t for t in agreed if t >= t0), last_ts)
        lags.append(max(0, nxt - t0) / 1000.0)
    return round(sum(lags) / len(lags), 3)


def chaos_soak(args) -> int:
    """The seeded fault-schedule soak (module docstring, "Chaos
    mode"). Returns the process exit code."""
    from . import chaos, obs, sync
    from .obs import ledger
    from .obs.fleet import fleet_report
    from .obs.perfetto import load_jsonl

    with open(args.chaos) as f:
        plan = json.load(f)
    n_replicas = int(plan.get("replicas", 8))
    rounds = int(plan.get("rounds", 6))
    doc = int(plan.get("doc", 40))
    sync.quarantine_reset()
    mesh, mesh_mirror, sa, sb, pa, pb = _chaos_fleet(n_replicas, doc)
    # one wave BEFORE arming chaos: the first wave's kernel builds and
    # allocations must not blur the stall/MTTR measurements, and
    # warm-phase dispatches must not consume the plan's invocation
    # counters
    sess = FleetSession([(sa, sb)] * 4)
    sess.wave()
    chaos.configure(plan=plan)

    stalled_waves = 0
    crashes = 0
    for r in range(rounds):
        obs.event("run.heartbeat", stage="chaos-soak", round=r)
        # --- sync mesh: seeded per-replica edits, two anti-entropy
        # ring laps (payload faults fire inside sync_pair; rejects
        # heal over the validated full-bag resync)
        for i in range(n_replicas):
            mesh[i] = mesh[i].conj(f"m{r}.{i}")
        with chaos.suspended():
            for i in range(n_replicas):
                mesh_mirror[i] = mesh_mirror[i].conj(f"m{r}.{i}")
        for _lap in range(2):
            for i in range(n_replicas):
                j = (i + 1) % n_replicas
                mesh[i], mesh[j] = sync.sync_pair(mesh[i], mesh[j])
        with chaos.suspended():
            for _lap in range(2):
                for i in range(n_replicas):
                    j = (i + 1) % n_replicas
                    mesh_mirror[i], mesh_mirror[j] = sync.sync_pair(
                        mesh_mirror[i], mesh_mirror[j])
        edns = {json.dumps(c.causal_to_edn(h), default=str)
                for h in mesh}
        if len(edns) != 1:
            print(f"chaos soak: mesh diverged at round {r}",
                  flush=True)
            return 4
        # --- wave session: symmetric edits, one wave (dispatch /
        # stall / exhaust faults fire inside); crash faults drop the
        # session and restore it from the serde checkpoint
        sa, sb = sa.conj(f"x{r}"), sb.conj(f"y{r}")
        with chaos.suspended():
            pa, pb = pa.conj(f"x{r}"), pb.conj(f"y{r}")
        sess.update([(sa, sb)] * 4)
        log_before = len(chaos.injected())
        t0 = time.perf_counter()
        sess.wave()
        wall_ms = (time.perf_counter() - t0) * 1000.0
        # a stall is DETECTED only when a stall fault actually fired
        # inside this wave AND the wall time shows the sleep — a
        # naturally slow wave must not satisfy the detection gate
        slept_ms = sum(f.get("stall_ms", 0.0)
                       for f in chaos.injected()[log_before:]
                       if f["family"] == "stall")
        if slept_ms and wall_ms >= slept_ms:
            stalled_waves += 1
        if chaos.should_crash("session"):
            ck = sess.checkpoint()
            del sess  # the crash: ALL in-memory state is gone
            sess = FleetSession.restore(ck)
            crashes += 1
    # --- convergence gates (chaos stays armed: a fault scheduled at
    # the converge dispatch must be survivable too)
    root = sess.converge()
    with chaos.suspended():
        oracle = pa.merge(pb)
        oracle_pure = CausalList(oracle.ct.evolve(weaver="pure"))
    ok = (c.causal_to_edn(root) == c.causal_to_edn(oracle_pure)
          and dict(root.ct.nodes) == dict(oracle_pure.ct.nodes)
          and [n[0] for n in root.get_weave()]
          == [n[0] for n in oracle_pure.get_weave()])
    mesh_ok = all(
        c.causal_to_edn(mesh[i]) == c.causal_to_edn(mesh_mirror[i])
        for i in range(n_replicas))
    blob = json.dumps(
        [c.causal_to_edn(root)] + [c.causal_to_edn(h) for h in mesh],
        default=str)
    clean = chaos.CORRUPT_MARKER not in blob
    obs.flush()

    rep = chaos.chaos_report()
    counters = obs.counters_snapshot()["counters"]
    evs = obs.events()
    exhausts = sum(1 for e in evs if e.get("ev") == "event"
                   and e.get("name") == "recovery.step"
                   and (e.get("fields") or {}).get("reason")
                   == "budget-exhaustion")
    detected = {
        "payload": counters.get("sync.reject", 0),
        "dispatch_raise": counters.get("recovery.retry", 0),
        "dispatch_exhaust": exhausts,
        "crash": counters.get("recovery.restores", 0),
        "stall": stalled_waves,
    }
    injected = dict(rep["by_family"])
    n_raise = sum(1 for f in rep["log"]
                  if f["family"] == "dispatch" and f["mode"] == "raise")
    n_exh = sum(1 for f in rep["log"]
                if f["family"] == "dispatch" and f["mode"] == "exhaust")
    undetected = []
    if detected["payload"] < injected.get("payload", 0):
        undetected.append("payload")
    if detected["dispatch_raise"] < n_raise:
        undetected.append("dispatch/raise")
    if detected["dispatch_exhaust"] < n_exh:
        undetected.append("dispatch/exhaust")
    if detected["crash"] < injected.get("crash", 0):
        undetected.append("crash")
    if detected["stall"] < injected.get("stall", 0):
        undetected.append("stall")

    flr = fleet_report(load_jsonl(args.obs_out))
    quarantined_now = sorted(sync.quarantined())
    mttr = _mttr_ms(evs)
    summary = {
        "injected": injected,
        "injected_total": rep["injected"],
        "detected": detected,
        "recovery": flr["recovery"],
        "divergence_incidents": len(flr["divergence_incidents"]),
        "quarantined_final": quarantined_now,
        "mttr_ms": mttr,
        "converged_bit_identical": bool(ok and mesh_ok and clean),
    }
    obs.event("chaos.done", **summary)
    obs.flush()
    print("chaos soak:", json.dumps(summary, indent=1), flush=True)

    if not (ok and mesh_ok and clean) \
            or flr["divergence_incidents"] or quarantined_now:
        print("chaos soak: CONVERGENCE GATE FAILED", flush=True)
        return 4
    if undetected:
        print(f"chaos soak: UNDETECTED FAULT FAMILIES: {undetected}",
              flush=True)
        return 5
    try:
        row = ledger.ingest_record(
            {
                "platform": _platform(),
                "metric": "chaos soak mean-time-to-reconverge",
                "value": mttr,
                "kernel": "chaos",
                "config": f"replicas={n_replicas} rounds={rounds} "
                          f"seed={plan.get('seed', 0)}",
                "smoke": False,
            },
            source=f"chaos-soak plan={os.path.basename(args.chaos)}",
            obs_jsonl=args.obs_out,
            kind="chaos",
            extra={"chaos": {k: v for k, v in summary.items()
                             if k != "quarantined_final"}},
        )
        print(f"chaos soak: ledger row ({row['platform']}) -> "
              f"{ledger.default_path()}", flush=True)
    except Exception as e:  # noqa: BLE001 - best-effort ledger append
        print(f"chaos soak: ledger append skipped "
              f"({type(e).__name__}: {e})", flush=True)
    print(f"chaos soak: {rep['injected']} fault(s) injected, all "
          f"detected and recovered; fleet bit-identical to the "
          f"fault-free oracle (MTTR {mttr:g} ms)", flush=True)
    return 0


def main(argv=None) -> int:
    from . import obs
    from .device import claim_device
    from .obs import lag

    ap = argparse.ArgumentParser(
        description="differential soak of the port")
    ap.add_argument("--minutes", type=float, default=60.0)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--obs-out", default="",
                    help="stream structured obs events (spans AND the "
                         "CRDT-semantic fleet vocabulary, JSONL) to "
                         "this path instead of raw prints only; a "
                         "clean run also appends a --kind soak row to "
                         "the port's ledger")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="convergence-lag SLO target in ms: after a "
                         "clean run, aggregate the sidecar's lag "
                         "records and exit 3 if attainment misses the "
                         "99%% goal (the soak as a lag-regression "
                         "gate); requires --obs-out")
    ap.add_argument("--chaos", default="",
                    help="run the seeded fault-schedule chaos soak "
                         "from this plan JSON instead of the timed "
                         "soup (see the module docstring); gates on "
                         "bit-identical convergence vs the fault-free "
                         "oracle and on every injected fault being "
                         "detected; lands a --kind chaos ledger row; "
                         "requires --obs-out")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    if args.slo_ms is not None and not args.obs_out:
        ap.error("--slo-ms requires --obs-out (the gate reads the "
                 "sidecar's lag.window records)")
    if args.chaos and not args.obs_out:
        ap.error("--chaos requires --obs-out (the committed obs "
                 "stream IS the fault/recovery evidence)")
    dev = claim_device(args.cpu, "soak")
    if args.obs_out:
        obs.configure(enabled=True, out=args.obs_out)
        # the device's platform tag on every record
        obs.set_platform(dev)
        if args.slo_ms is not None:
            # pin the recorded SLO target so every lag.window carries
            # the gate's own threshold, not the 100 ms default
            lag.set_slo(args.slo_ms)
    if args.chaos:
        from . import chaos as _chaos_mod

        try:
            return chaos_soak(args)
        finally:
            _chaos_mod.reset()
    deadline = time.monotonic() + args.minutes * 60
    seed = args.seed0
    done = 0
    while time.monotonic() < deadline:
        rng = random.Random(seed)
        kind = ROUNDS[seed % len(ROUNDS)]
        try:
            with obs.span("soak.round", kind=kind.__name__, seed=seed):
                kind(rng)
        except Exception as e:  # noqa: BLE001 - repro logging
            obs.event("soak.failure", seed=seed, kind=kind.__name__,
                      error=f"{type(e).__name__}: {e}")
            obs.flush()
            print(f"SOAK FAILURE seed={seed} kind={kind.__name__}: "
                  f"{type(e).__name__}: {e}", flush=True)
            raise
        seed += 1
        done += 1
        obs.counter("soak.rounds").inc()
        if done % 25 == 0:
            print(f"soak: {done} rounds clean (seed {seed})", flush=True)
            # liveness heartbeat for `obs watch` over the sidecar: a
            # soak that stops minting these has wedged, one that keeps
            # minting them while lag pends is merely slow
            obs.event("run.heartbeat", stage="soak", rounds=done,
                      seed=seed,
                      elapsed=round(time.monotonic()
                                    - (deadline - args.minutes * 60), 1))
    done_fields = dict(rounds=done, seed0=args.seed0, last_seed=seed)
    if obs.enabled() and args.obs_out:
        # the soak's cost-model aggregate (waves, dispatches, delta
        # ops, slope verdict) rides the terminal event, computed from
        # the SIDECAR FILE — the in-process ring is bounded and a long
        # soak overflows it, which would make this digest silently
        # disagree with the ledger row's ``cost`` extension
        # (ingest_record scans the same file)
        from .obs import load_jsonl
        from .obs.costmodel import costmodel_digest

        try:
            cost = costmodel_digest(load_jsonl(args.obs_out))
        except OSError:
            cost = {}
        if cost:
            done_fields["cost"] = cost
    obs.event("soak.done", **done_fields)
    obs.flush()
    _append_soak_ledger_row(args, done, seed)
    rc = 0
    if args.slo_ms is not None and obs.enabled() and args.obs_out:
        # the lag gate (report + --kind lag row + exit code) runs
        # only when the operator opted in with --slo-ms: a plain
        # --obs-out soak must not dirty the ledger
        rc = _lag_gate(args)
    print(f"soak finished: {done} rounds clean, no failures", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
