"""The port's north-star benchmark: a batched merge of divergent 10k-node
CausalLists across 1024 replica pairs on one card (``BASELINE.json``
config 5), as ``bench.py`` at the repo root measures the JAX package.

    python -m cause_tpu_torch.bench                    # on the card
    BENCH_FORCE_CPU=1 BENCH_SMOKE=1 python -m cause_tpu_torch.bench

prints ONE JSON line. ``value`` is the headline p50: the amortized
per-wave time over a burst of ``BENCH_BURST`` (8) merge waves with one
terminal wait, what a fleet that keeps its waves queued pays a wave;
``single_dispatch_ms`` is the p50 of one wave waited for on its own.
``vs_target`` (and ``vs_baseline``, the same number) is the 100 ms
target over the headline, at full size on the card only. ``card`` holds
the card's name and power limit as ``nvidia-smi`` prints them, so that
every number of the line stands beside them.

A wave is one ``benchgen.merge_wave_scalar`` call, the batch's merge and
weave reduced to ``[checksum, overflowed rows]`` on the device; a wait
is that tensor's copy to the host (``benchgen.time_dispatch``). The
overflow ladder tries v5 at the sampled token budget and at twice it,
then v4 and v2 at the run budget, then v1; ``BENCH_KERNEL`` (``v5``,
``v5w``, ``v5f``, ``v4``, ``v4w``, ``v3``, ``v2``) puts its kernel first.

The modes, each read from the environment:

- ``BENCH_SMOKE=1``: 8 pairs of 901-node lists instead of the north star;
- ``BENCH_DIV_SWEEP=10,500``: per even level of divergence ops a pair,
  a timed burst of the full-width ``torchwd.batched_weave_digest`` and
  of the delta window (``batched_delta_weave`` + ``splice_ranks``),
  gated on their digests agreeing bit for bit;
- ``BENCH_TREE=16`` (``BENCH_TREE_DIV``): the merge tree over real
  replica handles against the flat fold it replaces, gated on
  bit-identical roots;
- ``BENCH_LAG=64`` (``BENCH_LAG_DOC``, ``BENCH_LAG_ROUNDS``,
  ``BENCH_LAG_SLO_MS``, ``BENCH_LIVE=1``): per-op convergence lag over
  the rounds of a ``FleetSession``, and the live monitor's overhead.

The three modes read their evidence from the telemetry stream, so they
need ``CAUSE_TPU_OBS=1``. With telemetry on, the run's sidecar
(``CAUSE_TPU_OBS_OUT``, else ``measurements_torch/obs_bench_<time>.jsonl``)
gets a Perfetto trace beside it, the artifact and the modes' rows land
in the port's ledger (``obs.ledger``; the card's rows under its
platform tag ``gpu``), and the gap report goes to stderr.

Every mode marshals its host numpy before the first CUDA call, and runs
on the card unless ``BENCH_FORCE_CPU=1`` asks for the plain versions on
the CPU (``platform: "cpu-forced"``). There is no fallback: without a
card, or when a kernel fails to build or launch, the benchmark prints one
failure line (``"value": null`` and ``"error"``) and exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback

from . import obs

NORTH_STAR_MS = 100.0
# the artifact's schema: the reference's version 2
BENCH_SCHEMA_VERSION = 2


class _Overflow(RuntimeError):
    pass


def _flag(name: str) -> bool:
    return os.environ.get(name, "").strip() in ("1", "true", "yes")


def _require_obs(mode: str) -> None:
    """The modes whose evidence is computed from the telemetry stream
    (the sweep's per-path gap verdicts, the tree's per-level
    decomposition, the lag summary) refuse to run without it."""
    if not obs.enabled():
        raise SystemExit(
            f"bench: {mode} requires CAUSE_TPU_OBS=1 (its evidence — "
            f"wave.cost/wave.digest/lag records — is computed from "
            f"the obs event stream; set CAUSE_TPU_OBS_OUT=<path> to "
            f"keep the sidecar)")


def _int_list(name: str, what: str) -> list:
    """The sorted distinct integers of the comma-separated ``name``
    variable; empty when it is unset."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return []
    try:
        return sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        raise SystemExit(f"bench: {name} must be a comma-separated "
                         f"list of {what}; got {raw!r}")


def _sweep_levels() -> list:
    """``BENCH_DIV_SWEEP``: divergence ops a pair, one level each."""
    levels = _int_list("BENCH_DIV_SWEEP", "integers")
    if any(d < 2 or d % 2 for d in levels):
        # the generator splits a level between the pair's two sides
        raise SystemExit("bench: BENCH_DIV_SWEEP levels must be even "
                         "and >= 2 (ops split across the pair's two "
                         "sides)")
    return levels


def _tree_sizes() -> list:
    """``BENCH_TREE``: replicas a fleet, one fleet each."""
    sizes = _int_list("BENCH_TREE", "replica counts")
    if any(n < 4 for n in sizes):
        raise SystemExit("bench: BENCH_TREE fleets need >= 4 replicas "
                         "(smaller fleets have no tree to speak of)")
    return sizes


def _lag_sizes() -> list:
    """``BENCH_LAG``: replicas a fleet (they pair up in the session)."""
    sizes = _int_list("BENCH_LAG", "replica counts")
    if any(n < 2 or n % 2 for n in sizes):
        raise SystemExit("bench: BENCH_LAG fleets need an even replica "
                         "count >= 2 (replicas pair up in the session)")
    return sizes


def card_name_power(dev):
    """The card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (its first card), or None on the CPU."""
    import subprocess

    if dev.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch

        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _claim_device(platform: str):
    """The device every mode runs on, claimed after its marshal:
    ``"cpu"`` (the plain versions) or ``"cuda"``, which raises without
    a card. Sets the package default (the handle-level paths of the tree
    and lag modes read it) and the telemetry's platform. Returns
    ``(device, tag, card)``: the artifact's ``platform`` and ``card``."""
    import torch

    from .device import resolve_device, use_device

    dev = resolve_device(platform)
    if dev.type == "cuda":
        torch.cuda.init()
    use_device(dev)
    obs.set_platform(dev)
    tag = "cuda" if dev.type == "cuda" else "cpu-forced"
    return dev, tag, card_name_power(dev)


def _ledger_platform(tag: str) -> str:
    """The ledger's name for an artifact's platform: the card's rows go
    under the ledger's platform tag (``gpu``), the rest as they are."""
    from .obs import ledger

    return ledger.CHIP_PLATFORM if tag == "cuda" else tag


def _ledger_row(tag: str, kind: str, rec: dict, extra: dict) -> None:
    """One ``kind`` row of a mode into the port's ledger; best-effort,
    as a report."""
    try:
        from .obs import ledger

        ledger.ingest_record(
            dict(rec, platform=_ledger_platform(tag),
                 schema_version=BENCH_SCHEMA_VERSION),
            source=f"bench-{kind}@{time.strftime('%Y-%m-%d')}",
            kind=kind, extra=extra)
    except Exception as e:  # noqa: BLE001 - best-effort rows
        print(f"bench: {kind} ledger append failed ({e})", file=sys.stderr)


def _append_to_ledger(artifact_line: str, obs_out: str) -> None:
    """With telemetry on, the artifact lands in the port's ledger with
    the sidecar's devprof and counter digest. Best-effort: a ledger
    failure costs neither the artifact nor the exit code."""
    if not obs.enabled():
        return
    try:
        from .obs import ledger

        rec = json.loads(artifact_line)
        rec["platform"] = _ledger_platform(rec.get("platform", ""))
        row = ledger.ingest_record(
            rec, source=f"cause_tpu_torch.bench@{time.strftime('%Y-%m-%d')}",
            obs_jsonl=obs_out)
        print(f"bench: ledger row ({row['platform']}) -> "
              f"{ledger.default_path()}", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - best-effort ledger append
        print(f"bench: ledger append failed ({e})", file=sys.stderr)


def _print_gap_report(obs_out: str) -> None:
    """With telemetry on, the gap decomposition (the port's ledger and
    this run's sidecar) on stderr. Best-effort, as a report."""
    if not obs.enabled():
        return
    try:
        from .obs import load_jsonl
        from .obs.costmodel import gap_report, render_gap
        from .obs.ledger import load as ledger_load

        events = load_jsonl(obs_out) if (
            obs_out and os.path.exists(obs_out)) else []
        print(render_gap(gap_report(ledger_load(), events)),
              file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - best-effort report
        print(f"bench: gap report failed ({e})", file=sys.stderr)


def _export_obs_trace(obs_out: str) -> None:
    """The run's sidecar as a Perfetto trace beside it. Best-effort."""
    if not obs_out or not os.path.exists(obs_out):
        return
    try:
        n = obs.export_perfetto(obs_out + ".perfetto.json", jsonl=obs_out)
        print(f"bench: perfetto trace -> {obs_out}.perfetto.json "
              f"({n} events)", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - best-effort export
        print(f"bench: perfetto export failed ({e})", file=sys.stderr)


def _lag_bench(tag: str, card, smoke: bool, rounds: int, marshals: list,
               doc: int, div: int, slo_ms: float) -> dict:
    """``BENCH_LAG``: each fleet of real replica handles as a symmetric
    ``FleetSession`` (every row the same divergent pair, so a round's
    digests all agree and resolve the ops), one conj a replica a round,
    the ``obs.lag`` tracer resolving each op's create-to-converged
    latency. The warm rounds run with telemetry off and the lag registry
    is reset before the measured rounds, which are wave rounds only: a
    tree ``converge()`` would run at another width than any warm round.
    One ``--kind lag`` ledger row a fleet (value: converged p99 ms), and
    with ``BENCH_LIVE=1`` a ``--kind live`` row with the live monitor's
    poll time as a share of the wave rounds' wall."""
    from .obs import lag as lag_mod
    from .parallel.session import FleetSession

    rows = []
    for n, handles in marshals:
        a0, b0 = handles[0], handles[1]
        pairs = [(a0, b0)] * (n // 2)
        obs.configure(enabled=False)
        with obs.span("bench.lag.warm", n=n):
            sess = FleetSession(pairs)
            sess.wave()
            for w in range(2):
                sess.update([(a.conj(f"warm{w}"), b.conj(f"warm{w}b"))
                             for a, b in sess.pairs])
                sess.wave()
        obs.configure(enabled=True)
        # the summary reads this fleet's epoch only: lag_summary sums
        # across reset epochs by design
        lag_mod.reset()
        lag_mod.set_slo(slo_ms)
        fleet_epoch = lag_mod.current_epoch()
        live_att = None
        monitor_s = 0.0
        if _flag("BENCH_LIVE"):
            from .obs import live as live_mod

            live_att = live_mod.attach(source=f"bench-lag-n{n}")
        t_meas0 = time.perf_counter()
        for r in range(rounds):
            sess.update([(a.conj(f"r{r}"), b.conj(f"q{r}"))
                         for a, b in sess.pairs])
            sess.wave()
            if live_att is not None:
                t_mon = time.perf_counter()
                live_att.poll(emit_snapshot=True)
                monitor_s += time.perf_counter() - t_mon
        measured_s = time.perf_counter() - t_meas0
        summary = lag_mod.lag_summary(obs.events(), epoch=fleet_epoch)
        conv = summary["converged"]
        slo = summary["slo"]
        row = {
            "replicas": n, "doc": doc + 1, "div_ops": div,
            "rounds": rounds,
            "ops_converged": summary["ops_converged"],
            "pending": summary["pending"],
            "p50_ms": conv["p50_ms"], "p95_ms": conv["p95_ms"],
            "p99_ms": conv["p99_ms"], "max_ms": conv["max_ms"],
            "slo_ms": slo["target_ms"],
            "attainment": slo["attainment"],
            "verdict": slo["verdict"],
        }
        live_row = None
        if live_att is not None:
            snap = live_att.poll(emit_snapshot=True)
            wave_s = max(1e-9, measured_s - monitor_s)
            live_row = {
                "replicas": n, "rounds": rounds,
                "snapshots": live_att.monitor.snapshots_emitted,
                "snapshot_cadence": "per wave round",
                "alerts": len(live_att.monitor.alerts),
                "alert_rules": [r_.spec for r_ in live_att.monitor.rules],
                "queue_dropped": live_att.dropped,
                "records_folded": snap["records"],
                "monitor_ms": round(monitor_s * 1000.0, 3),
                "wave_wall_ms": round(wave_s * 1000.0, 3),
                "overhead_pct": round(100.0 * monitor_s / wave_s, 3),
            }
            row["live"] = live_row
            live_att.close()
        rows.append(row)
        print(f"bench: lag n={n}: {summary['ops_converged']} ops over "
              f"{rounds} round(s), p50 {conv['p50_ms']} ms / p99 "
              f"{conv['p99_ms']} ms, SLO {slo['target_ms']:g} ms -> "
              f"{slo['verdict']}", file=sys.stderr)
        what = f"{n} replicas x {doc + 1}-node CausalLists"
        if live_row is not None:
            print(f"bench: live n={n}: {live_row['snapshots']} "
                  f"snapshot(s), {live_row['alerts']} alert(s), "
                  f"monitor {live_row['monitor_ms']:g} ms = "
                  f"{live_row['overhead_pct']:g}% of wave wall",
                  file=sys.stderr)
            _ledger_row(tag, "live", {
                "metric": f"live monitor overhead, {what}", "value": None,
                "kernel": "session", "config": f"n{n}-live"},
                {"live": live_row})
        _ledger_row(tag, "lag", {
            "metric": f"op convergence lag p99, {what}",
            "value": conv["p99_ms"], "kernel": "session",
            "config": f"n{n}-lag"}, {"lag": row})
    obs.flush()
    return {
        "metric": f"per-op convergence lag over FleetSession rounds, "
                  f"{doc + 1}-node CausalLists"
                  + (" [smoke size]" if smoke else ""),
        "value": None,
        "unit": "ms",
        "fleets": rows,
        "slo_ms": slo_ms,
        "vs_baseline": 0.0,
        "platform": tag,
        "schema_version": BENCH_SCHEMA_VERSION,
        "card": card,
    }


def _tree_bench(tag: str, card, smoke: bool, reps: int, marshals: list,
                doc: int, div: int) -> dict:
    """``BENCH_TREE``: each fleet of real divergent replica handles
    through the merge tree (``parallel.tree.merge_tree_report``, ``reps``
    times after one warm tree with telemetry off) and once through the
    flat sequential fold it replaces (n - 1 full-width waves, each
    materialized: one rep, the tree's reps carry the repetition), the two
    roots gated on bit-identity (weave and node store). One ``--kind
    tree`` ledger row an arm and fleet; a fleet whose roots differ lands
    none."""
    import numpy as np

    from .parallel import tree as tree_mod

    rows = []
    agree_all = True
    for n, handles in marshals:
        obs.configure(enabled=False)
        with obs.span("bench.tree.warm", n=n):
            tree_mod.merge_tree(handles)
        obs.configure(enabled=True)
        tree_ms = []
        report = None
        for _ in range(reps):
            t0 = time.perf_counter()
            root, report = tree_mod.merge_tree_report(handles)
            tree_ms.append((time.perf_counter() - t0) * 1000.0)
        tree_p50 = float(np.median(tree_ms))
        t0 = time.perf_counter()
        fold = tree_mod.flat_fold(handles)
        fold_ms = (time.perf_counter() - t0) * 1000.0
        agreed = (root.ct.weave == fold.ct.weave
                  and root.ct.nodes == fold.ct.nodes)
        agree_all = agree_all and agreed
        paths = [lv["path"] for lv in report["levels"]]
        post = paths[1:]
        row = {
            "replicas": n, "doc": doc + 1, "div_ops": div,
            "rounds": len(report["levels"]),
            "rounds_expected": tree_mod.tree_rounds(n),
            "paths": paths,
            "post_level0_delta_share": (
                round(sum(1 for p in post if p == "delta") / len(post), 4)
                if post else None),
            "tree_p50_ms": round(tree_p50, 3),
            "tree_reps_ms": [round(x, 3) for x in tree_ms],
            "fold_ms": round(fold_ms, 3),
            "tree_over_fold": round(tree_p50 / max(fold_ms, 1e-9), 4),
            "bit_identical": agreed,
        }
        rows.append(row)
        print(f"bench: tree n={n}: {tree_p50:.1f} ms over "
              f"{len(report['levels'])} round(s) vs fold "
              f"{fold_ms:.1f} ms ({100 * row['tree_over_fold']:.1f}%), "
              + ("BIT-IDENTICAL" if agreed else "MISMATCH")
              + "; the last rep's levels (path, ms): "
              + ", ".join(f"{lv['path']} {lv['ms']:.1f}"
                          for lv in report["levels"]),
              file=sys.stderr)
        if not agreed:
            print(f"bench: tree n={n}: roots DISAGREE — skipping this "
                  "fleet's ledger rows", file=sys.stderr)
            continue
        # the fold is n - 1 sequential full-width rounds: its row keeps
        # its own round count, not the tree's
        for arm, val, arm_extra in (
                ("tree", tree_p50, {"rounds": row["rounds"],
                                    "paths": paths}),
                ("fold", fold_ms, {"rounds": n - 1, "sequential": True})):
            _ledger_row(tag, "tree", {
                "metric": f"fleet convergence ({arm}), {n} replicas x "
                          f"{doc + 1}-node CausalLists",
                "value": round(val, 3),
                "kernel": "v5t" if arm == "tree" else "v5",
                "config": f"n{n}-{arm}"},
                dict(arm_extra, bit_identical=True))
    obs.flush()
    return {
        "metric": f"merge tree vs flat fold fleet convergence, "
                  f"{doc + 1}-node CausalLists"
                  + (" [smoke size]" if smoke else ""),
        "value": None,
        "unit": "ms",
        "fleets": rows,
        "bit_identical": agree_all,
        "vs_baseline": 0.0,
        "platform": tag,
        "schema_version": BENCH_SCHEMA_VERSION,
        "card": card,
    }


def _divergence_sweep(dev, tag: str, card, smoke: bool, reps: int,
                      marshals, B: int, doc: int, cap: int) -> dict:
    """``BENCH_DIV_SWEEP``: at a fixed document shape, a timed burst per
    divergence level of the full-width v5 control
    (``torchwd.batched_weave_digest``) and of the delta window
    (``batched_delta_weave`` + ``splice_ranks`` into the control's
    resident ranks), each emitting ``wave.cost`` with the generator's
    known divergence, so that ``python -m cause_tpu_torch.obs gap``
    reads two cost-over-divergence curves (path ``full`` and ``delta``).
    A level's digests must agree bit for bit (full == prefix + window);
    one that disagrees lands no ledger rows. ``marshals`` is
    ``[(level, delta_sweep_inputs), ...]``, built before the device was
    claimed."""
    import numpy as np
    import torch

    from . import benchgen
    from .benchgen import LANE_KEYS5
    from .obs import costmodel as _cm
    from .weaver import torchwd
    from .weaver.arrays import next_pow2

    n_burst = int(os.environ.get("BENCH_BURST", "8"))
    rows = []
    agree_all = True
    for d, sw in marshals:
        n_div = d // 2
        u_need = int(benchgen.v5_token_budget(sw["full"]))
        u_full = next_pow2(u_need)
        n_w = 2 * sw["wcap"]
        with obs.span("bench.sweep.upload", level=d):
            full = benchgen.lanes_from_numpy(sw["full"], dev)
            win = benchgen.lanes_from_numpy(sw["window"], dev)
            dev_full = [full[k] for k in LANE_KEYS5]
            dev_win = [win[k] for k in LANE_KEYS5]
            pdig = torch.from_numpy(
                sw["prefix_digest"].view(np.int32)).to(dev)
            r0 = torch.from_numpy(sw["r0"]).to(dev)
            starts = torch.from_numpy(sw["starts"]).to(dev)
            counts = torch.from_numpy(sw["counts"]).to(dev)

        def full_dispatch():
            out = torchwd.batched_weave_digest(
                *dev_full, u_max=u_full, k_max=u_full, device=dev)
            if obs.enabled():
                _cm.record_dispatch(f"sweep:full:u{u_full}", site="bench")
            return out

        def begin():
            if obs.enabled():
                _cm.wave_begin("bench")

        def end(path, tokens, budget):
            def close():
                if obs.enabled():
                    _cm.wave_cost(uuid=f"bench:sweep:{d}", pairs=B,
                                  lanes=2 * cap * B, tokens=tokens,
                                  token_budget=budget,
                                  delta_ops=2 * n_div * B, path=path)
            return close

        # ---- the full-width control
        with obs.span("bench.sweep.full_warm", level=d):
            keep = full_dispatch()
            full_dig = keep[2].cpu().numpy().view(np.uint32)
            if bool(keep[3].any()):
                raise RuntimeError(f"sweep level {d}: full control "
                                   "overflowed its token budget")
        full_singles, full_bursts = benchgen.time_dispatch(
            lambda: full_dispatch()[2], reps, n_burst, begin=begin,
            end=end("full", u_need * B, u_full * B))
        full_p50 = float(np.median(full_singles))
        full_amortized = float(np.median(full_bursts))

        # ---- the delta window: the control's ranks and visibility are
        # the resident state a session would hold, spliced every wave
        res_rank, res_vis = keep[0].clone(), keep[1].clone()

        def delta_dispatch():
            rw, vw, dig, ovf = torchwd.batched_delta_weave(
                *dev_win, pdig, r0, u_max=n_w, k_max=n_w, device=dev)
            torchwd.splice_ranks(res_rank, res_vis, rw, vw, starts,
                                 counts, r0)
            if obs.enabled():
                _cm.record_dispatch(f"sweep:delta:w{sw['wcap']}",
                                    site="bench")
                _cm.record_dispatch("sweep:delta_splice", site="bench")
            return rw, vw, dig, ovf

        # the wait copies the digest, queued after the splice on the
        # same stream, so the splice is inside the timed wave
        with obs.span("bench.sweep.delta_warm", level=d):
            _rw, _vw, delta_dig, ovw = delta_dispatch()
            delta_dig = delta_dig.cpu().numpy().view(np.uint32)
            if bool(ovw.any()):
                raise RuntimeError(f"sweep level {d}: delta window "
                                   "overflowed (u_max = N_w should "
                                   "make this impossible)")
        delta_singles, delta_bursts = benchgen.time_dispatch(
            lambda: delta_dispatch()[2], reps, n_burst, begin=begin,
            end=end("delta", 2 * (n_div + 1) * B, n_w * B))
        delta_p50 = float(np.median(delta_singles))
        delta_amortized = float(np.median(delta_bursts))

        # ---- the gate
        agreed = bool(np.array_equal(full_dig, delta_dig))
        agree_all = agree_all and agreed
        if obs.enabled():
            from .obs import semantic as _sem

            # the two generations as two replicas of one document: their
            # digest folds agree iff every row's digests agree
            folds = [int(np.bitwise_xor.reduce(
                x ^ (np.arange(B, dtype=np.uint32) * np.uint32(
                    0x9E3779B1)))) for x in (full_dig, delta_dig)]
            if not agreed and folds[0] == folds[1]:
                folds[1] ^= 1  # never mask a real mismatch
            _sem.observe_wave(f"bench:sweep:{d}", folds, [True, True],
                              source="bench-delta-gate")
        row = {
            "level_ops": d, "n_div_side": n_div, "doc": doc + 1,
            "pairs": B, "wcap": sw["wcap"],
            "full_p50_ms": round(full_p50, 3),
            "full_amortized_ms": round(full_amortized, 3),
            "delta_p50_ms": round(delta_p50, 3),
            "delta_amortized_ms": round(delta_amortized, 3),
            "delta_over_full": round(delta_amortized /
                                     max(full_amortized, 1e-9), 4),
            "digest_agreed": agreed,
        }
        rows.append(row)
        print(f"bench: sweep level {d}: full {full_amortized:.1f} ms "
              f"vs delta {delta_amortized:.1f} ms amortized "
              f"({100 * row['delta_over_full']:.1f}%), digests "
              + ("AGREE" if agreed else "DISAGREE"), file=sys.stderr)
        if not agreed:
            print(f"bench: sweep level {d}: digests DISAGREE — "
                  "skipping this level's ledger rows", file=sys.stderr)
        else:
            for path_name, val, single in (
                    ("full", full_amortized, full_p50),
                    ("delta", delta_amortized, delta_p50)):
                _ledger_row(tag, "sweep", {
                    "metric": f"divergence sweep {path_name} wave, "
                              f"{B}x{doc + 1} nodes, {d}-op divergence",
                    "value": round(val, 3),
                    "single_dispatch_ms": round(single, 3),
                    "kernel": "v5" if path_name == "full" else "v5d",
                    "config": f"div{d}-{path_name}"},
                    {"digest_agreed": True})
        # free this level's device buffers before the next one
        del full, win, dev_full, dev_win, keep, res_rank, res_vis
    obs.flush()
    return {
        "metric": f"divergence sweep (delta-native vs full weave), "
                  f"{B} replica pairs x {doc + 1}-node CausalLists"
                  + (" [smoke size]" if smoke else ""),
        "value": None,
        "unit": "ms",
        "levels": rows,
        "digest_agreed": agree_all,
        "vs_baseline": 0.0,
        "platform": tag,
        "schema_version": BENCH_SCHEMA_VERSION,
        "card": card,
    }


def measure(platform: str) -> dict:
    """One run of the mode the environment names on ``platform``
    (``"cuda"``, or ``"cpu"`` for the plain versions); returns its
    artifact. Every mode marshals its host numpy first, then claims the
    device. Raises ``SystemExit`` for a malformed mode variable or an
    unknown ``BENCH_KERNEL``, and whatever the device path raises."""
    import numpy as np

    from . import benchgen
    from .benchgen import LANE_KEYS, LANE_KEYS4, LANE_KEYS5

    smoke = _flag("BENCH_SMOKE")
    sweep = _sweep_levels()
    if sweep:
        _require_obs("BENCH_DIV_SWEEP")
        if smoke:
            sw_B, sw_doc, sw_cap = 8, 1_000, 1_024
        else:
            sw_B, sw_doc, sw_cap = 1024, 10_000, 10_240
        bad = [d for d in sweep if d // 2 >= sw_doc]
        if bad:
            raise SystemExit(f"bench: sweep level(s) {bad} exceed "
                             f"the {sw_doc}-node document shape")
        marshals = []
        for d in sweep:
            with obs.span("bench.sweep.marshal", level=d, B=sw_B):
                marshals.append((d, benchgen.delta_sweep_inputs(
                    sw_B, sw_doc - d // 2, d // 2, sw_cap,
                    hide_every=8)))
        dev, tag, card = _claim_device(platform)
        return _divergence_sweep(dev, tag, card, smoke, reps=3,
                                 marshals=marshals, B=sw_B, doc=sw_doc,
                                 cap=sw_cap)
    tree_ns = _tree_sizes()
    if tree_ns:
        _require_obs("BENCH_TREE")
        if smoke:
            t_doc, t_div = 400, 6
        else:
            t_doc, t_div = 10_000, int(
                os.environ.get("BENCH_TREE_DIV", "24"))
        marshals = []
        for n in tree_ns:
            # the pure host weaver weaves the base: no device work
            with obs.span("bench.tree.marshal", n=n, doc=t_doc):
                marshals.append((n, benchgen.tree_fleet_handles(
                    n, t_doc, t_div, hide_every=8)))
        _dev, tag, card = _claim_device(platform)
        return _tree_bench(tag, card, smoke, reps=3, marshals=marshals,
                           doc=t_doc, div=t_div)
    lag_ns = _lag_sizes()
    if lag_ns:
        _require_obs("BENCH_LAG")
        if smoke:
            l_doc, l_div, l_rounds = 200, 4, 4
        else:
            # 960 keeps the document and every appended op inside the
            # 1024-lane pow2 capacity: a document at the edge would
            # re-upload the session in the middle of the measured rounds
            l_doc = int(os.environ.get("BENCH_LAG_DOC", "960"))
            l_div = 8
            l_rounds = int(os.environ.get("BENCH_LAG_ROUNDS", "8"))
        marshals = []
        for n in lag_ns:
            # two divergent replicas: the session's rows are n/2 copies
            # of that pair (a symmetric fleet)
            with obs.span("bench.lag.marshal", n=n, doc=l_doc):
                marshals.append((n, benchgen.tree_fleet_handles(
                    2, l_doc, l_div, hide_every=8)))
        _dev, tag, card = _claim_device(platform)
        return _lag_bench(tag, card, smoke, rounds=l_rounds,
                          marshals=marshals,
                          doc=l_doc, div=l_div,
                          slo_ms=float(os.environ.get(
                              "BENCH_LAG_SLO_MS", "") or 100.0))
    if smoke:
        B, n_base, n_div, cap, reps = 8, 800, 100, 1024, 3
    else:
        # 10k-node lists: 9k shared base + 1k divergent suffix a side
        # (every 8th suffix node a tombstone), 1024 replica pairs
        B, n_base, n_div, cap, reps = 1024, 9_000, 1_000, 10_240, 3

    with obs.span("bench.marshal", B=B, smoke=smoke):
        batch = benchgen.batched_pair_lanes(
            n_replicas=B, n_base=n_base, n_div=n_div, capacity=cap,
            hide_every=8)
        v5batch = benchgen.batched_v5_inputs(batch, cap)
        budget = benchgen.pair_run_budget(batch)
        u_budget = benchgen.v5_token_budget(v5batch)

    # the ladder, checked before any device work: v5 at the sampled
    # token budget and twice it, then v4 and v2 at the run budget (units
    # differ by family: tokens for v5, runs for the contracted
    # kernels), then v1 (k_max = 0, which cannot overflow)
    ladder = [(u_budget, "v5"), (2 * u_budget, "v5"),
              (budget, "v4"), (2 * budget, "v4"),
              (2 * budget, "v2"), (0, "v1")]
    forced = os.environ.get("BENCH_KERNEL", "").strip()
    if forced:
        family = {"v5": u_budget, "v5w": u_budget,
                  "v5f": u_budget, "v4": budget,
                  "v4w": budget, "v3": 2 * budget, "v2": 2 * budget}
        if forced not in family:
            raise SystemExit(
                f"bench: unknown BENCH_KERNEL {forced!r}; "
                f"one of {sorted(family)}")
        fb = family[forced]
        ladder = [(fb, forced), (2 * fb, forced)] + ladder

    dev, tag, card = _claim_device(platform)
    with obs.span("bench.upload"):
        lanes = benchgen.lanes_from_numpy(
            batch, dev, keys=tuple(dict.fromkeys(LANE_KEYS + LANE_KEYS4)))
        lanes.update(benchgen.lanes_from_numpy(
            v5batch, dev, keys=tuple(k for k in LANE_KEYS5
                                     if k not in lanes)))
    v5_family = ("v5", "v5w", "v5f")
    n_burst = int(os.environ.get("BENCH_BURST", "8"))

    def dispatch(k: int, kernel: str):
        keys = (LANE_KEYS5 if kernel in v5_family
                else LANE_KEYS4 if kernel in ("v4", "v4w") else LANE_KEYS)
        return benchgen.merge_wave_scalar(
            *(lanes[name] for name in keys), k_max=k, kernel=kernel,
            u_max=k if kernel in v5_family else 0, device=dev)

    def begin():
        if obs.enabled():
            # one timed wave, one wave.cost with the batch's known
            # divergence (2 * n_div suffix ops a pair)
            from .obs import costmodel as _cm

            _cm.wave_begin("bench")

    last = [None]

    def end():
        """After a wave: its checksum and overflow count (the copy
        waits for nothing more: the timed wait already copied it);
        overflowed rows carry unspecified ranks, so they end the rung."""
        out = last[0].cpu().reshape(-1)
        if k_max and int(out[1]):
            raise _Overflow()
        if obs.enabled():
            from .obs import costmodel as _cm

            fam = kernel in v5_family
            _cm.wave_cost(
                uuid="bench", pairs=B, lanes=2 * cap * B,
                tokens=k_max * B if fam else None,
                token_budget=k_max * B if fam else 0,
                delta_ops=2 * n_div * B, path="full")

    def wave():
        last[0] = dispatch(k_max, kernel)
        return last[0]

    with obs.span("bench.ladder"):
        for k_max, kernel in ladder:
            try:
                with obs.span("bench.warm", kernel=kernel,
                              k_max=int(k_max)):
                    begin()
                    wave().cpu()
                    end()
                break
            except _Overflow:
                obs.event("bench.overflow", kernel=kernel, k_max=int(k_max))
                print(f"bench: run budget {k_max} ({kernel}) "
                      "overflowed; retrying", file=sys.stderr)
    with obs.span("bench.timed", kernel=kernel, reps=reps, waves=n_burst):
        singles, bursts = benchgen.time_dispatch(
            wave, reps, n_burst, begin=begin, end=end)
    p50_single = float(np.median(singles))
    p50_amortized = float(np.median(bursts))

    # the 100 ms target is defined at full size on the card
    on_target = not smoke and dev.type == "cuda"
    vs = round(NORTH_STAR_MS / p50_amortized, 3) if on_target else 0.0
    out = {
        "metric": f"p50 batched merge+weave (amortized over {n_burst} "
                  f"pipelined waves), {B} replica pairs x "
                  f"{1 + n_base + n_div}-node CausalLists"
                  + (" [smoke size]" if smoke else ""),
        "value": round(p50_amortized, 3),
        "unit": "ms",
        "single_dispatch_ms": round(p50_single, 3),
        "waves_per_burst": n_burst,
        "reps": reps,
        "burst_reps": len(bursts),
        "kernel": kernel,
        # the port has no strategy switches: one configuration
        "config": "default",
        "vs_baseline": vs,
        "vs_target": vs,
        "target_ms": NORTH_STAR_MS,
        "platform": tag,
        "schema_version": BENCH_SCHEMA_VERSION,
        "card": card,
    }
    obs.flush()
    return out


def main() -> int:
    """Run the environment's mode, print its one JSON line; on any
    failure print one failure line and return 1."""
    obs_out = ""
    if obs.enabled():
        obs_out = os.environ.get("CAUSE_TPU_OBS_OUT", "").strip()
        if not obs_out:
            root = os.path.dirname(os.path.dirname(os.path.abspath(
                __file__)))
            obs_out = os.path.join(root, "measurements_torch",
                                   f"obs_bench_{int(time.time())}.jsonl")
            os.makedirs(os.path.dirname(obs_out), exist_ok=True)
            os.environ["CAUSE_TPU_OBS_OUT"] = obs_out
            obs.configure(out=obs_out)
        print(f"bench: obs events -> {obs_out}", file=sys.stderr)
    platform = "cpu" if _flag("BENCH_FORCE_CPU") else "cuda"
    try:
        out = measure(platform)
    except SystemExit as e:
        error = str(e.code)
    except Exception as e:  # noqa: BLE001 - the benchmark's one boundary
        traceback.print_exc()
        error = f"{type(e).__name__}: {e}"
    else:
        line = json.dumps(out)
        print(line, flush=True)
        _export_obs_trace(obs_out)
        if not (_sweep_levels() or _tree_sizes()):
            # the sweep and the tree landed their own rows
            _append_to_ledger(line, obs_out)
        _print_gap_report(obs_out)
        return 0
    print(f"bench: {platform} run failed: {error}", file=sys.stderr)
    failed_line = json.dumps({
        "metric": "p50 batched merge+weave (the run failed)",
        "value": None,
        "unit": "ms",
        "vs_baseline": 0.0,
        "platform": "none",
        "schema_version": BENCH_SCHEMA_VERSION,
        # a failed run has no number: the ledger keeps its row out of
        # every comparison
        "fallback": True,
        "error": error[:500],
    })
    print(failed_line, flush=True)
    _export_obs_trace(obs_out)
    _append_to_ledger(failed_line, obs_out)
    return 1


if __name__ == "__main__":
    sys.exit(main())
