"""The offline storage scrubber: ``python -m cause_tpu_torch.serve scrub``
(a copy of ``cause_tpu.serve.scrub``).

Durability claims rot silently — a WAL segment can sit bit-rotted for
weeks before a restore trips over it. The scrubber is the offline
audit that finds out FIRST: it walks every WAL segment (live and
retired) record by record re-checking each CRC trailer, parses the
serve checkpoint manifest and every tenant pack it names, and reports
torn records, CRC failures, missing/stray packs and GC-eligible bytes
— exiting nonzero on any corruption so a cron job or CI step gates on
it directly.

Also home to ``bench-fsync``, a micro-bench of the fsync policies'
append overhead (same append path, one tmp WAL per policy).

Host-only and telemetry-free: the scrubber reads a dead service's
directories and touches no tensor, so it runs on a machine without a
card (the package facade still imports torch). It reuses
:mod:`cause_tpu_torch.serve.wal`'s codec helpers rather than duplicating
the line format.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

from .wal import (WAL_MANIFEST_NAME, WriteAheadLog, list_segments,
                  scan_segment_file)

__all__ = ["scrub_wal", "scrub_checkpoints", "bench_fsync", "cli"]

# duplicated from .service (which imports the device machinery) so
# the scrubber stays importable on a bare host
_SERVE_MANIFEST_NAME = "serve_manifest.json"


def _scrub_one_dir(path: str, watermark: int) -> dict:
    segs = []
    for no, name in list_segments(path):
        seg = {"name": name, "records": 0, "torn": 0,
               "crc_failures": 0, "legacy": 0, "bytes": 0,
               "first_seq": None, "last_seq": None}
        fp = os.path.join(path, name)
        try:
            seg["bytes"] = os.path.getsize(fp)
            for kind, e in scan_segment_file(fp):
                if kind in ("rec", "legacy"):
                    seg["records"] += 1
                    if kind == "legacy":
                        seg["legacy"] += 1
                    q = int(e.get("seq", 0))
                    if seg["first_seq"] is None:
                        seg["first_seq"] = q
                    else:
                        seg["first_seq"] = min(seg["first_seq"], q)
                    seg["last_seq"] = (q if seg["last_seq"] is None
                                       else max(seg["last_seq"], q))
                elif kind == "corrupt":
                    seg["crc_failures"] += 1
                else:
                    seg["torn"] += 1
        except OSError:
            seg["torn"] += 1
        segs.append(seg)
    # GC-eligible: sealed (non-last) segments wholly at/below the
    # watermark — exactly what the next wal.gc() pass would retire
    gc_bytes = gc_segments = 0
    for seg in segs[:-1]:
        if (seg["last_seq"] or 0) <= watermark:
            gc_bytes += seg["bytes"]
            gc_segments += 1
    return {"path": path, "segments": segs,
            "records": sum(g["records"] for g in segs),
            "torn": sum(g["torn"] for g in segs),
            "crc_failures": sum(g["crc_failures"] for g in segs),
            "legacy": sum(g["legacy"] for g in segs),
            "bytes": sum(g["bytes"] for g in segs),
            "gc_eligible_segments": gc_segments,
            "gc_eligible_bytes": gc_bytes}


def scrub_wal(path: str, watermark: Optional[int] = None,
              retired: Optional[str] = None) -> dict:
    """Walk a WAL directory (and optionally its retire dir): every
    line of every segment re-classified through the shared codec.
    ``watermark`` overrides the WAL manifest's ``gc_watermark`` for
    the GC-eligible accounting (pass the serve manifest's watermark
    to preview what the next checkpoint's GC will reclaim)."""
    manifest = None
    mpath = os.path.join(path, WAL_MANIFEST_NAME)
    manifest_ok = True
    if os.path.exists(mpath):
        try:
            with open(mpath) as f:
                manifest = json.load(f)
            if not (isinstance(manifest, dict)
                    and "~wal_manifest" in manifest):
                manifest, manifest_ok = None, False
        except (OSError, ValueError):
            manifest_ok = False
    if watermark is None:
        watermark = int((manifest or {}).get("gc_watermark") or 0)
    rep = _scrub_one_dir(path, int(watermark))
    rep["watermark"] = int(watermark)
    rep["manifest_ok"] = manifest_ok
    if retired and os.path.isdir(retired):
        rep["retired"] = _scrub_one_dir(retired, int(watermark))
    rep["clean"] = (rep["torn"] == 0 and rep["crc_failures"] == 0
                    and manifest_ok)
    return rep


def scrub_checkpoints(path: str) -> dict:
    """Audit a serve checkpoint directory: the manifest must parse,
    every tenant pack it names must exist and parse as a pack dict,
    and anything else matching the pack/tmp patterns is a stray the
    post-checkpoint sweep missed (reported, not an error)."""
    rep = {"path": path, "manifest_ok": False, "tenants": 0,
           "packs_ok": 0, "packs_bad": [], "packs_missing": [],
           "stray_files": [], "errors": 0}
    mpath = os.path.join(path, _SERVE_MANIFEST_NAME)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        if not (isinstance(manifest, dict)
                and "~serve_manifest" in manifest):
            raise ValueError("not a serve manifest")
        rep["manifest_ok"] = True
    except (OSError, ValueError):
        rep["errors"] += 1
        return rep
    tenants = manifest.get("tenants") or {}
    rep["tenants"] = len(tenants)
    rep["gc_watermark"] = int(manifest.get("gc_watermark") or 0)
    live = {_SERVE_MANIFEST_NAME}
    for uuid, info in tenants.items():
        rel = info.get("file")
        live.add(rel)
        fp = os.path.join(path, rel)
        try:
            with open(fp) as f:
                pack = json.load(f)
            if not isinstance(pack, dict):
                raise ValueError("pack is not a dict")
            rep["packs_ok"] += 1
        except OSError:
            rep["packs_missing"].append(rel)
            rep["errors"] += 1
        except ValueError:
            rep["packs_bad"].append(rel)
            rep["errors"] += 1
    try:
        for name in sorted(os.listdir(path)):
            if name in live:
                continue
            if name.endswith(".ckpt.json") or ".tmp." in name:
                rep["stray_files"].append(name)
    except OSError:
        rep["errors"] += 1
    return rep


def bench_fsync(n: int = 2000, tmp_dir: Optional[str] = None) -> dict:
    """Append ``n`` one-op records under each fsync policy against a
    throwaway WAL; returns per-policy wall µs/append — the PERF.md
    Round 15 table."""
    import shutil
    import tempfile

    out = {}
    items = [{"node": "bench", "op": 1}]
    for policy in ("none", "batch", "always"):
        d = tempfile.mkdtemp(dir=tmp_dir, prefix=f"walbench-{policy}-")
        try:
            w = WriteAheadLog(os.path.join(d, "wal"), fsync=policy)
            t0 = time.perf_counter()
            for i in range(n):
                w.append("bench", "site", items)
            dt = time.perf_counter() - t0
            w.close()
            out[policy] = {"n": n,
                           "us_per_append": round(dt / n * 1e6, 2),
                           "appends_per_s": round(n / dt, 1),
                           "fsyncs": w.stats["fsyncs"]}
        finally:
            shutil.rmtree(d, ignore_errors=True)
    return out


# --------------------------------------------------------------- CLI


def _print_wal_report(rep: dict) -> None:
    print(f"wal {rep['path']}: {rep['records']} records in "
          f"{len(rep['segments'])} segments ({rep['bytes']} bytes), "
          f"watermark {rep['watermark']}")
    print(f"  torn={rep['torn']} crc_failures={rep['crc_failures']} "
          f"legacy={rep['legacy']} manifest_ok={rep['manifest_ok']}")
    print(f"  gc-eligible: {rep['gc_eligible_segments']} segments / "
          f"{rep['gc_eligible_bytes']} bytes")
    for seg in rep["segments"]:
        flag = ""
        if seg["torn"] or seg["crc_failures"]:
            flag = "  <-- DAMAGED"
        print(f"    {seg['name']}: recs={seg['records']} "
              f"seq=[{seg['first_seq']},{seg['last_seq']}] "
              f"torn={seg['torn']} crc={seg['crc_failures']}{flag}")
    if "retired" in rep:
        r = rep["retired"]
        print(f"  retired {r['path']}: {r['records']} records, "
              f"torn={r['torn']} crc_failures={r['crc_failures']}")


def cli(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.serve",
        description="serve-layer storage tools")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("scrub", help="audit WAL segments and "
                        "checkpoint packs; exit 1 on corruption")
    sp.add_argument("--wal", help="WAL directory (or legacy journal "
                    "file) to scrub")
    sp.add_argument("--retired", help="retired-segment dir to include")
    sp.add_argument("--checkpoint", help="serve checkpoint dir to "
                    "audit (its gc_watermark also prices the WAL's "
                    "GC-eligible bytes)")
    sp.add_argument("--json", action="store_true",
                    help="emit one JSON report to stdout")
    bp = sub.add_parser("bench-fsync", help="measure per-append "
                        "overhead of each fsync policy")
    bp.add_argument("--n", type=int, default=2000)
    bp.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.cmd == "bench-fsync":
        rep = bench_fsync(args.n)
        if args.json:
            print(json.dumps(rep, indent=2))
        else:
            for policy, r in rep.items():
                print(f"fsync={policy:6s} {r['us_per_append']:>9.2f} "
                      f"us/append  {r['appends_per_s']:>10.1f} "
                      f"appends/s  ({r['fsyncs']} fsyncs)")
        return 0

    if not args.wal and not args.checkpoint:
        ap.error("scrub needs --wal and/or --checkpoint")
    report = {}
    bad = False
    watermark = None
    if args.checkpoint:
        ck = scrub_checkpoints(args.checkpoint)
        report["checkpoint"] = ck
        watermark = ck.get("gc_watermark")
        bad = bad or ck["errors"] > 0
    if args.wal:
        if os.path.isdir(args.wal):
            w = scrub_wal(args.wal, watermark=watermark,
                          retired=args.retired)
            report["wal"] = w
            bad = bad or not w["clean"]
        else:
            # legacy single-file journal: same codec walk, one "file"
            w = {"path": args.wal, "records": 0, "torn": 0,
                 "crc_failures": 0, "legacy": 0, "segments": [],
                 "bytes": 0, "gc_eligible_segments": 0,
                 "gc_eligible_bytes": 0, "watermark": watermark or 0,
                 "manifest_ok": True}
            try:
                w["bytes"] = os.path.getsize(args.wal)
                for kind, e in scan_segment_file(args.wal):
                    if kind in ("rec", "legacy"):
                        w["records"] += 1
                        if kind == "legacy":
                            w["legacy"] += 1
                    elif kind == "corrupt":
                        w["crc_failures"] += 1
                    else:
                        w["torn"] += 1
            except OSError:
                w["torn"] += 1
            w["clean"] = w["torn"] == 0 and w["crc_failures"] == 0
            report["wal"] = w
            bad = bad or not w["clean"]
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        if "wal" in report:
            _print_wal_report(report["wal"])
        if "checkpoint" in report:
            ck = report["checkpoint"]
            print(f"checkpoint {ck['path']}: manifest_ok="
                  f"{ck['manifest_ok']} tenants={ck['tenants']} "
                  f"packs_ok={ck['packs_ok']} errors={ck['errors']}")
            for rel in ck.get("packs_missing", []):
                print(f"    MISSING pack {rel}")
            for rel in ck.get("packs_bad", []):
                print(f"    BAD pack {rel}")
            for name in ck.get("stray_files", []):
                print(f"    stray {name}")
        print("CORRUPTION DETECTED" if bad else "clean")
    return 1 if bad else 0
