"""The segmented CRC write-ahead log — the durable-storage lifecycle
behind the serve layer's zero-admitted-op-loss guarantee.

A copy of ``cause_tpu.serve.wal`` without its telemetry: the
``serve.disk`` events and the segment gauges come back with the
telemetry port; records, segment bytes, stats and GC are the
reference's.

:class:`IngestJournal` proved the WRITE-AHEAD contract but
kept the storage story a single ever-growing file with flush-but-no-
fsync appends: no reclamation after checkpoints, no defense against
bit-rot, no policy for a full disk. This module is the same journal
contract (record schema ``{"seq", "uuid", "site", "items", "ts_us"}``,
``append``/``iter_from``/``skipped``/``close``, drop-in for
``SyncService.restore`` and the net server's watermark seeding) with
real storage engineering underneath:

- **segments** — records land in numbered segment files
  (``wal-<n>.seg``) under one directory; segments rotate on size
  (``rotate_bytes``) and age (``rotate_s``), so retention has a unit
  smaller than "the whole history";
- **per-record CRC32 trailer** — every line is
  ``<json>\\t#<crc32 hex>``; a torn tail is an unparseable line
  (counted in ``skipped``, as before) and a BIT-ROTTED record — valid
  shape, wrong bytes — fails its CRC (counted in ``corrupt``), so
  at-rest corruption is detected, not silently replayed. Legacy
  bare-JSON lines (an old single-file journal's schema) still parse,
  so pre-WAL journals restore through :func:`open_journal` unchanged;
- **fsync policy** — ``none`` (flush only, the old behavior),
  ``batch`` (default: fsync every ``fsync_batch_n`` appends or
  ``fsync_batch_ms``, piggybacked on the appending thread) or
  ``always`` (fsync per append); overridable via the registered
  ``CAUSE_TPU_WAL_FSYNC`` env knob (the reference's name);
- **crash-safe GC** — :meth:`gc` retires every SEALED segment whose
  records all sit at-or-below the caller's minimum live watermark
  (the serve manifest's ``gc_watermark`` — every such record is
  already applied AND checkpointed by its tenant). The WAL manifest
  (watermark + lifetime retirement accounting) is atomically renamed
  BEFORE any segment is unlinked, and a crash mid-GC leaves only
  below-watermark segments behind for the next pass — replay above
  the watermark is bit-identical before and after GC (pinned in
  tests), and long-running disk usage is BOUNDED while the
  single-file baseline (``appended_bytes``) grows monotonically.
  ``retire_dir`` renames retired segments aside instead of unlinking
  (archival mode — the soak's oracle replays them);
- **chaos seams** — the ``disk`` family of this package's ``chaos`` injects here: ``torn``
  and ``enospc`` fail the append (never acked — admission's
  durability rung refuses with ``retry_after_ms``), ``bitrot``
  corrupts an acked record's durable copy (CRC detects it; the op
  survives in service memory and the next checkpoint), ``fsync``
  fails a flush (the WAL rotates to a fresh segment), ``rename``
  aborts a GC manifest swap (segments intact, retried next cycle).
  Every degradation is counted in ``stats``.

Stdlib-only (it imports nothing of torch itself): the WAL is host
work by definition.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

from .. import chaos as _chaos
from ..collections import shared as s
from .ingest import IngestJournal

__all__ = ["WriteAheadLog", "open_journal", "FSYNC_POLICIES",
           "WAL_MANIFEST_NAME", "list_segments", "scan_segment_file",
           "fsync_dir"]

FSYNC_POLICIES = ("none", "batch", "always")
WAL_MANIFEST_NAME = "wal_manifest.json"
WAL_MANIFEST_VERSION = 1
_SEG_PREFIX = "wal-"
_SEG_SUFFIX = ".seg"
_CHAOS_SITE = "serve.wal"


# ------------------------------------------------------ record codec


def encode_record(rec: dict) -> str:
    """One journal line: the record JSON plus a tab-separated CRC32
    trailer over the JSON bytes (``json.dumps`` escapes raw tabs, so
    the LAST tab always splits body from trailer)."""
    body = json.dumps(rec)
    return (body + "\t#"
            + format(zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF,
                     "08x") + "\n")


def decode_line(line: str) -> Tuple[str, Optional[dict]]:
    """Classify one journal line: ``("rec", entry)`` for a CRC-clean
    trailered record, ``("legacy", entry)`` for a bare-JSON
    (pre-WAL) line, ``("corrupt", None)`` for a trailered line whose
    CRC does not match its body (bit-rot), ``("torn", None)`` for
    anything unparseable, ``("blank", None)`` for whitespace."""
    line = line.strip()
    if not line:
        return ("blank", None)
    body, sep, trailer = line.rpartition("\t")
    if sep and len(trailer) == 9 and trailer[0] == "#":
        try:
            want = int(trailer[1:], 16)
        except ValueError:
            want = None
        if want is not None:
            if zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF != want:
                return ("corrupt", None)
            try:
                e = json.loads(body)
            except ValueError:
                return ("torn", None)
            if isinstance(e, dict) and "seq" in e:
                return ("rec", e)
            return ("torn", None)
    try:
        e = json.loads(line)
    except ValueError:
        return ("torn", None)
    if isinstance(e, dict) and "seq" in e:
        return ("legacy", e)
    return ("torn", None)


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a DIRECTORY — makes a just-landed rename
    (or unlink) durable on POSIX. Some platforms refuse to open a
    directory read-only or to fsync the fd; both are quietly fine
    (the file-content fsync before the rename carries the integrity
    guarantee, this carries the name)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass
    finally:
        os.close(fd)


def list_segments(path: str) -> List[Tuple[int, str]]:
    """``(number, filename)`` for every segment file under ``path``,
    sorted by segment number (creation order == seq order)."""
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(path)
    except OSError:
        return out
    for n in names:
        if n.startswith(_SEG_PREFIX) and n.endswith(_SEG_SUFFIX):
            try:
                no = int(n[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
            except ValueError:
                continue
            out.append((no, n))
    out.sort()
    return out


def scan_segment_file(fp: str) -> Iterator[Tuple[str, Optional[dict]]]:
    """Yield ``decode_line`` classifications for one segment file —
    the shared walk the WAL's scans, the scrubber and the soak's
    oracle all use."""
    with open(fp, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            kind, e = decode_line(line)
            if kind != "blank":
                yield (kind, e)


# -------------------------------------------------------------- WAL


class WriteAheadLog:
    """See the module docstring. ``path`` is a DIRECTORY (the drop-in
    contract: ``.path`` is whatever the serve manifest's ``journal``
    field carries, and :func:`open_journal` routes a directory here
    and a file to :class:`IngestJournal`). Thread-safe like the
    journal it replaces: generators append while the service thread
    drains/GCs."""

    def __init__(self, path: str, rotate_bytes: int = 4 * 1024 * 1024,
                 rotate_s: Optional[float] = None,
                 fsync: Optional[str] = None,
                 fsync_batch_n: int = 64,
                 fsync_batch_ms: float = 50.0,
                 retire_dir: Optional[str] = None):
        self.path = str(path)
        os.makedirs(self.path, exist_ok=True)
        if fsync is None:
            fsync = (os.environ.get("CAUSE_TPU_WAL_FSYNC", "").strip()
                     or "batch")
        if fsync not in FSYNC_POLICIES:
            raise ValueError(
                f"unknown fsync policy {fsync!r} "
                f"(want one of {FSYNC_POLICIES})")
        self.fsync_policy = fsync
        self.rotate_bytes = int(rotate_bytes)
        self.rotate_s = rotate_s
        self.fsync_batch_n = int(fsync_batch_n)
        self.fsync_batch_ms = float(fsync_batch_ms)
        self.retire_dir = retire_dir
        if retire_dir:
            os.makedirs(retire_dir, exist_ok=True)
        self._lock = threading.Lock()
        self.skipped = 0   # torn/unparseable lines, LATEST scan
        self.corrupt = 0   # CRC-mismatch lines, LATEST scan
        self.appended_bytes = 0  # lifetime bytes written — the
        # monotonic single-file baseline the bounded-disk gate
        # compares live usage against
        self.gc_watermark = 0
        self.stats = {"appends": 0, "append_failures": 0,
                      "rotations": 0, "fsyncs": 0, "fsync_failures": 0,
                      "gc_segments": 0, "gc_bytes": 0, "gc_aborts": 0}
        self._pending_fsync = 0
        self._last_fsync_s = time.monotonic()
        with self._lock:
            self._read_manifest_locked()
        # resume: index every existing segment (seq continues past the
        # max on disk AND past the manifest's max — after a full GC
        # there may be no record left to scan, and reusing a retired
        # seq would corrupt every watermark downstream)
        self._seq = max(self.gc_watermark, self._manifest_max_seq)
        self._index: List[dict] = []   # sealed segments, in order
        self.skipped = 0
        self.corrupt = 0
        segs = list_segments(self.path)
        for no, name in segs:
            sg = self._scan_segment_meta(name, no)
            self._index.append(sg)
            if sg["last_seq"]:
                self._seq = max(self._seq, sg["last_seq"])
        if self._index:
            active = self._index.pop()
            self._fh = open(os.path.join(self.path, active["name"]),
                            "a", encoding="utf-8")
            active["opened_s"] = time.monotonic()
            self._active = active
        else:
            self._active = None
            self._open_active_locked(1)

    # -------------------------------------------------- construction

    def _scan_segment_meta(self, name: str, no: int) -> dict:
        first = last = None
        size = 0
        fp = os.path.join(self.path, name)
        try:
            size = os.path.getsize(fp)
            for kind, e in scan_segment_file(fp):
                if kind in ("rec", "legacy"):
                    q = int(e.get("seq", 0))
                    first = q if first is None else min(first, q)
                    last = q if last is None else max(last, q)
                elif kind == "corrupt":
                    self.corrupt += 1
                else:
                    self.skipped += 1
        except OSError:
            pass
        return {"name": name, "no": no, "first_seq": first,
                "last_seq": last, "bytes": size,
                "opened_s": time.monotonic()}

    def _read_manifest_locked(self) -> None:
        self._manifest_max_seq = 0
        p = os.path.join(self.path, WAL_MANIFEST_NAME)
        try:
            with open(p) as f:
                m = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(m, dict) or "~wal_manifest" not in m:
            return  # advisory — the scrubber flags a broken one
        self.gc_watermark = int(m.get("gc_watermark") or 0)
        self._manifest_max_seq = int(m.get("max_seq") or 0)
        self.stats["gc_segments"] = int(m.get("retired_segments") or 0)
        self.stats["gc_bytes"] = int(m.get("retired_bytes") or 0)

    def _write_manifest_locked(self) -> None:
        m = {"~wal_manifest": WAL_MANIFEST_VERSION,
             "gc_watermark": self.gc_watermark,
             "max_seq": self._seq,
             "retired_segments": self.stats["gc_segments"],
             "retired_bytes": self.stats["gc_bytes"],
             "fsync": self.fsync_policy,
             "ts_us": time.time_ns() // 1000}
        p = os.path.join(self.path, WAL_MANIFEST_NAME)
        tmp = f"{p}.tmp.{os.getpid()}"
        # the rename below is gc()'s crash-safe commit point BEFORE
        # segments are unlinked — it must be durable regardless of the
        # append fsync policy, or a crash could persist the unlinks
        # while losing the manifest (watermark/max_seq reset to 0 and
        # the seq counter would reuse retired seqs). An OSError here
        # propagates and aborts the GC with segments intact, same as a
        # failed os.replace would.
        with open(tmp, "w") as f:
            f.write(json.dumps(m))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
        fsync_dir(self.path)

    def _open_active_locked(self, no: int) -> None:
        name = f"{_SEG_PREFIX}{no:08d}{_SEG_SUFFIX}"
        self._fh = open(os.path.join(self.path, name), "a",
                        encoding="utf-8")
        self._active = {"name": name, "no": no, "first_seq": None,
                        "last_seq": None, "bytes": 0,
                        "opened_s": time.monotonic()}

    # -------------------------------------------------------- append

    def append(self, uuid: str, site: str, items: list,
               ts_us: Optional[int] = None,
               trace: Optional[list] = None) -> int:
        """Durably record one admitted batch; returns its seq. Same
        contract as ``IngestJournal.append`` (write BEFORE the queue
        acknowledges), plus the disk chaos seams: a failed append
        raises ``CausalError`` naming the cause — the caller must NOT
        acknowledge (admission's durability rung refuses the offer)
        and the seq is not consumed. ``trace``: trace ids
        recorded in the row only when given; without them the segment
        bytes are the reference's obs-off bytes."""
        with self._lock:
            self._maybe_rotate_locked()
            seq = self._seq + 1
            rec = {"seq": seq, "uuid": str(uuid), "site": str(site),
                   "items": items,
                   "ts_us": int(ts_us if ts_us is not None
                                else time.time_ns() // 1000)}
            if trace:
                rec["trace"] = list(trace)
            body = json.dumps(rec)
            crc_hex = format(
                zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF, "08x")
            if _chaos.enabled():
                if _chaos.disk_enospc(_CHAOS_SITE):
                    self.stats["append_failures"] += 1
                    raise s.CausalError(
                        "wal: append refused (no space left)",
                        {"causes": {"wal-enospc"}, "path": self.path})
                if _chaos.disk_torn(_CHAOS_SITE):
                    # a crash mid-write: a prefix of the line lands
                    # (its own line, so later appends stay parseable)
                    # and the append FAILS — the op is never acked,
                    # the producer re-offers, the next scan counts
                    # exactly one torn line
                    torn = body[: max(1, len(body) // 2)] + "\n"
                    self._write_locked(torn)
                    self.stats["append_failures"] += 1
                    raise s.CausalError(
                        "wal: append torn (crash mid-write)",
                        {"causes": {"wal-torn"}, "path": self.path})
                flip = _chaos.disk_bitrot(_CHAOS_SITE,
                                          len(body.encode("utf-8")),
                                          seq=seq, rec=rec)
                if flip is not None:
                    # at-rest rot of an ACKED record: the durable copy
                    # is wrong (CRC trailer still covers the original
                    # bytes, so the scan detects it), but the op was
                    # applied in memory and the next checkpoint
                    # persists it — detection + checkpoint bounding is
                    # the story, not un-acking. json.dumps output is
                    # printable ASCII, so ^0x01 never mints a newline.
                    raw = bytearray(body.encode("utf-8"))
                    raw[flip] ^= 0x01
                    body = raw.decode("latin-1")
            self._write_locked(body + "\t#" + crc_hex + "\n")
            self._seq = seq
            a = self._active
            if a["first_seq"] is None:
                a["first_seq"] = seq
            a["last_seq"] = seq
            self.stats["appends"] += 1
            self._fsync_maybe_locked()
        return seq

    def _write_locked(self, text: str) -> None:
        self._fh.write(text)
        self._fh.flush()
        n = len(text)
        self._active["bytes"] += n
        self.appended_bytes += n

    def _fsync_maybe_locked(self) -> None:
        p = self.fsync_policy
        if p == "none":
            return
        self._pending_fsync += 1
        now = time.monotonic()
        if p == "always" or self._pending_fsync >= self.fsync_batch_n \
                or (now - self._last_fsync_s) * 1000.0 \
                >= self.fsync_batch_ms:
            if not self._fsync_locked(now):
                # a descriptor that failed fsync has undefined durable
                # state: rotate to a fresh segment/fd
                self._rotate_locked(final_sync=False)

    def _fsync_locked(self, now: Optional[float] = None) -> bool:
        """fsync the active descriptor; returns success. Never rotates
        — the CALLER decides what a failure means, because this runs
        both standalone (append path — rotate to a fresh fd) and as a
        rotation's final sync (rotating from in here would reenter
        ``_rotate_locked`` and seal the same segment twice)."""
        ok = True
        if _chaos.enabled() and _chaos.disk_fsync_fail(_CHAOS_SITE):
            ok = False
        else:
            try:
                os.fsync(self._fh.fileno())
            except OSError:  # pragma: no cover - real media failure
                ok = False
        if ok:
            self.stats["fsyncs"] += 1
        else:
            self.stats["fsync_failures"] += 1
        self._pending_fsync = 0
        self._last_fsync_s = now if now is not None else time.monotonic()
        return ok

    # ------------------------------------------------------ rotation

    def _maybe_rotate_locked(self) -> None:
        a = self._active
        if a["bytes"] <= 0:
            return
        if a["bytes"] >= self.rotate_bytes \
                or (self.rotate_s is not None
                    and time.monotonic() - a["opened_s"]
                    >= self.rotate_s):
            self._rotate_locked()

    def _rotate_locked(self, final_sync: bool = True) -> None:
        a = self._active
        if a["bytes"] <= 0:
            return
        if final_sync and self.fsync_policy != "none" \
                and self._pending_fsync:
            # failure is evidenced inside; no further action here —
            # this fd is being retired anyway and its replacement is
            # a fresh descriptor
            self._fsync_locked()
        try:
            self._fh.close()
        except OSError:  # pragma: no cover - close is best-effort
            pass
        self._index.append(a)
        self.stats["rotations"] += 1
        self._open_active_locked(a["no"] + 1)

    # ---------------------------------------------------------- scan

    def _scan(self) -> Iterator[dict]:
        # ``skipped``/``corrupt`` are the LATEST scan's counts, same
        # contract as IngestJournal (summing scans would over-report
        # one torn line as several)
        self.skipped = 0
        self.corrupt = 0
        with self._lock:
            self._fh.flush()
            names = [sg["name"] for sg in self._index] \
                + [self._active["name"]]
        for name in names:
            fp = os.path.join(self.path, name)
            if not os.path.exists(fp):
                continue
            for kind, e in scan_segment_file(fp):
                if kind in ("rec", "legacy"):
                    yield e
                elif kind == "corrupt":
                    self.corrupt += 1
                else:
                    self.skipped += 1

    def iter_from(self, min_seq_exclusive: int = 0) -> Iterator[dict]:
        """Entries with ``seq > min_seq_exclusive``, journal order —
        the drop-in replay contract restore and the net server's
        watermark seeding depend on."""
        wm = int(min_seq_exclusive)
        for e in self._scan():
            if int(e.get("seq", 0)) > wm:
                yield e

    # ------------------------------------------------------------ GC

    def gc(self, min_live_seq: int) -> dict:
        """Retire every sealed segment whose records all sit at or
        below ``min_live_seq`` (the serve manifest's minimum live
        watermark — everything below it is applied AND checkpointed by
        its tenant). Crash-safe order: the WAL manifest (watermark +
        retirement accounting) is atomically renamed FIRST, then
        segments are unlinked (or renamed into ``retire_dir``); the
        chaos crash point ``serve.wal.gc`` fires between the two, and
        a crash there leaves only below-watermark segments for the
        next pass — replay above the watermark is identical either
        way. A sealed segment with no valid record (all torn — every
        line unacknowledged by construction) retires at any
        watermark. Returns retirement accounting."""
        wm = int(min_live_seq)
        with self._lock:
            if _chaos.enabled() and _chaos.disk_rename_fail(
                    _CHAOS_SITE):
                # the manifest swap failed: segments intact, watermark
                # unadvanced, retried next cycle — evidenced, never
                # silent
                self.stats["gc_aborts"] += 1
                return {"retired": 0, "retired_bytes": 0,
                        "watermark": self.gc_watermark,
                        "aborted": True}
            self.gc_watermark = max(self.gc_watermark, wm)
            retire = [sg for sg in self._index
                      if (sg["last_seq"] or 0) <= self.gc_watermark]
            self._write_manifest_locked()
            if retire and _chaos.enabled() \
                    and _chaos.should_crash("serve.wal.gc"):  # causelint: disable=DUR004 -- the seam MUST sit between the manifest swap and the unlinks, both under _lock by design; the raise unwinds the with, and a real crash releases the lock with the process
                from .service import ServiceCrashed

                raise ServiceCrashed(
                    "chaos: crash point at serve.wal.gc "
                    "(manifest written, segments not yet retired)")
            n = b = 0
            for sg in retire:
                src = os.path.join(self.path, sg["name"])
                try:
                    if self.retire_dir:
                        os.replace(src, os.path.join(self.retire_dir,
                                                     sg["name"]))
                    else:
                        os.unlink(src)
                except OSError:  # pragma: no cover - skip, retry later
                    continue
                self._index.remove(sg)
                n += 1
                b += sg["bytes"]
            self.stats["gc_segments"] += n
            self.stats["gc_bytes"] += b
            if n:
                self._write_manifest_locked()
            return {"retired": n, "retired_bytes": b,
                    "watermark": self.gc_watermark, "aborted": False}

    # ------------------------------------------------------- queries

    def dir_bytes(self) -> int:
        """Live WAL directory size (segments + manifest) — the
        bounded-disk gate's measure."""
        with self._lock:
            names = [sg["name"] for sg in self._index] \
                + [self._active["name"], WAL_MANIFEST_NAME]
        total = 0
        for name in names:
            try:
                total += os.path.getsize(os.path.join(self.path, name))
            except OSError:
                continue
        return total

    def wal_report(self) -> dict:
        with self._lock:
            report = {"segments": len(self._index) + 1,
                      "appended_bytes": self.appended_bytes,
                      "gc_watermark": self.gc_watermark,
                      "fsync": self.fsync_policy,
                      "stats": dict(self.stats)}
        # dir_bytes takes the lock itself — must stay outside it
        report["live_bytes"] = self.dir_bytes()
        return report

    def close(self) -> None:
        with self._lock:
            try:
                if self.fsync_policy != "none" and self._pending_fsync:
                    # causelint: disable-next-line=LCK003 -- the final fsync rides _lock by design: close() must not race an append into a half-synced handle, and nothing contends after close
                    os.fsync(self._fh.fileno())
                    self.stats["fsyncs"] += 1
            except OSError:  # pragma: no cover - close is best-effort
                pass
            try:
                self._fh.close()
            except OSError:  # pragma: no cover - close is best-effort
                pass


def open_journal(path: str, **wal_kwargs):
    """The journal constructor restore paths use: a DIRECTORY is a
    :class:`WriteAheadLog`, anything else is a legacy single-file
    :class:`IngestJournal` — so old manifests (whose ``journal`` field
    names a file) keep restoring unchanged."""
    p = str(path)
    if os.path.isdir(p):
        return WriteAheadLog(p, **wal_kwargs)
    return IngestJournal(p)
