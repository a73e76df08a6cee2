"""Seeded, deterministic fault injection for the sync/wave substrate.

Copy of ``cause_tpu.chaos``: the same plan schema, the same families
and modes, the same seeded schedules. It reads the same
``CAUSE_TPU_CHAOS`` variable (a plan file's path or an inline JSON
object), so one plan drives either package, and its state is this
module's own: arming one package's engine does not arm the other's.

The families and where this package catches them:

- **payload** faults mangle a sync delta's on-wire node triples
  (``corrupt`` / ``truncate`` / ``duplicate`` / ``reorder`` / ``drop``)
  — caught by ``sync``'s validate-before-apply boundary (repeat
  offenders are quarantined);
- **dispatch** faults fail a device dispatch (``raise``: a transient
  :class:`InjectedDispatchError` the recovery ladder retries;
  ``exhaust``: a window-budget exhaustion that forces the session's or
  the merge tree's delta path back to full width) — caught by
  ``parallel.recovery`` and the ladder's seams;
- **crash** faults tell a harness to drop a ``FleetSession`` and
  restore it from its checkpoint (:func:`should_crash` only schedules);
- **stall** faults sleep inside a session wave (capped at 5 s);
- **net**, **disk** and **ship** faults schedule wire, durable-storage
  and telemetry-link failures; their hooks are here so a plan parses
  the same in both packages, and they fire once the transport, the
  serving plane and the telemetry shipper call them.

Determinism: every fault spec keeps its own per-site invocation
counter and its own seeded ``random.Random`` stream, so the same plan
over the same call sequence injects the same faults at the same points
— the repro contract (seed, plan) -> identical fault schedule.

Off-invariance: with ``CAUSE_TPU_CHAOS`` unset (or ``0``),
:func:`enabled` is False, every hook returns its input immediately, no
state is kept, no plan file is read and nothing is logged. Enable with
``CAUSE_TPU_CHAOS=<plan.json path>`` (or an inline JSON object), or
programmatically with :func:`configure` for tests. The injected-fault
log (:func:`injected`, :func:`chaos_report`) is the evidence; the
telemetry events of the reference come with the telemetry port.

Stdlib-only.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional

__all__ = [
    "FAMILIES",
    "InjectedDispatchError",
    "enabled",
    "configure",
    "reset",
    "suspended",
    "mangle_items",
    "dispatch_fault",
    "budget_exhaust",
    "should_crash",
    "stall_point",
    "net_partition",
    "net_reset",
    "net_latency_ms",
    "net_blackhole",
    "net_dup",
    "disk_torn",
    "disk_bitrot",
    "disk_enospc",
    "disk_fsync_fail",
    "disk_rename_fail",
    "ship_partition",
    "ship_drop",
    "ship_dup",
    "ship_reorder",
    "injected",
    "chaos_report",
]

FAMILIES = ("payload", "dispatch", "crash", "stall", "net", "disk",
            "ship")
PAYLOAD_MODES = ("corrupt", "truncate", "duplicate", "reorder", "drop")
NET_MODES = ("partition", "reset", "latency", "blackhole", "dup")
DISK_MODES = ("torn", "bitrot", "enospc", "fsync", "rename")
SHIP_MODES = ("partition", "drop", "dup", "reorder")
# the value planted by payload corruption: tests and the chaos soak
# gate grep converged documents for it — an admitted corruption is a
# validation hole, not a flake
CORRUPT_MARKER = "⚡chaos-corrupt⚡"
_TRUTHY = ("1", "true", "yes")
_LOG_MAX = 4096          # injected-fault log bound (drops counted)
_STALL_CAP_S = 5.0       # no plan may wedge a run for real


class InjectedDispatchError(RuntimeError):
    """A chaos-injected transient device-dispatch failure. The
    recovery ladder classifies it as transient and retries with
    backoff; nothing else in the repo raises it."""


class _Fault:
    """One armed fault spec (the reference's plan schema):
    family/site/mode plus a firing schedule — explicit invocation
    indices (``at``), a seeded probability (``prob``), and an optional
    total-fire cap (``times``)."""

    __slots__ = ("family", "site", "mode", "at", "prob", "times",
                 "ms", "seq", "fired", "rng")

    def __init__(self, spec: dict, seed: int, index: int):
        self.family = str(spec.get("family", ""))
        if self.family not in FAMILIES:
            raise ValueError(f"unknown chaos family: {self.family!r}")
        self.site = str(spec.get("site", "*"))
        self.mode = str(spec.get("mode", ""))
        if self.family == "payload":
            self.mode = self.mode or "corrupt"
            if self.mode not in PAYLOAD_MODES:
                raise ValueError(
                    f"unknown payload mode: {self.mode!r}")
        elif self.family == "dispatch":
            self.mode = self.mode or "raise"
            if self.mode not in ("raise", "exhaust"):
                raise ValueError(
                    f"unknown dispatch mode: {self.mode!r}")
        elif self.family == "net":
            self.mode = self.mode or "reset"
            if self.mode not in NET_MODES:
                raise ValueError(f"unknown net mode: {self.mode!r}")
        elif self.family == "disk":
            self.mode = self.mode or "torn"
            if self.mode not in DISK_MODES:
                raise ValueError(f"unknown disk mode: {self.mode!r}")
        elif self.family == "ship":
            self.mode = self.mode or "drop"
            if self.mode not in SHIP_MODES:
                raise ValueError(f"unknown ship mode: {self.mode!r}")
        self.at = frozenset(int(x) for x in (spec.get("at") or ()))
        self.prob = float(spec.get("prob") or 0.0)
        self.times = int(spec.get("times") or 0)
        self.ms = float(spec.get("ms") or 0.0)
        self.seq = 0
        self.fired = 0
        # one independent deterministic stream per spec: firing of
        # spec i never perturbs spec j's schedule. Stable int seed on
        # purpose (str hash() is process-salted; tuple seeding is
        # deprecated) — (plan seed, spec index, family) all mix in.
        self.rng = random.Random(
            int(seed) * 1_000_003 + int(index) * 7_919
            + zlib.crc32(self.family.encode()))

    def matches(self, site: str) -> bool:
        return self.site == "*" or self.site == site \
            or site.startswith(self.site + ".")

    def decide(self) -> bool:
        """One invocation at a matching site: advance the per-spec
        counter and report whether this invocation WOULD inject.
        ``fired`` is charged by the caller for the winning spec only —
        a spec that hits but loses the invocation to an earlier spec
        must not consume its ``times`` cap on a fault it never
        injected. Called under the engine lock."""
        self.seq += 1
        if self.times and self.fired >= self.times:
            return False
        hit = self.seq in self.at
        if not hit and self.prob:
            # drawn EVERY invocation so the stream stays aligned with
            # the invocation counter regardless of earlier outcomes
            hit = self.rng.random() < self.prob
        return hit


class _State:
    __slots__ = ("enabled", "faults", "log", "dropped", "lock",
                 "suspend_depth", "seed")

    def __init__(self, enabled_: bool, plan: Optional[dict]):
        self.enabled = bool(enabled_) and plan is not None
        self.seed = int((plan or {}).get("seed", 0))
        self.faults: List[_Fault] = [
            _Fault(spec, self.seed, i)
            for i, spec in enumerate((plan or {}).get("faults") or ())
        ]
        self.log: List[dict] = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.suspend_depth = 0


_STATE: Optional[_State] = None
_STATE_LOCK = threading.Lock()


def _load_plan(raw: str) -> dict:
    raw = raw.strip()
    if raw.startswith("{"):
        return json.loads(raw)
    with open(raw) as f:
        return json.load(f)


def _resolve_state() -> _State:
    global _STATE
    st = _STATE
    if st is None:
        with _STATE_LOCK:
            st = _STATE
            if st is None:
                raw = os.environ.get("CAUSE_TPU_CHAOS", "").strip()
                if not raw or raw.lower() in ("0", "false", "no"):
                    st = _State(False, None)
                else:
                    # a broken plan fails loudly: silently running
                    # without the faults you asked for is the one
                    # outcome a chaos harness must never have
                    st = _State(True, _load_plan(raw))
                _STATE = st
    return st


def configure(plan: Optional[dict] = None,
              enabled: Optional[bool] = None,
              reset: bool = False) -> None:
    """Arm (or disarm) the engine programmatically — the soak harness
    and tests. ``reset=True`` drops all engine state and re-reads the
    environment on next use."""
    global _STATE
    with _STATE_LOCK:
        if reset:
            _STATE = None
            if plan is None and enabled is None:
                return
        if plan is not None:
            _STATE = _State(True if enabled is None else enabled, plan)
            return
    st = _resolve_state()
    if enabled is not None:
        st.enabled = bool(enabled) and bool(st.faults)


def reset() -> None:
    """Drop all chaos state; re-read ``CAUSE_TPU_CHAOS`` on next use."""
    configure(reset=True)


def enabled() -> bool:
    st = _resolve_state()
    return st.enabled and st.suspend_depth == 0


class suspended:
    """Context manager: chaos is inert inside the block WITHOUT
    consuming any fault-spec invocation counters — the soak's
    fault-free oracle replays the same ops through the same call
    sites and must not perturb (or suffer) the fault schedule."""

    def __enter__(self):
        st = _resolve_state()
        with st.lock:
            st.suspend_depth += 1
        return self

    def __exit__(self, *exc):
        st = _resolve_state()
        with st.lock:
            st.suspend_depth = max(0, st.suspend_depth - 1)
        return False


def _decide(site: str, family: str,
            mode: Optional[str] = None) -> Optional[_Fault]:
    st = _resolve_state()
    if not (st.enabled and st.suspend_depth == 0):
        return None
    with st.lock:
        hit = None
        for f in st.faults:
            if f.family != family or not f.matches(site):
                continue
            if mode is not None and f.mode != mode:
                # mode-specific hooks never advance (or consume) a
                # different mode's schedule: raise-specs tick only at
                # dispatch_fault, exhaust-specs only at budget_exhaust
                continue
            # every matching spec advances (determinism: counters
            # depend on the call sequence, not on other specs'
            # outcomes); the first hit wins the invocation
            if f.decide() and hit is None:
                hit = f
        if hit is not None:
            hit.fired += 1
        return hit


def _record(f: _Fault, site: str, **details) -> None:
    st = _resolve_state()
    rec = {"family": f.family, "site": site, "mode": f.mode,
           "seq": f.seq, "ts_us": time.time_ns() // 1000}
    rec.update(details)
    with st.lock:
        if len(st.log) >= _LOG_MAX:
            st.dropped += 1
        else:
            st.log.append(rec)


# ------------------------------------------------------------- hooks


def mangle_items(items: list, site: str = "sync.delta") -> list:
    """Maybe-mangled copy of an encoded node-triple payload (the
    ``serde.encode_node_items`` wire form). Returns ``items``
    unchanged (same object) when no payload fault fires; empty
    payloads never consume a firing (there is nothing to corrupt)."""
    if not items:
        return items
    f = _decide(site, "payload")
    if f is None:
        return items
    out = [list(it) for it in items]
    idx = f.rng.randrange(len(out))
    mode = f.mode
    if mode == "corrupt":
        out[idx][2] = CORRUPT_MARKER
    elif mode == "truncate":
        out[idx] = out[idx][:2]
    elif mode == "duplicate":
        dup = [out[idx][0], out[idx][1], CORRUPT_MARKER]
        out.insert(idx + 1, dup)
    elif mode == "reorder":
        if len(out) >= 2:
            out[0], out[-1] = out[-1], out[0]
        else:
            out[idx][2] = CORRUPT_MARKER
            mode = "corrupt"
    elif mode == "drop":
        del out[idx]
    _record(f, site, nodes=len(items), index=idx, applied=mode)
    return out


def dispatch_fault(site: str) -> None:
    """A ``dispatch``-family fault in ``raise`` mode: raise the
    transient :class:`InjectedDispatchError` (the recovery ladder's
    retry input). ``exhaust``-mode specs are read by
    :func:`budget_exhaust` instead and never fire here."""
    f = _decide(f"{site}.dispatch", "dispatch", mode="raise")
    if f is None:
        return
    _record(f, site)
    raise InjectedDispatchError(
        f"chaos: injected dispatch failure at {site} "
        f"(seq {f.seq})")


def budget_exhaust(site: str) -> bool:
    """A ``dispatch``-family fault in ``exhaust`` mode: report a
    window-budget exhaustion (the caller drops its delta frontier and
    runs the full-width ladder rung)."""
    f = _decide(f"{site}.budget", "dispatch", mode="exhaust")
    if f is None:
        return False
    _record(f, site)
    return True


def should_crash(site: str) -> bool:
    """Whether a ``crash`` fault fires at this point — the HARNESS
    acts on it (drop the session, restore from checkpoint); the
    engine only schedules and records."""
    f = _decide(site, "crash")
    if f is None:
        return False
    _record(f, site)
    return True


def stall_point(site: str) -> float:
    """Sleep a ``stall`` fault's ``ms`` (capped) inside a wave —
    enough to trip the live ``absence:run.heartbeat`` rule in a
    watching monitor. Returns the seconds actually slept (0.0 when
    nothing fired)."""
    f = _decide(site, "stall")
    if f is None:
        return 0.0
    dur = min(max(f.ms, 0.0) / 1000.0, _STALL_CAP_S)
    _record(f, site, stall_ms=round(dur * 1000.0, 3))
    if dur:
        time.sleep(dur)
    return dur


# ------------------------------------------------------------- net
#
# Wire-level fault hooks for the replication transport. Each hook is
# mode-filtered (a ``latency`` spec never advances at the ``reset``
# hook and vice versa — the same rule the dispatch family follows),
# so one plan can schedule independent partition/reset/latency/
# blackhole/dup streams against the same site with per-spec
# determinism. Site convention: the transport calls the dial-side
# hook at ``<site>.connect`` and the frame-send hooks at
# ``<site>.send``, so a spec's ``site`` of ``net.client`` matches
# both via the prefix rule.


def net_partition(site: str) -> bool:
    """Whether a ``partition``-mode net fault refuses this connect
    attempt (the dial raises its connection-refused path; the caller's
    backoff ladder owns the retry). One invocation per dial."""
    f = _decide(f"{site}.connect", "net", mode="partition")
    if f is None:
        return False
    _record(f, site)
    return True


def net_reset(site: str) -> bool:
    """Whether a ``reset``-mode net fault kills the connection at this
    frame send (the transport closes the socket; the peer sees EOF
    mid-protocol)."""
    f = _decide(f"{site}.send", "net", mode="reset")
    if f is None:
        return False
    _record(f, site)
    return True


def net_latency_ms(site: str) -> float:
    """Milliseconds of injected latency before this frame send (the
    spec's ``ms``, capped like stalls so no plan wedges a run for
    real); 0.0 when nothing fired."""
    f = _decide(f"{site}.send", "net", mode="latency")
    if f is None:
        return 0.0
    dur_ms = min(max(f.ms, 0.0), _STALL_CAP_S * 1000.0)
    _record(f, site, latency_ms=round(dur_ms, 3))
    return dur_ms


def net_blackhole(site: str) -> bool:
    """Whether a ``blackhole``-mode net fault silently drops this
    outbound frame (the send "succeeds", nothing crosses the wire —
    the peer's read deadline is the only detector)."""
    f = _decide(f"{site}.send", "net", mode="blackhole")
    if f is None:
        return False
    _record(f, site)
    return True


def net_dup(site: str) -> bool:
    """Whether a ``dup``-mode net fault sends this frame twice (same
    seq on the wire — the receiver's wire-duplicate detector must
    count it and re-ack idempotently)."""
    f = _decide(f"{site}.send", "net", mode="dup")
    if f is None:
        return False
    _record(f, site)
    return True


# ------------------------------------------------------------ disk
#
# Durable-storage fault hooks for the WAL/checkpoint write seams.
# Mode-filtered like the net family (a ``torn`` spec never advances at
# the fsync hook and vice versa), so one plan schedules independent
# torn/bitrot/enospc/fsync/rename streams with per-spec determinism.
# Site convention: the WAL calls the record-write hooks at
# ``<site>.write``, the flush-to-media hook at ``<site>.fsync`` and
# the atomic-rename hooks at ``<site>.rename``, so a spec's ``site``
# of ``serve.wal`` (or ``serve.checkpoint``) matches via the prefix
# rule. The hooks only SCHEDULE; the storage layer owns the actual
# misbehavior (write the torn prefix, flip the byte, raise ENOSPC) —
# same split as ``should_crash``.


def disk_torn(site: str) -> bool:
    """Whether a ``torn``-mode disk fault tears this record write (the
    WAL writes a prefix of the line and fails the append — a crash
    mid-write; the op is never acknowledged and the next scan counts
    the tear)."""
    f = _decide(f"{site}.write", "disk", mode="torn")
    if f is None:
        return False
    _record(f, site)
    return True


def disk_bitrot(site: str, nbytes: int, **details) -> Optional[int]:
    """The byte index a ``bitrot``-mode disk fault flips in this
    record's durable copy (None when nothing fired). The caller's
    ``details`` ride the injection log — the soak's oracle reads the
    intact ground truth back from there, since the whole point of the
    fault is that the on-disk copy no longer has it."""
    f = _decide(f"{site}.write", "disk", mode="bitrot")
    if f is None or nbytes <= 0:
        return None
    idx = f.rng.randrange(int(nbytes))
    _record(f, site, index=idx, nbytes=int(nbytes), **details)
    return idx


def disk_enospc(site: str) -> bool:
    """Whether an ``enospc``-mode disk fault refuses this write (the
    WAL raises its unappendable error; admission must refuse with the
    durability shed rung — an unappendable journal never acks)."""
    f = _decide(f"{site}.write", "disk", mode="enospc")
    if f is None:
        return False
    _record(f, site)
    return True


def disk_fsync_fail(site: str) -> bool:
    """Whether a ``fsync``-mode disk fault fails this flush-to-media
    call (the WAL rotates to a fresh segment with evidence — a file
    descriptor that failed fsync has undefined durable state)."""
    f = _decide(f"{site}.fsync", "disk", mode="fsync")
    if f is None:
        return False
    _record(f, site)
    return True


def disk_rename_fail(site: str) -> bool:
    """Whether a ``rename``-mode disk fault fails this atomic
    manifest/GC rename (the caller must keep the previous manifest
    intact and surface the failure loudly)."""
    f = _decide(f"{site}.rename", "disk", mode="rename")
    if f is None:
        return False
    _record(f, site)
    return True


# ------------------------------------------------------------ ship
#
# Telemetry-link fault hooks for the obs shipping plane. Mode-filtered
# like the net/disk families (a ``drop`` spec never advances at the
# dup hook and vice versa), so one plan schedules independent
# partition/drop/dup/reorder streams against the telemetry link with
# per-spec determinism. Site convention mirrors the net family: the
# exporter calls the dial-side hook at ``<site>.connect`` and the
# frame-send hooks at ``<site>.send``, so a spec's ``site`` of
# ``obs.ship`` matches both via the prefix rule. These hooks fire
# ONLY inside the shipping layer — the data-plane transport never
# calls them, which is exactly what lets a ship-chaos soak gate on
# bit-identical data-plane output while the telemetry plane burns.


def ship_partition(site: str) -> bool:
    """Whether a ``partition``-mode ship fault refuses this exporter
    dial (the exporter's seeded backoff ladder owns the retry; records
    keep accumulating in the bounded buffer, oldest dropped with
    evidence). One invocation per dial."""
    f = _decide(f"{site}.connect", "ship", mode="partition")
    if f is None:
        return False
    _record(f, site)
    return True


def ship_drop(site: str) -> bool:
    """Whether a ``drop``-mode ship fault silently discards this
    outbound obs frame (the send "succeeds" locally, nothing crosses
    the wire — the collector's watermark gap plus the exporter's
    unacked resend window are the detectors)."""
    f = _decide(f"{site}.send", "ship", mode="drop")
    if f is None:
        return False
    _record(f, site)
    return True


def ship_dup(site: str) -> bool:
    """Whether a ``dup``-mode ship fault sends this obs frame twice
    (same (origin, seq) on the wire — the collector's per-origin
    watermark dedup must absorb it without a duplicate record)."""
    f = _decide(f"{site}.send", "ship", mode="dup")
    if f is None:
        return False
    _record(f, site)
    return True


def ship_reorder(site: str) -> bool:
    """Whether a ``reorder``-mode ship fault holds this obs frame back
    one send, letting the next frame overtake it (the collector sees
    seqs arrive out of order and must either buffer or refuse-and-let-
    resume repair — never persist out of watermark order)."""
    f = _decide(f"{site}.send", "ship", mode="reorder")
    if f is None:
        return False
    _record(f, site)
    return True


# ------------------------------------------------------------ report


def injected() -> List[dict]:
    """A copy of the injected-fault log (bounded; ``chaos_report``
    counts drops)."""
    st = _resolve_state()
    with st.lock:
        return [dict(r) for r in st.log]


def chaos_report() -> dict:
    """The engine's own accounting: total injections, by family, by
    site/mode — the soak gate compares this against the DETECTED side
    (sync.reject, recovery events) so an injected-but-undetected
    fault fails loudly."""
    st = _resolve_state()
    with st.lock:
        log = [dict(r) for r in st.log]
        dropped = st.dropped
    by_family: Dict[str, int] = {}
    by_site: Dict[str, int] = {}
    for r in log:
        by_family[r["family"]] = by_family.get(r["family"], 0) + 1
        key = f"{r['site']}:{r['mode']}" if r.get("mode") else r["site"]
        by_site[key] = by_site.get(key, 0) + 1
    return {"injected": len(log), "dropped": dropped,
            "by_family": by_family, "by_site": by_site, "log": log}
