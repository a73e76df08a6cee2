"""Cross-process trace propagation: one causal identity per op batch.

Every other obs axis (PRs 1-10) is per-process: wire frames carry no
trace context, WAL records can't be joined back to the op that
produced them, and multi-stream evidence merges by raw wall timestamps
— meaningless across hosts with skewed clocks. This module is the
write side of the fix (``journey`` is the read side): a **trace**
(one minted op batch) moves through named **hops**, each hop one
``xtrace.hop`` event carrying ``trace``/``span``/``parent`` ids, so a
later reader can reconstruct the full causal chain an op took —
mint → send → (wire) → recv → admit → journal → tick → wave → apply →
converged — across process and host boundaries.

Design rules:

- **obs-off is zero**: every public API checks ``enabled()`` first
  and returns ``None`` without touching state, reading the
  environment, or allocating. The wire/journal context fields exist
  ONLY when the emitting process has obs on; receivers treat
  them as optional keys, so old/new endpoints interoperate freely.
- **spans are cheap ids, not timers**: a hop is an instant event (the
  obs record's ``ts_us`` is its wall-clock time); latency between
  hops is the READER's subtraction, after per-connection clock-offset
  correction. ``parent`` makes the chain checkable: a journey with a
  hop whose parent span is missing has lost evidence (an "orphan").
- **cross-thread continuation is explicit**: the wire carries
  ``{"t": trace, "s": span}`` context; in-process handoffs (queue
  entries, WAL rows) carry the bare trace id and the per-trace
  last-span registry links the chain — admission threads and the
  service tick thread never share a thread-local.
- **op ids join the lag tracer**: :func:`bind_ops` maps node ids to
  their trace so ``op.lag`` / ``lag.replica`` records (and the
  ``converged`` hop) can print trace ids the ``journey`` CLI accepts
  — the lag→journey drill-down. The registry is LRU-bounded like
  every other obs registry.

Clock-offset estimation rides the existing request/response pairs
(hello→welcome, ping→pong): when obs is on the server stamps its
reply with ``ts_us``/``pid`` and the client emits one ``xtrace.clock``
event per exchange — ``offset_us ≈ server_ts - midpoint(t0, t1)``,
the classic NTP half-RTT estimate. The journey reader takes the
median per (observer pid → remote pid) edge.

Stdlib only, in-process, thread-safe. NEVER call from inside a jit
trace (causelint XTR001 enforces the ``obs.enabled()`` guard).
"""

from __future__ import annotations

import os as _os
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

from . import core

__all__ = [
    "enabled", "reset", "new_trace", "hop", "wire_context",
    "continue_from", "bind_ops", "trace_of", "last_span",
    "clock_sample", "reply_stamp", "HOP_ORDER",
]

# canonical hop vocabulary, in causal order (the journey reader uses
# this to label decomposition edges; unknown hop names still work)
HOP_ORDER = ("mint", "send", "recv", "admit", "journal", "defer",
             "tick", "replay", "wave", "apply", "converged", "shed")

_OPS_MAX = 16384     # op-id -> trace registry bound (entries)
_LAST_MAX = 4096     # trace -> last-span registry bound (entries)

_LOCK = threading.Lock()
# op id (node id tuple) -> trace id; LRU (insertion refreshed on bind)
_OPS: "OrderedDict[object, str]" = OrderedDict()
# trace id -> last span id emitted for it (the cross-thread parent)
_LAST: "OrderedDict[str, str]" = OrderedDict()
_SPAN_N = 0


def enabled() -> bool:
    """Whether tracing records anything (== ``obs.enabled()``)."""
    return core.enabled()


def reset() -> None:
    """Drop all trace state (tests, bench warm phases; delegated to by
    ``obs.reset()`` so one reset reaches every tracer)."""
    global _SPAN_N
    with _LOCK:
        _OPS.clear()
        _LAST.clear()
        _SPAN_N = 0


def _new_span_locked() -> str:
    global _SPAN_N
    _SPAN_N += 1
    return f"{_os.getpid():x}.{_SPAN_N:x}"


def new_trace() -> Optional[str]:
    """Mint a fresh trace id (None when obs is off). The id is random
    (collision-safe across hosts) and printable — the ``journey`` CLI
    accepts it verbatim."""
    if not core.enabled():
        return None
    return _os.urandom(8).hex()


def last_span(trace: str) -> Optional[str]:
    """The last span id emitted for ``trace`` in THIS process (the
    default parent for a cross-thread continuation), or None."""
    if not core.enabled():
        return None
    with _LOCK:
        return _LAST.get(str(trace))


def hop(name: str, trace: Optional[str],
        parent: Optional[str] = None, **attrs) -> Optional[str]:
    """Record one hop on ``trace``: emits an ``xtrace.hop`` event and
    returns the hop's span id (the parent for whatever follows).
    ``parent=None`` links to the trace's last in-process span — the
    queue-entry/WAL-row handoff case; pass ``parent=""`` explicitly
    for a root hop (mint). No-op (None) when obs is off or ``trace``
    is falsy, so callers may pass an unminted trace straight
    through."""
    if not core.enabled() or not trace:
        return None
    trace = str(trace)
    with _LOCK:
        span = _new_span_locked()
        if parent is None:
            parent = _LAST.get(trace) or ""
        _LAST.pop(trace, None)
        _LAST[trace] = span
        while len(_LAST) > _LAST_MAX:
            _LAST.popitem(last=False)
    core.event("xtrace.hop", trace=trace, span=span,
               parent=str(parent), hop=str(name), **attrs)
    return span


def wire_context(trace: Optional[str],
                 span: Optional[str]) -> Optional[dict]:
    """The frame-attachable context for a hop: ``{"t": .., "s": ..}``.
    None when obs is off or either id is missing — the caller attaches
    nothing and the frame bytes stay pinned."""
    if not core.enabled() or not trace or not span:
        return None
    return {"t": str(trace), "s": str(span)}


def continue_from(ctx) -> Tuple[Optional[str], Optional[str]]:
    """Validate an inbound wire context: ``(trace, parent_span)``, or
    ``(None, None)`` for anything malformed (the wire is a trust
    boundary — a garbage ctx must degrade to an untraced frame, never
    an exception on the admission path)."""
    if not core.enabled() or not isinstance(ctx, dict):
        return (None, None)
    t, sp = ctx.get("t"), ctx.get("s")
    if not isinstance(t, str) or not t or len(t) > 64 \
            or not isinstance(sp, str) or not sp or len(sp) > 64:
        return (None, None)
    return (t, sp)


def bind_ops(trace: Optional[str], op_ids: Iterable) -> None:
    """Join ``op_ids`` (node id tuples) to ``trace`` so the lag tracer
    can print trace ids and the ``converged`` hop can find its trace.
    First bind wins — a replay re-binding an id keeps the original
    trace."""
    if not core.enabled() or not trace:
        return
    trace = str(trace)
    with _LOCK:
        for op in op_ids:
            try:
                key = tuple(op) if isinstance(op, list) else op
            except TypeError:
                key = op
            if key not in _OPS:
                _OPS[key] = trace
        while len(_OPS) > _OPS_MAX:
            _OPS.popitem(last=False)


def trace_of(op_id) -> Optional[str]:
    """The trace an op id was bound to, or None (off, or unbound)."""
    if not core.enabled():
        return None
    try:
        key = tuple(op_id) if isinstance(op_id, list) else op_id
    except TypeError:
        key = op_id
    with _LOCK:
        return _OPS.get(key)


def traces_of(op_ids: Iterable) -> List[str]:
    """Distinct traces of ``op_ids``, first-seen order (off -> [])."""
    if not core.enabled():
        return []
    out: List[str] = []
    seen = set()
    with _LOCK:
        for op in op_ids:
            try:
                key = tuple(op) if isinstance(op, list) else op
            except TypeError:
                key = op
            t = _OPS.get(key)
            if t is not None and t not in seen:
                seen.add(t)
                out.append(t)
    return out


def reply_stamp() -> Dict[str, int]:
    """The server-side reply fields behind clock estimation:
    ``{"ts_us", "pid"}``. Callers merge into a reply ONLY when obs is
    on (the obs-off frame bytes are pinned)."""
    return {"ts_us": time.time_ns() // 1000, "pid": _os.getpid()}


def clock_sample(reply: dict, t0_us: int, t1_us: int,
                 via: str = "") -> Optional[float]:
    """Estimate the remote clock offset from one request/response pair
    and emit the ``xtrace.clock`` event the journey reader folds:
    ``reply`` is the peer's response (carrying ``ts_us``/``pid`` when
    its obs is on), ``t0_us``/``t1_us`` the local WALL-clock
    microseconds around the exchange. Returns the offset estimate in
    microseconds (remote - local), or None when the peer sent no stamp
    (old server, or obs off on its side)."""
    if not core.enabled() or not isinstance(reply, dict):
        return None
    ts = reply.get("ts_us")
    rpid = reply.get("pid")
    if not isinstance(ts, int) or not isinstance(rpid, int):
        return None
    mid = (int(t0_us) + int(t1_us)) / 2.0
    offset = float(ts) - mid
    core.event("xtrace.clock", remote_pid=rpid,
               offset_us=round(offset, 1),
               rtt_us=int(t1_us) - int(t0_us), via=str(via))
    return offset
