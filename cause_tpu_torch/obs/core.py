"""The unified trace/metrics substrate (spans, counters, events).

A copy of ``cause_tpu.obs.core``: the same record schema, event names,
field names and environment variables, so a stream from either package
reads the same to the other package's folds. It is the ONE substrate
the port reports through:

- **spans** — ``with obs.span("wave.dispatch", kernel="v5"):`` —
  record wall time (start ``ts_ns`` and end ``end_ns`` from one clock,
  epoch ns, the clock ``torch.profiler``'s ``trace_start_ns`` counts
  from; ``ts_us`` and ``dur_us`` derived from them), pid/tid,
  nesting (parent id + depth), the reporting process's platform tag
  (``gpu`` on the card, ``cpu`` otherwise; never ``tpu``), and the
  port's program identity — the ``BENCH_KERNEL`` pipeline and the
  hash of the CUDA kernel sources (``kernels.source_hash``) — under
  the record's ``switches`` key, so a number in a trace can always be
  tied back to the exact kernels that produced it (the JAX package's
  trace-time strategy switches do not exist here: the port always
  launches its CUDA kernels);
- a **counter/gauge registry** — program-cache hits/misses, lane-cache
  hits, wave fallbacks, checksum-gate outcomes, certification
  revocations — aggregated in-process and snapshotted into the event
  stream by ``flush()`` (and automatically at exit);
- a bounded in-process **event ring buffer** (newest events win) with
  JSONL export, plus a streaming **sink**: when an output path is
  configured every event is appended to it the moment it is recorded,
  one JSON line per event, via a single O_APPEND write. That makes the
  sink safe for child processes: a child keeps streaming its events
  into the same sidecar file, and concurrent parent/child appends
  interleave at line granularity;
- a **Chrome-trace/Perfetto exporter** (``cause_tpu_torch.obs.perfetto``,
  ``python -m cause_tpu_torch.obs``) so any run opens in a trace
  viewer.

Stdlib-only at import time: the program-identity snapshot imports the
kernel library lazily, on live-span close.

Off by default: with ``CAUSE_TPU_OBS`` unset (or ``0``) and no
``torch.profiler`` recording, ``span()`` returns a shared no-op context
manager (its cost: one read of the profiler's state, and only where
``torch`` is already imported), ``counter()``/``gauge()`` return a
shared no-op instrument, nothing is recorded, no file is opened, no
CUDA event is made, and no program-identity input (``BENCH_KERNEL``,
the kernel sources) is ever read (the snapshot happens only on
live-span close). Enable with ``CAUSE_TPU_OBS=1``; stream with
``CAUSE_TPU_OBS_OUT=<path>``; bound the ring with
``CAUSE_TPU_OBS_RING`` (default 65536 events). This package's state is
its own: configuring one package's obs does not configure the other's,
though both read the same variables when they first resolve.

A recording profiler turns the program's spans on. While a
``torch.profiler`` records, every ``span()`` is live even with obs
off: it opens ``torch.profiler.record_function(<span name>)``, so the
span is a host range of the profiler's own trace, on its clock, around
the ops and launches it issued, and its record (marked ``profiled``)
goes to the ring, not to the sink. Counters, gauges and events stay
obs-only. Stopping the profiler turns the spans off again.

The device interval: a live span given the tensor (or device) whose
work it wraps (``span(name, on=x)``) records, where that is a CUDA
device, a timing ``torch.cuda.Event`` on the device's current stream at
enter and at exit. Its record then carries ``dev_us``: the span's
length on the device's timeline, from the stream reaching the span's
first work to it finishing its last. ``dev_us`` is resolved lazily,
once the work is done: the ring's read (``events()``), ``flush()`` and
``export_jsonl()`` wait for it, and a span's close settles the ones
already done; the record reaches the sink and the subscribers when it
is resolved. Nothing synchronizes inside a span. On the CPU a record
has no ``dev_us``.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, Optional

__all__ = [
    "configure",
    "enabled",
    "span",
    "event",
    "counter",
    "gauge",
    "counters_snapshot",
    "events",
    "flush",
    "export_jsonl",
    "set_platform",
    "platform_of",
    "reset",
    "subscribe",
    "unsubscribe",
]

_TRUTHY = ("1", "true", "yes")
_DEFAULT_RING = 65536
# live spans whose device interval is still open past which a span's
# close settles the ones already done
_PENDING_POLL = 64
_PROFILER = "torch.autograd.profiler"
# the process id stamped on every record: read once, and again in a
# forked child (a system call costs tens of microseconds in a
# sandboxed process, and spans close on the wave's hot path)
_PID = os.getpid()


def _reset_pid() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_reset_pid)


def _profiling() -> bool:
    """Whether a ``torch.profiler`` records in this process: the
    profiler module's own flag, read only where ``torch`` is already
    imported (obs itself never imports it)."""
    prof = sys.modules.get(_PROFILER)
    return prof is not None and prof._is_profiler_enabled


class _NullSpan:
    """The disabled-mode span: one shared instance, every method a
    no-op. Deliberately tiny — the disabled ``span()`` call is on trace
    -time and wave hot paths and must stay sub-microsecond. ``live``
    is False: a call site computes derived attributes only for a live
    span."""

    __slots__ = ()
    live = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


class _NullInstrument:
    """Disabled-mode counter/gauge: shared, inert."""

    __slots__ = ()

    def inc(self, n=1):
        return self

    def set(self, value):
        return self

    @property
    def value(self):
        return 0


_NULL_SPAN = _NullSpan()
_NULL_INSTRUMENT = _NullInstrument()

# default bound of one in-process subscriber queue (obs.live's
# monitor drains on its own cadence; a stalled reader must cost the
# writer one deque append and nothing else)
_SUBSCRIBER_QUEUE = 8192


class Subscription:
    """One bounded in-process subscriber on the sink: every record the
    substrate emits is appended to this queue the moment it lands in
    the ring (newest win when the reader falls behind — ``dropped``
    counts the loss honestly). Readers drain with :meth:`drain` on
    their own cadence; the writer never blocks and never runs reader
    code (no callback re-entrancy under the state lock). Created via
    :func:`subscribe`, torn down via :func:`unsubscribe`."""

    __slots__ = ("queue", "dropped", "lock", "closed")

    def __init__(self, maxlen: int):
        self.queue = deque(maxlen=max(1, int(maxlen)))
        self.dropped = 0
        self.lock = threading.Lock()
        self.closed = False

    def push(self, obj: dict) -> None:
        with self.lock:
            if self.closed:
                return
            if len(self.queue) == self.queue.maxlen:
                self.dropped += 1
            self.queue.append(obj)

    def drain(self) -> list:
        """All queued records, oldest first (and empties the queue)."""
        with self.lock:
            out = list(self.queue)
            self.queue.clear()
        return out


class _State:
    """One process-wide obs state (enabled flag, registry, ring,
    sink). Re-created by configure(reset=True) for tests."""

    __slots__ = (
        "enabled", "out", "ring", "counters", "gauges", "lock",
        "tls", "fd", "platform", "ids", "atexit_armed", "subscribers",
        "pending",
    )

    def __init__(self, enabled_: bool, out: str, ring_size: int):
        self.enabled = enabled_
        self.out = out
        self.ring = deque(maxlen=max(1, int(ring_size)))
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.lock = threading.Lock()
        self.tls = threading.local()
        self.fd = None            # lazily opened O_APPEND sink
        # None follows the package default device (``use_device``)
        # until ``set_platform`` names one
        self.platform: Optional[str] = None
        self.ids = itertools.count(1)
        self.atexit_armed = False
        # in-process live subscribers (obs.live monitors); empty
        # tuple in the common case so record() pays one attribute
        # read, nothing else
        self.subscribers: tuple = ()
        # closed spans whose device interval is not resolved yet, in
        # close order: (record, start event, end event, emit)
        self.pending: deque = deque()

    # ---------------------------------------------------------- sink
    def write_line(self, obj: dict) -> None:
        """Append one JSON line to the sink (if any). A single
        os.write of the whole line on an O_APPEND fd: parent and
        abandoned-child writers interleave at line granularity, and an
        IO failure never takes the instrumented program down."""
        if not self.out:
            return
        try:
            if self.fd is None:
                d = os.path.dirname(os.path.abspath(self.out))
                if d:
                    os.makedirs(d, exist_ok=True)
                self.fd = os.open(
                    self.out, os.O_APPEND | os.O_CREAT | os.O_WRONLY,
                    0o644,
                )
            os.write(self.fd,
                     (json.dumps(obj, default=str) + "\n").encode())
        except OSError:
            self.out = ""  # sink is best-effort; stop retrying

    def record(self, obj: dict, emit: bool = True) -> None:
        """Keep ``obj`` in the ring and, where ``emit``, stream it."""
        self.ring.append(obj)
        if emit:
            self.emit(obj)

    def emit(self, obj: dict) -> None:
        """Stream ``obj`` to the sink and the subscribers."""
        self.write_line(obj)
        for sub in self.subscribers:
            sub.push(obj)

    def settle(self, wait: bool) -> None:
        """Resolve the ``dev_us`` of closed spans in close order and
        stream those that obs emits: every one when ``wait`` (waiting
        for their end events outside the lock), else those whose work is
        already done."""
        if not self.pending:
            return
        if wait:
            with self.lock:
                ends = [p[2] for p in self.pending]
            for end in ends:
                end.synchronize()
        with self.lock:
            while self.pending:
                rec, start, end, emit = self.pending[0]
                if not end.query():
                    break
                self.pending.popleft()
                rec["dev_us"] = round(start.elapsed_time(end) * 1e3, 3)
                if emit:
                    self.emit(rec)


_STATE: Optional[_State] = None
_STATE_LOCK = threading.Lock()


def _resolve_state() -> _State:
    global _STATE
    st = _STATE
    if st is None:
        with _STATE_LOCK:
            st = _STATE
            if st is None:
                on = os.environ.get("CAUSE_TPU_OBS", "").strip().lower()
                out = os.environ.get("CAUSE_TPU_OBS_OUT", "").strip()
                try:
                    ring = int(os.environ.get("CAUSE_TPU_OBS_RING",
                                              "") or _DEFAULT_RING)
                except ValueError:
                    ring = _DEFAULT_RING
                st = _State(on in _TRUTHY, out, ring)
                _STATE = st
                if st.enabled:
                    _arm_atexit(st)
    return st


def _arm_atexit(st: _State) -> None:
    if not st.atexit_armed:
        st.atexit_armed = True
        atexit.register(_atexit_flush)


def _atexit_flush() -> None:
    # the final counter snapshot: an abandoned bench child exits
    # naturally (SystemExit between phases), so its counters land in
    # the sidecar even though nobody waits for it; spans whose device
    # interval is open are resolved first, best-effort (the card may be
    # gone by now)
    st = _STATE
    if st is not None and st.enabled and (st.counters or st.gauges
                                          or st.pending):
        try:
            st.settle(wait=True)
        except Exception:  # noqa: BLE001 - telemetry never fails an exit
            st.pending.clear()
        flush()


def configure(enabled: Optional[bool] = None,
              out: Optional[str] = None,
              ring_size: Optional[int] = None,
              reset: bool = False) -> None:
    """Reconfigure obs at runtime (tests, --obs-out script flags).
    ``reset=True`` drops recorded events/counters and re-reads the
    environment for anything not explicitly given."""
    global _STATE
    with _STATE_LOCK:
        cur = _STATE
        if reset or cur is None:
            if cur is not None:
                if cur.fd is not None:
                    try:
                        os.close(cur.fd)
                    except OSError:
                        pass
                # a reset drops ALL obs state, subscribers included —
                # mark them closed so a live attachment polling a
                # dead queue can SEE it died (sub.closed) instead of
                # silently draining nothing forever
                with cur.lock:
                    for s in cur.subscribers:
                        s.closed = True
                    cur.subscribers = ()
            _STATE = None
    if reset:
        # one reset reaches every tracer layered on this core: the
        # lag registries and the xtrace span/op registries would
        # otherwise leak state (and trace bindings) across test cases
        # and bench fleets. Late imports — both modules import core
        # at module level, so the top of this file cannot import them
        from . import lag as _lag
        from . import xtrace as _xtrace

        _lag.reset()
        _xtrace.reset()
    with _STATE_LOCK:
        if reset and enabled is None and out is None \
                and ring_size is None:
            return
    st = _resolve_state()
    with st.lock:
        if enabled is not None:
            st.enabled = bool(enabled)
        if out is not None:
            if st.fd is not None and out != st.out:
                try:
                    os.close(st.fd)
                except OSError:
                    pass
                st.fd = None
            st.out = out
        if ring_size is not None and ring_size != st.ring.maxlen:
            st.ring = deque(st.ring, maxlen=max(1, int(ring_size)))
        if st.enabled:
            _arm_atexit(st)


def reset() -> None:
    """Drop all obs state and re-read the environment on next use."""
    configure(reset=True)


def enabled() -> bool:
    return _resolve_state().enabled


def platform_of(device) -> str:
    """The platform tag of a device: ``gpu`` for a CUDA device (a
    ``torch.device``, or a string such as ``"cuda:0"``), ``cpu`` for
    the CPU, anything else as its type name."""
    kind = str(getattr(device, "type", device) or "").split(":")[0]
    return {"cuda": "gpu", "cpu": "cpu"}.get(kind, kind)


def _platform(st: _State) -> str:
    if st.platform is not None:
        return st.platform
    from .. import device as _device

    return platform_of(_device._DEFAULT)


def set_platform(platform) -> None:
    """Tag subsequent events with the platform of the work they
    describe: a device (``torch.device("cuda")`` -> ``gpu``, a CPU
    device -> ``cpu``) or a tag string; ``None`` returns to following
    the package default device."""
    st = _resolve_state()
    st.platform = None if platform is None else platform_of(platform)


def subscribe(maxlen: int = _SUBSCRIBER_QUEUE) -> Optional[Subscription]:
    """Attach a bounded in-process subscriber to the sink: every
    subsequently recorded event/span/gauge/counter snapshot is queued
    for the subscriber to :meth:`Subscription.drain` on its own
    cadence (the ``obs.live`` in-process feed). Returns None when obs
    is disabled — the obs-off contract is zero state, so a disabled
    process keeps no subscriber registry at all. An ``obs.reset()`` /
    ``configure(reset=True)`` detaches every subscriber and marks it
    ``closed`` — the holder must re-subscribe against the new state
    (``live.LiveAttachment.closed`` surfaces this)."""
    st = _resolve_state()
    if not st.enabled:
        return None
    sub = Subscription(maxlen)
    with st.lock:
        st.subscribers = st.subscribers + (sub,)
    return sub


def unsubscribe(sub: Optional[Subscription]) -> None:
    """Detach a subscriber (idempotent; None is a no-op so callers can
    pass the obs-off :func:`subscribe` result straight back)."""
    if sub is None:
        return
    sub.closed = True
    st = _STATE
    if st is None:
        return
    with st.lock:
        st.subscribers = tuple(s for s in st.subscribers if s is not sub)


def _switches_snapshot() -> Dict[str, str]:
    """The program-identity snapshot stamped on spans: the
    ``BENCH_KERNEL`` pipeline when set, and the hash of the kernel
    library's sources, headers and flags (what a build on the card
    compiles). Read ONLY on live-span close — disabled mode reads
    neither."""
    from .. import kernels

    out = {"kernels": kernels.source_hash()}
    v = os.environ.get("BENCH_KERNEL", "")
    if v:
        out["BENCH_KERNEL"] = v
    return out


class _Span:
    """A live span: context manager recording one "span" event on
    close. ``set(**attrs)`` adds attributes mid-flight. Opened while a
    profiler records, it is also a ``record_function`` range of the
    profiler's trace; given a CUDA tensor or device (``on``), it also
    times its work on the device (module docstring)."""

    __slots__ = ("st", "name", "attrs", "sid", "parent", "depth",
                 "ts_ns", "on", "stream", "rf", "events")
    live = True

    def __init__(self, st: _State, name: str, attrs: dict, on=None):
        self.st = st
        self.name = name
        self.attrs = attrs
        self.sid = next(st.ids)
        self.parent = 0
        self.depth = 0
        self.ts_ns = 0
        self.on = on
        self.stream = None
        self.rf = None
        self.events = None

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def __enter__(self):
        st = self.st
        stack = getattr(st.tls, "stack", None)
        if stack is None:
            stack = st.tls.stack = []
        if stack:
            self.parent = stack[-1]
        self.depth = len(stack)
        stack.append(self.sid)
        self.ts_ns = time.time_ns()
        if _profiling():
            self.rf = sys.modules[_PROFILER].record_function(self.name)
            self.rf.__enter__()
        dev = _cuda_device(self.on)
        if dev is not None:
            # a CUDA tensor or device: torch is loaded
            cuda = sys.modules["torch"].cuda
            self.stream = cuda.current_stream(dev)
            self.events = (cuda.Event(enable_timing=True),
                           cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        st = self.st
        # a span that raised may not have queued its work: no interval
        events = self.events if exc_type is None else None
        if events is not None:
            events[1].record(self.stream)
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        end_ns = time.time_ns()
        stack = getattr(st.tls, "stack", None)
        if stack and stack[-1] == self.sid:
            stack.pop()
        rec = {
            "ev": "span",
            "name": self.name,
            "ts_us": self.ts_ns // 1000,
            "dur_us": (end_ns - self.ts_ns) // 1000,
            "ts_ns": self.ts_ns,
            "end_ns": end_ns,
            "pid": _PID,
            "tid": threading.get_ident(),
            "id": self.sid,
            "parent": self.parent,
            "depth": self.depth,
            "platform": _platform(st),
            "switches": _switches_snapshot(),
        }
        if self.rf is not None:
            rec["profiled"] = True
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        emit = st.enabled
        with st.lock:
            if events is None:
                st.record(rec, emit)
            else:
                st.record(rec, emit=False)
                st.pending.append((rec, events[0], events[1], emit))
        if len(st.pending) > _PENDING_POLL:
            st.settle(wait=False)
        return False


def _cuda_device(on):
    """The CUDA device of ``on`` (a tensor or a device), or None."""
    if on is None:
        return None
    dev = getattr(on, "device", on)
    return dev if getattr(dev, "type", None) == "cuda" else None


class _Counter:
    __slots__ = ("st", "name")

    def __init__(self, st: _State, name: str):
        self.st = st
        self.name = name

    def inc(self, n=1):
        st = self.st
        with st.lock:
            st.counters[self.name] = st.counters.get(self.name, 0) + n
        return self

    @property
    def value(self):
        return self.st.counters.get(self.name, 0)


class _Gauge:
    __slots__ = ("st", "name")

    def __init__(self, st: _State, name: str):
        self.st = st
        self.name = name

    def set(self, value):
        """Record the new value in the registry AND as a timestamped
        ``gauge`` event — a gauge is a sampled time series (devprof
        memory curves), so each set must land in the stream, not just
        in the flush-time snapshot (which only has flush resolution)."""
        st = self.st
        rec = {
            "ev": "gauge",
            "name": self.name,
            "ts_us": time.time_ns() // 1000,
            "pid": _PID,
            "platform": _platform(st),
            "value": value,
        }
        with st.lock:
            st.gauges[self.name] = value
            st.record(rec)
        return self

    @property
    def value(self):
        return self.st.gauges.get(self.name, 0)


def span(name: str, on=None, **attrs):
    """A wall-time span, live while obs is on or a profiler records;
    otherwise the shared no-op. ``on``, the tensor (or device) whose
    work the span wraps, gives a live span on a CUDA device its device
    interval (``dev_us``)."""
    st = _resolve_state()
    if not st.enabled and not _profiling():
        return _NULL_SPAN
    return _Span(st, name, attrs, on)


def event(name: str, **fields) -> None:
    """An instant event (harvest ladder decisions, checksum-gate
    outcomes, overflow retries). ``fields`` must be JSON-serializable
    (non-serializable values are stringified)."""
    st = _resolve_state()
    if not st.enabled:
        return
    stack = getattr(st.tls, "stack", None)
    rec = {
        "ev": "event",
        "name": name,
        "ts_us": time.time_ns() // 1000,
        "pid": _PID,
        "tid": threading.get_ident(),
        "parent": stack[-1] if stack else 0,
        "platform": _platform(st),
    }
    if fields:
        rec["fields"] = fields
    with st.lock:
        st.record(rec)


def counter(name: str):
    """The named monotonic counter (disabled mode: shared no-op)."""
    st = _resolve_state()
    if not st.enabled:
        return _NULL_INSTRUMENT
    return _Counter(st, name)


def gauge(name: str):
    """The named last-value gauge (disabled mode: shared no-op)."""
    st = _resolve_state()
    if not st.enabled:
        return _NULL_INSTRUMENT
    return _Gauge(st, name)


def counters_snapshot() -> dict:
    """{"counters": {...}, "gauges": {...}} — current aggregate
    values (empty dicts when disabled)."""
    st = _resolve_state()
    with st.lock:
        return {"counters": dict(st.counters),
                "gauges": dict(st.gauges)}


def flush() -> None:
    """Resolve the device intervals of closed spans, then snapshot the
    counter/gauge registry into the event stream (and the sink). Call
    at phase boundaries; also runs at exit."""
    st = _resolve_state()
    st.settle(wait=True)
    if not st.enabled:
        return
    with st.lock:
        rec = {
            "ev": "counters",
            "ts_us": time.time_ns() // 1000,
            "pid": _PID,
            "platform": _platform(st),
            "counters": dict(st.counters),
            "gauges": dict(st.gauges),
        }
        st.record(rec)


def events() -> list:
    """A snapshot list of the ring buffer's events (oldest first), the
    device intervals of closed spans resolved."""
    st = _resolve_state()
    st.settle(wait=True)
    with st.lock:
        return list(st.ring)


def export_jsonl(path: str) -> int:
    """Write the ring buffer (plus a final counter snapshot) to
    ``path`` as JSON lines; returns the number of lines written."""
    st = _resolve_state()
    st.settle(wait=True)
    with st.lock:
        evs = list(st.ring)
        snap = {
            "ev": "counters",
            "ts_us": time.time_ns() // 1000,
            "pid": _PID,
            "platform": _platform(st),
            "counters": dict(st.counters),
            "gauges": dict(st.gauges),
        }
    evs.append(snap)
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        for e in evs:
            f.write(json.dumps(e, default=str) + "\n")
    return len(evs)
