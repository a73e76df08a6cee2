"""cause_tpu_torch.obs — the unified trace/metrics subsystem.

The port of ``cause_tpu.obs``: spans, counters/gauges, a bounded event
ring with JSONL streaming, the Chrome-trace/Perfetto exporter, the
CRDT-semantic events, the convergence-lag tracer and journeys, the
fleet and cost folds, the perf ledger, the live fold the serving loop
reads, the device-side ``devprof``, and the networked
half: the ``ship`` uplink, the ``collector`` and the ``watch``
dashboard (all imported on demand, as the reference imports them). The
same event names, fields and environment variables as the reference, so
either package's folds read the other's streams. A no-op unless
``CAUSE_TPU_OBS=1`` (or ``configure(enabled=True)``). See ``core.py``'s
module docstring for the full contract and
``python -m cause_tpu_torch.obs --help`` for the trace converter.
"""

from .core import (
    configure,
    counter,
    counters_snapshot,
    enabled,
    event,
    events,
    export_jsonl,
    flush,
    gauge,
    platform_of,
    reset,
    set_platform,
    span,
    subscribe,
    unsubscribe,
)
from .perfetto import export_perfetto, load_jsonl, to_chrome_trace
from . import costmodel
from . import journey
from . import lag
from . import live
from . import semantic
from . import xtrace

__all__ = [
    "configure",
    "costmodel",
    "counter",
    "counters_snapshot",
    "enabled",
    "event",
    "events",
    "export_jsonl",
    "export_perfetto",
    "flush",
    "gauge",
    "journey",
    "lag",
    "live",
    "load_jsonl",
    "platform_of",
    "reset",
    "semantic",
    "set_platform",
    "span",
    "subscribe",
    "to_chrome_trace",
    "unsubscribe",
    "xtrace",
]
