"""The resilient sync service: the long-lived serving loop, designed
failure-first (SafarDB's offload split, arXiv:2603.08003: the
accelerator owns merge, the host owns admission and ordering of
replicated-data-type ops). The port of ``cause_tpu.serve``.

- :mod:`.ingest` — bounded-queue admission: per-site deltas validated
  at the boundary (``sync.validate_node_items``; poison never enters
  the queue, quarantine semantics preserved), coalesced per tenant,
  journaled WRITE-AHEAD (admitted ops are never lost), with a declared
  three-rung shed ladder (defer cold tenants → reject with retry-after
  → drop the oldest **unadmitted** entry);
- :mod:`.controller` — the adaptive ``T_batch`` controller: the lag
  SLO's cost model solved for ``T_batch``, clamped and
  hysteresis-damped, with the H100's measured dispatch floor;
- :mod:`.residency` — LRU residency for hot documents: cold tenants
  spill to host checkpoint packs and a touch restores GATED on digest
  bit-identity, so a tenant population larger than device memory
  degrades to re-upload cost, never to wrong answers;
- :mod:`.batch` — the batched tick: every touched tenant's delta window
  rides ONE ``batched_delta_weave`` dispatch per pow2 bucket (the B1,
  B2 and B3 kernels on the card);
- :mod:`.service` — the lifecycle: ticks with a watchdog, graceful
  drain (stop admission → flush the queue → checkpoint) and restore
  from a checkpoint that replays the ingest journal above each
  tenant's applied watermark and resumes steady-state delta waves;
- :mod:`.wal` — the segmented write-ahead log with per-record CRC32
  trailers, size/age rotation, an fsync policy (``none``/``batch``/
  ``always``) and crash-safe post-checkpoint GC, drop-in for
  ``IngestJournal``, with the chaos ``disk`` seams;
- :mod:`.scrub` — the offline storage scrubber
  (``python -m cause_tpu_torch.serve scrub``).

The sessions run on the package default device (``use_device``): only
the ticking thread touches CUDA; admission, the journal and the net
server's connection threads stay on the host. With telemetry on, the
plane records what the reference's does (``serve.*`` events, counters,
gauges, traces and the live feed the controller reads); the telemetry
uplink (``CAUSE_TPU_OBS_SHIP``) comes with the networked half of the
telemetry port.

Import discipline: this ``__init__`` and the host-side modules (ingest,
controller, wal, scrub) import nothing of torch themselves; the
device-backed pieces (sessions, residency restores, the batch
scheduler) resolve lazily.
"""

from .ingest import Admission, IngestJournal, IngestQueue
from .controller import BatchController
from .wal import WriteAheadLog, open_journal

__all__ = [
    "Admission",
    "BatchController",
    "BatchScheduler",
    "IngestJournal",
    "IngestQueue",
    "ResidencyManager",
    "ServiceCrashed",
    "SyncService",
    "WriteAheadLog",
    "open_journal",
]


def __getattr__(name):
    # ResidencyManager, BatchScheduler and SyncService resolve lazily,
    # as the reference's do (there it keeps the admission-only import
    # free of JAX). Here it saves nothing: the package facade already
    # loads torch and the session machinery.
    if name in ("ResidencyManager",):
        from .residency import ResidencyManager

        return ResidencyManager
    if name in ("BatchScheduler",):
        from .batch import BatchScheduler

        return BatchScheduler
    if name in ("SyncService", "ServiceCrashed"):
        from . import service as _service

        return getattr(_service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
