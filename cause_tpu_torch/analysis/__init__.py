"""causelint — trace-identity and jit-purity static analysis.

The framework's correctness leans on conventions nothing used to
enforce mechanically: trace-time switches are *imported, never
restated* and appear in every program-cache key; obs-off code paths
read zero TRACE_SWITCHES env vars; jit-reachable code is free of host
effects; lane-cache arena views are never mutated in place outside
their owner. This package turns them into rules that gate a change.
The catalog also covers the concurrent host substrate: lock discipline
(LCK — guarded-by inference, lock-order cycles, blocking under a lock,
commit-step reentrancy), durable commit protocol (DUR —
fsync-before-rename, dir-fsync, journal-before-ack, crash seams under
locks) and the refusal-evidence contract (EVD). See ``rules`` for the
TID/JPH/OBS/LCA catalog and the parameterized guard-rule table,
``concurrency``/``protocol`` for the LCK/DUR/EVD families,
``callgraph`` for the jit-reachability machinery, ``switches`` for the
registry of ``CAUSE_TPU_*`` variables the TID rules read, and
``__main__`` for the CLI (``python -m cause_tpu_torch.analysis``, with
``--cache``/``--changed`` incremental modes).

The reachability seeds are the JAX wrappers (``jax.jit``, ``vmap``,
``shard_map``, ``pallas_call``). The port traces no program, so over
its own tree the rules that read traced paths (JPH, TID001's traced
reads, OBS002-007, XTR, CHS, SRV, NET, DSK, SHP) find nothing; the
shared fixtures keep them exercised. The LCK, DUR, EVD, LCA, OBS001
and TID002 rules read every module.

Deliberately dependency-light: stdlib ``ast`` plus the import-free
``switches`` registry — no torch, no numpy, so the lint runs before
anything is installed.
"""

from .core import (AnalysisResult, Finding, cached_run, changed_files,
                   list_rules, run)
from .report import load_baseline, to_json, write_baseline

__all__ = [
    "AnalysisResult",
    "Finding",
    "cached_run",
    "changed_files",
    "list_rules",
    "load_baseline",
    "run",
    "to_json",
    "write_baseline",
]
