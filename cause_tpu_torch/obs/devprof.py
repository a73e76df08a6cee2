"""Device telemetry on the card: the kernel library's build, the first
dispatch of each program identity, device-memory gauges.

The counterpart of ``cause_tpu.obs.devprof``. The JAX package prices
each compiled XLA program (``cost_analysis``/``memory_analysis``) at
its program-cache miss. The port compiles no programs: its device work
is PyTorch ops plus six hand-written CUDA kernels built once per
process from ``csrc/``. So its counterparts are:

- ``devprof.compile`` — the span around the first build or load of the
  kernel library (``kernels.library``: ``build_all`` + ``load``);
- ``devprof.program`` — one event per dispatch identity (pipeline,
  ``B``, ``N``, ``u_max``/``k_max``, ``BENCH_KERNEL`` and the library
  hash), emitted by :func:`profiled` around that identity's FIRST
  dispatch. It carries the dispatch's kernel launches by kernel (the
  change in ``kernels.launches``, whose total is its deterministic
  ``cost``) and, on the card, the CUDA caching allocator's statistics
  after it: bytes allocated and reserved, and the allocator's peak
  (``max_memory_allocated``, the process's high-water mark as of that
  dispatch's end; the caller's peak counters are never reset to
  narrow it). Fields the card cannot give (XLA's flops, bytes
  accessed, code size) are absent, not 0;
- ``sample_device_memory(site, device)`` — ``memory_allocated``,
  ``memory_reserved`` and the allocator's count of live blocks (the
  counterpart of ``jax.live_arrays``) as gauges, at wave boundaries;
- ``arena_footprint(arena, site)`` — host-side lane-arena bytes
  (copied).

None of it synchronizes the device: launch counts are host counters and
the allocator's statistics are host bookkeeping. On CPU tensors nothing
touches CUDA (no context is opened): :func:`profiled` records launches
only (none run there) and :func:`sample_device_memory` records
nothing. Device arguments follow the package rule: ``"cuda"`` by
default, raising without a card unless the caller asks for the CPU.

With ``CAUSE_TPU_OBS`` unset every entry point returns at once and
nothing is read or recorded; call sites sit behind ``obs.enabled()``.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Dict, Tuple

from . import core

__all__ = [
    "enabled",
    "reset",
    "profiled",
    "sample_device_memory",
    "arena_footprint",
]

_LOCK = threading.Lock()
# dispatch identities whose devprof.program event has been emitted
_SEEN: Dict[Tuple, bool] = {}
_SEEN_MAX = 4096


def enabled() -> bool:
    """Whether devprof records anything (== ``obs.enabled()``)."""
    return core.enabled()


def reset() -> None:
    """Forget which identities were seen (tests)."""
    with _LOCK:
        _SEEN.clear()


def _device(device):
    from ..device import resolve_device

    return resolve_device("cuda" if device is None else device)


def _allocator_stats(dev) -> dict:
    """The CUDA caching allocator's bookkeeping for ``dev`` (host
    reads, no synchronization)."""
    import torch

    stats = torch.cuda.memory_stats(dev)
    return {
        "device_bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "device_bytes_reserved": int(torch.cuda.memory_reserved(dev)),
        "live_blocks": int(stats.get("active.all.current", 0)),
    }


def profiled(fn: Callable, device="cuda", **identity) -> Callable:
    """``fn`` (one dispatch) wrapped so that the FIRST call of this
    dispatch identity emits its ``devprof.program`` event. The identity
    is ``identity``'s fields except ``site`` (pipeline, B, N, u_max,
    k_max) plus ``BENCH_KERNEL`` and the kernel library's hash; later
    calls of a seen identity run ``fn`` untouched. Returns ``fn``
    itself when obs is off."""
    if not core.enabled():
        return fn
    from .. import kernels

    dev = _device(device)
    bench = os.environ.get("BENCH_KERNEL", "").strip()
    library = kernels.source_hash()
    key = tuple(sorted((k, v) for k, v in identity.items()
                       if k != "site")) + (("bench_kernel", bench),
                                           ("library", library))
    with _LOCK:
        if key in _SEEN:
            return fn
        _SEEN[key] = True
        while len(_SEEN) > _SEEN_MAX:
            _SEEN.pop(next(iter(_SEEN)))

    def first(*args, **kwargs):
        before = dict(kernels.launches)
        out = fn(*args, **kwargs)
        launched = {k: v - before.get(k, 0)
                    for k, v in kernels.launches.items()
                    if v != before.get(k, 0)}
        fields = dict(identity)
        fields.update(bench_kernel=bench, library=library,
                      launches=launched,
                      cost={"launches": sum(launched.values())})
        if dev.type == "cuda":
            import torch

            mem = _allocator_stats(dev)
            mem["device_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(dev))
            fields["memory"] = mem
            core.gauge("devprof.program.peak_bytes").set(
                mem["device_peak_bytes"])
        core.event("devprof.program", **fields)
        return out

    return first


def sample_device_memory(site: str, device="cuda") -> dict:
    """Gauge the caching allocator's state on ``device``: bytes
    allocated and reserved, and its count of live blocks. ``site``
    names the boundary sampled (``wave``, ``session`` ...) so each
    renders as its own Perfetto counter track. A CPU device records
    nothing (no CUDA context is opened)."""
    if not core.enabled():
        return {}
    dev = _device(device)
    if dev.type != "cuda":
        return {}
    out = _allocator_stats(dev)
    for k, v in out.items():
        core.gauge(f"devprof.{k}.{site}").set(v)
    return out


def arena_footprint(arena, site: str = "lanecache") -> dict:
    """Gauge one lane arena's host-side footprint (the numpy columns
    the wave marshal reuses across versions). Cheap: ``nbytes`` sums
    over the already-allocated columns, no copies."""
    if not core.enabled():
        return {}
    try:
        cols = ("ts", "site", "tx", "cause_idx", "vclass",
                "cause_hi", "cause_lo")
        nbytes = sum(
            int(getattr(getattr(arena, c), "nbytes", 0) or 0)
            for c in cols
        )
        out = {"arena_bytes": nbytes,
               "arena_lanes": int(arena.committed_n)}
    except Exception:  # noqa: BLE001 - telemetry must never raise
        return {}
    for k, v in out.items():
        core.gauge(f"devprof.{k}.{site}").set(v)
    return out
