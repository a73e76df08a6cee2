"""The traced segment of a ``--trace 1`` run, as plain data.

``torch.profiler`` records a bounded number of steady waves of the
window (the mix's ``trace_waves``) with the device's activity and the
host's operations; the benchmark's own host spans (``weavebench.*``)
are ``record_function`` ranges in the same trace. ``summarize`` turns
the profiler's events into a dict of tuples that the per-layer readers
(``metrics/``) and ``breakdown`` read:

- ``device``: ``(name, kind, start_us, end_us)`` of each device
  activity, ``kind`` one of ``kernel``, ``htod``, ``dtoh``, ``memcpy``,
  ``memset``;
- ``spans``: ``(name, start_us, end_us)`` of the benchmark's spans;
- ``ops``: ``(name, start_us, end_us)`` of the host's other operations
  (PyTorch ops and CUDA runtime calls);
- ``t0``, ``t1``: the traced segment (the ``weavebench.traced`` span);
- ``waves``: the waves it holds.
"""

from __future__ import annotations

import re
from pathlib import Path

SEGMENT = "weavebench.traced"


def kind_of(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "htod"
    if name.startswith("Memcpy DtoH"):
        return "dtoh"
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def summarize(events, waves: int) -> dict:
    """The summary of a profiler's ``events()`` over ``waves`` waves."""
    from torch.autograd import DeviceType

    device, spans, ops = [], [], []
    t0 = t1 = None
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA and (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith("weavebench.")):
            continue  # a host span's shadow on the device's timeline
        if e.device_type == DeviceType.CUDA:
            device.append((e.name, kind_of(e.name), tr.start, tr.end))
        elif e.name == SEGMENT:
            t0, t1 = tr.start, tr.end
        elif e.name.startswith("weavebench."):
            spans.append((e.name, tr.start, tr.end))
        else:
            ops.append((e.name, tr.start, tr.end))
    if t0 is None:
        raise RuntimeError("the trace holds no traced segment")
    return {"device": device, "spans": spans, "ops": ops, "t0": t0,
            "t1": t1, "waves": waves}


def clipped(summary: dict):
    """The device activities inside the segment: ``(name, kind,
    start_us, end_us)``, cut to it."""
    t0, t1 = summary["t0"], summary["t1"]
    return [(n, k, max(s, t0), min(e, t1)) for n, k, s, e in
            summary["device"] if e > t0 and s < t1]


def intervals(summary: dict):
    """The device's busy intervals inside the segment, merged and
    sorted."""
    iv = sorted((s, e) for _n, _k, s, e in clipped(summary))
    merged = []
    for s, e in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(summary: dict) -> float:
    return float(sum(e - s for s, e in intervals(summary)))


def gaps(summary: dict):
    """The device's idle gaps inside the segment: ``(start, end)``."""
    out, at = [], summary["t0"]
    for s, e in intervals(summary):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if summary["t1"] > at:
        out.append((at, summary["t1"]))
    return out


def _innermost(items, t):
    """The name of the latest-starting item of ``items`` that holds
    ``t``, or None."""
    best = None
    for name, s, e in items:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return None if best is None else best[0]


def gap_name(summary: dict, t: float) -> str:
    """What the host was doing at ``t``: the benchmark span, and the
    innermost host operation inside it."""
    span = _innermost(summary["spans"], t) or "weavebench.loop"
    op = _innermost(summary["ops"], t)
    return f"{span}/{op}" if op else span


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time in the segment, and
    the longest idle gaps by what the host was doing at their middle,
    in seconds."""
    by_name: dict = {}
    for name, _k, s, e in clipped(summary):
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(summary), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[gap_name(summary, (s + e) / 2), (e - s) * 1e-6]
                          for s, e in idle]}


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def port_kernel_names(csrc: Path) -> frozenset:
    """The names of the kernels the port's ``csrc/`` defines."""
    names = set()
    for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_GLOBAL.findall(p.read_text()))
    return frozenset(names)


def is_port_kernel(name: str, names: frozenset) -> bool:
    """Whether a profiler kernel name (demangled, with its template
    arguments and parameters) is one of ``names``."""
    head = name.split("(", 1)[0].split("<", 1)[0].strip()
    head = head.rsplit(" ", 1)[-1].rsplit("::", 1)[-1]
    return head in names
