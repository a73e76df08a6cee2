"""What the readers of the program's own spans share; no metric (it has
no ``read``).

While the profiler of a ``--trace 1`` run records, the program's spans
are live (``cause_tpu_torch.obs``: a recording profiler turns them on)
and their records, marked ``profiled``, stay in the obs ring: ``v5``
once a wave, its phases ``v5.A`` ... ``v5.F``, ``v5.sync`` around each
host read of a device value, ``kernel.b1`` ... ``kernel.b3`` around
each call of the port's B1-B3 with the call's contract ``bytes``, and
``replica.digest``. A span on the card carries ``dev_us``, its length
on the device's timeline (CUDA events). "A wave" is one ``v5`` span.
A program that records none of them leaves the readers nothing: each
returns None. A test passes canned records as ``ctx["spans"]``.
"""

from __future__ import annotations

import functools
import re

from .. import cells
from ..trace import _GLOBAL, clipped, is_port_kernel

# the kernel library of each of B1-B3 (``kernels.SOURCES``' keys)
LIBRARIES = {"b1": "sort", "b2": "euler_walk", "b3": "fphase"}

_INCLUDE = re.compile(r'#include\s+"([^"]+)"')


def records(ctx) -> list:
    """The program's span records made while the profiler recorded."""
    if "spans" in ctx:
        return ctx["spans"]
    try:
        from cause_tpu_torch import obs

        evs = obs.events()
    except (ImportError, AttributeError):
        return []
    return [e for e in evs if e.get("ev") == "span" and e.get("profiled")]


def waves(recs) -> int:
    return sum(1 for r in recs if r.get("name") == "v5")


def device_ms(ctx, name: str):
    """The ``dev_us`` of the ``name`` spans a wave, in ms."""
    recs = records(ctx)
    n = waves(recs)
    dev = [r["dev_us"] for r in recs
           if r.get("name") == name and "dev_us" in r]
    return sum(dev) * 1e-3 / n if n and dev else None


def host_waits(ctx):
    """The ``v5.sync`` spans a wave, and their host ms a wave."""
    recs = records(ctx)
    n = waves(recs)
    if not n:
        return None
    syncs = [r for r in recs if r.get("name") == "v5.sync"]
    ns = sum(r["end_ns"] - r["ts_ns"] for r in syncs)
    return len(syncs) / n, ns * 1e-6 / n


@functools.lru_cache(maxsize=None)
def library_kernels(lib: str) -> frozenset:
    """The ``__global__`` names of the ``csrc/`` files that the kernel
    library ``lib`` compiles: its source and the headers it includes,
    followed through."""
    from cause_tpu_torch import kernels

    csrc = cells.ROOT / "cause_tpu_torch" / "csrc"
    todo, seen, names = [kernels.SOURCES[lib]], set(), set()
    while todo:
        f = todo.pop()
        if f in seen or not (csrc / f).exists():
            continue
        seen.add(f)
        text = (csrc / f).read_text()
        names.update(_GLOBAL.findall(text))
        todo += _INCLUDE.findall(text)
    return frozenset(names)


def roofline_pct(ctx, which: str):
    """Kernel ``which``'s share of its roofline: the contract bytes of
    its calls a wave at the card's bandwidth, over the device time a
    wave of its library's kernels in the traced segment, in %."""
    tr, bw = ctx["trace"], ctx["peak_bytes_per_s"]
    if tr is None or not bw:
        return None
    recs = records(ctx)
    n = waves(recs)
    got = [r["attrs"]["bytes"] for r in recs
           if r.get("name") == f"kernel.{which}"
           and "bytes" in r.get("attrs", {})]
    if not n or not got:
        return None
    names = library_kernels(LIBRARIES[which])
    us = sum(e - s for name, k, s, e in clipped(tr)
             if k == "kernel" and is_port_kernel(name, names))
    if not us:
        return None
    return 100.0 * (sum(got) / n / bw) / (us * 1e-6 / tr["waves"])
