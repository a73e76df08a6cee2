"""A1's share of its roofline, in %: the contract bytes a wave of its
calls (``kernel.a1`` spans: every ``[B, S]`` input and output once and
the four lanes a segment reads) at the card's bandwidth, over the device
time a wave of its library's kernels (``kernels.SOURCES["seg_order"]``)
in the traced segment. A program without A1 records no such span: the
reader returns None."""

from ..trace import clipped, is_port_kernel
from ._spans import library_kernels, records, waves


def read(ctx):
    tr, bw = ctx["trace"], ctx["peak_bytes_per_s"]
    if tr is None or not bw:
        return None
    recs = records(ctx)
    n = waves(recs)
    got = [r["attrs"]["bytes"] for r in recs
           if r.get("name") == "kernel.a1" and "bytes" in r.get("attrs", {})]
    if not n or not got:
        return None
    names = library_kernels("seg_order")
    us = sum(e - s for name, k, s, e in clipped(tr)
             if k == "kernel" and is_port_kernel(name, names))
    if not us:
        return None
    return 100.0 * (sum(got) / n / bw) / (us * 1e-6 / tr["waves"])
