"""Device time a wave of the kernels that the port's ``csrc/``
defines, by profiler name, in ms."""

from ..trace import clipped, is_port_kernel


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    us = sum(e - s for name, k, s, e in clipped(tr)
             if k == "kernel" and is_port_kernel(name, ctx["port_kernels"]))
    return us * 1e-3 / tr["waves"]
