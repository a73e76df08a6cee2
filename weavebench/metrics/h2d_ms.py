"""Device time a wave of host-to-device copies (the profiler's Memcpy
HtoD activities), in ms."""

from ..trace import clipped


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    us = sum(e - s for _n, k, s, e in clipped(tr) if k == "htod")
    return us * 1e-3 / tr["waves"]
