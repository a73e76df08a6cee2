"""Share of the traced segment in which no kernel or copy runs on the
device, in %."""

from ..trace import busy_us


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 100.0 * (1.0 - busy_us(tr) / (tr["t1"] - tr["t0"]))
