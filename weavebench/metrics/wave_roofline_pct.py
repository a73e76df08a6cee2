"""A wave's least time, its bytes (``wave_bytes``: what it must move
whatever implements it) at the card's published memory bandwidth, over
its time in the traced segment (the segment's length over its waves),
in %."""


def read(ctx):
    tr, bw = ctx["trace"], ctx["peak_bytes_per_s"]
    if tr is None or not bw:
        return None
    wave_s = (tr["t1"] - tr["t0"]) * 1e-6 / tr["waves"]
    return 100.0 * (ctx["wave_bytes"] / bw) / wave_s
