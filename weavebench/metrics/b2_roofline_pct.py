"""B2's share of its roofline, in %: the contract bytes a wave of its
calls (``kernel.b2`` spans: every input and output tensor once) at
the card's bandwidth, over the device time a wave of its library's
kernels in the traced segment."""

from ._spans import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b2")
