"""Phase F of the v5 kernel: the device ms a wave of its ``v5.F``
spans, from the stream reaching the phase's first work to it finishing
its last (CUDA events). In a host-paced cell that includes the device
waiting on the phase's launches."""

from ._spans import device_ms


def read(ctx):
    return device_ms(ctx, "v5.F")
