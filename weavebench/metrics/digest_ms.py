"""The digest of a wave's weaves (``mesh.replica_digest``): the device
ms a wave of its ``replica.digest`` spans (CUDA events)."""

from ._spans import device_ms


def read(ctx):
    return device_ms(ctx, "replica.digest")
