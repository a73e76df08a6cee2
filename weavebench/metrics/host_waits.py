"""The host's waits for the card a wave: ``v5.sync`` spans, each a host
read of a device value on the wave's path (phase D's walk tests), over
``v5`` spans."""

from ._spans import host_waits


def read(ctx):
    got = host_waits(ctx)
    return None if got is None else got[0]
