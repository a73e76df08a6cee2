"""Host ms a wave inside ``v5.sync`` spans: the launch of each read and
the wait for the work queued before it, over ``v5`` spans."""

from ._spans import host_waits


def read(ctx):
    got = host_waits(ctx)
    return None if got is None else got[1]
