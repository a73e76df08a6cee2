"""The partition-tolerant network transport: long-lived replication
sessions connecting remote producers to a ``SyncService`` across real
sockets, designed partition-first — SafarDB's split (arXiv:2603.08003:
the host owns admission and ordering, the accelerator owns merge) with
the ingest ordering pushed into the network layer (arXiv:1605.05619).
A copy of ``cause_tpu.net`` without its telemetry (the ``net.*``
events and trace contexts come back with the telemetry port); frames
are byte-identical to the reference's obs-off frames, so a port client
talks to a reference server and the reverse.

- :mod:`.transport` — framed endpoints over the ``sync.send_frame`` CRC
  framing: unbuffered :class:`FrameStream` with read deadlines,
  seeded-jitter exponential :class:`Backoff`, :func:`dial` with the
  partition chaos hook, and the wire-level fault seam (latency / reset
  / blackhole / dup) applied at the send side, post-CRC;
- :mod:`.session` — :class:`NetClient`: bounded outbound queues,
  reconnect/backoff, heartbeats, NACK backpressure honored, and
  resumable per-(tenant, site) lamport watermarks negotiated at every
  (re)connect, so a healed partition ships exactly the missed suffix;
- :mod:`.server` — :class:`ReplicationServer`: the acceptor that turns
  inbound frames into ``Admission.offer`` calls, NACKs sheds with their
  ``retry_after_ms`` hints, suppresses idempotent re-delivery through
  the journal-seeded watermark, detects and re-acks wire-duplicate
  frames, and rejects out-of-order or tampered frames into the
  offender/quarantine ladder.

Host work by design: nothing here imports torch, and a server's
connection threads never touch the device.
"""

from .transport import Backoff, FrameStream, dial, loopback_pair
from .session import NetClient
from .server import ReplicationServer

__all__ = [
    "Backoff",
    "FrameStream",
    "NetClient",
    "ReplicationServer",
    "dial",
    "loopback_pair",
]
