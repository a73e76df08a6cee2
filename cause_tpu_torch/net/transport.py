"""Framed socket endpoints for the replication transport (a copy of
``cause_tpu.net.transport``).

The frame protocol already "runs over sockets, pipes, files"
(``sync``'s length-prefixed JSON frames with CRC-tagged node
payloads); this module supplies the missing transport half — the
pieces a LONG-LIVED cross-host connection needs that a one-shot
``sync_stream`` round does not:

- :class:`FrameStream` — an UNBUFFERED duplex adapter over a connected
  socket, exposing exactly the ``read/write/flush`` surface
  ``sync.send_frame``/``recv_frame`` consume plus ``settimeout`` (the
  read-deadline hook ``sync._arm_deadline`` duck-types against).
  Unbuffered on purpose: a buffered ``makefile()`` reader can pull
  bytes of the NEXT frame into its private buffer, which breaks any
  fd-level deadline machinery; one ``recv`` per read keeps the kernel
  buffer the single source of truth;
- :func:`send_msg` / :func:`recv_msg` — one frame each way with the
  wire-level chaos seam applied at the send side (injected latency,
  connection reset, blackhole, frame duplication — exactly where a
  real link misbehaves, after the CRC was computed over the true
  payload) and read deadlines mapped to the protocol's uniform
  ``read-timeout`` CausalError;
- :class:`Backoff` — seeded-jitter exponential reconnect backoff: the
  delay ladder doubles to a cap and each step is jittered by a
  ``random.Random(seed)`` stream, so (seed → identical backoff
  schedule) holds for the chaos soak's repro contract while a real
  fleet's reconnect storms still decorrelate;
- :func:`dial` — connect with the ``partition`` chaos hook at the one
  place a partition manifests (the connect attempt), mapping every
  refused/unreachable outcome to a uniform ``net-unreachable``
  CausalError the caller's backoff ladder owns.

Stdlib + this package's ``sync``/``chaos`` only — the transport is host
work by design and imports nothing of torch.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Optional, Tuple

from .. import chaos as _chaos
from .. import sync
from ..collections import shared as s

__all__ = [
    "FrameStream",
    "Backoff",
    "dial",
    "send_msg",
    "recv_msg",
    "loopback_pair",
]

# transport defaults: a silent peer is declared dead after the read
# deadline; a connection with no frames at all for the idle deadline
# is closed server-side (heartbeats keep a healthy-but-quiet client
# alive well inside it)
DEFAULT_READ_TIMEOUT_S = 10.0
DEFAULT_IDLE_TIMEOUT_S = 30.0
DEFAULT_CONNECT_TIMEOUT_S = 5.0


class FrameStream:
    """Unbuffered duplex stream over a connected socket (see module
    docstring). ``site`` names the chaos injection site for frames
    sent THROUGH this stream (``<site>.send``)."""

    __slots__ = ("sock", "site", "closed")

    def __init__(self, sock: socket.socket, site: str = "net"):
        self.sock = sock
        self.site = str(site)
        self.closed = False

    def settimeout(self, timeout_s: Optional[float]) -> None:
        if not self.closed:
            self.sock.settimeout(timeout_s)

    def read(self, n: int) -> bytes:
        """At most one ``recv`` (short reads are the caller's loop —
        ``sync._read_exact`` accumulates). A reset/closed connection
        reads as EOF (empty bytes): the protocol layer's uniform
        ``eof`` reject is the right shape for a dead peer. A deadline
        expiry propagates as ``TimeoutError`` for ``sync`` to map."""
        if self.closed:
            return b""
        try:
            return self.sock.recv(n)
        except TimeoutError:
            raise
        except OSError:
            return b""

    def write(self, data: bytes) -> int:
        self.sock.sendall(data)
        return len(data)

    def flush(self) -> None:  # the socket has no userspace buffer
        pass

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        try:
            self.sock.close()
        except OSError:  # pragma: no cover - close is best-effort
            pass


class Backoff:
    """Seeded-jitter exponential backoff: attempt ``k`` waits
    ``min(cap, base * 2^k)`` scaled into ``[1/2, 1)`` by the seeded
    jitter stream. ``reset()`` (on a successful connect) rewinds the
    exponent but NOT the jitter stream — the schedule stays a pure
    function of (seed, sequence of next()/reset() calls), which is the
    determinism the chaos soak replays."""

    __slots__ = ("base_ms", "cap_ms", "attempt", "rng")

    def __init__(self, base_ms: float = 50.0, cap_ms: float = 5000.0,
                 seed: int = 0):
        self.base_ms = float(base_ms)
        self.cap_ms = float(cap_ms)
        self.attempt = 0
        self.rng = random.Random(int(seed) * 1_000_003 + 0x5EED)

    def next_ms(self) -> float:
        """The next delay in milliseconds; advances the ladder."""
        raw = min(self.cap_ms, self.base_ms * (2.0 ** self.attempt))
        self.attempt += 1
        return raw * (0.5 + 0.5 * self.rng.random())

    def reset(self) -> None:
        self.attempt = 0


def dial(host: str, port: int, site: str = "net.client",
         connect_timeout_s: float = DEFAULT_CONNECT_TIMEOUT_S,
         read_timeout_s: float = DEFAULT_READ_TIMEOUT_S) -> FrameStream:
    """Connect to a replication endpoint. The ``partition`` chaos mode
    fires here — one invocation per attempt, so a plan's ``at``
    schedule refuses exactly the attempts it names — and every
    refused/unreachable/timed-out outcome maps to one uniform
    ``net-unreachable`` CausalError (the caller's backoff ladder does
    not care which errno a partition wears)."""
    if _chaos.enabled() and _chaos.net_partition(site):
        raise s.CausalError(
            "net: connection refused (injected partition)",
            {"causes": {"net-unreachable"}, "site": site,
             "injected": True},
        )
    try:
        sock = socket.create_connection((host, int(port)),
                                        timeout=connect_timeout_s)
    except OSError as e:
        raise s.CausalError(
            "net: peer unreachable",
            {"causes": {"net-unreachable"}, "site": site,
             "errno": getattr(e, "errno", None)},
        ) from None
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:  # pragma: no cover - best-effort (AF_UNIX etc.)
        pass
    sock.settimeout(read_timeout_s)
    return FrameStream(sock, site=site)


def send_msg(fs: FrameStream, obj: dict) -> bool:
    """Send one frame through the wire-level chaos seam. Returns
    whether the frame actually went out (False only for an injected
    blackhole — the caller behaves as if it sent; the missing reply is
    the peer's read deadline's problem, exactly like a real silently
    -dropped packet). An injected reset closes the stream and raises
    the uniform ``net-reset`` CausalError; a real dead peer raises it
    too (one reconnect path for both)."""
    if _chaos.enabled():
        lat_ms = _chaos.net_latency_ms(fs.site)
        if lat_ms:
            time.sleep(lat_ms / 1000.0)
        if _chaos.net_reset(fs.site):
            fs.close()
            raise s.CausalError(
                "net: connection reset (injected)",
                {"causes": {"net-reset"}, "site": fs.site,
                 "injected": True},
            )
        if _chaos.net_blackhole(fs.site):
            return False
        # dup injection targets SEQUENCED frames only: the receiver's
        # duplicate evidence is seq-based, so duplicating a seq-less
        # hello/bye would be an injected-but-uncountable fault (and
        # reconnect hellos would shift the dup schedule under crash
        # timing) — the exact-evidence contract stays exact
        dup = "seq" in obj and _chaos.net_dup(fs.site)
    else:
        dup = False
    try:
        sync.send_frame(fs, obj)
        if dup:
            sync.send_frame(fs, obj)
    except OSError as e:
        fs.close()
        raise s.CausalError(
            "net: connection reset",
            {"causes": {"net-reset"}, "site": fs.site,
             "errno": getattr(e, "errno", None)},
        ) from None
    return True


def recv_msg(fs: FrameStream,
             timeout_s: Optional[float] = None) -> dict:
    """Receive one frame under the read deadline (``sync.recv_frame``
    does the deadline arming and the TimeoutError → ``read-timeout``
    mapping)."""
    return sync.recv_frame(fs, timeout_s=timeout_s)


def loopback_pair(site_a: str = "net.a",
                  site_b: str = "net.b") -> Tuple[FrameStream,
                                                  FrameStream]:
    """A connected FrameStream pair over ``socketpair`` (tests and the
    single-process soak's in-memory endpoints)."""
    sa, sb = socket.socketpair()
    return FrameStream(sa, site=site_a), FrameStream(sb, site=site_b)
