"""Obs-off byte-identity pin for the port's wire and journal formats. A
port of ``scripts/obs_off_pin.py``.

    python -m cause_tpu_torch.obs_off_pin --check [PIN]
    python -m cause_tpu_torch.obs_off_pin --out capture.json

The distributed-tracing layer adds trace context to net frames and
journal records, but ONLY when obs is enabled. The standing obs-off
invariance contract says a disabled process's bytes are untouchable —
and the wire format is the riskiest seam, so this module pins it
machine-to-machine:

- **wire**: a real ``NetClient`` talks to a real ``ReplicationServer``
  through a byte-recording loopback proxy with obs OFF; both
  directions' raw frame bytes (hello/welcome, delta/ack, ping/pong,
  delta/nack, bye) are captured end-to-end — every byte the endpoints
  actually construct, not a re-serialization;
- **journal**: fixed batches appended to an ``IngestJournal`` file and
  a ``WriteAheadLog`` segment with pinned timestamps; the on-disk
  bytes are captured verbatim.

``--out`` writes the capture JSON; ``--check`` re-runs the identical
scenario against the current code and exits non-zero on the first
differing byte. Without a path, ``--check`` reads the committed capture
``measurements/obs_off_pin_r19.json`` of the repo's root (the
reference's, made before its tracing layer existed), so ``--check``
passing IS the obs-off invariance evidence for the port.

Host modules only (no torch: the stub service serves admission, never a
wave), so it needs no device and takes no ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import sys
import tempfile
import threading

from . import chaos, obs
from .ids import ROOT_ID as root_id
from .net import NetClient, ReplicationServer
from .serve import IngestJournal, IngestQueue
from .serve.wal import WriteAheadLog

PIN_PATH_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "measurements", "obs_off_pin_r19.json")
_TENANT = "pin-tenant"
_SITE = "s1"


class _StubService:
    """The duck-typed surface ReplicationServer fronts: a queue and a
    tenant registry. No device, no waves — admission is host work."""

    def __init__(self):
        self.queue = IngestQueue(max_ops=64, defer_frac=1.0)
        self.tenants = {_TENANT: {"applied_seq": 0}}


class _RecordingProxy:
    """A loopback TCP proxy that records both directions' raw bytes —
    the capture sees exactly what the endpoints put on the wire."""

    def __init__(self, upstream_port: int):
        self.c2s = bytearray()
        self.s2c = bytearray()
        self._up_port = upstream_port
        self._lsock = socket.create_server(("127.0.0.1", 0))
        self._lsock.settimeout(10.0)
        self.port = self._lsock.getsockname()[1]
        self._threads = []
        self._accept = threading.Thread(target=self._run, daemon=True)
        self._accept.start()

    def _run(self):
        try:
            conn, _ = self._lsock.accept()
        except OSError:
            return
        up = socket.create_connection(("127.0.0.1", self._up_port))
        for src, dst, buf in ((conn, up, self.c2s),
                              (up, conn, self.s2c)):
            t = threading.Thread(target=self._shuttle,
                                 args=(src, dst, buf), daemon=True)
            t.start()
            self._threads.append(t)

    @staticmethod
    def _shuttle(src, dst, buf):
        try:
            while True:
                chunk = src.recv(65536)
                if not chunk:
                    break
                buf.extend(chunk)
                dst.sendall(chunk)
        except OSError:
            pass
        try:
            dst.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def close(self):
        try:
            self._lsock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=5.0)


def capture_wire() -> dict:
    """One scripted client/server session with obs OFF, byte-recorded:
    hello/welcome, a 2-op delta/ack, ping/pong, an unknown-tenant
    delta/nack, bye. Every input is pinned (fixed tenant/site/node
    ids), so the bytes are deterministic run to run."""
    assert not obs.enabled(), "the pin is an obs-OFF capture"
    svc = _StubService()
    srv = ReplicationServer(svc).start()
    proxy = _RecordingProxy(srv.port)
    try:
        cl = NetClient("127.0.0.1", proxy.port, [_TENANT],
                       client_id="pin", heartbeat_s=3600.0,
                       read_timeout_s=5.0, connect_timeout_s=5.0)
        cl.pump()  # connect: hello -> welcome
        assert cl.connected, "pin client failed to connect"
        ops = [((1001, _SITE, 0), root_id, "a"),
               ((1002, _SITE, 0), (1001, _SITE, 0), "b")]
        assert cl.queue_ops(_TENANT, _SITE, ops)
        cl.pump()  # delta -> ack
        assert cl.stats["acked_ops"] == 2, cl.stats
        cl._heartbeat()  # ping -> pong (deterministic seq)
        assert cl.queue_ops("nope", _SITE,
                            [((2001, _SITE, 0), root_id, "x")])
        cl.pump()  # delta -> nack (unknown-tenant)
        assert cl.stats["nacks"].get("unknown-tenant") == 1, cl.stats
        cl.close()  # bye
    finally:
        proxy.close()
        srv.stop()
    return {"c2s": bytes(proxy.c2s).hex(),
            "s2c": bytes(proxy.s2c).hex()}


_JOURNAL_BATCHES = [
    (_TENANT, _SITE,
     [[[1001, _SITE, 0], ["r", "", 0], "a"],
      [[1002, _SITE, 0], [1001, _SITE, 0], "b"]],
     1_700_000_000_000_000),
    (_TENANT, "s2",
     [[[1003, "s2", 0], ["r", "", 0], "c"]],
     1_700_000_000_500_000),
]


def capture_journal() -> dict:
    """Fixed batches with pinned timestamps appended to both journal
    implementations, on-disk bytes captured verbatim."""
    assert not obs.enabled()
    tmp = tempfile.mkdtemp(prefix="obs_off_pin_")
    try:
        jp = os.path.join(tmp, "ingest.jsonl")
        jr = IngestJournal(jp)
        for uuid, site, items, ts in _JOURNAL_BATCHES:
            jr.append(uuid, site, items, ts_us=ts)
        jr.close()
        with open(jp, "rb") as f:
            journal_bytes = f.read()
        wd = os.path.join(tmp, "wal")
        os.makedirs(wd)
        wal = WriteAheadLog(wd)
        for uuid, site, items, ts in _JOURNAL_BATCHES:
            wal.append(uuid, site, items, ts_us=ts)
        wal.close()
        seg = os.path.join(wd, "wal-00000001.seg")
        with open(seg, "rb") as f:
            wal_bytes = f.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"ingest_journal": journal_bytes.hex(),
            "wal_segment": wal_bytes.hex()}


def capture() -> dict:
    obs.configure(enabled=False, reset=True)
    obs.configure(enabled=False)
    chaos.reset()
    return {"pin": "obs-off byte identity",
            "wire": capture_wire(), "journal": capture_journal()}


def check(pin_path: str) -> int:
    with open(pin_path) as f:
        want = json.load(f)
    got = capture()
    fails = []
    for section in ("wire", "journal"):
        for key, w in want[section].items():
            g = got[section].get(key)
            if g != w:
                fails.append(f"{section}.{key}: "
                             f"{len(w) // 2}B pinned != "
                             f"{(len(g) or 0) // 2}B current")
    if fails:
        print("obs-off pin: BYTES CHANGED — " + "; ".join(fails))
        for section in ("wire", "journal"):
            for key, w in want[section].items():
                g = got[section].get(key) or ""
                if g != w:
                    wb, gb = bytes.fromhex(w), bytes.fromhex(g)
                    i = next((k for k in range(min(len(wb), len(gb)))
                              if wb[k] != gb[k]),
                             min(len(wb), len(gb)))
                    print(f"  {section}.{key} first diff at byte {i}:")
                    print(f"    pinned : ...{wb[max(0, i - 20):i + 40]!r}")
                    print(f"    current: ...{gb[max(0, i - 20):i + 40]!r}")
        return 1
    print("obs-off pin: clean — wire frames and journal bytes "
          "byte-identical to the pinned capture")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="obs-off byte-identity pin of the wire and journal")
    ap.add_argument("--out", default=None,
                    help="write a fresh capture to this path")
    ap.add_argument("--check", default=None, nargs="?",
                    const=PIN_PATH_DEFAULT,
                    help="re-capture and compare against a pinned "
                         "capture (default: the repo's "
                         "measurements/obs_off_pin_r19.json)")
    a = ap.parse_args(argv)
    if a.out:
        cap = capture()
        with open(a.out, "w") as f:
            json.dump(cap, f, indent=1)
        print(f"obs-off pin: capture written to {a.out}")
        return 0
    if a.check:
        return check(a.check)
    ap.error("need --out or --check")
    return 2


if __name__ == "__main__":
    sys.exit(main())
