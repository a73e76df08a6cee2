"""``python -m cause_tpu_torch.obs watch`` — the fleet watch dashboard
(a copy of ``cause_tpu.obs.watch``).

The terminal face of ``cause_tpu_torch.obs.live``: tail one or more obs
JSONL sidecars (or read them once), run the incremental fold + alert
rules, and redraw one glanceable block — fleet shape, convergence
staleness, lag percentiles with the SLO verdict and burn rate,
full-bag and fallback rates, waves/sec, dispatch counts, token
-headroom minima, the last run heartbeat, per-event recency, and
every alert the rules fired. Curses-free on purpose: plain ANSI
home-and-clear redraw works over any ssh tunnel, inside tmux, and in
a CI log (where ``--once`` prints the block exactly once).

    python -m cause_tpu_torch.obs watch events.jsonl            # live tail
    python -m cause_tpu_torch.obs watch a.jsonl b.jsonl --once  # one shot
    python -m cause_tpu_torch.obs watch events.jsonl --rules "burn>2" \\
        --rules "absence:run.heartbeat:600"
    python -m cause_tpu_torch.obs watch events.jsonl --serve-port 9464
    python -m cause_tpu_torch.obs watch --collector host:9419   # fleet

``--collector HOST:PORT`` reads the fleet-wide fold from a
running :class:`~cause_tpu_torch.obs.collector.CollectorServer` over its
socket feed instead of tailing local files — every host's serve/net/
lag/journey axes appear WHILE the fleet runs, no file merging. The
snapshot arrives with per-origin (host, pid) rows; the Prometheus
endpoint emits them as labeled serve/net series so multi-origin
scrapes never clobber each other (label cardinality is bounded by the
collector's origin LRU, not by traffic).

``--serve-port`` additionally serves the snapshot as Prometheus text
(``/metrics``, stdlib http.server — no client dependency) and as JSON
(``/``), so a scraper or the serving loop's admission controller reads
the same numbers the dashboard shows. A collector snapshot also carries
the ship plane's accounting (origins, accepted, duplicate-skipped and
missed records, unexplained gaps), which the port exports as the
``cause_tpu_live_ship_*`` family; the reference's text has no such
family, and is otherwise the same. With ``CAUSE_TPU_OBS=1`` the watch
process also emits its periodic ``live.snapshot`` rollups (and any
``live.alert`` firings) into its own obs stream — watching a watcher
works.

Stdlib-only (no numpy, no torch), like every other obs reader.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import Callable, List, Optional

from .live import DEFAULT_RULE_SPECS, LiveMonitor, MultiTailer
from .perfetto import load_streams

__all__ = ["render", "prometheus_text", "serve_metrics", "main"]

_CLEAR = "\x1b[H\x1b[2J"   # home + clear (first frame)
_HOME = "\x1b[H"           # home (subsequent frames)
_EOS = "\x1b[0J"           # clear below the rendered block


def _g(v, none="-"):
    """Compact number formatting with an explicit missing marker."""
    if v is None:
        return none
    if isinstance(v, float):
        return f"{v:g}"
    return str(v)


def render(snap: dict, alerts: List[dict], paths: List[str],
           clock: Optional[float] = None) -> str:
    """The dashboard block (plain text; the live loop wraps it in the
    ANSI redraw, ``--once`` prints it bare)."""
    fleet = snap.get("fleet") or {}
    lag = snap.get("lag") or {}
    conv = lag.get("converged") or {}
    slo = lag.get("slo") or {}
    win = lag.get("window") or {}
    sync = snap.get("sync") or {}
    wave = snap.get("wave") or {}
    cost = snap.get("cost") or {}
    rates = snap.get("rates") or {}
    head = snap.get("headroom") or {}
    ages = snap.get("ages_s") or {}
    when = time.strftime("%H:%M:%S",
                         time.gmtime(clock if clock is not None
                                     else snap.get("ts_us", 0) / 1e6))
    lines = [
        f"live telemetry [{when}] — {len(paths)} stream(s), "
        f"{snap.get('records', 0)} record(s)"
        + (f", span {_g(snap.get('span_s'))} s"
           if snap.get("span_s") is not None else ""),
        f"  fleet: {fleet.get('documents', 0)} document(s), "
        f"{fleet.get('waves', 0)} wave(s), "
        f"{fleet.get('replicas', 0)} replicas; "
        f"{fleet.get('agreed_documents', 0)}/{fleet.get('documents', 0)}"
        f" agreed, {fleet.get('divergence_incidents', 0)} divergence "
        f"incident(s)",
    ]
    if fleet.get("staleness"):
        hist = "  ".join(f"{k} behind: {v}"
                         for k, v in fleet["staleness"].items())
        lines.append(f"  staleness: {hist}")
    if lag.get("ops_converged"):
        lines.append(
            f"  lag: {lag['ops_converged']} converged "
            f"(p50 {_g(conv.get('p50_ms'))} ms  "
            f"p95 {_g(conv.get('p95_ms'))}  "
            f"p99 {_g(conv.get('p99_ms'))}), "
            f"{lag.get('pending', 0)} pending; "
            f"SLO {_g(slo.get('target_ms'))} ms -> "
            f"{slo.get('verdict') or '-'}"
            + (f" ({100 * slo['attainment']:.1f}% within, "
               f"burn {_g(slo.get('burn_rate'))}x)"
               if slo.get("attainment") is not None else ""))
        if win:
            lines.append(
                f"  window (last {win.get('n')}): "
                f"p50 {_g(win.get('p50_ms'))} ms  "
                f"p95 {_g(win.get('p95_ms'))}  "
                f"p99 {_g(win.get('p99_ms'))}  "
                f"(burn {_g(win.get('burn_rate'))}x)")
    elif lag.get("pending"):
        lines.append(f"  lag: 0 converged, {lag['pending']} PENDING "
                     "(no fleet-wide digest agreement yet)")
    else:
        lines.append("  lag: no convergence-lag records")
    lines.append(
        f"  sync: {sync.get('delta_rounds', 0)} delta round(s), "
        f"{sync.get('full_bag', 0)} full-bag "
        f"({100 * (sync.get('full_bag_rate') or 0):.1f}%); "
        f"waves/sec {_g(rates.get('waves_per_s'))}")
    lines.append(
        f"  waves: {wave.get('pairs', 0)} pair-merges, "
        f"{100 * (wave.get('fallback_rate') or 0):.1f}% fallback, "
        f"{wave.get('overflow_retries', 0)} overflow retrie(s), "
        f"{wave.get('session_overflow', 0)} session overflow(s)")
    if cost:
        slope = (cost.get("slope") or {}).get("verdict")
        by = cost.get("by_path")
        lines.append(
            f"  cost: {cost.get('waves', 0)} wave(s), "
            f"{cost.get('dispatches', 0)} dispatch(es), "
            f"{cost.get('delta_ops', 0)} delta op(s), "
            f"{_g(cost.get('wall_ms'))} ms"
            + (f", slope {slope}" if slope else "")
            + (f" [{', '.join(f'{k}:{v}' for k, v in by.items())}]"
               if by else ""))
    if head.get("min") is not None:
        per = ", ".join(f"{k} {_g(v)}" for k, v
                        in sorted(head.get("min_by_site", {}).items()))
        lines.append(f"  headroom: min {_g(head['min'])} ({per})")
    srv = snap.get("serve") or {}
    if srv.get("active"):
        lines.append(
            f"  serve: {srv.get('ticks', 0)} tick(s), "
            f"queue depth {_g(srv.get('queue_depth'))}, "
            f"{_g(srv.get('resident_docs'))} resident doc(s), "
            f"T_batch {_g(srv.get('t_batch_ms'))} ms; "
            f"{srv.get('sheds', 0)} shed(s) "
            f"({_g(srv.get('shed_rate'))}/s)")
        if srv.get("wal_bytes") is not None or srv.get("disk_faults") \
                or srv.get("journal_torn"):
            lines.append(
                f"  wal: {_g(srv.get('wal_segments'))} segment(s), "
                f"{_g(srv.get('wal_bytes'))} bytes; "
                f"{srv.get('disk_faults', 0)} disk fault(s), "
                f"{srv.get('journal_torn', 0)} torn/corrupt line(s)")
    net = snap.get("net") or {}
    if net.get("active"):
        lines.append(
            f"  net: {_g(net.get('connections'))} connection(s), "
            f"{net.get('connects', 0)} connect(s) "
            f"({net.get('reconnects', 0)} re, "
            f"{_g(net.get('reconnects_per_min'))}/min), "
            f"{net.get('nacks', 0)} nack(s), "
            f"{net.get('dup_frames', 0)} dup frame(s) "
            f"+ {net.get('dup_ops_suppressed', 0)} op(s) suppressed, "
            f"outbound {_g(net.get('outbound_depth'))}")
    jy = snap.get("journey") or {}
    if jy.get("active"):
        line = (
            f"  journeys: {jy.get('traces', 0)} trace(s) "
            f"({jy.get('complete', 0)} complete, "
            f"{jy.get('shed', 0)} shed, "
            f"{jy.get('inflight', 0)} in flight), "
            f"{jy.get('orphan_hops', 0)} orphan hop(s); "
            f"mint→converged p50 {_g(jy.get('total_p50_ms'))} ms "
            f"p99 {_g(jy.get('total_p99_ms'))}")
        lines.append(line)
        if jy.get("worst_trace"):
            lines.append(
                f"    worst: {_g(jy.get('worst_total_ms'))} ms — "
                f"`obs journey {jy['worst_trace']}`")
    shp = snap.get("ship") or {}
    if shp.get("active"):
        lines.append(
            f"  ship: {shp.get('origins', 0)} origin(s), "
            f"{shp.get('accepted', 0)} record(s) accepted, "
            f"{shp.get('dup_records', 0)} dup-skipped, "
            f"{shp.get('missed', 0)} missed (evidenced), "
            f"{shp.get('unexplained_gaps', 0)} unexplained gap(s)")
        for o in (snap.get("origins") or [])[:8]:
            lines.append(
                f"    {o['host']}:{o['pid']}: wm {o['watermark']}, "
                f"{o['accepted']} accepted, {o['missed']} missed, "
                f"last {_g(o.get('age_s'))} s ago")
    hb = snap.get("heartbeat")
    if hb:
        hb_age = ages.get("run.heartbeat")
        desc = " ".join(f"{k}={v}" for k, v in hb.items()
                        if k not in ("ts_us",))
        lines.append(f"  heartbeat: {desc}"
                     + (f"  ({_g(hb_age)} s ago)"
                        if hb_age is not None else ""))
    recency = [(n, a) for n, a in sorted(ages.items())
               if n in ("any", "wave.digest", "wave.cost",
                        "run.heartbeat", "lag.window")]
    if recency:
        lines.append("  ages: " + "  ".join(f"{n} {_g(a)}s"
                                            for n, a in recency))
    lines.append(f"  alerts: {len(alerts)} fired")
    for a in alerts[-8:]:
        when_a = time.strftime("%H:%M:%S",
                               time.gmtime(a.get("ts_us", 0) / 1e6))
        if a.get("kind") == "absence":
            lines.append(
                f"    [{when_a}] {a['rule']}: no {a['event']} for "
                f"{_g(a.get('age_s'))} s (limit {_g(a.get('window_s'))})")
        else:
            lines.append(
                f"    [{when_a}] {a['rule']}: {a.get('path')} = "
                f"{_g(a.get('value'))} (limit {a.get('op')} "
                f"{_g(a.get('limit'))})")
    return "\n".join(lines)


# -------------------------------------------------------- prometheus

# metric name -> (snapshot path, prometheus type)
_PROM_METRICS = (
    ("cause_tpu_live_records", "records", "counter"),
    ("cause_tpu_live_documents", "fleet.documents", "gauge"),
    ("cause_tpu_live_waves_total", "fleet.waves", "counter"),
    ("cause_tpu_live_replicas", "fleet.replicas", "gauge"),
    ("cause_tpu_live_agreed_documents", "fleet.agreed_documents",
     "gauge"),
    ("cause_tpu_live_divergence_incidents",
     "fleet.divergence_incidents", "counter"),
    ("cause_tpu_live_ops_converged", "lag.ops_converged", "counter"),
    ("cause_tpu_live_ops_pending", "lag.pending", "gauge"),
    ("cause_tpu_live_lag_p50_ms", "lag.converged.p50_ms", "gauge"),
    ("cause_tpu_live_lag_p95_ms", "lag.converged.p95_ms", "gauge"),
    ("cause_tpu_live_lag_p99_ms", "lag.converged.p99_ms", "gauge"),
    ("cause_tpu_live_window_p99_ms", "lag.window.p99_ms", "gauge"),
    ("cause_tpu_live_slo_target_ms", "lag.slo.target_ms", "gauge"),
    ("cause_tpu_live_slo_attainment", "lag.slo.attainment", "gauge"),
    ("cause_tpu_live_slo_burn_rate", "lag.slo.burn_rate", "gauge"),
    ("cause_tpu_live_full_bag_rate", "sync.full_bag_rate", "gauge"),
    ("cause_tpu_live_wave_fallback_rate", "wave.fallback_rate",
     "gauge"),
    ("cause_tpu_live_waves_per_s", "rates.waves_per_s", "gauge"),
    ("cause_tpu_live_dispatches_total", "cost.dispatches", "counter"),
    ("cause_tpu_live_delta_ops_total", "cost.delta_ops", "counter"),
    ("cause_tpu_live_headroom_min", "headroom.min", "gauge"),
    ("cause_tpu_live_serve_queue_depth", "serve.queue_depth", "gauge"),
    ("cause_tpu_live_serve_resident_docs", "serve.resident_docs",
     "gauge"),
    ("cause_tpu_live_serve_shed_rate", "serve.shed_rate", "gauge"),
    ("cause_tpu_live_serve_sheds_total", "serve.sheds", "counter"),
    ("cause_tpu_live_serve_t_batch_ms", "serve.t_batch_ms", "gauge"),
    ("cause_tpu_live_serve_disk_faults_total", "serve.disk_faults",
     "counter"),
    ("cause_tpu_live_serve_journal_torn_total", "serve.journal_torn",
     "counter"),
    ("cause_tpu_live_serve_wal_segments", "serve.wal_segments",
     "gauge"),
    ("cause_tpu_live_serve_wal_bytes", "serve.wal_bytes", "gauge"),
    ("cause_tpu_live_net_connections", "net.connections", "gauge"),
    ("cause_tpu_live_net_connects_total", "net.connects", "counter"),
    ("cause_tpu_live_net_reconnects_total", "net.reconnects",
     "counter"),
    ("cause_tpu_live_net_reconnects_per_min",
     "net.reconnects_per_min", "gauge"),
    ("cause_tpu_live_net_nacks_total", "net.nacks", "counter"),
    ("cause_tpu_live_net_dup_frames_total", "net.dup_frames",
     "counter"),
    ("cause_tpu_live_net_dup_ops_total", "net.dup_ops_suppressed",
     "counter"),
    ("cause_tpu_live_net_outbound_depth", "net.outbound_depth",
     "gauge"),
    ("cause_tpu_live_journey_traces_total", "journey.traces",
     "counter"),
    ("cause_tpu_live_journey_complete_total", "journey.complete",
     "counter"),
    ("cause_tpu_live_journey_inflight", "journey.inflight", "gauge"),
    ("cause_tpu_live_journey_orphan_hops_total",
     "journey.orphan_hops", "counter"),
    ("cause_tpu_live_journey_p99_ms", "journey.total_p99_ms",
     "gauge"),
    # the ship plane's accounting, present in a collector's snapshot
    # only (this package's addition to the reference's families)
    ("cause_tpu_live_ship_origins", "ship.origins", "gauge"),
    ("cause_tpu_live_ship_connections_total", "ship.connections",
     "counter"),
    ("cause_tpu_live_ship_accepted_total", "ship.accepted", "counter"),
    ("cause_tpu_live_ship_dup_records_total", "ship.dup_records",
     "counter"),
    ("cause_tpu_live_ship_missed_total", "ship.missed", "counter"),
    ("cause_tpu_live_ship_unexplained_gaps_total",
     "ship.unexplained_gaps", "counter"),
    ("cause_tpu_live_alerts_total", "alerts_total", "counter"),
)


def _prom_name(raw: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in raw)


def _prom_label(raw) -> str:
    return str(raw).replace("\\", "\\\\").replace('"', '\\"')


def prometheus_text(snap: dict) -> str:
    """The snapshot as Prometheus exposition text (version 0.0.4):
    one line per known metric, Nones skipped — a scraper sees only
    what the stream actually measured. A collector snapshot's
    per-origin rows additionally emit every serve/net gauge as a
    (host, pid)-labeled series — without the labels a multi-origin
    scrape is last-writer-wins per metric name, i.e. one arbitrary
    host's queue depth wearing the fleet's name. Series cardinality
    is bounded by the collector's origin LRU: an evicted origin's
    row simply stops being exported."""
    from .live import snapshot_path

    lines = []
    for name, path, kind in _PROM_METRICS:
        v = snapshot_path(snap, path)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {v:g}")
    typed = set()
    for o in snap.get("origins") or []:
        labels = (f'{{host="{_prom_label(o.get("host"))}"'
                  f',pid="{_prom_label(o.get("pid"))}"}}')
        for sect in ("serve", "net"):
            for k, v in sorted((o.get(sect) or {}).items()):
                if not isinstance(v, (int, float)) \
                        or isinstance(v, bool):
                    continue
                name = f"cause_tpu_origin_{sect}_{_prom_name(k)}"
                if name not in typed:
                    typed.add(name)
                    lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name}{labels} {v:g}")
    return "\n".join(lines) + "\n"


def serve_metrics(port: int, get_snapshot: Callable[[], dict]):
    """Serve ``/metrics`` (Prometheus text) and ``/`` (snapshot JSON)
    on a daemon thread. Returns ``(server, actual_port)`` — pass port
    0 for an ephemeral port (tests)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
            try:
                snap = get_snapshot()
                if self.path.split("?")[0].rstrip("/") == "/metrics":
                    body = prometheus_text(snap).encode()
                    ctype = "text/plain; version=0.0.4"
                else:
                    body = (json.dumps(snap, default=str) + "\n").encode()
                    ctype = "application/json"
            except Exception as e:  # noqa: BLE001 - serve 500, never die
                body = f"error: {type(e).__name__}: {e}\n".encode()
                self.send_response(500)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet: the dashboard owns stdout
            pass

    server = ThreadingHTTPServer(("127.0.0.1", int(port)), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="obs-watch-metrics", daemon=True)
    thread.start()
    return server, server.server_address[1]


# ---------------------------------------------------- collector feed


class _CollectorFeed:
    """One persistent connection to a CollectorServer: ``snap()``
    requests the fleet-wide fold snapshot ({"op": "snap"}) and
    returns it, reconnecting lazily across ticks — a collector
    restart costs one missed frame, not a dead dashboard. The watch
    side is a pure reader: no hello, no origin row, no watermark."""

    def __init__(self, host: str, port: int,
                 connect_timeout_s: float = 2.0,
                 read_timeout_s: float = 5.0):
        self.host = host
        self.port = int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self.read_timeout_s = float(read_timeout_s)
        self.fs = None
        self.last_error: Optional[str] = None

    def snap(self) -> Optional[dict]:
        import socket

        from .. import sync as _sync
        from ..collections import shared as _s
        from ..net import transport as _transport

        try:
            if self.fs is None:
                sock = socket.create_connection(
                    (self.host, self.port),
                    timeout=self.connect_timeout_s)
                sock.settimeout(self.read_timeout_s)
                self.fs = _transport.FrameStream(sock,
                                                 site="obs.watch")
            _sync.send_frame(self.fs, {"op": "snap"})
            reply = _transport.recv_msg(self.fs, self.read_timeout_s)
        except (_s.CausalError, OSError) as e:
            self.last_error = f"{type(e).__name__}: {e}"
            self.close()
            return None
        if reply.get("op") != "snap":
            self.last_error = f"unexpected reply op {reply.get('op')!r}"
            return None
        self.last_error = None
        return reply.get("snapshot")

    def close(self) -> None:
        if self.fs is not None:
            try:
                self.fs.close()
            except OSError:
                pass
            self.fs = None


# --------------------------------------------------------------- CLI


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.obs watch",
        description="Live fleet watch over obs JSONL stream(s): "
                    "incremental fold (fleet health, lag/SLO, cost, "
                    "rates, heartbeats), declarative alert rules, "
                    "ANSI-redraw dashboard, optional Prometheus "
                    "endpoint. --once renders a single snapshot and "
                    "exits (CI, cron, tunnel checks).")
    ap.add_argument("jsonl", nargs="*",
                    help="obs event file(s) to tail (JSON lines; "
                         "files may not exist yet in live mode). "
                         "Not used with --collector.")
    ap.add_argument("--collector", default=None, metavar="HOST:PORT",
                    help="read the fleet-wide snapshot from a running "
                         "CollectorServer's socket feed instead of "
                         "tailing local files")
    ap.add_argument("--rules", action="append", default=None,
                    metavar="SPEC",
                    help="alert rule (repeatable): <path><op><value> "
                         "(aliases: burn, p99, full_bag_rate, "
                         "pending, headroom, waves_per_s, ...) or "
                         "absence:<event>:<seconds>. Default: "
                         + ", ".join(DEFAULT_RULE_SPECS))
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll/redraw interval seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="read the stream(s) once, render one "
                         "snapshot + alerts, exit")
    ap.add_argument("--json", action="store_true",
                    help="machine output: with --once one "
                         "{snapshot, alerts} document; live mode one "
                         "JSON line per interval instead of the ANSI "
                         "dashboard")
    ap.add_argument("--serve-port", type=int, default=None,
                    metavar="PORT",
                    help="serve /metrics (Prometheus text) + / "
                         "(snapshot JSON) on 127.0.0.1:PORT")
    ap.add_argument("--duration", type=float, default=None,
                    metavar="SECONDS",
                    help="live mode: stop after this many seconds "
                         "(default: run until interrupted)")
    a = ap.parse_args(argv)

    if a.collector is not None:
        from .ship import parse_endpoint

        if a.jsonl:
            print("watch: give obs JSONL file(s) OR --collector, "
                  "not both", file=sys.stderr)
            return 2
        ep = parse_endpoint(a.collector)
        if ep is None:
            print(f"watch: bad --collector endpoint: {a.collector!r} "
                  "(want HOST:PORT)", file=sys.stderr)
            return 2
        return _collector_main(a, _CollectorFeed(*ep))
    if not a.jsonl:
        print("watch: give obs JSONL file(s) or --collector "
              "HOST:PORT", file=sys.stderr)
        return 2

    try:
        monitor = LiveMonitor(rules=a.rules)
    except ValueError as e:
        print(f"watch: {e}", file=sys.stderr)
        return 2

    if a.once:
        for path in a.jsonl:
            if not os.path.exists(path):
                print(f"watch: no such file: {path}", file=sys.stderr)
                return 2
        monitor.feed(load_streams(a.jsonl))
        # a replayed historical stream is judged against its OWN end,
        # not today's clock: an absence rule must detect a wedge
        # inside the recorded run, not the age of the file
        end_us = monitor.fold.last_ts_us
        snap = monitor.emit_snapshot(now_us=end_us)
        monitor.evaluate(now_us=end_us, snap=snap)
        snap = monitor.snapshot(now_us=snap["ts_us"])
        try:
            if a.json:
                print(json.dumps({"snapshot": snap,
                                  "alerts": monitor.alerts},
                                 default=str, indent=1))
            else:
                print(render(snap, monitor.alerts, a.jsonl,
                             clock=snap["ts_us"] / 1e6))
        except BrokenPipeError:
            # `obs watch ... --once | head` is the normal tunnel
            # one-liner; a closed pipe is the reader's choice, not
            # an error
            try:
                sys.stdout.close()
            except OSError:
                pass
        return 0

    server = None
    tail = MultiTailer(a.jsonl)
    latest = {"snap": monitor.snapshot()}
    if a.serve_port is not None:
        server, port = serve_metrics(a.serve_port,
                                     lambda: latest["snap"])
        print(f"watch: serving /metrics on 127.0.0.1:{port}",
              file=sys.stderr)
    deadline = (time.monotonic() + a.duration
                if a.duration is not None else None)
    first = True
    try:
        while True:
            monitor.feed(tail.poll())
            snap = monitor.emit_snapshot()
            monitor.evaluate(snap=snap)
            snap = monitor.snapshot()
            latest["snap"] = snap
            if a.json:
                print(json.dumps({"snapshot": snap,
                                  "alerts_fired": len(monitor.alerts)},
                                 default=str), flush=True)
            else:
                block = render(snap, monitor.alerts, a.jsonl,
                               clock=time.time())
                prefix = _CLEAR if first else _HOME
                sys.stdout.write(prefix + block + "\n" + _EOS)
                sys.stdout.flush()
            first = False
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(max(0.05, a.interval))
    except (KeyboardInterrupt, BrokenPipeError):
        pass
    finally:
        tail.close()
        if server is not None:
            server.shutdown()
    if not a.json:
        try:
            sys.stdout.write("\n")
        except (OSError, ValueError):
            pass
    return 0


def _collector_main(a, feed: _CollectorFeed) -> int:
    """The --collector loop: same dashboard, snapshots pulled from
    the collector's socket feed (rules run collector-side — its
    fleet-wide monitor already evaluated them; ``alerts_recent``
    rides the snapshot)."""
    label = [f"collector {feed.host}:{feed.port}"]
    if a.once:
        snap = feed.snap()
        feed.close()
        if snap is None:
            print(f"watch: collector unreachable: {feed.last_error}",
                  file=sys.stderr)
            return 2
        alerts = snap.get("alerts_recent") or []
        if a.json:
            print(json.dumps({"snapshot": snap, "alerts": alerts},
                             default=str, indent=1))
        else:
            print(render(snap, alerts, label,
                         clock=snap.get("ts_us", 0) / 1e6))
        return 0
    server = None
    latest = {"snap": {}}
    if a.serve_port is not None:
        server, port = serve_metrics(a.serve_port,
                                     lambda: latest["snap"])
        print(f"watch: serving /metrics on 127.0.0.1:{port}",
              file=sys.stderr)
    deadline = (time.monotonic() + a.duration
                if a.duration is not None else None)
    first = True
    try:
        while True:
            snap = feed.snap()
            if snap is not None:
                latest["snap"] = snap
            alerts = (snap or latest["snap"]).get(
                "alerts_recent") or []
            if a.json:
                print(json.dumps(
                    {"snapshot": snap,
                     "unreachable": feed.last_error}, default=str),
                    flush=True)
            elif snap is not None:
                block = render(snap, alerts, label,
                               clock=time.time())
                prefix = _CLEAR if first else _HOME
                sys.stdout.write(prefix + block + "\n" + _EOS)
                sys.stdout.flush()
                first = False
            else:
                sys.stdout.write(
                    f"watch: collector unreachable "
                    f"({feed.last_error}); retrying\n")
                sys.stdout.flush()
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(max(0.05, a.interval))
    except (KeyboardInterrupt, BrokenPipeError):
        pass
    finally:
        feed.close()
        if server is not None:
            server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
