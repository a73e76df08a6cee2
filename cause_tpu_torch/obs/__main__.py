"""CLI: the obs toolbox.

    python -m cause_tpu_torch.obs events.jsonl -o trace.json   # Perfetto
    python -m cause_tpu_torch.obs export events.jsonl ...      # the same
    python -m cause_tpu_torch.obs ledger --check               # perf ledger
    python -m cause_tpu_torch.obs fleet events.jsonl           # fleet health
    python -m cause_tpu_torch.obs gap [--obs events.jsonl]     # gap report
    python -m cause_tpu_torch.obs lag events.jsonl             # lag tracer
    python -m cause_tpu_torch.obs journey <trace|--worst N> .. # journeys
    python -m cause_tpu_torch.obs watch events.jsonl [--once]  # live watch

The default (first) form converts an obs JSONL event stream to a
Perfetto trace — open the output at https://ui.perfetto.dev (or
chrome://tracing); with ``--summary`` it also prints per-span-name
aggregate wall times and the final counter values. ``ledger`` manages
the persistent perf ledger (``cause_tpu_torch.obs.ledger``); ``watch``
is the live dashboard over streams or a collector
(``cause_tpu_torch.obs.watch``).
"""

from __future__ import annotations

import argparse
import json
import sys

from .perfetto import export_perfetto, load_jsonl, merged_final_counters


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "export":
        return _convert_main(argv[1:])
    if argv and argv[0] == "ledger":
        from .ledger import main as ledger_main

        return ledger_main(argv[1:])
    if argv and argv[0] == "fleet":
        from .fleet import main as fleet_main

        return fleet_main(argv[1:])
    if argv and argv[0] == "gap":
        from .costmodel import main as gap_main

        return gap_main(argv[1:])
    if argv and argv[0] == "lag":
        from .lag import main as lag_main

        return lag_main(argv[1:])
    if argv and argv[0] == "journey":
        from .journey import main as journey_main

        return journey_main(argv[1:])
    if argv and argv[0] == "watch":
        from .watch import main as watch_main

        return watch_main(argv[1:])
    return _convert_main(argv)


def _convert_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.obs",
        description="Convert obs JSONL events to a Perfetto/Chrome "
                    "trace (and/or print a summary).")
    ap.add_argument("jsonl", help="obs event file (JSON lines)")
    ap.add_argument("-o", "--out", default="",
                    help="write the Perfetto trace JSON here "
                         "(default: <jsonl>.perfetto.json)")
    ap.add_argument("--summary", action="store_true",
                    help="print per-span aggregates and counters")
    a = ap.parse_args(argv)

    events = load_jsonl(a.jsonl)
    out = a.out or (a.jsonl + ".perfetto.json")
    n = export_perfetto(out, events=events)
    print(f"{out}: {n} trace events from {len(events)} records",
          file=sys.stderr)

    if a.summary:
        agg: dict = {}
        for e in events:
            if e.get("ev") == "span":
                name = e.get("name", "?")
                tot, cnt = agg.get(name, (0, 0))
                agg[name] = (tot + e.get("dur_us", 0), cnt + 1)
        counters = merged_final_counters(events, include_gauges=True)
        for name in sorted(agg, key=lambda n_: -agg[n_][0]):
            tot, cnt = agg[name]
            print(json.dumps({"span": name, "total_ms":
                              round(tot / 1000.0, 3), "count": cnt}))
        if counters:
            print(json.dumps({"counters": counters}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
