"""The benchmark of the PyTorch and CUDA port (``cause_tpu_torch``).

    python -m weavebench --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card. The
cell's configuration, traffic mix, entry and per-layer metrics are
found by name (``cells.py``). One run:

1. set-up (``setup_s``, from the start of ``main``): imports, the
   cell's inputs from ``--seed`` (``gen.py``), the port's marshal and
   upload, the kernels' first build or load (into
   ``cause_tpu_torch/_build/``), and one wave of every batch plus the
   mix's ``warm_waves`` at the loop's depth, so that nothing builds or
   warms up inside the window;
2. the window: a closed loop that keeps the mix's ``depth`` waves in
   flight, issuing wave i+depth once wave i's answer (its digests and
   overflow flags, copied to pinned host memory) is on the host, for
   ``--seconds``. A wave's latency runs from the start of its issue to
   the return of its answer. ``--trace 1`` runs the same loop and puts
   ``torch.profiler`` over ``trace_waves`` steady waves of it;
3. the check (``check.py``): the reference weaves every batch the
   window drove, on the card, once the program's inputs are freed, and
   the program's answers are held against it;
4. one JSON line on standard output, the compared numbers beside their
   limits as the last lines on standard error.

It exits 2 without a result where no card is usable, and 3 where the
process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from collections import deque
from contextlib import nullcontext

from . import cells

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "cause_tpu"})
GIB = float(1 << 30)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m weavebench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (of ``names``, by default
    ``sys.modules``) that the benchmark must not load, compared
    whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


class Slot:
    """Host buffers for one in-flight wave's answer, and the event that
    marks its copy done (pinned memory and an event on the card)."""

    def __init__(self, n: int, dev):
        import torch

        cuda = dev.type == "cuda"
        self.dig = torch.empty(n, dtype=torch.int32, pin_memory=cuda)
        self.ovf = torch.empty(n, dtype=torch.bool, pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

    def put(self, dig, ovf) -> None:
        self.dig.copy_(dig.reshape(-1), non_blocking=True)
        self.ovf.copy_(ovf.reshape(-1), non_blocking=True)
        if self.event is not None:
            self.event.record()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def take(self):
        return self.dig.numpy().copy(), self.ovf.numpy().copy()


class Tracer:
    """The profiler over ``waves`` steady waves of a window, started at
    the first issue past ``start_after`` seconds."""

    def __init__(self, waves: int, start_after: float):
        self.waves, self.start_after = waves, start_after
        self.prof = self.seg = None
        self.first = self.done = None

    def span(self, name):
        from torch.profiler import record_function

        return record_function(name)

    def before_issue(self, i: int, elapsed: float) -> None:
        if self.prof is None and self.done is None \
                and elapsed >= self.start_after:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                acc_events=True)
            self.prof.start()
            self.seg = self.span("weavebench.traced")
            self.seg.__enter__()
            self.first = i

    def after_complete(self, j: int) -> None:
        if self.prof is not None and j >= self.first + self.waves - 1:
            self.seg.__exit__(None, None, None)
            self.prof.stop()
            self.done, self.prof = self.prof, None

    def active(self) -> bool:
        return self.prof is not None

    def pending(self) -> bool:
        return self.done is None

    def summary(self):
        from . import trace

        if self.done is None:
            return None
        s = trace.summarize(self.done.events(), self.waves)
        return s if s["device"] else None


def run_loop(entry, dev, depth: int, start: int, seconds=None, waves=None,
             tracer=None) -> dict:
    """The closed loop: ``depth`` waves in flight from wave ``start``,
    for ``seconds`` (or for ``waves`` waves). Returns each wave's
    answer and timings."""
    slots = [Slot(entry.docs_per_wave, dev) for _ in range(depth)]
    inflight = deque()
    out = {"waves": [], "lat_s": [], "done_at": [], "entry_ms": [],
           "done_in_window": 0, "issued": 0}
    span = tracer.span if tracer is not None else (lambda _n: nullcontext())
    t0 = time.perf_counter()
    t_end = t0 + seconds if seconds is not None else None
    i = start

    def issue():
        nonlocal i
        if tracer is not None:
            tracer.before_issue(i, time.perf_counter() - t0)
        traced = tracer is not None and tracer.active()
        slot = slots[(i - start) % depth]
        ts = time.perf_counter()
        with span("weavebench.entry"):
            b, dig, ovf = entry.issue(i)
        te = time.perf_counter()
        with span("weavebench.copy"):
            slot.put(dig, ovf)
        inflight.append((i, b, ts, slot))
        if not traced:
            out["entry_ms"].append((te - ts) * 1e3)
        out["issued"] += 1
        i += 1

    def more(now) -> bool:
        if waves is not None:
            return out["issued"] < waves
        return now < t_end or (tracer is not None and tracer.pending()
                               and tracer.active())

    while len(inflight) < depth and more(time.perf_counter()):
        issue()
    while inflight:
        j, b, ts, slot = inflight.popleft()
        with span("weavebench.wait"):
            slot.wait()
        now = time.perf_counter()
        dig, ovf = slot.take()
        out["waves"].append((b, dig, ovf))
        out["lat_s"].append(now - ts)
        out["done_at"].append(now - t0)
        if t_end is None or now <= t_end:
            out["done_in_window"] += 1
        if tracer is not None:
            tracer.after_complete(j)
        if more(now):
            issue()
    out["window_s"] = seconds if seconds is not None else \
        time.perf_counter() - t0
    return out


def host_sample() -> dict:
    """The process's CPU seconds and involuntary context switches, read
    around the window, to tell a slow host from a slow program."""
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw,
            "wall": time.perf_counter()}


def host_delta(a: dict, b: dict) -> str:
    wall = b["wall"] - a["wall"]
    return (f"process cpu {(b['cpu_s'] - a['cpu_s']) / wall:.3f} of the "
            f"window, {b['nivcsw'] - a['nivcsw']} involuntary switches")


def quarters(loop: dict, seconds: float) -> list:
    """Waves done and their median latency (ms) in each quarter of the
    window: whether the loop drifts within a run."""
    import numpy as np

    out = []
    at = np.asarray(loop["done_at"])
    lat = np.asarray(loop["lat_s"])
    for q in range(4):
        m = (at >= q * seconds / 4) & (at < (q + 1) * seconds / 4)
        out.append((int(m.sum()),
                    float(np.median(lat[m]) * 1e3) if m.any() else None))
    return out


def card_power_limit():
    """The card's ``name, power.limit`` as nvidia-smi prints them, or
    None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def peak_bandwidth(kind: str):
    peaks = json.loads((cells.HERE / "peaks.json").read_text())
    entry = peaks.get(kind)
    return entry["memory_bytes_per_s"] if isinstance(entry, dict) else None


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, marks=None) -> dict:
    """One run of ``cell`` on ``device``; the result's fields. ``marks``
    are the ``(name, time)`` steps of set-up before the call."""
    import numpy as np
    import torch

    from cause_tpu_torch import kernels

    from . import check
    from . import trace as tracemod

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    marks = list(marks or [])
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("cuda_init", time.perf_counter()))
    cfg, mix = cell["config"], cell["mix"]
    depth = mix["depth"]
    entry = cells.entry_class(mix)(cfg, mix, seed, dev)

    # ---- set-up
    entry.setup()
    marks.append(("inputs", time.perf_counter()))
    n_batches = mix["batches"]
    for i in range(n_batches):
        _b, dig, _o = entry.issue(i)
        dig.cpu()
    marks.append(("first_waves", time.perf_counter()))
    run_loop(entry, dev, depth, n_batches, waves=mix["warm_waves"])
    if cuda:
        torch.cuda.synchronize(dev)
    # what set-up made lives through the run: the collector need not
    # walk it inside the window
    gc.collect()
    gc.freeze()
    marks.append(("warm_waves", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    parts, at = {}, t_start
    for name, t in marks:
        parts[name] = t - at
        at = t

    # ---- the window
    tracer = (Tracer(mix["trace_waves"], 0.2 * seconds) if trace else None)
    first = n_batches + mix["warm_waves"]
    launches0 = sum(kernels.launches.values())
    host0 = host_sample()
    loop = run_loop(entry, dev, depth, first, seconds=seconds,
                    tracer=tracer)
    host = host_delta(host0, host_sample())
    launches = sum(kernels.launches.values()) - launches0
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    t_close = time.perf_counter()
    summary = tracer.summary() if tracer is not None else None
    parts["trace_read"] = time.perf_counter() - t_close

    # ---- the check, with the program's inputs freed
    outputs = entry.outputs()
    lanes = entry.reference_lanes()
    wave_bytes = entry.wave_bytes()
    entry.free()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(lanes, outputs, loop["waves"], dev)
    parts["check"] = time.perf_counter() - t_check

    docs = entry.docs_per_wave
    over = [int(np.asarray(o, bool).sum()) for _b, _d, o in loop["waves"]]
    in_window = loop["done_in_window"]
    fields = {
        "correct": check.verdict(numbers),
        "attempted": docs * len(loop["waves"]),
        "failed": sum(over),
        "numbers": numbers,
        "setup_s": setup_s,
        "peak": peak,
        "e2e": {
            "docs_merged_per_s": (docs * in_window - sum(over[:in_window]))
            / loop["window_s"],
            "wave_p95_ms": float(np.percentile(loop["lat_s"], 95)) * 1e3,
            "device_peak_gib": peak / GIB,
            "setup_s": setup_s,
        },
        "waves": len(loop["waves"]),
        "parts": parts,
        "quarters": quarters(loop, seconds),
        "host": host,
    }
    if trace:
        kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
        fields["ctx"] = {
            "trace": summary,
            "entry_ms": loop["entry_ms"],
            "port_launches_per_wave": launches / loop["issued"],
            "port_kernels": tracemod.port_kernel_names(
                cells.ROOT / "cause_tpu_torch" / "csrc"),
            "wave_bytes": wave_bytes,
            "peak_bytes_per_s": peak_bandwidth(kind),
        }
        if summary is not None:
            fields["busy_s"] = tracemod.busy_us(summary) * 1e-6
            fields["window_s"] = (summary["t1"] - summary["t0"]) * 1e-6
            fields["breakdown"] = tracemod.breakdown(summary)
    return fields


def result_line(cell: dict, fields: dict, trace: bool, dev_kind: str,
                count: int) -> dict:
    """The result object, in the contract's key order, the compared
    numbers last."""
    from . import check

    spec = cells.load_spec()
    metrics = {}
    if trace:
        units = {m["name"]: m["unit"] for m in spec["per_layer"]}
        for name in cell["per_layer"]:
            v = cells.metric_reader(name)(fields["ctx"])
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
    else:
        for m in spec["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]):
                v = fields["e2e"][cells.quantity(m["name"])]
                metrics[m["name"]] = {"value": float(v),
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if dev_kind != "cpu" else "cpu",
              "kind": dev_kind, "count": count,
              "memory_peak_bytes": fields["peak"]}
    if trace and "busy_s" in fields:
        device["busy_s"] = fields["busy_s"]
        device["window_s"] = fields["window_s"]
    out = {"correct": fields["correct"], "attempted": fields["attempted"],
           "failed": fields["failed"], "metrics": metrics, "device": device}
    if trace and "breakdown" in fields:
        out["breakdown"] = fields["breakdown"]
    out["compared"] = check.report(fields["numbers"])
    return out


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse(argv)
    cell = cells.resolve(args.workload)
    # the port builds no Triton kernel; should a library it loads do
    # so, its cache stays in the checkout at a fixed path
    os.environ["TRITON_CACHE_DIR"] = str(cells.HERE / "_cache" / "triton")
    import torch

    marks = [("import_torch", time.perf_counter())]
    import cause_tpu_torch  # noqa: F401  (the program under test)

    marks.append(("import_port", time.perf_counter()))

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"weavebench: {args.workload} needs {cell['chips']} CUDA "
              "card(s); none usable", file=sys.stderr)
        return 2
    fields = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", t_start, marks)
    bad = forbidden_modules()
    if bad:
        print(f"weavebench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, fields, bool(args.trace),
                       torch.cuda.get_device_name(0), cell["chips"])
    print(f"weavebench: {args.workload} seed {args.seed}: "
          f"{fields['waves']} waves, card {card_power_limit()}",
          file=sys.stderr)
    print("weavebench: seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in fields["parts"].items()), file=sys.stderr)
    print("weavebench: quarters of the window (waves, p50 ms): " + ", ".join(
        f"{n} {p50 if p50 is None else round(p50, 3)}"
        for n, p50 in fields["quarters"]), file=sys.stderr)
    print(f"weavebench: host in the window: {fields['host']}",
          file=sys.stderr)
    for name, v in line["compared"].items():
        bound = v.get("limit", v.get("min"))
        word = "limit" if "limit" in v else "at least"
        print(f"{name} {v['value']} {word} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
