"""The stage profiler: the v5 ``stage=`` prefix ladder as obs spans.

The counterpart of ``cause_tpu.obs.stages``: one timing loop
(``timed_median``) plus the v5 cumulative-prefix ladder
(``run_v5_stage_ladder``), both recording through obs — every warm-up,
every rep and every stage delta lands in the same JSONL/Perfetto stream
as the wave spans.

Stages (``torchw5.batched_merge_weave_v5(stage=...)`` early returns,
each a per-row checksum of that phase's live outputs): A segment
ordering + explode/dedupe; B token construction; C token sort +
dedupe; D cause resolution; E token-width ranking + kills; FULL adds
lane expansion + visibility. On the card the prefixes run the B1 sort
(A, C, E), the B2 walk (E) and the B3 expansion (FULL).

The device follows the package rule: ``"cuda"`` unless the caller asks
for the CPU, raising without a card. On the card a rep is timed with
CUDA events around the call (the only sync is the end event's); on the
CPU with the host clock.

CLI: ``python -m cause_tpu_torch.obs stages [--smoke] [--reps N]
[--shape B,NB,ND,CAP] [--device cpu] [--obs-out PATH]`` — enables obs
for the run and streams the ladder's spans to the sidecar.

Unlike the rest of ``cause_tpu_torch.obs`` this module runs kernels;
``obs/__init__`` does not import it.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional, Tuple

from . import core

__all__ = ["STAGES", "timed_median", "run_v5_stage_ladder", "main"]

# the v5 prefix ladder, cumulative; None = the full kernel
STAGES = ("A", "B", "C", "D", "E", None)


def timed_median(name: str, fn: Callable, *args, reps: int = 3,
                 device="cuda") -> Tuple[object, float, List[float]]:
    """The shared timing loop: one warm-up call (under a
    ``stages.warm`` span — on a fresh process it includes the kernel
    library's build), then ``reps`` timed calls (``stages.rep`` spans).
    On the card each rep is timed by a pair of CUDA events recorded on
    the current stream around the call and read after the end event's
    synchronize; on the CPU by the host clock. Returns (last output,
    median ms, all samples). Works with obs off — the spans are no-ops
    and the samples remain."""
    from ..device import resolve_device

    outs, samples = _timed_turns((name,), (fn,), args, reps,
                                 resolve_device(device))
    return outs[0], _median(samples[0]), samples[0]


def _median(samples: List[float]) -> float:
    import numpy as np

    return float(np.median(samples))


def _timed_turns(names, fns, args, reps: int, dev):
    """``timed_median``'s loop over several programs on the same
    ``args``: a warm-up of each, then ``reps`` rounds of one timed call
    of each in turn, so that the host's drift over the rounds falls on
    all of them alike. Returns (last outputs, samples per program)."""
    import torch

    on_card = dev.type == "cuda"
    outs = []
    for name, fn in zip(names, fns):
        with core.span("stages.warm", program=name):
            outs.append(fn(*args))
            if on_card:
                torch.cuda.synchronize(dev)
    samples: List[List[float]] = [[] for _ in fns]
    for i in range(max(1, int(reps))):
        for j, (name, fn) in enumerate(zip(names, fns)):
            with core.span("stages.rep", program=name, rep=i):
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record(torch.cuda.current_stream(dev))
                    outs[j] = fn(*args)
                    end.record(torch.cuda.current_stream(dev))
                    end.synchronize()
                    samples[j].append(float(start.elapsed_time(end)))
                else:
                    t0 = time.perf_counter()
                    outs[j] = fn(*args)
                    samples[j].append((time.perf_counter() - t0) * 1000.0)
    for name, got in zip(names, samples):
        core.event("stages.result", program=name,
                   p50_ms=round(_median(got), 3),
                   samples=[round(s, 3) for s in got])
    return outs, samples


def run_v5_stage_ladder(smoke: bool = False, reps: int = 3,
                        shape: Optional[Tuple[int, int, int, int]] = None,
                        device="cuda", inputs=None,
                        echo: Callable[[str], None] = None,
                        beside: Optional[Callable] = None) -> List[dict]:
    """Time the v5 kernel truncated at each stage checkpoint at the
    north-star shape (1024 pairs, 9,000 base + 1,000 divergent nodes,
    capacity 10,240), or ``smoke`` / an explicit ``shape`` (B, n_base,
    n_div, capacity), or on given ``inputs`` (a ``(v5 numpy batch,
    u_max)`` pair, e.g. a caller's own north-star batch), and report
    per-stage increments.

    ``beside``, a program of the same lane tensors (``*args``, e.g. the
    caller's dispatch), is timed in turns with FULL, a call of each a
    rep on the same clock, so that the host's drift falls on both
    alike: FULL's dict then also holds its ``beside_p50_ms`` and
    ``beside_ms`` (every sample).

    Every stage lands as a ``stages.prefix`` obs event (stage, p50,
    delta) on top of the per-rep spans from ``timed_median``. Returns
    the stage dicts in ladder order. A stage that fails raises."""
    from .. import benchgen
    from ..benchgen import LANE_KEYS5
    from ..device import resolve_device
    from ..weaver.torchw5 import batched_merge_weave_v5

    def _echo(line: str) -> None:
        (echo or (lambda s: print(s, flush=True)))(line)

    dev = resolve_device(device)
    core.set_platform(dev)
    if inputs is not None:
        v5, u = inputs
    else:
        if shape is not None:
            B, NB, ND, CAP = shape
        elif smoke:
            B, NB, ND, CAP = 8, 800, 100, 1024
        else:
            B, NB, ND, CAP = 1024, 9_000, 1_000, 10_240
        with core.span("stages.marshal", B=B, cap=CAP):
            batch = benchgen.batched_pair_lanes(
                n_replicas=B, n_base=NB, n_div=ND, capacity=CAP,
                hide_every=8,
            )
            v5 = benchgen.batched_v5_inputs(batch, CAP)
            u = benchgen.v5_token_budget(v5)
    B = int(v5["hi"].shape[0])
    _echo(f"platform={core.platform_of(dev)} B={B} "
          f"N={v5['hi'].shape[1]} S={v5['sg_len'].shape[1]} u_budget={u}")
    lanes = benchgen.lanes_from_numpy(v5, dev)
    args = [lanes[k] for k in LANE_KEYS5]

    def prog_for(stage):
        def run(*xs):
            return batched_merge_weave_v5(*xs, u_max=u, k_max=u,
                                          device=dev, stage=stage)
        return run

    results: List[dict] = []
    prev = 0.0
    for stage in STAGES:
        name = stage or "FULL"
        extra = {}
        if stage is None and beside is not None:
            _, (got, near) = _timed_turns(
                (f"stages.prefix.{name}", "stages.beside"),
                (prog_for(stage), beside), args, reps, dev)
            med = _median(got)
            extra = {"beside_p50_ms": _median(near), "beside_ms": near}
        else:
            _, med, _samples = timed_median(
                f"stages.prefix.{name}", prog_for(stage), *args, reps=reps,
                device=dev)
        _echo(f"prefix->{name:4s} {med:9.3f} ms   "
              f"(+{med - prev:8.3f} ms)")
        core.event("stages.prefix", stage=name, p50_ms=round(med, 3),
                   delta_ms=round(med - prev, 3))
        results.append({"stage": name, "p50_ms": med,
                        "delta_ms": med - prev, **extra})
        prev = med
    core.flush()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cause_tpu_torch.obs stages",
        description="Cumulative-prefix stage timing of the v5 kernel "
                    "through obs spans.")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--shape", default="",
                    help="explicit B,n_base,n_div,capacity (overrides "
                         "--smoke; e.g. 2,30,6,64 for a tiny run)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; raises "
                         "without a card unless cpu is asked for)")
    ap.add_argument("--obs-out", default="",
                    help="stream the run's obs events to this JSONL "
                         "path (default: record into the ring only)")
    a = ap.parse_args(argv)
    shape = None
    if a.shape:
        try:
            parts = tuple(int(x) for x in a.shape.split(","))
            if len(parts) != 4:
                raise ValueError
            shape = parts
        except ValueError:
            ap.error("--shape wants B,n_base,n_div,capacity")
    core.configure(enabled=True,
                   out=a.obs_out if a.obs_out else None)
    results = run_v5_stage_ladder(smoke=a.smoke, reps=a.reps,
                                  shape=shape, device=a.device)
    if a.obs_out:
        print(f"stages: obs events -> {a.obs_out}", file=sys.stderr)
    return 0 if results else 1


if __name__ == "__main__":
    raise SystemExit(main())
