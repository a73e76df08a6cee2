"""The control of the comparison that decides ``correct``.

    python -m weavebench.control --workload <name> --seeds 1,2,3 \
        [--break deletes,order] [--device cuda]

The reference, with one guarantee of the configuration broken
(``reference.weave``'s ``break_guarantee``: ``deletes`` ignores every
hide, ``order`` puts concurrent siblings oldest first), is put in the
program's place: it weaves each batch of the cell's inputs from the
seed at the cell's own size, and its answers (ranks and visibility by
lane, one wave's digests a batch) go through the same comparison as a
run's. A sound comparison finds it wrong. One JSON line a seed, with
the compared numbers. The benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import cells, check
from .entries.common import ref_lanes
from .reference import weave as ref


def cell_lanes(cell: dict, seed: int) -> list:
    """The reference's lanes of each batch of ``cell`` from ``seed``."""
    cfg, mix = cell["config"], cell["mix"]
    return [ref_lanes(x) for x in
            cells.entry_class(mix).make_lanes(cfg, mix, seed)]


def control_numbers(cell: dict, seed: int, broken: str, device,
                    lanes=None) -> dict:
    """The compared numbers of the broken reference in the program's
    place, for one seed of ``cell`` (whose lanes ``lanes`` may hold)."""
    import torch

    dev = torch.device(device)
    if lanes is None:
        lanes = cell_lanes(cell, seed)
    outputs, waves = [], []
    for b, x in enumerate(lanes):
        B, N = x["hi"].shape
        step = max(1, check.BLOCK_LANES // N)
        parts = []
        for r0 in range(0, B, step):
            t = {k: torch.as_tensor(np.ascontiguousarray(v[r0:r0 + step]))
                 .to(dev) for k, v in x.items()}
            w = ref.weave(t["hi"], t["lo"], t["chi"], t["clo"], t["vc"],
                          t["valid"], break_guarantee=broken)
            parts.append(check.as_program(w, N))
        outputs.append((torch.cat([p[0] for p in parts]),
                        torch.cat([p[1] for p in parts])))
        dig = torch.cat([p[2] for p in parts]).cpu().numpy()
        waves.append((b, dig, np.zeros(B, bool)))
    return check.compare(lanes, outputs, waves, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m weavebench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--break", dest="broken", default="deletes,order",
                    help="comma-separated: deletes, order")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    breaks = args.broken.split(",")
    if not set(breaks) <= set(ref.BREAKS) - {None}:
        ap.error(f"--break takes {', '.join(b for b in ref.BREAKS if b)}")
    for s in args.seeds.split(","):
        lanes = cell_lanes(cell, int(s))
        for broken in breaks:
            n = control_numbers(cell, int(s), broken, args.device, lanes)
            print(json.dumps({"workload": args.workload, "seed": int(s),
                              "break": broken, "correct":
                              check.verdict(n), **n}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
