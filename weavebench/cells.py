"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix. A configuration's sizes are in the file
its entry names (under ``configs/``), a traffic mix's parameters in
``traffic/<traffic>.json``, the mix names the entry module that drives
the program (``entries/<entry>.py``), and each per-layer metric is read
by ``metrics/<name>.py``. Adding a cell or a metric adds files and
entries; no file here changes. A metric's name may carry a suffix after
a dot, which splits one quantity between groups of cells that report
different end-to-end metrics; the suffix changes nothing of how it is
read.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload``: its name, configuration, traffic mix,
    chips, and the per-layer metrics it reports."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"weavebench: no workload {workload!r}; "
                         f"one of {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    per_layer = [m["name"] for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return {"name": workload, "config": cfg, "mix": mix,
            "chips": cell["chips"], "per_layer": per_layer}


def entry_class(mix: dict):
    """The class that drives the program for ``mix``."""
    return importlib.import_module(
        f"weavebench.entries.{mix['entry']}").Entry


def quantity(name: str) -> str:
    """What metric ``name`` measures: its name up to the first dot. A
    quantity whose cells report different end-to-end metrics is split
    by a suffix (``glue_device_ms.card`` moves ``docs_merged_per_s.card``),
    and each part is read alike."""
    return name.split(".")[0]


def metric_reader(name: str):
    """The ``read(ctx)`` function of per-layer metric ``name``
    (``metrics/<quantity>.py``)."""
    return importlib.import_module(
        f"weavebench.metrics.{quantity(name)}").read
