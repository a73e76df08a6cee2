"""Small cells for the CPU tests: each of ``BENCHMARK.json``'s cells,
with the configuration cut to a size a test run holds, and the typing
mixes the tests draw from."""

from __future__ import annotations

import copy

from weavebench import cells

PAIRS = dict(documents=4, base_nodes=40, divergent_nodes=24, capacity=80,
             hide_p=0.125)
FLEET = dict(replicas=8, base_nodes=40, divergent_nodes=24, capacity=80,
             hide_p=0.125)
# typing mixes: the port's chains; crdt-benchmarks' one-character edits
# at drawn positions; runs short enough at this size to have many
CHAIN = dict(base_run_mean=None, div_run_mean=None, hides="previous")
RANDOM = dict(base_run_mean=1, div_run_mean=1, hides="uniform")
RUNS = dict(base_run_mean=4, div_run_mean=3, hides="uniform")
MIXES = {"chain": CHAIN, "random": RANDOM, "runs": RUNS}

CELLS = [w["name"] for w in cells.load_spec()["workloads"]]


def small_cell(name: str) -> dict:
    cell = copy.deepcopy(cells.resolve(name))
    base = FLEET if "replicas" in cell["config"] else PAIRS
    cell["config"] = dict(base)
    return cell
