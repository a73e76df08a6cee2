"""``BENCHMARK.json`` keeps to the benchmark's contract, and every
name in it finds its files."""

import json
import re

import pytest

from weavebench import cells

SPEC = cells.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert SPEC["paths"] == ["weavebench"]
    assert all(_line(w) for w in SPEC["command"])


def test_configs():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and c["file"].startswith("weavebench/")
        cfg = json.loads((cells.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and "guarantees" in cfg
    assert len({c["source"] for c in SPEC["configs"]}) == \
        len(SPEC["configs"])


def test_workloads():
    names = {c["name"] for c in SPEC["configs"]}
    seen = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        cell = cells.resolve(w["name"])
        assert callable(cells.entry_class(cell["mix"]))
    assert {w["config"] for w in SPEC["workloads"]} == names


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cell_names = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", [])) <= cell_names
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
        assert callable(cells.metric_reader(m["name"]))
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) \
        == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_a_per_layer_metric(name):
    assert cells.resolve(name)["per_layer"]


def _e2e_of(cell):
    return {m["name"] for m in SPEC["end_to_end"]
            if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_and_another_end_to_end_metric(name):
    e2e = _e2e_of(name)
    assert "setup_s" in e2e and len(e2e) >= 2
    # each split quantity is reported once a cell
    assert len({cells.quantity(m) for m in e2e}) == len(e2e)


def test_each_per_layer_metric_moves_what_its_cells_report():
    for m in SPEC["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in _e2e_of(cell), (m["name"], cell)
