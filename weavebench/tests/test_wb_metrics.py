"""The per-layer readers on canned profiler summaries, and the byte
counts of ``wave_roofline_pct`` for each traffic."""

import importlib

import pytest

from weavebench import cells, trace
from weavebench.tests.small import CELLS, small_cell

PORT = frozenset({"sort_rows_radix_kernel", "euler_walk_kernel",
                  "fphase_row_kernel"})


def _summary():
    # a segment of 100 us holding two waves: kernels, an upload, a
    # copy back, overlapping activities and idle gaps
    device = [
        ("void sort_rows_radix_kernel<8>(SortArgs, int, int)", "kernel",
         8.0, 20.0),
        ("void at::native::vectorized_elementwise_kernel<4, X>(int)",
         "kernel", 15.0, 30.0),
        ("Memcpy HtoD (Pageable -> Device)", "htod", 40.0, 45.0),
        ("euler_walk_kernel(int const*, int)", "kernel", 50.0, 52.0),
        ("void cub::DeviceRadixSortOnesweepKernel<X>(int)", "kernel",
         60.0, 70.0),
        ("Memcpy DtoH (Device -> Pinned)", "dtoh", 95.0, 96.0),
        ("fphase_row_kernel", "kernel", 120.0, 130.0),
    ]
    spans = [("weavebench.entry", 0.0, 50.0), ("weavebench.wait", 50.0,
                                              100.0)]
    ops = [("aten::nonzero", 30.0, 41.0), ("cudaStreamSynchronize", 31.0,
                                           40.0)]
    return {"device": device, "spans": spans, "ops": ops, "t0": 0.0,
            "t1": 100.0, "waves": 2}


def _ctx(**kw):
    ctx = {"trace": _summary(), "entry_ms": [2.0, 4.0],
           "port_launches_per_wave": 8.0, "port_kernels": PORT,
           "wave_bytes": 335_000, "peak_bytes_per_s": 3.35e12}
    ctx.update(kw)
    return ctx


def _read(name, ctx):
    return importlib.import_module(f"weavebench.metrics.{name}").read(ctx)


def test_idle_share_from_intervals():
    s = _summary()
    # busy: [8, 30] + [40, 45] + [50, 52] + [60, 70] + [95, 96] = 40;
    # the last kernel lies outside the segment
    assert trace.busy_us(s) == 40.0
    assert _read("device_idle_pct", _ctx()) == pytest.approx(60.0)
    assert trace.gaps(s) == [(0.0, 8.0), (30.0, 40.0), (45.0, 50.0),
                             (52.0, 60.0), (70.0, 95.0), (96.0, 100.0)]


def test_kernel_and_glue_split():
    ctx = _ctx()
    assert _read("kernel_device_ms", ctx) == pytest.approx(14.0e-3 / 2)
    assert _read("glue_device_ms", ctx) == pytest.approx(25.0e-3 / 2)
    assert _read("glue_launches", ctx) == 1.0
    assert _read("h2d_ms", ctx) == pytest.approx(5.0e-3 / 2)
    assert _read("kernel_launches", ctx) == 8.0
    assert _read("host_call_ms", ctx) == 3.0


def test_roofline_share():
    # 335 kB at 3.35 TB/s is 0.1 us; a wave takes 50 us
    assert _read("wave_roofline_pct", _ctx()) == pytest.approx(0.2)
    assert _read("wave_roofline_pct", _ctx(peak_bytes_per_s=None)) is None


def test_readers_find_nothing_without_a_trace():
    for name in ("h2d_ms", "glue_launches", "glue_device_ms",
                 "kernel_device_ms", "device_idle_pct",
                 "wave_roofline_pct"):
        assert _read(name, _ctx(trace=None)) is None
    assert _read("host_call_ms", _ctx(entry_ms=[])) is None


def test_breakdown_gaps_are_named_by_the_host_span():
    b = trace.breakdown(_summary(), top=3)
    assert b["idle_gaps"][0] == ["weavebench.wait", pytest.approx(25e-6)]
    assert b["idle_gaps"][1] == ["weavebench.entry/cudaStreamSynchronize",
                                 pytest.approx(10e-6)]
    assert b["idle_gaps"][2] == ["weavebench.entry", pytest.approx(8e-6)]
    assert b["device_ops"][0][0].startswith("void at::native")
    assert len(b["device_ops"]) == 3


def test_port_kernel_names_come_from_csrc():
    names = trace.port_kernel_names(cells.ROOT / "cause_tpu_torch" / "csrc")
    assert {"sort_rows_radix_kernel", "euler_walk_kernel",
            "fphase_row_kernel", "sort_rows_cluster"} <= names
    assert trace.is_port_kernel(
        "void sort_rows_radix_kernel<8, 2>(SortArgs, int, int)", names)
    assert trace.is_port_kernel("euler_walk_split_links(int const*)", names)
    assert not trace.is_port_kernel(
        "void at::native::radix_sort_kernel<int>(int)", names)


def test_every_per_layer_metric_has_a_reader():
    for m in cells.load_spec()["per_layer"]:
        assert callable(cells.metric_reader(m["name"]))


@pytest.mark.parametrize("name", CELLS)
def test_wave_bytes(name):
    """What a wave must move: the entry's inputs at their dtypes, plus
    rank (int32), visibility (bool) and the digest (int32) written."""
    import torch

    cell = small_cell(name)
    cfg, mix = cell["config"], cell["mix"]
    e = cells.entry_class(mix)(cfg, mix, 3, torch.device("cpu"))
    e.setup()
    got = e.wave_bytes()
    cap = cfg["capacity"]
    if name == "fleet_converge":
        N = cfg["replicas"] * cap
        S = e.args[0][6].shape[0]
        # 5 int32 lanes + 1 bool; 8 int32 + 2 bool table columns
        # (sg_valid, sg_dense, sg_tail_special: 3 bool, 7 int32)
        want_in = N * (5 * 4 + 1) + S * (7 * 4 + 3)
        assert got == want_in + N * 5 + 4
        return
    B = cfg["documents"]
    N = 2 * cap
    S = e.args[0][6].shape[1]
    assert got == B * N * (5 * 4 + 1) + B * S * (7 * 4 + 3) \
        + B * N * 5 + B * 4
