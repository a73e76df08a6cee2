"""The readers of the program's own spans (``metrics/_spans.py``) on
canned span records and a canned profiler summary, and, on the card,
the phase spans of one north-star dispatch against the dispatch timed
whole."""

import importlib
import statistics

import pytest

from weavebench import cells
from weavebench.metrics import _spans

QUANTITIES = [f"v5_{x}_ms" for x in "abcdef"] + [
    "digest_ms", "host_waits", "host_wait_ms", "b1_roofline_pct",
    "b2_roofline_pct", "b3_roofline_pct"]


def _span(name, i, dev_us=None, host_us=0, **attrs):
    rec = {"ev": "span", "name": name, "id": i, "ts_ns": 1_000 * i,
           "end_ns": 1_000 * i + 1_000 * host_us, "profiled": True}
    if dev_us is not None:
        rec["dev_us"] = dev_us
    if attrs:
        rec["attrs"] = attrs
    return rec


def _records():
    # two waves: phase A 100 and 300 us on the device, three walk tests
    # in one wave and two in the other (host 40 us each), six B1 calls a
    # wave of 1 MB, one B2 call of 64 kB, one B3 call of 2 MB
    out = []
    for w in range(2):
        base = 100 * w
        out.append(_span("v5", base, dev_us=5_000.0))
        out.append(_span("v5.A", base + 1, dev_us=100.0 + 200 * w))
        for x, us in zip("BCDEF", (10.0, 20.0, 30.0, 40.0, 50.0)):
            out.append(_span(f"v5.{x}", base + 2 + "BCDEF".index(x),
                             dev_us=us))
        for k in range(3 - w):
            out.append(_span("v5.sync", base + 10 + k, host_us=40,
                             site="v5.walk", step=k))
        for k in range(6):
            out.append(_span("kernel.b1", base + 20 + k, dev_us=1.0,
                             form="radix", bytes=1_000_000))
        out.append(_span("kernel.b2", base + 30, dev_us=1.0, form="row",
                         bytes=64_000))
        out.append(_span("kernel.b3", base + 31, dev_us=1.0, form="row",
                         bytes=2_000_000))
        out.append(_span("replica.digest", base + 40, dev_us=7.0))
    return out


def _summary():
    # a segment of 1,000 us holding two waves: B1's radix and cluster
    # kernels, B2's split links, B3, and PyTorch's own
    device = [
        ("void sort_rows_radix_kernel<8, 2>(SortArgs, int, int)", "kernel",
         0.0, 300.0),
        ("void sort_rows_cluster<unsigned long, 16, 256>(SortArgs)",
         "kernel", 400.0, 600.0),
        ("euler_walk_split_links(int const*, int)", "kernel", 600.0, 610.0),
        ("void fphase_row_kernel<true>(int const*)", "kernel", 610.0,
         650.0),
        ("void at::native::vectorized_elementwise_kernel<4, X>(int)",
         "kernel", 650.0, 900.0),
        ("Memcpy DtoH (Device -> Pinned)", "dtoh", 950.0, 960.0),
    ]
    return {"device": device, "spans": [], "ops": [], "t0": 0.0,
            "t1": 1_000.0, "waves": 2}


def _ctx(**kw):
    ctx = {"trace": _summary(), "entry_ms": [2.0], "port_launches_per_wave":
           8.0, "port_kernels": frozenset(), "wave_bytes": 1,
           "peak_bytes_per_s": 4.0e12, "spans": _records()}
    ctx.update(kw)
    return ctx


def _read(name, ctx):
    return importlib.import_module(f"weavebench.metrics.{name}").read(ctx)


def test_phase_and_digest_ms_are_device_time_a_wave():
    ctx = _ctx()
    assert _read("v5_a_ms", ctx) == pytest.approx(0.2)
    for x, us in zip("bcdef", (10.0, 20.0, 30.0, 40.0, 50.0)):
        assert _read(f"v5_{x}_ms", ctx) == pytest.approx(us * 1e-3)
    assert _read("digest_ms", ctx) == pytest.approx(7e-3)


def test_host_waits_and_their_host_time_a_wave():
    ctx = _ctx()
    assert _read("host_waits", ctx) == pytest.approx(2.5)
    assert _read("host_wait_ms", ctx) == pytest.approx(5 * 40e-3 / 2)
    # waves without a wait read 0, not nothing
    quiet = [r for r in _records() if r["name"] != "v5.sync"]
    assert _read("host_waits", _ctx(spans=quiet)) == 0.0


def test_roofline_shares_of_each_kernel_library():
    ctx = _ctx()
    # B1: 6 MB a wave at 4 TB/s is 1.5 us; its kernels 500 us over two
    # waves, 250 us a wave
    assert _read("b1_roofline_pct", ctx) == pytest.approx(100 * 1.5 / 250)
    # B2: 64 kB is 0.016 us over 5 us a wave; B3: 2 MB, 0.5 over 20
    assert _read("b2_roofline_pct", ctx) == pytest.approx(100 * 0.016 / 5)
    assert _read("b3_roofline_pct", ctx) == pytest.approx(100 * 0.5 / 20)
    assert _read("b1_roofline_pct", _ctx(peak_bytes_per_s=None)) is None
    no_b3 = dict(_summary(), device=_summary()["device"][:3])
    assert _read("b3_roofline_pct", _ctx(trace=no_b3)) is None


def test_readers_find_nothing_without_the_programs_spans():
    """A program that records no span (an older checkout), or a run
    without a trace, leaves every reader nothing to read."""
    for name in QUANTITIES:
        assert _read(name, _ctx(spans=[])) is None, name
    no_wave = [r for r in _records() if r["name"] != "v5"]
    for name in QUANTITIES:
        assert _read(name, _ctx(spans=no_wave)) is None, name
    for name in ("b1_roofline_pct", "b2_roofline_pct", "b3_roofline_pct"):
        assert _read(name, _ctx(trace=None)) is None
    cpu = [{k: v for k, v in r.items() if k != "dev_us"} for r in _records()]
    for name in QUANTITIES[:7]:
        assert _read(name, _ctx(spans=cpu)) is None, name


def test_records_are_the_profiled_spans_of_the_obs_ring():
    from cause_tpu_torch import obs

    obs.reset()
    try:
        obs.configure(enabled=True)
        with obs.span("v5"):
            pass
        obs.event("not.a.span")
        assert _spans.records({}) == []
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            with obs.span("v5"):
                pass
        got = _spans.records({})
        assert [r["name"] for r in got] == ["v5"] and got[0]["profiled"]
    finally:
        obs.reset()


def test_library_kernels_follow_the_includes():
    b1 = _spans.library_kernels("sort")
    assert {"sort_rows_radix_kernel", "sort_rows_cluster",
            "sort_rows_wide_scatter", "sort_rows_kernel"} <= b1
    assert not b1 & {"euler_walk_kernel", "fphase_row_kernel"}
    assert {"euler_walk_kernel", "euler_walk_split_links"} <= \
        _spans.library_kernels("euler_walk")
    assert _spans.library_kernels("fphase") == {"fphase_row_kernel"}


def test_each_quantity_is_split_by_what_sets_the_pace():
    entries = {m["name"]: m for m in cells.load_spec()["per_layer"]}
    for q in QUANTITIES:
        assert entries[q]["workloads"] == ["pairs_full", "fleet_converge"]
        assert entries[q]["moves"] == "docs_merged_per_s"
        assert entries[q + ".card"]["workloads"] == ["pairs_random"]
        assert entries[q + ".card"]["moves"] == "docs_merged_per_s.card"
        assert {k: v for k, v in entries[q].items()
                if k not in ("name", "workloads", "moves")} == \
            {k: v for k, v in entries[q + ".card"].items()
             if k not in ("name", "workloads", "moves")}


@pytest.mark.card
def test_phase_spans_sum_to_the_dispatch_on_the_card(card):
    """One north-star dispatch (``pairs_full``'s first batch): its
    ``v5.A`` ... ``v5.F`` and ``replica.digest`` ``dev_us``, with obs
    on, sum to within 15% of the same dispatch timed whole by CUDA
    events with obs off, the two in turns (medians of 7)."""
    import torch

    from cause_tpu_torch import benchgen, obs
    from cause_tpu_torch.weaver import torchwd
    from weavebench import gen
    from weavebench.entries.common import budget, marshal

    cell = cells.resolve("pairs_full")
    cfg, mix = cell["config"], cell["mix"]
    v5 = marshal(gen.pair_batch(gen.rng_for(2 ** 31 + 11, 0), cfg, mix),
                 cfg["capacity"])
    u = budget(v5)
    lanes = benchgen.lanes_from_numpy(v5, card)
    args = [lanes[k] for k in benchgen.LANE_KEYS5]

    def dispatch():
        return torchwd.batched_weave_digest(*args, u_max=u, k_max=u,
                                            device=card)

    names = [f"v5.{x}" for x in "ABCDEF"] + ["replica.digest"]
    dispatch()
    torch.cuda.synchronize(card)
    sums, whole = [], []
    obs.reset()
    try:
        for _ in range(7):
            obs.configure(enabled=True)
            dispatch()
            got = [e for e in obs.events() if e.get("name") in names]
            obs.reset()
            assert sorted(e["name"] for e in got) == sorted(names)
            sums.append(sum(e["dev_us"] for e in got) * 1e-3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dispatch()
            end.record()
            end.synchronize()
            whole.append(start.elapsed_time(end))
    finally:
        obs.reset()
    s, w = statistics.median(sums), statistics.median(whole)
    assert abs(s - w) <= 0.15 * w, (sums, whole)
