"""The port's program spans inside the v5 wave, on CPU tensors.

``cause_tpu_torch.obs.core`` turns a span live while obs is on or while
a ``torch.profiler`` records. A live span opens a ``record_function``
range of its name under the profiler, takes its start and end from one
clock (epoch ns), and, on a CUDA tensor's path, times its work on the
device with CUDA events resolved when the ring is read. The v5 kernel
records ``v5`` with ``v5.A`` ... ``v5.F``; each host read of a device
value on the wave's path records ``v5.sync``; the B1-B3 and A1
dispatchers record ``kernel.b1`` ... ``kernel.b3`` and ``kernel.a1``
with the call's form, shapes and contract bytes; ``mesh.replica_digest``
records ``replica.digest``.
Off, a wave records nothing and ``span()`` is the shared no-op.
"""

import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen, obs
from cause_tpu_torch.obs import core
from cause_tpu_torch.parallel.mesh import replica_digest
from cause_tpu_torch.weaver import torchw5, torchw5f, torchwd
from cause_tpu_torch.weaver.bitonic import sort_pairs
from cause_tpu_torch.weaver.euler import euler_walk
from cause_tpu_torch.weaver.fphase import fphase_expand

PHASES = [f"v5.{x}" for x in "ABCDEF"]


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for k in ("CAUSE_TPU_OBS", "CAUSE_TPU_OBS_OUT", "CAUSE_TPU_OBS_RING"):
        monkeypatch.delenv(k, raising=False)
    before = ct.default_device()
    ct.use_device("cpu")
    obs.reset()
    yield
    obs.reset()
    ct.use_device(before)


@pytest.fixture(scope="module")
def wave():
    """A small batch of pairs with hides (so the host walk steps) on
    the CPU: the v5 lanes in ``LANE_KEYS5`` order and the budget."""
    batch = benchgen.batched_pair_lanes(n_replicas=3, n_base=30, n_div=8,
                                        capacity=64, hide_every=3)
    v5 = benchgen.batched_v5_inputs(batch, 64)
    u = benchgen.v5_token_budget(v5)
    lanes = benchgen.lanes_from_numpy(v5, "cpu")
    return [lanes[k] for k in benchgen.LANE_KEYS5], u


def run_v5(wave, **kw):
    args, u = wave
    return torchw5.batched_merge_weave_v5(*args, u_max=u, k_max=u,
                                          device="cpu", **kw)


def spans(name=None):
    return [e for e in obs.events() if e.get("ev") == "span"
            and (name is None or e["name"] == name)]


def profiled_wave(wave):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_v5(wave)
    return prof


def test_v5_records_its_phases_in_order_under_the_profiler(wave):
    prof = profiled_wave(wave)
    (v5,) = spans("v5")
    phases = sorted((e for e in spans() if e["name"] in PHASES),
                    key=lambda e: e["ts_ns"])
    assert [e["name"] for e in phases] == PHASES
    assert all(e["parent"] == v5["id"] and e["depth"] == v5["depth"] + 1
               for e in phases)
    assert all(a["end_ns"] <= b["ts_ns"] for a, b in zip(phases,
                                                         phases[1:]))
    assert v5["ts_ns"] <= phases[0]["ts_ns"]
    assert phases[-1]["end_ns"] <= v5["end_ns"]
    args, u = wave
    assert v5["attrs"] == {"rows": 3, "lanes": args[0].shape[1],
                           "u_max": u, "k_max": u}
    # each is a range of the profiler's own trace, by name
    ranges = [e.name for e in prof.events()]
    for name in ["v5"] + PHASES:
        assert ranges.count(name) == 1, name
    assert all(e.get("profiled") for e in spans())


def test_kernel_calls_sit_in_their_phases(wave):
    obs.configure(enabled=True)
    run_v5(wave)
    by_id = {e["id"]: e["name"] for e in spans()}
    where = {}
    for e in spans():
        if e["name"].startswith("kernel."):
            where.setdefault(e["name"], []).append(by_id[e["parent"]])
    assert where == {"kernel.b1": ["v5.A", "v5.C", "v5.E", "v5.E", "v5.F",
                                   "v5.F"],
                     "kernel.b2": ["v5.E"], "kernel.b3": ["v5.F"],
                     "kernel.a1": ["v5.A"]}


def _record(call):
    obs.configure(enabled=True)
    out = call()
    (rec,) = [e for e in spans() if e["name"].startswith("kernel.")]
    return out, rec


def test_b1_span_holds_the_calls_contract():
    ops = tuple(torch.randint(-50, 50, (4, 37), dtype=torch.int32)
                for _ in range(3))
    out, rec = _record(lambda: sort_pairs(ops, num_keys=2))
    assert rec["name"] == "kernel.b1"
    assert rec["attrs"] == {"rows": 4, "lanes": 37, "operands": 3,
                            "keys": 2, "form": "plain",
                            "bytes": sum(x.nbytes for x in ops + out)}
    assert rec["attrs"]["bytes"] == 2 * 3 * 4 * 37 * 4


def test_b2_span_holds_the_calls_contract():
    B, K = 2, 5
    parent = torch.tensor([[-1, 0, 0, 1, -1]] * B, dtype=torch.int32)
    fc = torch.tensor([[1, 3, -1, -1, -1]] * B, dtype=torch.int32)
    ns = torch.tensor([[-1, 2, -1, -1, -1]] * B, dtype=torch.int32)
    w = torch.tensor([[1, 2, 3, 4, 0]] * B, dtype=torch.int32)
    base, rec = _record(lambda: euler_walk(fc, ns, parent, w))
    assert rec["name"] == "kernel.b2"
    assert rec["attrs"] == {"rows": B, "lanes": K, "operands": 4, "keys": 0,
                            "form": "plain", "bytes": 5 * B * K * 4}
    assert rec["attrs"]["bytes"] == sum(
        x.nbytes for x in (fc, ns, parent, w, base))


def test_b3_span_holds_the_calls_contract(wave):
    obs.configure(enabled=True)
    run_v5(wave)
    (rec,) = spans("kernel.b3")
    args, u = wave
    B, N = args[0].shape
    S = args[10].shape[1]
    # in: lk, tb_l [B, U]; cs, ce [B, S]; vclass, seg, flags [B, N]
    # (int32); out: rank (int32) and visibility (bool) [B, N]
    assert rec["attrs"] == {"rows": B, "lanes": N, "operands": 7, "keys": 0,
                            "form": "plain",
                            "bytes": 4 * B * (2 * u + 2 * S + 3 * N)
                            + 5 * B * N}


def test_a1_span_holds_the_calls_contract(wave):
    obs.configure(enabled=True)
    run_v5(wave)
    (rec,) = spans("kernel.a1")
    args, _u = wave
    B, N = args[0].shape
    S = args[10].shape[1]
    # in: the sort's three and five int32 tables, three bool tables, and
    # four lanes a segment; out: three int32 and five bool [B, S]
    assert rec["attrs"] == {"rows": B, "segments": S, "lanes": N,
                            "form": "plain",
                            "bytes": B * S * (8 * 4 + 3 + 4 * 4 + 3 * 4
                                              + 5)}


def test_sync_fires_once_per_walk_test(wave):
    """``v5.sync`` wraps each test of phase D's host walk: as many as the
    host reads the profiler sees inside ``v5.D``, the walk's iterations
    plus the test that ends it, in order."""
    prof = profiled_wave(wave)
    syncs = spans("v5.sync")
    (d,) = spans("v5.D")
    assert {e["parent"] for e in syncs} == {d["id"]}
    assert [e["attrs"] for e in syncs] == [
        {"site": "v5.walk", "step": i} for i in range(len(syncs))]
    evs = prof.events()
    (rng,) = [e for e in evs if e.name == "v5.D"]
    reads = [e for e in evs if e.name == "aten::is_nonzero"
             and rng.time_range.start <= e.time_range.start
             <= rng.time_range.end]
    assert len(syncs) == len(reads) >= 2  # the walk stepped


def test_v5f_and_the_splice_record_their_host_waits(wave):
    obs.configure(enabled=True)
    args, u = wave
    torchw5f.batched_merge_weave_v5f(*args, u_max=u, k_max=u, device="cpu")
    names = [e["name"] for e in spans()]
    assert "v5" not in names and {"v5.A", "v5.B"} <= set(names)
    sites = {e["attrs"]["site"] for e in spans("v5.sync")}
    assert sites == {"v5f.walk"}
    obs.reset()
    obs.configure(enabled=True)
    B, cap, wcap = 2, 8, 4
    rank = torch.full((B, 2 * cap), 2 * cap, dtype=torch.int32)
    vis = torch.zeros((B, 2 * cap), dtype=torch.bool)
    rank_w = torch.arange(2 * wcap, dtype=torch.int32).repeat(B, 1)
    vis_w = torch.ones((B, 2 * wcap), dtype=torch.bool)
    torchwd.splice_ranks(rank, vis, rank_w, vis_w, [[2, 3], [1, 1]],
                         [[2, 1], [3, 0]], [5, 6])
    assert [e["attrs"] for e in spans("v5.sync")] == [
        {"site": "splice", "step": 0}, {"site": "splice", "step": 1}]


def test_digest_span_and_a_full_wave(wave):
    obs.configure(enabled=True)
    args, u = wave
    torchwd.batched_weave_digest(*args, u_max=u, k_max=u, device="cpu")
    names = [e["name"] for e in spans() if e["depth"] == 0]
    assert names == ["v5", "replica.digest"]
    (dig,) = spans("replica.digest")
    assert dig["attrs"] == {"rows": 3, "lanes": args[0].shape[1]}
    obs.reset()
    obs.configure(enabled=True)
    r = torch.tensor([0, 1, 2], dtype=torch.int32)
    replica_digest(r, r, r, r > 0)
    assert spans("replica.digest")[0]["attrs"] == {"rows": 1, "lanes": 3}


def test_off_a_wave_records_nothing(wave):
    assert core._NULL_SPAN is obs.span("v5", on=wave[0][0], rows=1)
    assert not obs.span("x").live
    run_v5(wave)
    args, u = wave
    torchwd.batched_weave_digest(*args, u_max=u, k_max=u, device="cpu")
    st = core._resolve_state()
    assert obs.events() == [] and not st.pending


def test_stopping_the_profiler_turns_the_spans_off(wave):
    profiled_wave(wave)
    n = len(obs.events())
    assert n > 0 and not obs.enabled()
    assert obs.span("after") is core._NULL_SPAN
    run_v5(wave)
    assert len(obs.events()) == n


def test_a_stage_prefix_records_the_phases_it_runs(wave):
    obs.configure(enabled=True)
    ck = run_v5(wave, stage="C")
    assert ck.shape == (3,)
    names = {e["name"] for e in spans()}
    assert {"v5", "v5.A", "v5.B", "v5.C"} <= names
    assert not names & {"v5.D", "v5.E", "v5.F"}


def test_a_record_takes_start_and_end_from_one_clock():
    obs.configure(enabled=True)
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("clocked", k=1):
            time.sleep(0.002)
    after = time.time_ns()
    (rec,) = spans("clocked")
    assert before <= rec["ts_ns"] < rec["end_ns"] <= after
    assert rec["ts_us"] == rec["ts_ns"] // 1000
    assert rec["dur_us"] == (rec["end_ns"] - rec["ts_ns"]) // 1000 >= 2000
    assert "dev_us" not in rec and rec["profiled"]
    # the profiler counts its trace from the same epoch clock: the
    # span's range lies inside the record's interval
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (rng,) = [e for e in prof.events() if e.name == "clocked"]
    start = t0 + rng.time_range.start * 1000
    end = t0 + rng.time_range.end * 1000
    assert rec["ts_ns"] - 1e5 <= start <= end <= rec["end_ns"] + 1e5


def test_obs_on_streams_spans_outside_a_profiler(tmp_path):
    side = tmp_path / "s.jsonl"
    obs.configure(enabled=True, out=str(side))
    with obs.span("plain", a=1) as sp:
        assert sp.live
    (rec,) = spans("plain")
    assert "profiled" not in rec and "dev_us" not in rec
    lines = [json.loads(x) for x in side.read_text().splitlines()]
    assert [x["name"] for x in lines] == ["plain"]


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: done once ``query`` or
    ``synchronize`` has been allowed; 1.5 ms apart."""

    made = 0
    synced = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.done = False

    def record(self, stream=None):
        self.done = False
        self.stream = stream

    def query(self):
        return self.done

    def synchronize(self):
        _FakeEvent.synced += 1
        self.done = True

    def elapsed_time(self, end):
        return 1.5


class _FakeCuda:
    Event = _FakeEvent

    @staticmethod
    def current_stream(dev):
        return ("stream", dev)


def test_device_interval_is_resolved_when_the_ring_is_read(monkeypatch,
                                                          tmp_path):
    """On a CUDA tensor's path a live span records a timing event at
    enter and at exit, never waits inside the span, and gets ``dev_us``
    when the ring is read; the sink has the record once it is
    resolved."""
    monkeypatch.setattr(torch, "cuda", _FakeCuda)
    cuda = torch.device("cuda", 0)
    side = tmp_path / "s.jsonl"
    obs.configure(enabled=True, out=str(side))
    _FakeEvent.made = _FakeEvent.synced = 0
    with obs.span("on.card", on=cuda):
        pass
    st = core._resolve_state()
    assert _FakeEvent.made == 2 and _FakeEvent.synced == 0
    assert len(st.pending) == 1 and not side.exists()
    assert "dev_us" not in st.ring[-1]
    (rec,) = spans("on.card")
    assert rec["dev_us"] == 1500.0 and not st.pending
    assert [json.loads(x)["dev_us"] for x in
            side.read_text().splitlines()] == [1500.0]
    with obs.span("again", on=cuda):
        pass
    obs.flush()
    assert _FakeEvent.made == 4 and spans("again")[0]["dev_us"] == 1500.0
    assert _FakeEvent.synced == 2


def test_a_failing_span_keeps_no_device_interval(monkeypatch):
    monkeypatch.setattr(torch, "cuda", _FakeCuda)
    obs.configure(enabled=True)
    with pytest.raises(KeyError):
        with obs.span("boom", on=torch.device("cuda", 0)):
            raise KeyError("x")
    st = core._resolve_state()
    (rec,) = spans("boom")
    assert rec["error"] == "KeyError" and "dev_us" not in rec
    assert not st.pending


def test_records_stamp_the_pid_of_the_process_that_made_them():
    """The pid is read once a process, and again in a forked child (a
    fresh interpreter with no other thread forks, so the fork is
    safe)."""
    import os
    import subprocess
    import sys

    code = (
        "import json, os\n"
        "from cause_tpu_torch.obs import core\n"
        "core.configure(enabled=True)\n"
        "with core.span('parent'):\n"
        "    pass\n"
        "r, w = os.pipe()\n"
        "pid = os.fork()\n"
        "if pid == 0:\n"
        "    with core.span('child'):\n"
        "        pass\n"
        "    rec = [e for e in core.events() if e['name'] == 'child'][0]\n"
        "    os.write(w, json.dumps([rec['pid'], os.getpid()]).encode())\n"
        "    os._exit(0)\n"
        "os.close(w)\n"
        "child = json.loads(os.read(r, 200).decode())\n"
        "os.waitpid(pid, 0)\n"
        "parent = [e['pid'] for e in core.events() if e['name'] == 'parent']\n"
        "print(json.dumps([child, parent, os.getpid()]))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CAUSE_TPU_")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    (child_pid, child_own), parent, own = json.loads(
        out.stdout.splitlines()[-1])
    assert child_pid == child_own != own and parent == [own]
