"""The port's boundaries: what it imports, and where it refuses to run.

- No module of ``cause_tpu_torch`` and not ``chip_smoke.py`` imports JAX
  or anything of the JAX package (``cause_tpu``), not even a module of
  it that is JAX-free: the port keeps its own copies.
- Without a CUDA card, every device entry point called without
  ``device="cpu"`` raises — the batched programs, the waves, the
  session, the routes that reach the device through a base, a sync
  round, a compaction or a load, and the serving plane (a tenant's
  first wave, a service or residency restore, the bucket dispatch), and
  the benchmark CLI's device configs (5 and 6) —
  and the kernel wrappers refuse CPU tensors: nothing carries on
  quietly on the CPU. The serving plane's host side (admission, the
  journal, the controller, the scrubber, the wire, the native weaver)
  holds no tensor code: its modules import no torch themselves, and
  neither does the package facade, whose device names load torch on
  first use.
- The kernels are built and loaded only on first launch, never at
  import time, and each wrapper counts only its own launches.
- Telemetry (``obs``): off, it records nothing, keeps no registry
  state, reads no environment variable after its one-time resolution
  and changes no output; its new device entry points (``devprof``'s
  samplers, a telemetry-on ``SyncService``) follow the no-card rule; its host modules hold no tensor code; the
  cost model's dispatch floor is the serving controller's.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as tbench
from cause_tpu_torch import kernels
from cause_tpu_torch.weaver import befuse, bitonic, euler, fphase, segorder

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "cause_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "cause_tpu")


def forbidden_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_cause_tpu(path):
    assert forbidden_imports(path) == []


def test_import_checker_catches_each_form(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax\nimport jax.numpy as jnp\n"
                   "from cause_tpu import clist\nfrom cause_tpu.weaver "
                   "import jaxw5\nimport cause_tpu.ids\n"
                   "from cause_tpu_torch import ids\nfrom . import util\n")
    assert forbidden_imports(src) == ["jax", "jax.numpy", "cause_tpu",
                                      "cause_tpu.weaver", "cause_tpu.ids"]


@pytest.fixture
def no_card():
    """Run only where there is no card (decided here, never at import),
    with the package default device back at its "cuda" default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    before = ct.default_device()
    ct.use_device("cuda")
    yield
    ct.use_device(before)


def _small_v5():
    batch = tbench.batched_pair_lanes(2, 20, 6, 64, hide_every=3)
    v5 = tbench.batched_v5_inputs(batch, 64)
    return v5, tbench.v5_token_budget(v5)


def test_device_entry_points_raise_without_cuda(no_card):
    v5, u = _small_v5()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbench.lanes_from_numpy(v5)
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    args = [lanes[k] for k in tbench.LANE_KEYS5]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ct.batched_merge_weave_v5(*args, u_max=u, k_max=u)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ct.batched_weave_digest(*args, u_max=u, k_max=u)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ct.batched_merge_weave_v5f(*args, u_max=u, k_max=u)
    # with device="cpu" the same calls run
    r, v, cf, ov = ct.batched_merge_weave_v5(*args, u_max=u, k_max=u,
                                             device="cpu")
    assert r.device.type == "cpu" and not ov.any()


def test_benchmark_device_configs_raise_without_cuda(no_card):
    """The benchmark CLI's device configs (5: the batched merge, 6: the
    map-fleet wave) run on the package default and refuse without a
    card; asked for the CPU, they run."""
    from cause_tpu_torch import benchmarks

    tiny5 = dict(n_replicas=2, n_base=24, n_div=8, cap=64, reps=1)
    tiny6 = dict(n_pairs=2, n_keys=4, edits=2, reps=1)
    for kernel in ("v5", "v4"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            benchmarks.config5_batched_merge(kernel=kernel, **tiny5)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            benchmarks.config6_map_fleet(kernel=kernel, **tiny6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        benchmarks.main(["-c", "5"])
    assert benchmarks.config5_batched_merge(device="cpu", **tiny5)["value"] > 0
    assert benchmarks.config6_map_fleet(device="cpu", **tiny6)["value"] > 0


def test_handle_paths_follow_the_package_default(no_card):
    a = ct.clist("x", "y")
    a = ct.CausalList(a.ct.evolve(weaver="torch"))
    b = ct.CausalList(a.ct.evolve(site_id=ct.new_site_id())).conj("z")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ct.merge_wave([(a, b)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        a.merge(b)
    ct.use_device("cpu")
    assert ct.merge_wave([(a, b)]).merged(0).causal_to_edn() == [
        "x", "y", "z"]
    assert a.merge(b).causal_to_edn() == ["x", "y", "z"]


def test_map_paths_follow_the_package_default(no_card):
    """The map wave, the ``weaver="torch"`` map reweave and the map merge
    refuse without a card unless asked for the CPU."""
    from cause_tpu_torch.weaver import mapw, torchw

    a = ct.cmap("x", 1, weaver="torch")
    b = ct.CausalMap(a.ct.evolve(site_id=ct.new_site_id())).assoc("y", 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ct.merge_map_wave([(a, b)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torchw.refresh_map_weave(b.ct)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        a.merge(b)
    lanes, meta = mapw.pair_rows([(a.ct.nodes, b.ct.nodes)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mapw.batched_merge_map_weave_v5(lanes, meta["capacity"])
    assert ct.merge_map_wave([(a, b)], device="cpu").merged(0) \
        .causal_to_edn() == {"x": 1, "y": 2}
    assert torchw.refresh_map_weave(b.ct, device="cpu").weave == b.ct.weave
    ct.use_device("cpu")
    assert a.merge(b).causal_to_edn() == {"x": 1, "y": 2}


def test_base_sync_and_compaction_follow_the_package_default(no_card):
    """The routes that reach the device through a base, a sync round, a
    compaction and a load refuse without a card unless asked for the
    CPU: ``sync_pair`` and ``sync_base_pair`` between ``weaver="torch"``
    replicas, ``compact`` (its reweave), and ``loads`` of a
    ``weaver="torch"`` base (every collection reweaves)."""
    ct.use_device("cpu")
    cb = ct.transact(ct.base(weaver="torch"), [[None, None, {
        ct.K("l"): list("abcd"), ct.K("s"): {"x"}}]])
    ra = ct.CausalBase(cb.cb.evolve(site_id="siteA________"))
    rb = ct.CausalBase(cb.cb.evolve(site_id="siteB________"))
    lu = next(u for u, h in cb.cb.collections.items()
              if isinstance(h, ct.CausalList))
    ra = ct.transact(ra, [[lu, ct.root_id, "A"]])
    rb = ct.transact(rb, [[lu, ct.root_id, "B"]])
    la, lb = ct.get_collection(ra, lu), ct.get_collection(rb, lu)
    hidden = la.append(list(la)[-1][0], ct.hide)
    text = ct.dumps(ra)
    ct.use_device("cuda")
    for call in (lambda: ct.sync_pair(la, lb),
                 lambda: ct.sync_base_pair(ra, rb),
                 lambda: ct.compact(hidden),
                 lambda: ct.loads(text)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    ct.use_device("cpu")
    a2, b2 = ct.sync_pair(la, lb)
    assert a2.ct.weave == b2.ct.weave
    sa, sb = ct.sync_base_pair(ra, rb)
    assert sa.causal_to_edn() == sb.causal_to_edn()
    assert ct.compact(hidden).causal_to_edn() == hidden.causal_to_edn()
    assert ct.loads(text).causal_to_edn() == ra.causal_to_edn()


def test_serving_plane_follows_the_package_default(no_card, tmp_path):
    """The serving plane's device entry points refuse without a card
    unless the CPU was asked for: ``SyncService.add_tenant`` (its first
    wave), ``SyncService.restore`` (every tenant's session),
    ``ResidencyManager.get`` of a spilled tenant (a session restore) and
    ``BatchScheduler.wave_fleet`` (the bucket dispatch)."""
    from cause_tpu_torch.serve import (BatchScheduler, IngestJournal,
                                       IngestQueue, ResidencyManager,
                                       SyncService)

    def pair(tag):
        b = ct.CausalList(ct.clist(weaver="torch").ct.evolve(
            site_id=f"s{tag}BASE000000"))
        b = b.extend(["w"] * 12)
        return (ct.CausalList(b.ct.evolve(site_id=f"s{tag}A0000000000"))
                .conj("A"),
                ct.CausalList(b.ct.evolve(site_id=f"s{tag}B0000000000"))
                .conj("B"))

    def service(root):
        root.mkdir(exist_ok=True)
        q = IngestQueue(journal=IngestJournal(str(root / "wal.jsonl")))
        return SyncService(q, residency=ResidencyManager(capacity=1),
                           checkpoint_dir=str(root / "ckpt"), d_max=16)

    ct.use_device("cpu")
    svc = service(tmp_path / "one")
    u1 = svc.add_tenant(*pair("P"))
    u2 = svc.add_tenant(*pair("Q"))  # capacity 1: spills u1
    assert svc.residency.spilled() == [u1]
    manifest = svc.drain()
    sess = svc.residency.get(u2)
    a, b = pair("R")
    ct.use_device("cuda")
    for call in (lambda: service(tmp_path / "two").add_tenant(a, b),
                 lambda: SyncService.restore(manifest),
                 lambda: svc.residency.get(u1),
                 lambda: BatchScheduler().wave_fleet({u2: sess})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    ct.use_device("cpu")
    restored = SyncService.restore(manifest)
    assert restored.converged_digest(u1) == svc.converged_digest(u1)
    assert BatchScheduler().wave_fleet({u2: sess})[u2].tolist() == \
        sess._last_digest.tolist()


HOST_ONLY = ["serve/__init__.py", "serve/__main__.py", "serve/ingest.py",
             "serve/wal.py", "serve/controller.py", "serve/scrub.py",
             "net/__init__.py", "net/transport.py", "net/session.py",
             "net/server.py", "native/__init__.py",
             # the wire and ship plane's instruments: they reach the card
             # only through a service's ticks, and their host roles (the
             # journey client, the collectors, the producers) never do
             "journey_smoke.py", "net_soak.py", "ship_smoke.py",
             "ship_soak.py"]


@pytest.mark.parametrize("rel", HOST_ONLY)
def test_host_side_serving_modules_hold_no_tensor_code(rel):
    """Admission, the journal, the controller, the scrubber, the wire
    and the native weaver are host work: none of them imports torch
    itself, so the ingest and connection threads reach the card only
    through the ticking thread's session calls. This reads each
    module's own imports; ``import cause_tpu_torch`` loads torch only
    when a device name of the facade is first used."""
    tree = ast.parse((ROOT / "cause_tpu_torch" / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if n.split(".")[0] == "torch"]


def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing():
    kernels.reset_launches()
    x = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bitonic.sort_pairs_cuda((x, x), num_keys=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        euler.euler_walk_cuda(x, x, x, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fphase.fphase_expand_cuda(x, x, x, x, x, x, x)
    p = torch.zeros((2, 128), dtype=torch.int32)
    s8 = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        befuse.k1_sort_redirect_cuda(*(p,) * 8, U=128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        befuse.k2_runs_cuda(*(p,) * 6, U=128, k_max=128, Kp=128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        befuse.k4_rank_kills_cuda(*(p,) * 11, s8, U=128, k_max=128, N=4)
    b = torch.zeros((2, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA tensors"):
        segorder.seg_order_cuda(*(x,) * 11, b, b, b, x)
    # on CPU tensors the dispatching wrappers take the plain versions
    bitonic.sort_pairs((x, x), num_keys=1)
    euler.euler_walk(torch.full_like(x, -1), torch.full_like(x, -1),
                     torch.full_like(x, -1), x)
    befuse.k1_sort_redirect(*(p,) * 8, U=128)
    assert kernels.launches == {name: 0 for name in kernels.SOURCES}
    assert set(kernels.launches) == {
        "sort", "euler_walk", "fphase", "k1_sort_redirect", "k2_runs",
        "k4_rank_kills", "seg_order"}


@pytest.mark.parametrize("bad, err", [
    (lambda x: (x.long(), x), TypeError),          # not int32
    (lambda x: (x, x[:, :2]), ValueError),         # ragged operands
    (lambda x: (x.t(), x.t()), ValueError),        # not contiguous
    (lambda x: (x,) * 10, ValueError),             # too many operands
])
def test_sort_wrapper_checks_its_inputs(bad, err):
    x = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(err):
        bitonic.sort_pairs_cuda(bad(x), num_keys=1)


def _p(width=128, dtype=torch.int32):
    return torch.zeros((2, width), dtype=dtype)


@pytest.mark.parametrize("call, err", [
    (lambda: befuse.k1_sort_redirect_cuda(
        _p(dtype=torch.int64), *(_p(),) * 7, U=128), TypeError),
    (lambda: befuse.k1_sort_redirect_cuda(
        *(_p(),) * 7, _p(64), U=128), ValueError),        # ragged
    (lambda: befuse.k1_sort_redirect_cuda(
        *(_p(96),) * 8, U=96), ValueError),               # not a power of 2
    (lambda: befuse.k2_runs_cuda(
        *(_p(),) * 6, U=128, k_max=256, Kp=256), ValueError),  # Kp > P
    (lambda: befuse.k4_rank_kills_cuda(
        *(_p(),) * 11, _p(4), U=128, k_max=128, N=4), ValueError),
])
def test_fused_kernel_wrappers_check_their_inputs(call, err):
    with pytest.raises(err):
        call()


def test_nothing_is_built_at_import():
    """Importing the package needs neither nvcc nor a card."""
    assert kernels._LIBS == {} or torch.cuda.is_available()
    assert set(kernels.SOURCES) == {"sort", "euler_walk", "fphase",
                                    "k1_sort_redirect", "k2_runs",
                                    "k4_rank_kills", "seg_order"}
    for src in kernels.SOURCES.values():
        assert (kernels.CSRC / src).exists()


def test_lanes_from_numpy_fixes_dtypes():
    v5, _ = _small_v5()
    v5 = {k: (v.astype(np.int64) if v.dtype == np.int32 else v)
          for k, v in v5.items()}
    lanes = tbench.lanes_from_numpy(v5, "cpu")
    for k in tbench.LANE_KEYS5:
        want = torch.bool if k in tbench.V5_BOOL_KEYS else torch.int32
        assert lanes[k].dtype == want, k
        assert lanes[k].is_contiguous()


# ------------------------------------------------------------ telemetry

OBS_HOST = ["obs/__init__.py", "obs/__main__.py", "obs/core.py",
            "obs/perfetto.py", "obs/semantic.py", "obs/xtrace.py",
            "obs/lag.py", "obs/journey.py", "obs/fleet.py",
            "obs/costmodel.py", "obs/ledger.py", "obs/live.py",
            "obs/ship.py", "obs/collector.py", "obs/watch.py"]


@pytest.mark.parametrize("rel", OBS_HOST)
def test_obs_host_modules_hold_no_tensor_code(rel):
    """The telemetry substrate is host bookkeeping: only ``devprof``
    (the allocator's statistics) touches torch, and imports it inside
    its functions; ``core`` reads the profiler's state and makes CUDA
    events only where torch is already loaded. The uplink's
    pump thread, the collector's and the dashboard's threads never
    reach the card."""
    tree = ast.parse((ROOT / "cause_tpu_torch" / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if n.split(".")[0] == "torch"]


def test_costmodel_floor_is_the_controllers():
    from cause_tpu_torch.obs import costmodel
    from cause_tpu_torch.serve import controller

    assert costmodel.DISPATCH_FLOOR_MS is controller.DISPATCH_FLOOR_MS
    assert controller.BatchController().floor_ms \
        == costmodel.DISPATCH_FLOOR_MS


@pytest.fixture
def obs_clean(monkeypatch):
    from cause_tpu_torch import obs
    from cause_tpu_torch.obs import costmodel, devprof, semantic

    for k in ("CAUSE_TPU_OBS", "CAUSE_TPU_OBS_OUT", "CAUSE_TPU_OBS_RING",
              "CAUSE_TPU_LAG_SLO_MS"):
        monkeypatch.delenv(k, raising=False)
    for m in (obs, semantic, costmodel, devprof):
        m.reset()
    yield obs
    for m in (obs, semantic, costmodel, devprof):
        m.reset()


def test_obs_entry_points_raise_without_cuda(no_card, obs_clean, tmp_path):
    """``devprof``'s samplers and a telemetry-on service default to
    CUDA and refuse without a card; on the CPU, asked for, they run."""
    from cause_tpu_torch.obs import devprof
    from cause_tpu_torch.serve import IngestQueue, SyncService

    obs_clean.configure(enabled=True)
    calls = (
        lambda: devprof.sample_device_memory("wave"),
        lambda: devprof.profiled(lambda: 1, pipeline="v5"),
        lambda: SyncService(IngestQueue()).add_tenant(
            *_serve_pair("T")),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert devprof.sample_device_memory("wave", "cpu") == {}
    ct.use_device("cpu")
    svc = SyncService(IngestQueue())
    svc.add_tenant(*_serve_pair("U"))
    svc.close()


def _serve_pair(tag):
    b = ct.CausalList(ct.clist(weaver="torch").ct.evolve(
        site_id=f"s{tag}BASE000000", uuid=f"hyg-{tag}"))
    b = b.extend(["w"] * 12)
    return (ct.CausalList(b.ct.evolve(site_id=f"s{tag}A0000000000"))
            .conj("A"),
            ct.CausalList(b.ct.evolve(site_id=f"s{tag}B0000000000"))
            .conj("B"))


def test_obs_off_records_nothing_reads_nothing_changes_nothing(
        obs_clean, tmp_path, monkeypatch):
    """Every instrumented path with telemetry off: no event, no
    counter, no registry state anywhere in ``obs``, no environment read
    of a telemetry variable once the state resolved, and the same
    outputs as the same paths with telemetry on."""
    import os

    from cause_tpu_torch.obs import core, costmodel, devprof, lag
    from cause_tpu_torch.obs import semantic, xtrace
    from cause_tpu_torch.serve import IngestQueue, SyncService

    ct.use_device("cpu")

    def run():
        base = ct.CausalList(ct.clist(weaver="torch").ct.evolve(
            site_id="sHYGBASE00000", uuid="hyg-doc")).extend(["w"] * 20)
        pairs = [(ct.CausalList(base.ct.evolve(site_id=f"sHA{i}000000000"))
                  .conj("a"),
                  ct.CausalList(base.ct.evolve(site_id=f"sHB{i}000000000"))
                  .conj("b")) for i in range(3)]
        out = [ct.merge_wave(pairs).digest.tolist()]
        sess = ct.FleetSession(pairs)
        out.append(sess.wave().tolist())
        pairs = [(a.conj("x"), b.conj("y")) for a, b in pairs]
        sess.update(pairs)
        out.append(sess.wave().tolist())
        root = ct.merge_tree([h for p in pairs for h in p])
        out.append(root.ct.weave)
        a2, b2 = ct.sync_pair(*pairs[0])
        out.append(a2.ct.weave)
        svc = SyncService(IngestQueue(), d_max=16)
        uuid = svc.add_tenant(*_serve_pair("H"))
        left, _r = svc.residency.get(uuid).pairs[0]
        l2 = left.conj("z")
        svc.queue.offer(uuid, l2.ct.site_id, ct.serde.encode_node_items(
            ct.sync.delta_nodes(l2, ct.sync.version_vector(left))))
        tick = svc.tick()
        out.append({k: v for k, v in tick.items()
                    if k not in ("wave_dispatches", "t_batch_ms")})
        out.append(svc.converged_digest(uuid))
        svc.close()
        return out, tick

    obs_clean.configure(enabled=False)
    read = []

    class _Tracker(dict):
        def get(self, key, default=None):
            read.append(key)
            return super().get(key, default)

        def __getitem__(self, key):
            read.append(key)
            return super().__getitem__(key)

    monkeypatch.setattr(os, "environ", _Tracker(os.environ))
    off, tick_off = run()
    monkeypatch.undo()
    assert not [k for k in read if k.startswith("CAUSE_TPU_OBS")
                or k in ("CAUSE_TPU_LAG_SLO_MS", "CAUSE_TPU_LEDGER")]
    assert obs_clean.events() == []
    assert obs_clean.counters_snapshot() == {"counters": {}, "gauges": {}}
    assert core._STATE.subscribers == ()
    assert semantic._MON == {} and costmodel._PROGRAMS == {}
    assert costmodel._PENDING_OPS == {} and costmodel._PENDING_BAGS == {}
    assert lag._DOCS == {} and xtrace._OPS == {} and xtrace._LAST == {}
    assert devprof._SEEN == {}
    assert tick_off["wave_dispatches"] == 0
    obs_clean.configure(enabled=True)
    on, tick_on = run()
    assert on == off
    assert tick_on["wave_dispatches"] > 0
