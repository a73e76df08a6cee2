"""The port's replica mesh over spawned gloo ranks, and the rank bodies
the mesh tests run there.

A rank unpickles its body by module, so this module imports the port
only (never jax or ``cause_tpu``): its functions are the bodies, and its
tests are the ones that need no reference.

- The wave over 2 ranks (mirrors ``tests/test_wave.py:121`` and
  ``:160``): each rank builds the same replica pairs (fixed site ids,
  so its interner ranks them alike); ``merge_wave(pairs, mesh)`` gives
  the unsharded wave's digests and every ``merged(i)`` equals
  ``a.merge(b)``; a pair off the device domain falls back, and the 7
  live rows pad to 8 to divide the mesh.
- ``dryrun_multichip(2, device="cpu")``: the multi-device dry run of the
  reference's ``__graft_entry__.py``.
- Two processes, each with its own world-1 gloo mesh, sync one document
  over a socket and agree on its content digest (slow; mirrors
  ``tests/test_distributed.py:114``).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen as t_bench
from cause_tpu_torch.parallel.entry import dryrun_multichip, list_pairs
from cause_tpu_torch.parallel.ranks import run_ranks

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the sharded steps as the mesh tests name them: k_max and kernel of
# sharded_merge_weave, or the v5 pipeline
STEPS = ("v1", "v2", "v3", "v4", "v5", "v5f")


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's device paths on the CPU for each test."""
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def run_step(mod, mesh, name, lanes, v5lanes, u5):
    """Step ``name`` of package ``mod``'s ``parallel.mesh`` over ``mesh``
    (both packages' steps take the same arguments): v2-v4 at a run
    budget of the full row, v5 and v5f at ``u5``."""
    if name == "v5" or name == "v5f":
        return mod.sharded_merge_weave_v5(mesh, v5lanes, u5, u5, name)
    k_max = lanes["hi"].shape[1]
    if name == "v4":
        return mod.sharded_merge_weave_v4(
            mesh, *(lanes[k] for k in t_bench.LANE_KEYS4), k_max)
    if name == "v1":
        k_max = 0
    return mod.sharded_merge_weave(
        mesh, *(lanes[k] for k in t_bench.LANE_KEYS), k_max, name)


def steps_rank(mesh, lanes, v5lanes, u5):
    """Every sharded step on one rank: ``{name: outputs}``."""
    from cause_tpu_torch.parallel import mesh as t_mesh

    return {name: run_step(t_mesh, mesh, name, lanes, v5lanes, u5)
            for name in STEPS}


def wave_pairs(n_pairs, n_base, n_div):
    """``tests/test_wave.py``'s ``make_pairs`` with fixed site ids."""
    return list_pairs(
        n_pairs, n_base,
        lambda p, a: a.extend([f"a{p}.{i}" for i in range(n_div)]),
        lambda p, b: b.extend([f"b{p}.{i}" for i in range(n_div)]))


def wave_rank(mesh):
    """``test_wave.py``'s two mesh cases on one rank: the sharded wave's
    digests beside the unsharded wave's, its fallbacks and digest
    flags, and whether every ``merged(i)`` equals the host merge."""
    out = {}
    plain = wave_pairs(8, 40, 4)
    poisoned = wave_pairs(8, 30, 3)
    a, b = poisoned[3]
    # an id beyond the PackSpec's ts bound: no lane cache, host merge
    big = ((1 << 31) - 1, a.get_site_id(), 0)
    poisoned[3] = (a.insert((big, ct.root_id, "huge-ts")),
                   b.insert((big, ct.root_id, "huge-ts")))
    for name, pairs in (("plain", plain), ("poisoned", poisoned)):
        res = ct.merge_wave(pairs, mesh)
        ref = ct.merge_wave(pairs)
        out[name] = {
            "digest": res.digest, "unsharded": ref.digest,
            "fallback": res.fallback, "digest_valid": res.digest_valid,
            "merged_ok": [ct.causal_to_edn(res.merged(i))
                          == ct.causal_to_edn(x.merge(y))
                          for i, (x, y) in enumerate(pairs)],
        }
    return out


@pytest.fixture(scope="module")
def two_rank_waves():
    return run_ranks(2, wave_rank, device="cpu")


def test_wave_sharded_over_two_gloo_ranks(two_rank_waves):
    r = two_rank_waves["plain"]
    assert r["fallback"] == []
    assert r["digest_valid"].all()
    assert np.array_equal(r["digest"], r["unsharded"])
    assert len(set(r["digest"].tolist())) == 8
    assert all(r["merged_ok"])


def test_wave_over_two_ranks_survives_fallback_shrink(two_rank_waves):
    r = two_rank_waves["poisoned"]
    assert r["fallback"] == [3]
    assert not r["digest_valid"][3] and r["digest_valid"][0]
    valid = r["digest_valid"]
    assert np.array_equal(r["digest"][valid], r["unsharded"][valid])
    assert all(r["merged_ok"])


def test_dryrun_multichip_over_two_gloo_ranks():
    dryrun_multichip(2, device="cpu")


_HOST_PROG = r"""
import sys, socket
sys.path.insert(0, {root!r})

import cause_tpu_torch as ct
from cause_tpu_torch import benchgen, sync
from cause_tpu_torch.collections import clist as c_list
from cause_tpu_torch.collections.clist import CausalList
from cause_tpu_torch.parallel.mesh import make_mesh, sharded_merge_weave_v5
from cause_tpu_torch.parallel.wave import _assemble_rows
from cause_tpu_torch.weaver import lanecache
from cause_tpu_torch.weaver.arrays import next_pow2

ct.use_device("cpu")
host_id = int(sys.argv[1])
port = int(sys.argv[2])

base = CausalList(c_list.new_causal_tree("torch").evolve(
    uuid="shareddoc0000000000xx", site_id="seedsite00000"))
base = base.extend([f"doc{{i}}" for i in range(40)])
base = CausalList(c_list.weave(base.ct))

replicas = []
for r in range(4):
    rep = CausalList(base.ct.evolve(site_id=f"h{{host_id}}r{{r}}{{'_' * 9}}"))
    rep = rep.extend([f"h{{host_id}}.{{r}}.{{i}}" for i in range(3)])
    rep = rep.append(rep.tail_id(), ct.hide)
    replicas.append(rep)

local = replicas[0].merge_many(replicas[1:])
if host_id == 0:
    srv = socket.create_server(("127.0.0.1", port))
    print("LISTENING", flush=True)
    conn, _ = srv.accept()
else:
    import time as _time
    for attempt in range(60):
        try:
            conn = socket.create_connection(("127.0.0.1", port),
                                            timeout=30)
            break
        except OSError:
            _time.sleep(0.5)
    else:
        raise SystemExit("peer never came up")
stream = conn.makefile("rwb")
merged = sync.sync_stream(local, stream)

# this host's own world-1 gloo mesh: the converged tree against the
# shared base through the sharded v5 step, replicated over 4 rows
mesh = make_mesh(device="cpu")
va = lanecache.view_for(merged.ct)
vb = lanecache.view_for(base.ct)
cap = next_pow2(max(va.n, vb.n))
lanes = _assemble_rows([(va, vb)] * 4, cap)
u = benchgen.v5_token_budget(lanes)
rank, visible, overflow, digest, total_vis, n_conf, n_ovf = (
    sharded_merge_weave_v5(mesh, lanes, u_max=u, k_max=u))
assert int(n_ovf) == 0 and int(n_conf) == 0
# the device digest is interner-scoped (per process); the cross-host
# check is the canonical content digest and the visible count
dig = (ct.content_digest(merged), int(total_vis))
print("DIGEST", dig, flush=True)
print("EDN", len(ct.causal_to_edn(merged)), flush=True)
"""


@pytest.mark.slow
def test_two_process_mesh_sync_convergence():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    prog = _HOST_PROG.format(root=_ROOT)

    def spawn(i):
        return subprocess.Popen(
            [sys.executable, "-c", prog, str(i), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    procs = []
    outs = []
    try:
        h0 = spawn(0)
        procs.append(h0)
        first = h0.stdout.readline()
        assert first.strip() == "LISTENING", first
        procs.append(spawn(1))
        for p in procs:
            out, err = p.communicate(timeout=420)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    digests = [ln for o in outs for ln in o.splitlines()
               if ln.startswith("DIGEST")]
    edns = [ln for o in outs for ln in o.splitlines()
            if ln.startswith("EDN")]
    assert len(digests) == 2 and digests[0] == digests[1], digests
    assert len(edns) == 2 and edns[0] == edns[1], edns
