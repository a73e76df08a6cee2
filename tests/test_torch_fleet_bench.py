"""The port's fleet benchmark (``cause_tpu_torch.fleet_bench``) against
the reference's ``scripts/fleet_bench.py``, both on the CPU at the smoke
configuration (8 replicas of 800 + 100 nodes, capacity 1,024).

- ``kernel_level`` (v4) and ``kernel_level_v5`` reach the reference's
  ``k_max`` / ``u_max`` through the same overflow ladder, and the last
  step's outputs are the reference's: the ranks and the overflow flag
  exactly, so the ``[checksum, overflow]`` each package reads from them
  (a float32 sum of the ranks) is the reference's.
- ``api_level`` merges the reference's node count, and its merged
  document equals the pure weaver's merge of the same replicas.
- ``python -m cause_tpu_torch.fleet_bench --smoke --cpu`` prints three
  JSON lines with the reference's keys plus ``card`` (null on the CPU).
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cause_tpu.collections.clist import CausalList as JList
from cause_tpu.weaver import jaxw4, jaxw5

import cause_tpu_torch as ct
from cause_tpu_torch import fleet_bench
from cause_tpu_torch.collections.clist import CausalList as TList

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = dict(K=8, n_base=800, n_div=100, cap=1024)


def ref_fleet_bench():
    """``scripts/fleet_bench.py`` as a module."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ref_fleet_bench", os.path.join(ROOT, "scripts",
                                            "fleet_bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(os.path.join(ROOT, "scripts"))
    return mod


@pytest.fixture(autouse=True)
def _cpu():
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def recording(monkeypatch, mod, name, budget_kw):
    """Wrap ``mod.name`` to keep each call's budget and outputs."""
    calls = []
    fn = getattr(mod, name)

    def rec(*args, **kw):
        out = fn(*args, **kw)
        calls.append((kw[budget_kw], [np.asarray(x) for x in out]))
        return out

    monkeypatch.setattr(mod, name, rec)
    return calls


@pytest.mark.parametrize("kernel", ["v4", "v5"])
def test_kernel_level_equals_the_reference(monkeypatch, kernel):
    ref = ref_fleet_bench()
    if kernel == "v4":
        j_calls = recording(monkeypatch, jaxw4, "merge_weave_kernel_v4_jit",
                            "k_max")
        t_calls = recording(monkeypatch, fleet_bench,
                            "merge_weave_kernel_v4", "k_max")
        want = ref.kernel_level(**SMOKE)
        got = fleet_bench.kernel_level(**SMOKE, device="cpu")
        budget, rank_at, ovf_at = "k_max", 1, 4
    else:
        j_calls = recording(monkeypatch, jaxw5, "merge_weave_kernel_v5_jit",
                            "u_max")
        t_calls = recording(monkeypatch, fleet_bench,
                            "merge_weave_kernel_v5", "u_max")
        want = ref.kernel_level_v5(**SMOKE)
        got = fleet_bench.kernel_level_v5(**SMOKE, device="cpu")
        budget, rank_at, ovf_at = "u_max", 0, 3
        assert got["tokens"] == want["tokens"]
    assert got[budget] == want[budget]
    assert got["lanes"] == want["lanes"] == 8 * 1024
    assert set(got) == set(want)
    assert got["platform"] == want["platform"] == "cpu"
    # the ladder's budgets in order, then the warm call and 3 timed ones
    assert [k for k, _ in t_calls] == [k for k, _ in j_calls]
    (_, t_out), (_, j_out) = t_calls[-1], j_calls[-1]
    for t, j in zip(t_out, j_out):
        assert np.array_equal(t, j)
    j_sum = np.asarray(jnp.sum(jnp.asarray(j_out[rank_at]).astype(
        jnp.float32)))
    t_sum, t_ovf = fleet_bench._checked(torch.from_numpy(t_out[rank_at]),
                                        torch.from_numpy(t_out[ovf_at]), 0)
    assert t_sum == j_sum and not t_ovf


def test_api_level_merges_the_reference_node_count(monkeypatch):
    ref = ref_fleet_bench()
    counts = {}
    merged = []

    def wrap(cls, tag):
        fn = cls.merge_many

        def rec(self, others):
            out = fn(self, others)
            counts.setdefault(tag, []).append(len(out.ct.nodes))
            if tag == "torch":
                merged.append((self, list(others), out))
            return out

        monkeypatch.setattr(cls, "merge_many", rec)

    wrap(JList, "jax")
    wrap(TList, "torch")
    want = ref.api_level(K=4, n_nodes=200)
    got = fleet_bench.api_level(K=4, n_nodes=200)
    assert set(got) == set(want) and got["platform"] == "cpu"
    assert counts["torch"] == counts["jax"] == [1 + 200 + 4 * 32] * 2
    first, others, out = merged[-1]
    pure = TList(first.ct.evolve(weaver="pure")).merge_many(
        [TList(o.ct.evolve(weaver="pure")) for o in others])
    assert out.ct.weave == pure.ct.weave and list(out) == list(pure)


def test_cli_smoke_prints_the_reference_keys_plus_card():
    ref = ref_fleet_bench()
    want = [ref.kernel_level_v5(**SMOKE), ref.kernel_level(**SMOKE),
            ref.api_level(K=8, n_nodes=1000)]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("CAUSE_TPU_", "BENCH_"))}
    out = subprocess.run(
        [sys.executable, "-m", "cause_tpu_torch.fleet_bench", "--smoke",
         "--cpu"], capture_output=True, text=True, timeout=300, env=env,
        cwd=ROOT, stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert len(lines) == 3
    for got, w in zip(lines, want):
        assert set(got) == set(w) | {"card"}
        assert got["metric"] == w["metric"]
        assert got["card"] is None and got["platform"] == "cpu"
    assert lines[0]["u_max"] == want[0]["u_max"]
    assert lines[1]["k_max"] == want[1]["k_max"]
