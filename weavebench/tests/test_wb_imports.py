"""What the benchmark loads and opens.

In a fresh interpreter, importing every module of the benchmark and of
each cell's entry loads no module whose top-level name (before the
first dot, compared whole) is ``jax``, ``jaxlib``, ``flax`` or
``cause_tpu``; ``cause_tpu_torch`` passes. The reference loads nothing
of the port. No source of the benchmark names the JAX package's
records."""

import subprocess
import sys
from pathlib import Path

import pytest

from weavebench import cells, run

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
MODULES = sorted(
    "weavebench." + ".".join(p.relative_to(HERE).with_suffix("").parts)
    for p in HERE.rglob("*.py")
    if "tests" not in p.parts and p.name not in ("__main__.py",
                                                  "conftest.py"))


def _loaded_after(imports) -> set:
    code = ("import sys\n" + "".join(f"import {m}\n" for m in imports)
            + "print(' '.join(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(out.stdout.split())


def test_no_jax_after_a_dry_import_of_every_cell():
    entries = sorted({f"weavebench.entries.{w['mix']['entry']}" for w in
                      (cells.resolve(c["name"]) for c in
                       cells.load_spec()["workloads"])})
    loaded = _loaded_after(MODULES + entries + ["weavebench.run"])
    assert "cause_tpu_torch" in loaded
    assert not loaded & run.FORBIDDEN, loaded & run.FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded_after(["weavebench.reference.weave",
                            "weavebench.check"])
    assert "cause_tpu_torch" not in loaded
    assert not loaded & run.FORBIDDEN


def test_forbidden_names_are_compared_whole():
    ok = ["cause_tpu_torch", "cause_tpu_torch.weaver.torchw5", "numpy",
          "jaxtyping", "flaxen"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + ["cause_tpu.weaver", "jaxlib.xla",
                                       "flax", "jax"]) == \
        ["cause_tpu", "flax", "jax", "jaxlib"]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(HERE)) for p in HERE.rglob("*")
    if p.suffix in (".py", ".json") and "tests" not in p.parts))
def test_no_source_opens_the_jax_records(path):
    text = (HERE / path).read_text()
    for name in ("BENCH_", "MULTICHIP_", "measurements"):
        assert name not in text, (path, name)


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with only ``BENCHMARK.json`` and ``weavebench/``
    the run exits with an error and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "weavebench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = subprocess.run(
        [sys.executable, "-m", "weavebench", "--workload", "pairs_full",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
