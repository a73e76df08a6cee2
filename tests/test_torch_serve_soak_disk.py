"""The port's serve soak under ``--chaos disk`` (``cause_tpu_torch.serve_soak``
on the committed ``measurements/disk_plan_r15.json``), held to the checks
of the reference CI's disk smoke (``.github/workflows/ci.yml``): exit 0,
every storage check true, at least 3 GC cycles or the honest skip, the
final scrub clean, the drain -> restore bit-identical, ``serve.disk``,
``serve.gc`` and ``serve.shed`` in the stream, the offline scrubber
(``python -m cause_tpu_torch.serve scrub``) clean on the surviving state,
``obs watch --once`` rendering the ``wal:`` line and ``ledger --check``
passing. The window is CI's 24 s: at 8 s checkpoints come every second,
and on a loaded host the plan's bit-rotted record can still be queued,
unapplied, when the mid-GC crash's checkpoint lands; the restore then
cannot replay it and raises, in the reference as in the port (ROADMAP
C.5). At 24 s checkpoints come every 3 s.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = os.path.join(ROOT, "measurements", "disk_plan_r15.json")
CI_DISK = ["--tenants", "4", "--capacity", "4", "--doc", "100",
           "--d-max", "64", "--seconds", "24", "--rate-mult", "1",
           "--seed", "15", "--chaos", "disk", "--disk-plan", PLAN]


def run(module, args, env=None, cwd=ROOT):
    e = {k: v for k, v in os.environ.items()
         if not k.startswith(("CAUSE_TPU_", "BENCH_"))}
    # one intra-op thread: the plain versions at these sizes gain
    # nothing from more, and the suite's other workers keep their cores
    e["OMP_NUM_THREADS"] = "1"
    e.update(env or {})
    return subprocess.run([sys.executable, "-m", module] + list(args),
                          capture_output=True, text=True, timeout=300,
                          env=e, cwd=cwd, stdin=subprocess.DEVNULL)


def test_cli_passes_the_reference_ci_disk_smoke(tmp_path):
    from cause_tpu_torch.obs import load_jsonl

    led = str(tmp_path / "ledger.jsonl")
    obs_out = str(tmp_path / "obs_disk.jsonl")
    out = run("cause_tpu_torch.serve_soak",
              ["--cpu"] + CI_DISK + ["--obs-out", obs_out],
              env={"CAUSE_TPU_LEDGER": led})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "serve soak: clean" in out.stdout.splitlines()[-1]
    state = obs_out + ".state"
    scrub = run("cause_tpu_torch.serve",
                ["scrub", "--wal", f"{state}/wal", "--retired",
                 f"{state}/wal_retired", "--checkpoint", f"{state}/ckpt"])
    assert scrub.returncode == 0, scrub.stdout + scrub.stderr
    watch = run("cause_tpu_torch.obs", ["watch", obs_out, "--once"])
    assert watch.returncode == 0, watch.stderr
    assert "wal: " in watch.stdout

    with open(PLAN) as f:
        plan = json.load(f)
    modes = {s.get("mode") for s in plan["faults"]
             if s["family"] == "disk"}
    assert modes == {"torn", "bitrot", "enospc", "fsync", "rename"}
    assert any(s["family"] == "crash" and s["site"] == "serve.wal.gc"
               for s in plan["faults"])
    rows = [json.loads(x) for x in open(led)]
    (row,) = [r for r in rows if r.get("kind") == "disk"]
    assert row["platform"] == "cpu" and row["card"] is None
    d = row["disk"]["disk"]
    assert all(d["checks"].values()), d["checks"]
    assert d["gc_cycles"] >= 3 or d["checks"]["disk_bounded"] \
        == "skipped: insufficient_gc_cycles", d
    assert d["scrub"]["clean"] is True, d["scrub"]
    assert row["disk"]["restore_bit_identical"] is True
    evs = load_jsonl(obs_out)
    names = {e.get("name") for e in evs if e.get("ev") == "event"}
    for need in ("serve.disk", "serve.gc", "serve.shed"):
        assert need in names, sorted(
            n for n in names if str(n).startswith("serve."))
    check = run("cause_tpu_torch.obs", ["ledger", "--ledger", led,
                                        "--check"])
    assert check.returncode == 0, check.stdout + check.stderr


def test_the_committed_plan_is_found_from_any_directory(tmp_path):
    from cause_tpu_torch import serve_soak

    assert os.path.samefile(serve_soak.DISK_PLAN_DEFAULT, PLAN)
    code = ("import os, sys\n"
            "from cause_tpu_torch import serve_soak\n"
            "print(os.path.isfile(serve_soak.DISK_PLAN_DEFAULT))\n")
    e = {k: v for k, v in os.environ.items()
         if not k.startswith(("CAUSE_TPU_", "BENCH_"))}
    e["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=e, cwd=str(tmp_path),
                         stdin=subprocess.DEVNULL)
    assert out.returncode == 0 and out.stdout.strip() == "True", out.stderr
