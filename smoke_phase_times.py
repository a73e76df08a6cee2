"""Time ``chip_smoke.py`` phase by phase, on the host clock.

Runs ``chip_smoke.py`` (no arguments) from each checkout given, one
after the other, each with a HOME and a TMPDIR of its own inside its
checkout. Every line the smoke prints is written to
``<log dir>/phase_times_<name>.log`` with the seconds since its start;
a line that opens with ``[N `` belongs to phase N. With ``--stop-at N``
the run (its whole process group) ends at phase N's first line. Prints
per checkout its exit code, when each phase's first line came, each
phase's seconds (to the next phase's first line) and, with
``--stop-at``, the seconds from phase 1's line to phase N's.

    python3 smoke_phase_times.py [--stop-at 10] [--log-dir DIR] \
        parent=DIR tree=DIR

Compare two checkouts only within one run of this script, on one card.
"""

import argparse
import os
import re
import signal
import subprocess
import sys
import time


def run_one(name: str, root: str, stop_at: int, log_dir: str) -> str:
    root = os.path.abspath(root)
    env = dict(os.environ, HOME=os.path.join(root, ".home"),
               TMPDIR=os.path.join(root, ".tmp"), PYTHONUNBUFFERED="1")
    os.makedirs(env["HOME"], exist_ok=True)
    os.makedirs(env["TMPDIR"], exist_ok=True)
    log = os.path.join(log_dir, f"phase_times_{name}.log")
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    first, stopped, tail = {}, False, []
    with open(log, "w") as f:
        for line in proc.stdout:
            t = time.time() - t0
            f.write(f"{t:9.2f} {line}")
            tail = (tail + [line.rstrip()])[-3:]
            m = re.match(r"\[(\d+)[ \]]", line)
            if m:
                first.setdefault(int(m.group(1)), round(t, 2))
                if stop_at and int(m.group(1)) == stop_at:
                    os.killpg(proc.pid, signal.SIGKILL)
                    stopped = True
                    break
    rc = proc.wait()
    order = sorted(first)
    secs = {k: round(first[n] - first[k], 2) for k, n in zip(order, order[1:])}
    out = (f"[phase times] {name}: rc {rc}{' (stopped)' if stopped else ''}"
           f" in {time.time() - t0:.1f} s; first lines {first}; phase "
           f"seconds {secs}")
    if stop_at in first and 1 in first:
        out += f"; phases 1-{stop_at - 1} {first[stop_at] - first[1]:.2f} s"
    if not stopped:
        out += "\n" + "\n".join(tail)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stop-at", type=int, default=0, metavar="N")
    ap.add_argument("--log-dir", default="measurements_torch",
                    help="where the stamped logs go (default: %(default)s)")
    ap.add_argument("runs", nargs="+", metavar="NAME=DIR")
    args = ap.parse_args()
    os.makedirs(args.log_dir, exist_ok=True)
    worst = 0
    for spec in args.runs:
        name, root = spec.split("=", 1)
        line = run_one(name, root, args.stop_at, args.log_dir)
        print(line, flush=True)
        rc = int(re.search(r"rc (-?\d+)", line).group(1))
        if not args.stop_at and rc:
            worst = 1
    return worst


if __name__ == "__main__":
    sys.exit(main())
