"""The ranks of a replica mesh as processes on one host.

``run_ranks(world, fn, *args, device=)`` starts ``world`` processes with
the ``spawn`` start method, joins them in one ``torch.distributed``
group over a file store in a temporary directory (gloo ranks on the
CPU, NCCL ranks on a card each), and in each rank sets the package's
device, builds ``make_mesh()`` and calls ``fn(mesh, *args)``. Every rank
runs the same call on the same arguments: the SPMD contract of
``parallel.mesh``. It returns rank 0's result with its tensors as numpy
arrays, or raises the first exception a rank reports; it never returns
a partial result.

A rank unpickles ``fn`` by its module and name, so ``fn`` is a
module-level function, and a rank imports that module: keep it to one
that imports the port only.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from ..device import resolve_device, use_device
from .mesh import make_mesh

__all__ = ["run_ranks"]

# seconds a rank may wait in a collective, and the caller for all
# results, before the run fails
_TIMEOUT_S = 300.0


def _host(x):
    """``x`` with every tensor in it (through tuples, lists and dicts) as
    a numpy array."""
    if torch.is_tensor(x):
        return x.cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, store, device, fn, args, results):
    """One rank: join the group, run ``fn(make_mesh(), *args)``, report
    ``(rank, error, payload)``: rank 0's pickled result, or the error
    and its traceback."""
    try:
        use_device(device)
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        dist.init_process_group(
            backend, store=dist.FileStore(store, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=_TIMEOUT_S))
        try:
            out = fn(make_mesh(device=device), *args)
            payload = pickle.dumps(_host(out) if rank == 0 else None)
        finally:
            dist.destroy_process_group()
        report = (rank, None, payload)
    except Exception as err:  # reported to the caller, which raises it
        tb = traceback.format_exc()
        try:
            pickle.dumps(err)
        except Exception:  # an exception that cannot travel
            err = RuntimeError(f"{type(err).__name__}: {err}")
        report = (rank, err, tb)
    results.put(report)
    # the report reaches the pipe before the process exits
    results.close()
    results.join_thread()


def _collect(results, procs):
    """Rank 0's result once every rank has reported; the first error a
    rank reports is raised, with the rank's traceback in a note."""
    world = len(procs)
    got = {}
    deadline = time.monotonic() + _TIMEOUT_S
    while len(got) < world:
        # a rank that exited before this wait began had written its
        # report (see _rank_main), so the wait must find it
        exited = {r: p.exitcode for r, p in enumerate(procs)
                  if p.exitcode is not None and r not in got}
        try:
            rank, err, payload = results.get(timeout=1.0)
        except queue.Empty:
            if exited:
                r, code = next(iter(exited.items()))
                raise RuntimeError(
                    f"rank {r} of {world} exited with code {code} "
                    f"without a result") from None
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world - len(got)} of {world} ranks gave no result "
                    f"in {_TIMEOUT_S:.0f} s") from None
            continue
        if err is not None:
            err.add_note(f"raised on rank {rank} of {world}:\n{payload}")
            raise err
        got[rank] = payload
    return pickle.loads(got[0])


def run_ranks(world: int, fn, *args, device=None):
    """``fn(mesh, *args)`` on each of ``world`` spawned ranks over one
    process group on ``device``'s type (the package default when None,
    so CUDA unless ``use_device`` said otherwise; "cpu": gloo; "cuda":
    NCCL, one card a rank, so ``world`` may not exceed the cards, and
    without a card it raises). Returns rank 0's
    result with tensors as numpy arrays; raises what a rank raised.
    Every rank's group is destroyed before it exits, and a rank still
    running when another failed is stopped."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"{world} ranks need {world} cards; "
                         f"{torch.cuda.device_count()} present")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, store, dev.type, fn, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            return _collect(results, procs)
        except BaseException:
            # a rank that failed leaves the others waiting in a
            # collective: stop them
            for p in procs:
                p.terminate()
            raise
        finally:
            for p in procs:
                p.join(timeout=_TIMEOUT_S)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
