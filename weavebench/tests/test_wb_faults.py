"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a small size, with one fault the cell can have
planted in the program: a step that returns its state unchanged, half
of the batch left out, an answer altered where it is produced. (The
cells take one chip: no exchange between chips to leave out.)"""

import time

import numpy as np
import pytest
import torch

from cause_tpu_torch.weaver import torchw5, torchwd
from weavebench import run
from weavebench.tests.small import CELLS, small_cell


def _run(name):
    return run.run_cell(small_cell(name), 12345, 0.4, False, "cpu",
                        time.perf_counter())


def _wrap(monkeypatch, module, fn_name, after):
    orig = getattr(module, fn_name)

    def broken(*a, **k):
        return after(orig(*a, **k), a)
    monkeypatch.setattr(module, fn_name, broken)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    f = _run(name)
    assert f["correct"] and f["failed"] == 0
    assert f["numbers"]["docs_compared"] > 0


def _unchanged(monkeypatch, name):
    """The step returns its state unchanged: no weave is computed (the
    answers stay what the buffers held)."""
    def blank(out, a):
        rank, vis = out[0], out[1]
        N = rank.shape[-1]
        return (torch.full_like(rank, N), torch.zeros_like(vis),
                *(torch.zeros_like(x) for x in out[2:]))
    if name == "fleet_converge":
        _wrap(monkeypatch, torchw5, "merge_weave_kernel_v5", blank)
    else:
        _wrap(monkeypatch, torchwd, "batched_weave_digest", blank)


def _half(monkeypatch, name):
    """Half of the batch left out: the second half of the rows gets no
    weave and no digest (the fleet's one row: half of its lanes)."""
    def halve(out, a):
        out = [x.clone() for x in out]
        rank, vis = out[0], out[1]
        if rank.dim() == 1:
            n = rank.shape[0] // 2
            rank[n:] = rank.shape[0]
            vis[n:] = False
            return tuple(out)
        B, N = rank.shape
        rank[B // 2:] = N
        vis[B // 2:] = False
        if len(out) > 3:
            out[2][B // 2:] = 0
        return tuple(out)
    if name == "fleet_converge":
        _wrap(monkeypatch, torchw5, "merge_weave_kernel_v5", halve)
    else:
        _wrap(monkeypatch, torchwd, "batched_weave_digest", halve)


def _altered(monkeypatch, name):
    """One answer altered where it is produced: one node's rank moved
    by one in the last row."""
    def alter(out, a):
        out = [x.clone() for x in out]
        rank = out[0]
        row = rank if rank.dim() == 1 else rank[-1]
        N = row.shape[0]
        kept = torch.nonzero(row < N).flatten()
        i = int(kept[len(kept) // 2])
        row[i] = row[i] + 1
        return tuple(out)
    if name == "fleet_converge":
        _wrap(monkeypatch, torchw5, "merge_weave_kernel_v5", alter)
    else:
        _wrap(monkeypatch, torchwd, "batched_weave_digest", alter)


def _digest_altered(monkeypatch, name):
    """One document's digest altered where it is produced."""
    def flip(dig):
        dig = dig.clone()
        dig.view(-1)[-1] ^= 1
        return dig
    if name == "fleet_converge":
        from cause_tpu_torch.parallel import mesh
        _wrap(monkeypatch, mesh, "replica_digest", lambda d, a: flip(d))
        return
    _wrap(monkeypatch, torchwd, "batched_weave_digest",
          lambda out, a: (*out[:2], flip(out[2]), out[3]))


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered,
          "digest_altered": _digest_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch, name)
    f = _run(name)
    assert not f["correct"], f["numbers"]
    n = f["numbers"]
    assert n["rank_mismatch"] + n["vis_mismatch"] + n["digest_mismatch"] > 0
    assert np.isfinite(f["e2e"]["docs_merged_per_s"])
