"""The reference held to the port's plain CPU path at small sizes of
every traffic, and to the port's pure host weaver, which defines the
semantics; its control variants differ from it."""

import numpy as np
import pytest
import torch

from cause_tpu_torch import benchgen
from cause_tpu_torch.ids import HIDE
from cause_tpu_torch.weaver import pure, torchwd
from weavebench import check, gen
from weavebench.reference import weave as ref
from weavebench.tests.small import FLEET, MIXES, PAIRS


def _lanes(kind, seed):
    if kind.startswith("fleet"):
        mix = MIXES[kind.split("_")[1]]
        r = gen.fleet_row(gen.rng_for(seed, 0), FLEET, mix)
        return {k: v[None] for k, v in r.items()}, FLEET["capacity"]
    return gen.pair_batch(gen.rng_for(seed, 0), PAIRS, MIXES[kind]), \
        PAIRS["capacity"]


def _port(lanes, cap):
    v5 = benchgen.batched_v5_inputs(
        {k: lanes[k] for k in benchgen.LANE_KEYS4}, cap)
    u = benchgen.v5_token_budget(v5)
    return torchwd.batched_weave_digest(
        *(v5[k] for k in benchgen.LANE_KEYS5), u_max=u, k_max=u,
        device="cpu")


def _ref(lanes, broken=None):
    t = {k: torch.as_tensor(lanes[k]) for k in
         ("hi", "lo", "chi", "clo", "vc", "valid")}
    return ref.weave(t["hi"], t["lo"], t["chi"], t["clo"], t["vc"],
                     t["valid"], break_guarantee=broken)


@pytest.mark.parametrize("kind", ["chain", "random", "runs", "fleet_chain",
                                  "fleet_random"])
@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
def test_reference_agrees_with_the_port(kind, seed):
    lanes, cap = _lanes(kind, seed)
    rank, vis, dig, ovf = _port(lanes, cap)
    assert not ovf.any()
    waves = [(0, dig.numpy(), ovf.numpy())]
    keys = ("hi", "lo", "chi", "clo", "vc", "valid")
    n = check.compare([{k: lanes[k] for k in keys}], [(rank, vis)], waves,
                      torch.device("cpu"))
    assert n == {"rank_mismatch": 0, "vis_mismatch": 0, "digest_mismatch": 0,
                 "docs_compared": rank.shape[0]}


def _pure_weave(row):
    """The pure weaver's weave of one row: nodes inserted in id order."""
    valid = row["valid"]
    ids = {}
    for i in np.flatnonzero(valid):
        nid = (int(row["hi"][i]), int(row["lo"][i]))
        cid = None if row["chi"][i] < 0 else (int(row["chi"][i]),
                                              int(row["clo"][i]))
        ids[nid] = (nid, cid, HIDE if row["vc"][i] == 1 else f"v{i}")
    order = sorted(ids)
    w = [ids[order[0]]]
    for nid in order[1:]:
        w = pure.weave_node(w, ids[nid])
    return w


@pytest.mark.parametrize("kind", ["chain", "random", "runs"])
@pytest.mark.parametrize("seed", [3, 4])
def test_reference_agrees_with_the_pure_weaver(kind, seed):
    lanes, _cap = _lanes(kind, seed)
    w = _ref(lanes)
    for r in range(2):
        row = {k: v[r] for k, v in lanes.items()}
        woven = _pure_weave(row)
        n = int(w["n_nodes"][r])
        assert n == len(woven)
        by_rank = sorted(range(n), key=lambda g: int(w["rank"][r, g]))
        got = [(int(w["hi"][r, g]), int(w["lo"][r, g])) for g in by_rank]
        assert got == [node[0] for node in woven]
        for pos, node in enumerate(woven):
            nxt = woven[pos + 1] if pos + 1 < len(woven) else None
            hidden = nxt is not None and nxt[2] is HIDE and nxt[1] == node[0]
            want = pos > 0 and node[2] is not HIDE and not hidden
            assert bool(w["visible"][r, by_rank[pos]]) == want


@pytest.mark.parametrize("broken", ["deletes", "order"])
def test_the_controls_break_the_weave(broken):
    lanes, _cap = _lanes("chain", 6)
    good, bad = _ref(lanes), _ref(lanes, broken)
    field = "visible" if broken == "deletes" else "rank"
    assert not torch.equal(good[field], bad[field])
    assert not torch.equal(ref.digest(good), ref.digest(bad))


def test_digest_arithmetic_is_the_ports():
    from cause_tpu_torch.parallel.mesh import mix32_np

    rng = np.random.default_rng(0)
    hi = rng.integers(0, 2**31 - 1, 1000).astype(np.int32)
    lo = rng.integers(0, 2**31 - 1, 1000).astype(np.int32)
    pos = rng.integers(0, 2**20, 1000).astype(np.int32)
    vis = rng.random(1000) < 0.5
    ours = ref.mix32(*(torch.as_tensor(a) for a in (hi, lo, pos, vis)))
    assert (ours.numpy() == mix32_np(hi, lo, pos, vis).astype(np.int64)).all()
