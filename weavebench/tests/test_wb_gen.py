"""The generator's invariants, for every typing mix."""

import numpy as np
import pytest

from weavebench import gen
from weavebench.tests.small import FLEET, MIXES, PAIRS

SEEDS = [0, 7, 2**31 + 11]


def _trees(lanes, cap):
    """Each tree's lanes and its first concat lane in its row."""
    per_row = lanes["hi"].shape[-1] // cap
    n = lanes["hi"].size // cap
    return [({k: v.reshape(-1)[t * cap:(t + 1) * cap]
              for k, v in lanes.items()}, (t % per_row) * cap)
            for t in range(n)]


def _pairs(seed, kind):
    return gen.pair_batch(gen.rng_for(seed, 0), PAIRS, MIXES[kind])


def _fleet(seed, kind="chain"):
    return gen.fleet_row(gen.rng_for(seed, 0), FLEET, MIXES[kind])


def _all(seed):
    return [(_pairs(seed, k), PAIRS) for k in MIXES] + \
        [(_fleet(seed, k), FLEET) for k in MIXES]


@pytest.mark.parametrize("seed", SEEDS)
def test_ids_sorted_and_causes_earlier(seed):
    for lanes, cfg in _all(seed):
        cap = cfg["capacity"]
        for tree, off in _trees(lanes, cap):
            v = tree["valid"]
            n = int(v.sum())
            assert v[:n].all() and not v[n:].any()
            key = tree["hi"][:n].astype(np.int64) << 32 | tree["lo"][:n]
            assert (np.diff(key) > 0).all(), "ids ascend within a tree"
            assert tree["hi"][0] == 0 and tree["lo"][0] == 0
            cl = tree["cci"][1:n] - off
            assert (cl >= 0).all() and (cl < np.arange(1, n)).all()
            # the cause ids are the ids at the cause lanes
            assert (tree["chi"][1:n] == tree["hi"][cl]).all()
            assert (tree["clo"][1:n] == tree["lo"][cl]).all()
            assert tree["chi"][0] == -1


@pytest.mark.parametrize("seed", SEEDS)
def test_hides_in_the_delta_domain(seed):
    for lanes, cfg in _all(seed):
        cap, nb = cfg["capacity"], cfg["base_nodes"]
        n_hides = 0
        for tree, off in _trees(lanes, cap):
            vc = tree["vc"]
            assert not vc[:nb + 2].any(), "no hide in the base or first"
            hides = np.flatnonzero(vc == gen.VC_HIDE)
            n_hides += len(hides)
            # a hide targets a live normal node, never a hide
            targets = tree["cci"][hides] - off
            assert (vc[targets] == 0).all() and (targets > 0).all()
            assert len(set(targets)) == len(targets)
        assert n_hides, "some hides are drawn"


def test_chain_shape():
    lanes = _pairs(3, "chain")
    cap, nb, nd = PAIRS["capacity"], PAIRS["base_nodes"], \
        PAIRS["divergent_nodes"]
    for tree, off in _trees({k: v[:1] for k, v in lanes.items()}, cap):
        n = 1 + nb + nd
        assert (tree["cci"][1:n] - off == np.arange(n - 1)).all()


def test_fleet_replicas_share_one_base():
    for kind in MIXES:
        row = _fleet(4, kind)
        cap, nb = FLEET["capacity"], FLEET["base_nodes"]
        cl = row["cci"].reshape(-1, cap)[:, 1:nb + 1] \
            - cap * np.arange(FLEET["replicas"])[:, None]
        assert (cl == cl[0]).all()


def test_random_mix_types_every_node_at_a_drawn_position():
    """One-character edits at drawn positions: the base and the sides
    are mostly not typed after the node before them."""
    lanes = _pairs(8, "random")
    cap, nb = PAIRS["capacity"], PAIRS["base_nodes"]
    tree = {k: v[0, :cap] for k, v in lanes.items()}
    n = int(tree["valid"].sum())
    after_prev = tree["cci"][2:n] == np.arange(1, n - 1)
    assert after_prev.mean() < 0.5
    base_heads = tree["cci"][2:nb + 1] != np.arange(1, nb)
    assert base_heads.sum() >= nb // 2


def test_runs_shape_types_at_many_positions():
    lanes = _pairs(5, "runs")
    cap = PAIRS["capacity"]
    tree = {k: v[0, :cap] for k, v in lanes.items()}
    n = int(tree["valid"].sum())
    heads = (tree["cci"][1:n] != np.arange(n - 1)) & (tree["vc"][1:n] == 0)
    assert heads.sum() >= 8, "runs start at drawn positions"


@pytest.mark.parametrize("make", ["chain", "random", "runs", "fleet"])
def test_seed_changes_the_inputs(make):
    def draw(seed):
        return _fleet(seed) if make == "fleet" else _pairs(seed, make)
    a, b, c = draw(1), draw(1), draw(2)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a)
    # the same sizes whatever the seed
    assert all(a[k].shape == c[k].shape for k in a)
    assert a["valid"].sum() == c["valid"].sum()


def test_rows_are_distinct_documents():
    lanes = _pairs(9, "chain")
    B = lanes["lo"].shape[0]
    sites = {tuple(lanes["lo"][r, [PAIRS["base_nodes"] + 1,
                                   PAIRS["capacity"] + PAIRS["base_nodes"]
                                   + 1]]) for r in range(B)}
    assert len(sites) == B
