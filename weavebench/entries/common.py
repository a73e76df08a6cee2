"""What the entries share: the reference's lanes, byte counts and the
port's marshal."""

from __future__ import annotations

import numpy as np

from .. import gen

# the lanes the reference reads
REF_KEYS = ("hi", "lo", "chi", "clo", "vc", "valid")


def nbytes(x) -> int:
    """Bytes of a numpy array or a tensor at its dtype."""
    if isinstance(x, np.ndarray):
        return int(x.nbytes)
    return int(x.numel() * x.element_size())


def ref_lanes(lanes: dict) -> dict:
    """The reference's view of generated lanes, ``[B, N]``."""
    return {k: np.atleast_2d(lanes[k]) for k in REF_KEYS}


def marshal(lanes: dict, capacity: int) -> dict:
    """The port's v5 marshal of generated lanes (``[B, N]`` or one
    ``[N]`` row): its segment tables, as the service builds them."""
    from cause_tpu_torch import benchgen

    four = {k: lanes[k] for k in benchgen.LANE_KEYS4}
    if lanes["hi"].ndim == 1:
        return benchgen.v5_inputs(four, capacity)
    return benchgen.batched_v5_inputs(four, capacity)


def budget(v5: dict) -> int:
    """The port's token budget for a marshalled batch or row."""
    from cause_tpu_torch import benchgen

    return int(benchgen.v5_token_budget(v5))


def batches(cfg: dict, mix: dict, seed: int, make):
    """``mix["batches"]`` inputs from ``make(rng, cfg, mix)``, each from
    its own stream of ``seed``."""
    return [make(gen.rng_for(seed, k), cfg, mix)
            for k in range(mix["batches"])]
