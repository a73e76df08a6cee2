"""The dispatch seam of the recovery ladder.

Counterpart of the part of ``cause_tpu.parallel.recovery`` that
``run_dispatch`` needs. The ladder's rungs, in degradation order, are
``delta -> full -> double_budget -> host``; the full wave, its doubled
budget and the per-pair host merge live in ``parallel.wave``. This
module runs one device dispatch with a bounded retry of TRANSIENT
failures; everything else (shape errors, CUDA launch errors, out of
memory) propagates at once. The fault injection that raises transient
failures and the recovery telemetry come with the chaos and telemetry
ports.
"""

from __future__ import annotations

import time
from typing import Callable

__all__ = ["TransientDispatchError", "run_dispatch"]

# a real device flake is either gone on the second try or not transient
MAX_RETRIES = 2
BACKOFF_S = 0.02


class TransientDispatchError(RuntimeError):
    """A dispatch failure worth retrying."""


def run_dispatch(site: str, fn: Callable, *, retries: int = MAX_RETRIES,
                 backoff_s: float = BACKOFF_S):
    """Run one device dispatch; retry ``TransientDispatchError`` up to
    ``retries`` times with linear backoff, then re-raise. ``site`` names
    the dispatch seam in the error."""
    attempt = 0
    while True:
        try:
            return fn()
        except TransientDispatchError as e:
            if attempt >= retries:
                e.add_note(f"{site}: failed after {attempt + 1} attempts")
                raise
            attempt += 1
            time.sleep(backoff_s * attempt)
