"""The explicit recovery ladder: one declared degradation policy for
every device dispatch seam.

Counterpart of ``cause_tpu.parallel.recovery``. The ladder's rungs, in
degradation order, are

    delta -> full -> double_budget -> host

and their implementations stay where they live: the session's and the
merge tree's full-width bounce, ``parallel.wave``'s doubled token
budget and its per-pair host merge (overflowing rows and quarantined
replicas). This module names the transitions (:func:`step`) and owns
the execution seam (:func:`run_dispatch`): one device dispatch with the
chaos engine's injected faults applied and a bounded retry of TRANSIENT
failures — ``chaos.InjectedDispatchError`` and this module's
:class:`TransientDispatchError`. Everything else propagates at once: a
CUDA launch error, an out-of-memory and a shape error are not
transient (a sticky CUDA error poisons the context, so a retry could
only fail again). The telemetry the reference records at each
transition comes with the telemetry port; until then :func:`step` is a
no-op.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

from .. import chaos as _chaos

__all__ = [
    "LADDER",
    "MAX_RETRIES",
    "BACKOFF_S",
    "TransientDispatchError",
    "step",
    "is_transient",
    "run_dispatch",
]

# the rungs, in degradation order; "host" is the per-pair host merge —
# always correct, never fast
LADDER: Tuple[str, ...] = ("delta", "full", "double_budget", "host")

# a real device flake is either gone on the second try or not transient
MAX_RETRIES = 2
BACKOFF_S = 0.02


class TransientDispatchError(RuntimeError):
    """A dispatch failure worth retrying."""


def step(site: str, from_step: str, to_step: str, reason: str,
         uuid: str = "", **extra) -> None:
    """Record one ladder transition. A no-op until the telemetry port
    (the reference emits a ``recovery.step`` event here)."""


def is_transient(exc: BaseException) -> bool:
    """Whether a dispatch failure is worth retrying: the chaos engine's
    injected transient or a ``TransientDispatchError``, nothing else."""
    return isinstance(exc, (_chaos.InjectedDispatchError,
                            TransientDispatchError))


def run_dispatch(site: str, fn: Callable, *, retries: int = MAX_RETRIES,
                 backoff_s: float = BACKOFF_S, uuid: str = ""):
    """Run one device dispatch through the ladder's retry rung: chaos
    dispatch faults are injected here (so every dispatch seam is
    injectable by construction), transient failures retry up to
    ``retries`` times with linear backoff, and a failure that survives
    every retry re-raises with a note naming ``site`` (and ``uuid``,
    the document, when given) — it is not absorbed."""
    attempt = 0
    while True:
        try:
            if _chaos.enabled():
                _chaos.dispatch_fault(site)
            return fn()
        except Exception as e:  # noqa: BLE001 - classified below
            if not is_transient(e):
                raise
            if attempt >= retries:
                where = f"{site} ({uuid})" if uuid else site
                e.add_note(f"{where}: failed after {attempt + 1} attempts")
                raise
            attempt += 1
            time.sleep(backoff_s * attempt)
