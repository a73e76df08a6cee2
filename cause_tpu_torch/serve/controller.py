"""The adaptive T_batch controller: the lag SLO's cost model, inverted
live. A copy of ``cause_tpu.serve.controller`` with the H100's dispatch
floor as its default (``DISPATCH_FLOOR_MS`` below, the port's one floor
constant: ``obs.costmodel`` reads it too).

The lag SLO decomposes as ``p99 ≈ T_batch + floor×dispatches +
slope×batch_ops``: an op created at the start of a
coalescing window waits ``T_batch`` for admission, then one wave wall
(dispatch floor × dispatches per wave, plus the delta-native slope
over the batch's ops). Everything on the right except ``T_batch`` is
measured by the cost model, so the controller's steady-state target is
the inversion solved for ``T_batch``:

    T_target = slo_ms − floor_ms × dispatches_per_wave
                      − slope_ms_per_op × batch_ops

driven by exactly the two live terms of the telemetry snapshot:

- **feedback** — the sliding SLO burn rate (``lag.slo.burn_rate``):
  burning ≥2x sustainable shrinks T_batch multiplicatively (wave
  sooner, smaller batches); burn comfortably under 1 relaxes back
  toward the inversion target;
- **capacity** — the ``fleet.token_headroom`` minimum: headroom
  thinner than one batch's worth of ops means the next divergence
  spike overflows the compiled window budget, so T_batch halves
  (smaller windows) regardless of what the SLO says.

Damping: the result is clamped to ``[t_min_ms, t_max_ms]``, a change
smaller than the hysteresis fraction is ignored, per-update movement
is bounded to 2x/0.5x, and a post-change cooldown holds the value for
a few ticks — so an edge-triggered alert flapping on a threshold
cannot oscillate the batch size (pinned in tests/test_serve.py). The
controller is a pure consumer: feed it ``live.snapshot`` dicts (or a
``LiveMonitor`` snapshot) and read ``t_batch_ms``; it never touches
the queue or the sessions itself.

Stdlib-only (it imports nothing of torch itself). ``floor_ms`` overrides the
default floor, for a card run below its power limit or a host where
the dispatch floor is not the measured one.
"""

from __future__ import annotations

from typing import Optional

from .. import obs

__all__ = ["BatchController", "DISPATCH_FLOOR_MS"]

# The per-tick dispatch floor on an NVIDIA H100 80GB HBM3 at its
# 700 W power limit: the p50 host-clock wall of one service tick's
# bucket dispatch with a single tenant's delta window in it
# (``batched_delta_weave`` over one row padded to 8, w_cap = 128,
# synchronized; 10 reps), as ``chip_smoke.py``'s served-fleet phase
# measures it: 28.58 ms (min 26.56, max 38.67).
DISPATCH_FLOOR_MS = 28.58

# burn thresholds: >BURN_HIGH shrinks now, <BURN_LOW may relax
_BURN_HIGH = 2.0
_BURN_LOW = 1.0
_SHRINK = 0.5          # multiplicative shrink under pressure
_RELAX = 1.25          # multiplicative relax toward the target
_STEP_CAP = 2.0        # max per-update movement (both directions)


class BatchController:
    """See the module docstring. ``update(snapshot)`` returns the
    (possibly unchanged) ``t_batch_ms``; ``on_alert`` is the
    edge-triggered interrupt side (register it as a ``LiveMonitor``
    callback) — a ``burn`` alert forces the shrink branch on the next
    update even if the sliding burn has not crossed yet."""

    def __init__(self, slo_ms: float = 100.0,
                 t_min_ms: float = 5.0, t_max_ms: float = 2000.0,
                 floor_ms: Optional[float] = None,
                 hysteresis: float = 0.2, cooldown_ticks: int = 2,
                 initial_ms: Optional[float] = None):
        if floor_ms is None:
            floor_ms = DISPATCH_FLOOR_MS
        self.slo_ms = float(slo_ms)
        self.t_min_ms = float(t_min_ms)
        self.t_max_ms = float(t_max_ms)
        self.floor_ms = float(floor_ms)
        self.hysteresis = float(hysteresis)
        self.cooldown_ticks = int(cooldown_ticks)
        self.t_batch_ms = float(
            initial_ms if initial_ms is not None
            else min(t_max_ms, max(t_min_ms, slo_ms / 2.0)))
        self._cooldown = 0
        self._alert_pressure = False
        self.changes = 0
        self.last_terms: dict = {}

    # ------------------------------------------------------- interrupts

    def on_alert(self, alert: dict) -> None:
        """LiveMonitor callback: burn/p99 excursions arm the shrink
        branch for the next update. Edge-triggered by construction
        (the monitor emits once per excursion) and consumed once —
        flapping rules cannot pump the controller."""
        rule = str(alert.get("rule", ""))
        if rule.startswith(("burn", "p99", "window_p99", "shed_rate")):
            self._alert_pressure = True

    # ----------------------------------------------------------- update

    def target_ms(self, snapshot: dict) -> float:
        """The SLO inversion against one snapshot's measured cost
        terms (floor × dispatches/wave + slope × batch ops), clamped.
        Pure — no controller state touched."""
        cost = snapshot.get("cost") or {}
        waves = cost.get("waves") or 0
        d_per_wave = (cost.get("dispatches", 0) / waves) if waves else 1.0
        batch_ops = (cost.get("delta_ops", 0) / waves) if waves else 0.0
        slope = ((cost.get("slope") or {}).get("slope_ms_per_op")
                 or 0.0)
        t = self.slo_ms - self.floor_ms * d_per_wave \
            - slope * batch_ops
        return min(self.t_max_ms, max(self.t_min_ms, t))

    def update(self, snapshot: dict) -> float:
        """One control tick against a ``live.snapshot`` dict. Applies
        feedback (burn) and capacity (headroom) to the inversion
        target, then hysteresis/step-cap/cooldown damping. Emits one
        ``serve.control`` event per actual change (obs on)."""
        lag = snapshot.get("lag") or {}
        slo = lag.get("slo") or {}
        burn = slo.get("burn_rate")
        head = (snapshot.get("headroom") or {}).get("min")
        cost = snapshot.get("cost") or {}
        waves = cost.get("waves") or 0
        batch_ops = (cost.get("delta_ops", 0) / waves) if waves else 0.0

        target = self.target_ms(snapshot)
        proposed = self.t_batch_ms
        why = "steady"
        pressure = self._alert_pressure or (
            isinstance(burn, (int, float)) and burn > _BURN_HIGH)
        if pressure:
            proposed = self.t_batch_ms * _SHRINK
            why = "burn"
        elif burn is None or burn < _BURN_LOW:
            # comfortable: relax toward (never past) the inversion
            if self.t_batch_ms < target:
                proposed = min(target, self.t_batch_ms * _RELAX)
                why = "relax"
            elif self.t_batch_ms > target:
                proposed = target
                why = "target"
        # capacity term: headroom thinner than ~one batch of ops means
        # the compiled window budget is about to overflow — halve,
        # whatever the SLO arithmetic says
        if isinstance(head, (int, float)) \
                and head < max(8.0, 2.0 * batch_ops) \
                and proposed > self.t_batch_ms * _SHRINK:
            proposed = self.t_batch_ms * _SHRINK
            why = "headroom"

        # damping ladder: step cap, clamp, hysteresis, cooldown
        proposed = min(self.t_batch_ms * _STEP_CAP,
                       max(self.t_batch_ms / _STEP_CAP, proposed))
        proposed = min(self.t_max_ms, max(self.t_min_ms, proposed))
        self.last_terms = {
            "target_ms": round(target, 3), "burn": burn,
            "headroom_min": head, "why": why,
            "batch_ops": round(batch_ops, 2),
        }
        if self._cooldown > 0:
            # the alert flag SURVIVES cooldown (consumed only past
            # this gate): an edge-triggered alert fires once per
            # excursion, so discarding it here would lose the shrink
            # entirely if the sliding burn then settles under the
            # threshold
            self._cooldown -= 1
            return self.t_batch_ms
        self._alert_pressure = False
        if self.t_batch_ms > 0 and abs(proposed - self.t_batch_ms) \
                / self.t_batch_ms < self.hysteresis:
            return self.t_batch_ms
        old = self.t_batch_ms
        self.t_batch_ms = proposed
        self._cooldown = self.cooldown_ticks
        self.changes += 1
        if obs.enabled():
            obs.counter("serve.control_changes").inc()
            obs.gauge("serve.t_batch_ms").set(round(proposed, 3))
            obs.event("serve.control", old_ms=round(old, 3),
                      new_ms=round(proposed, 3), **self.last_terms)
        return self.t_batch_ms
