"""Cross-tenant wave batching: one fused device dispatch per pow2 bucket
serves every ready tenant's delta window.

The port of ``cause_tpu.serve.batch``. A tick that waved each touched
tenant alone would pay one dispatch — about 1,300 kernel launches on
the card whatever its width — per tenant. But the delta wave's program
(``weaver.torchwd.batched_delta_weave``) is batched across rows, and
its window assembly (``parallel.wave.assemble_delta_window``) is host
work over cached views with no dependence on any session's resident
capacity. So N tenants whose frontiers share a window budget ride ONE
dispatch: their windows stacked as batch rows, woven once, the per-row
digests split back per tenant.

:class:`BatchScheduler` is that external driver, built on the session
hooks factored out of ``FleetSession._delta_wave``:

- **bucket** — tenants group by ``FleetSession.bucket_key`` (the pow2
  window budget ``w_cap``): one dispatch per DISTINCT budget, not per
  tenant. Batch rows are padded to the next pow2 with copies of row 0
  (outputs discarded), as the reference pads them for a stable compiled
  program shape; the padded rows' work is real on the card, where no
  program cache needs it;
- **dispatch** — one ``batched_delta_weave`` per bucket on the package
  default device (``use_device``), through the recovery ladder's retry
  rung, with the injectable chaos seams the per-tenant path has (stall,
  budget exhaustion). On
  the card it runs the B1 sort (six calls), the B2 walk and the B3
  expansion once over the whole bucket;
- **split back** — the bucket's digests are fetched once; each member's
  ``complete_window`` takes its rows of the rank and visibility tensors
  (left on the device; the splice is deferred until something reads
  the resident weave);
- **fallback** — a tenant with no frontier, or whose window overflows
  its bucket, runs its own full-width ``wave()`` (re-establish)
  WITHOUT dragging its bucket-mates down the slow path.

Cost accounting (telemetry on): each bucket emits one ``wave.cost``
with ``bucket`` and ``batch_rows`` fields (``path="batched"``),
draining every member tenant's pending delta-op evidence, so
``floor_budget_ms`` scales with #buckets, not #tenants.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import chaos as _chaos
from .. import obs
from ..obs import xtrace

__all__ = ["BatchScheduler"]


class BatchScheduler:
    """Group ready sessions by pow2 bucket, run one fused delta-wave
    dispatch per bucket, split the results back per tenant."""

    def __init__(self):
        # last wave_fleet's shape, for the tick's summary
        self.last_buckets = 0
        self.last_batch_rows = 0
        self.last_fallbacks = 0
        # tick-scoped {uuid: [trace ids]} for per-tenant wave hops
        self._traces_by_uuid: Dict[str, list] = {}

    def wave_fleet(self, sessions,
                   traces_by_uuid=None) -> Dict[str, np.ndarray]:
        """One batched wave over ``{uuid: FleetSession}``: every session
        ends wave-current; returns ``{uuid: digest array}`` bit-identical
        to per-tenant ``wave()`` calls. The dispatches run on the package
        default device, and raise without a card when that is CUDA.
        ``traces_by_uuid`` (telemetry on) maps tenants to the trace ids
        riding this tick so each fused bucket span fans out per-tenant
        "wave" child hops."""
        from ..device import resolve_device

        device = resolve_device()
        self._traces_by_uuid = traces_by_uuid or {}
        digests: Dict[str, np.ndarray] = {}
        fallback: List[str] = []
        buckets: Dict[int, list] = {}
        for uuid, sess in sessions.items():
            if _chaos.enabled() and sess.bucket_key \
                    and _chaos.budget_exhaust("session"):
                # injected window-budget exhaustion: this tenant alone
                # drops to the full-width rung, same as in wave()
                sess.abandon_frontier("budget-exhaustion")
            pack = sess.window_pack()
            if pack is None:
                fallback.append(uuid)
            else:
                buckets.setdefault(pack["w_cap"], []).append(
                    (uuid, sess, pack))
        self.last_buckets = len(buckets)
        self.last_batch_rows = 0
        for wcap in sorted(buckets):
            self._wave_bucket(wcap, buckets[wcap], digests, fallback,
                              device)
        for uuid in fallback:
            # full-width re-establish, one tenant at a time
            digests[uuid] = sessions[uuid].wave()
            if obs.enabled():
                for tr in self._traces_by_uuid.get(uuid, ()):
                    xtrace.hop("wave", tr, uuid=uuid, path="full")
        self.last_fallbacks = len(fallback)
        return digests

    def _wave_bucket(self, wcap: int, group, digests, fallback, device):
        from ..benchgen import LANE_KEYS5, lanes_from_numpy
        from ..parallel import recovery as _recovery
        from ..parallel.wave import assemble_delta_window, fetch_digest
        from ..weaver import torchwd
        from ..weaver.arrays import next_pow2

        n_w = 2 * wcap
        views: list = []
        s_parts, anchor_parts, pdig_parts = [], [], []
        row_of = []  # (uuid, sess, first row, row count)
        for uuid, sess, pack in group:
            row_of.append((uuid, sess, len(views), pack["rows"]))
            views.extend(pack["views"])
            s_parts.append(np.asarray(pack["s"]))
            anchor_parts.append(np.asarray(pack["anchor"]))
            pdig_parts.append(np.asarray(pack["prefix_digest"]))
        n_real = len(views)
        n_pad = int(next_pow2(max(1, n_real)))
        if n_pad > n_real:
            # pad with copies of the first row, as the reference does;
            # padded rows' outputs are sliced off below
            pad = n_pad - n_real
            views = views + [views[0]] * pad
            s_parts.append(np.repeat(s_parts[0][:1], pad))
            anchor_parts.append(np.repeat(anchor_parts[0][:1], pad))
            pdig_parts.append(np.repeat(pdig_parts[0][:1], pad))
        s_arr = np.concatenate(s_parts).astype(np.int32)
        anchor_arr = np.concatenate(anchor_parts).astype(np.int32)
        pdig = np.concatenate(pdig_parts).astype(np.uint32)
        uuids = [u for u, _se, _lo, _n in row_of]
        self.last_batch_rows += n_pad
        if _chaos.enabled():
            # one stall draw per dispatch, the same rate the per-tenant
            # path pays per wave
            _chaos.stall_point("session")
        if obs.enabled():
            from ..obs import costmodel as _cm

            _cm.wave_begin("serve")
            obs.event("run.heartbeat", stage="serve.batch_wave",
                      bucket=int(wcap), tenants=len(group),
                      batch_rows=n_pad)
        with obs.span("serve.batch_wave", bucket=int(wcap),
                      tenants=len(group), rows=n_real):
            with obs.span("serve.batch_assemble"):
                lanes, starts, counts = assemble_delta_window(
                    views, s_arr, anchor_arr, wcap, n_w)
            r0 = s_arr - 1
            t = lanes_from_numpy(lanes, device)

            def run():
                return torchwd.batched_delta_weave(
                    *(t[k] for k in LANE_KEYS5), pdig, r0,
                    u_max=n_w, k_max=n_w, device=device)

            if obs.enabled():
                from ..obs import devprof

                run = devprof.profiled(run, device, site="serve",
                                       pipeline="delta", B=n_pad,
                                       N=int(n_w), u_max=int(n_w),
                                       k_max=int(n_w))
            rank_w, vis_w, digest, ovf = _recovery.run_dispatch(
                "session", run)
            # one host fetch of the bucket's digests and flags; the
            # ranks and visibility stay on the device, split per tenant
            # by rows
            out = fetch_digest(digest)
            ovf_np = ovf.cpu().numpy()
            if obs.enabled():
                from ..obs import costmodel as _cm

                _cm.record_dispatch(f"serve:batch:w{int(wcap)}x{n_pad}",
                                    site="serve")
        delta_ops = 0
        full_bags = 0
        for uuid, sess, r_lo, rows in row_of:
            sl = slice(r_lo, r_lo + rows)
            if bool(ovf_np[sl].any()):  # pragma: no cover -
                # structurally unreachable at u_max = N_w (the same
                # budget rule as _delta_wave); kept so a future budget
                # change degrades this tenant alone, not its bucket
                obs.counter("serve.batch_row_overflow").inc()
                sess.abandon_frontier("window-overflow")
                fallback.append(uuid)
                continue
            d, f = sess.pop_divergence()
            delta_ops += d
            full_bags += f
            digests[uuid] = sess.complete_window(
                rank_w[sl], vis_w[sl], out[sl], starts[sl], counts[sl])
            if obs.enabled():
                # the bucket span fans out per-tenant child hops: each
                # trace's "wave" hop names the fused dispatch (bucket +
                # rows) that actually served it
                for tr in self._traces_by_uuid.get(uuid, ()):
                    xtrace.hop("wave", tr, uuid=uuid, path="batched",
                               bucket=int(wcap), batch_rows=n_pad)
        if obs.enabled():
            from ..obs import costmodel as _cm
            from ..obs import devprof

            devprof.sample_device_memory("serve.batch", device)
            _cm.wave_cost(
                uuid=f"bucket:w{int(wcap)}",
                pairs=n_real,
                lanes=sum(2 * int(se.capacity) * n
                          for _u, se, _lo, n in row_of),
                tokens=int(counts[:n_real].sum()) + 2 * n_real,
                token_budget=int(n_w) * n_pad,
                delta_ops=delta_ops,
                full_bag=full_bags,
                path="batched",
                bucket=int(wcap),
                batch_rows=n_pad,
                uuids=uuids,
            )
