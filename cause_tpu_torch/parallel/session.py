"""Device-resident fleet sessions: merge waves without re-shipping the
fleet.

Counterpart of ``cause_tpu.parallel.session``. ``merge_wave`` assembles
and uploads the full [B, 2*cap] lane batch on every call. A
``FleetSession`` keeps the batch ON THE DEVICE between waves and ships
only what changed:

- per edited tree, the appended delta lanes (the lane cache knows the
  previous wave's length; appends are the steady state);
- the per-row segment tables (tens of entries per row), re-sent
  wholesale each wave;
- the deltas are written into the resident lane tensors in place
  (``_apply_deltas``), where the reference donates its buffers to a
  jitted masked scatter: only lanes under each tree's delta count are
  indexed, so no write ever leaves the tensors.

A tree whose cache dropped (mid-order insert, weft) or whose delta
exceeds the budget falls back to a full re-upload of the whole batch
that wave — correct, just slower. ``wave()`` converges the fleet and
fetches ONE small digest array; ranks and visibility stay resident.

**Delta-native waves.** After a full-width wave the session freezes a
per-pair *delta frontier* — the shared converged lane prefix, its
weave-final node (the anchor every divergent subtree attaches under),
and the prefix's exact uint32 digest contribution — and steady-state
waves dispatch ``weaver.torchwd.batched_delta_weave`` over just the
divergent WINDOW (anchor + suffix lanes), splice ranks and visibility
into the resident weave in place (``splice_ranks``) and return digests
bit-identical to the full wave's. First contact, domain violations
(``wave.delta_domain_ok``), window-budget overflow and every
update-level fallback run the full kernel and re-establish.

**Fleet convergence.** ``converge()`` brings every replica of every
pair to one state through the merge reduction tree (``parallel.tree``),
or the flat fold behind ``converge(tree=False)``.

**Batched serving.** The assemble → dispatch → splice pipeline of the
delta wave is also factored into hooks (``bucket_key``,
``window_pack``, ``complete_window``, ``abandon_frontier``,
``pop_divergence``) so that ``serve.batch.BatchScheduler`` can stack
MANY sessions' windows as rows of ONE dispatch per pow2 bucket. A
session it drives (``defer_device``) keeps its resident lanes behind
the host views while a frontier lives (the window is assembled from
the views alone), and holds its rows of the bucket output on the device
until something reads the resident weave (``_flush_window``).

The device is the package default (``use_device``) unless ``device=``
names one; on the card every wave runs the B1, B2 and B3 kernels.
With telemetry on (``obs``), each wave emits its spans, one
``wave.cost`` event, its ``wave.digest`` semantics and a device-memory
sample; with it off, none of that runs.

**Fault injection.** With the chaos engine armed, each ``wave()``
passes its seams first: a ``stall`` fault sleeps there, and a
``budget_exhaust("session")`` fault drops the delta frontier exactly
as a real window-budget exhaustion would, so that wave runs full width
(bit-identical digests). Every dispatch runs through
``recovery.run_dispatch``, where injected dispatch faults are retried.
"""

from __future__ import annotations

import base64
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import chaos as _chaos
from .. import obs
from ..benchgen import LANE_KEYS5, lanes_from_numpy, v5_token_budget
from ..collections import shared as s
from ..device import resolve_device
from ..weaver import lanecache
from ..weaver.arrays import next_pow2
from ..weaver.segments import SEG_LANE_KEYS, concat_seg_tables
from . import recovery as _recovery
from .mesh import mix32_np, replica_digest
from .wave import (WaveBuffers, WaveResult, _PAD, _assemble_rows,
                   _observe_semantics, _sampled_body_spotcheck,
                   assemble_delta_window, delta_domain_ok, fetch_digest)

__all__ = ["FleetSession"]

_LANE_COLS = ("hi", "lo", "cci", "vc", "valid", "seg")


def _upload(lanes, device) -> dict:
    """The lane batch as resident tensors on ``device``. Always a copy:
    the session writes into them in place, and on the CPU
    ``lanes_from_numpy`` would alias the reused host buffers."""
    out = lanes_from_numpy(lanes, device)
    return {k: t.clone() if t.device.type == "cpu" else t
            for k, t in out.items()}


def _apply_deltas(dev, deltas, starts, counts, b_shift, old_nb) -> None:
    """Splice per-tree delta lanes into the resident batch, in place.

    ``deltas[col]`` is a host [B, 2, d_max] array; ``starts``/``counts``
    [B, 2] are each tree's previous length and delta size (concat lane
    = tree offset + start + j). ``b_shift`` [B] re-bases tree B's OLD
    seg ordinals when tree A gained segments; ``old_nb`` [B] bounds that
    shift to B's pre-delta lanes."""
    B, N = dev["hi"].shape
    cap = N // 2
    d_max = deltas["hi"].shape[2]
    device = dev["hi"].device
    lane = torch.arange(N, device=device)
    nb = torch.as_tensor(old_nb, dtype=torch.int32, device=device)
    shift = torch.as_tensor(b_shift, dtype=torch.int32, device=device)
    seg = dev["seg"]
    moved = (lane[None, :] >= cap) & (lane[None, :] < cap + nb[:, None]) \
        & (seg >= 0)
    seg.add_(torch.where(moved, shift[:, None], 0))
    # the delta lanes' coordinates, on the host: only lanes under each
    # tree's count are ever indexed
    r, t, j = np.nonzero(np.arange(d_max)[None, None, :]
                         < counts[:, :, None])
    rows = torch.as_tensor(r, device=device)
    lanes = torch.as_tensor(t * cap + starts[r, t] + j, device=device)
    for col in _LANE_COLS:
        vals = torch.as_tensor(np.ascontiguousarray(deltas[col][r, t, j]))
        dev[col].index_put_((rows, lanes),
                            vals.to(device=device, dtype=dev[col].dtype))


class FleetSession:
    """A device-resident batch of replica pairs converged wave after
    wave. See the module docstring; usage::

        sess = FleetSession(pairs)          # full upload once
        d0 = sess.wave()                    # digests, device-resident
        pairs = edit(pairs)                 # host-side appends
        sess.update(pairs)                  # ship deltas only
        d1 = sess.wave()
    """

    def __init__(self, pairs: Sequence[Tuple[object, object]],
                 d_max: int = 256, u_headroom: float = 2.0,
                 delta: bool = True, device=None):
        pairs = list(pairs)
        if not pairs:
            raise s.CausalError("Nothing to merge.",
                                {"causes": {"empty-fleet"}})
        for a, b in pairs:
            s.check_mergeable(a.ct, b.ct)
        self.device = resolve_device(device)
        self.d_max = int(d_max)
        self._bufs = WaveBuffers()
        self._views: List[Tuple[object, object]] = []
        self._uploaded_n = None     # [B, 2] lane counts on device
        self._uploaded_k = None     # [B] tree-A segment counts on device
        self.capacity = 0
        self.u_max = 0
        self._u_headroom = float(u_headroom)
        self.dev = None
        # delta-native wave state, established after each full wave
        # (see _establish_delta): None = next wave runs full width.
        # ``delta=False`` pins the session to full-width waves.
        # Establishment costs an O(doc) rank fetch, so repeated
        # failures back off after _DELTA_FAILURE_LIMIT misses in a row.
        self._delta_enabled = bool(delta)
        self._delta = None
        self._delta_failures = 0
        # what the LAST update shipped (delta lanes against a full
        # re-upload): the divergence evidence pop_divergence hands out
        self._last_delta_lanes = 0
        self._last_update_full = False
        # the last wave's fetched digests: checkpoint() serializes
        # them and restore() gates on recomputing them bit-identically
        self._last_digest = None
        self._full_upload(pairs)

    _DELTA_FAILURE_LIMIT = 3

    # Batched-serving state (see window_pack/complete_window): the last
    # bucket dispatch's unspliced window output, the deferred
    # device-lane mode flag, and whether the resident lanes are behind
    # the host views. Class-level defaults, so restored sessions get
    # the unbatched behaviour.
    _pending_window = None
    _dev_stale = False
    defer_device = False

    # ------------------------------------------------------------------
    def _collect_views(self, pairs):
        views = []
        for a, b in pairs:
            va = lanecache.view_for(a.ct)
            vb = lanecache.view_for(b.ct)
            if va is None or vb is None or not lanecache.compatible(
                    (va, vb)):
                return None
            views.append((va, vb))
        return views

    def _full_upload(self, pairs):
        with obs.span("session.full_upload", pairs=len(pairs)):
            obs.counter("session.full_upload").inc()
            return self._full_upload_inner(pairs)

    def _full_upload_inner(self, pairs):
        views = self._collect_views(pairs)
        if views is None:
            raise s.CausalError(
                "fleet outside the device domain (PackSpec overflow?)",
                {"causes": {"outside-domain"}},
            )
        cap = next_pow2(max(max(va.n, vb.n) for va, vb in views))
        if cap < self.capacity:
            cap = self.capacity  # never shrink: resident shapes are fixed
        # device-resident rounds never see host value bytes: sampled
        # append-only body check on every (re-)upload (see wave.py)
        _bad = _sampled_body_spotcheck(views)
        if _bad:
            raise next(iter(_bad.values()))
        lanes = _assemble_rows(views, cap, bufs=self._bufs)
        u = v5_token_budget(lanes)
        # pow2-quantized: stable program shapes across re-uploads
        self.u_max = max(self.u_max, next_pow2(
            int(u * self._u_headroom) + self.d_max
        ))
        if obs.enabled():
            # resident-budget headroom: how far the CURRENT fleet sits
            # below the session's token ceiling
            from ..obs import semantic as _sem

            _sem.token_headroom(int(self.u_max) - int(u), "session")
        self.capacity = cap
        self.dev = _upload(lanes, self.device)
        self._views = views
        self._uploaded_n = np.array(
            [[va.n, vb.n] for va, vb in views], np.int32
        )
        self._uploaded_k = np.array(
            [int(va.segments()["sg_len"].shape[0]) for va, _ in views],
            np.int32,
        )
        # what the delta path must verify survived unchanged: the
        # per-lane segment ordinals of every uploaded prefix (an
        # interior stab restructures them) and the interner rank
        # generation (a reassignment repacks every lo)
        self._uploaded_rol = [
            (va.segments()["run_of_lane"], vb.segments()["run_of_lane"])
            for va, vb in views
        ]
        self._gen = views[0][0].interner.generation
        self.pairs = list(pairs)
        # a full upload is the session's O(doc) degradation: the next
        # wave.cost records it as a full-bag wave with zero delta ops,
        # and the delta-wave capability drops until the next full wave
        # re-establishes the resident frontier
        self._last_delta_lanes = 0
        self._last_update_full = True
        self._delta = None
        self._dev_stale = False
        self._pending_window = None
        if obs.enabled():
            from ..obs import devprof

            devprof.sample_device_memory("session.upload", self.device)

    def _degrade(self, pairs, reason: str):
        """The update-level ``delta -> full`` recovery-ladder rung:
        every full re-upload taken from the delta path is a declared,
        evidenced transition (``recovery.step``), not a silent
        bounce."""
        _recovery.step("session", "delta", "full", reason,
                       uuid=str(pairs[0][0].ct.uuid) if pairs else "")
        return self._full_upload(pairs)

    # ------------------------------------------------------------------
    def update(self, pairs: Sequence[Tuple[object, object]]):
        """Ship this wave's edits. Appends ride the delta path; anything
        else (dropped caches, oversized deltas, capacity growth) falls
        back to a full re-upload."""
        pairs = list(pairs)
        # an update invalidates the checkpointable state until the next
        # wave: the resident pairs move ahead of the last wave's
        # rank/visibility/digest
        self._last_digest = None
        with obs.span("session.update", pairs=len(pairs)):
            return self._update_inner(pairs)

    def _update_inner(self, pairs):
        if len(pairs) != len(self._views):
            return self._degrade(pairs, "pair-count-change")
        views = self._collect_views(pairs)
        if views is None:
            raise s.CausalError(
                "fleet outside the device domain",
                {"causes": {"outside-domain"}},
            )
        if views[0][0].interner.generation != self._gen:
            # rank reassignment since upload: resident lo/sg packs are
            # old-generation, deltas would be new-generation
            return self._full_upload(pairs)
        B = len(pairs)
        cap = self.capacity
        d_max = self.d_max
        starts = np.zeros((B, 2), np.int32)
        counts = np.zeros((B, 2), np.int32)
        tables = {k: [] for k in SEG_LANE_KEYS}
        b_shift = np.zeros(B, np.int32)
        old_nb = np.zeros(B, np.int32)
        s_needed = 0
        for r, ((va, vb), (ova, ovb)) in enumerate(
                zip(views, self._views)):
            for t, (v, ov) in enumerate(((va, ova), (vb, ovb))):
                n0 = int(self._uploaded_n[r, t])
                if (v.arena is not ov.arena and ov.arena.nodes[:n0]
                        != v.arena.nodes[:n0]):
                    return self._degrade(pairs, "rewritten-history")
                if v.n < n0 or v.n - n0 > d_max or v.n > cap:
                    return self._degrade(pairs, "delta-overflow")
                # an append that stabbed an old interior lane
                # restructures the uploaded prefix's segment ordinals —
                # the resident seg lane would be silently stale
                if not np.array_equal(
                        v.segments()["run_of_lane"][:n0],
                        self._uploaded_rol[r][t][:n0]):
                    return self._degrade(pairs, "interior-stab")
            ka = int(va.segments()["sg_len"].shape[0])
            kb = int(vb.segments()["sg_len"].shape[0])
            s_needed = max(s_needed, ka + kb)
        s_max = self.dev["sg_len"].shape[1]
        if s_needed > s_max:
            return self._degrade(pairs, "segment-overflow")

        # delta path committed from here on; the sampled append-only
        # body check covers whole trees (a corrupt lane may be resident
        # from an earlier upload)
        _bad = _sampled_body_spotcheck(views)
        if _bad:
            raise next(iter(_bad.values()))
        obs.counter("session.delta_update").inc()

        if self._delta is not None:
            # delta-WAVE domain (stricter than the lane-splice domain
            # above): every appended lane must weave strictly after the
            # frozen resident prefix, and the window must fit the
            # session's budget. A violation only drops the delta-wave
            # capability (the next wave runs full width and
            # re-establishes); the lane splice stays valid either way.
            dstate = self._delta
            w_cap = dstate["w_cap"]
            for r, (va, vb) in enumerate(views):
                sp = int(dstate["s"][r])
                anchor = int(dstate["anchor"][r])
                ok = all(
                    v.n - sp <= w_cap - 1 and delta_domain_ok(
                        v, sp, anchor, start=int(self._uploaded_n[r, t]))
                    for t, v in enumerate((va, vb)))
                if not ok:
                    obs.counter("session.delta_wave_invalidate").inc()
                    # the splice stays valid; only the delta-WAVE
                    # capability drops — the next wave runs the full
                    # rung and re-establishes
                    _recovery.step("session", "delta", "full",
                                   "domain-violation",
                                   uuid=str(pairs[0][0].ct.uuid), pair=r)
                    self._delta = None
                    break

        # Batched serving defers the resident lane splice: with a live
        # frontier the delta wave assembles its window from host views
        # only, so the device lanes can stay behind until the next
        # full-width wave (which re-uploads). Without a live frontier
        # the next wave is full width and needs current lanes — stale
        # residents take the full upload instead of a splice onto lanes
        # that no longer match the bookkeeping.
        defer = self.defer_device and self._delta is not None
        if not defer and self._dev_stale:
            return self._full_upload(pairs)
        deltas = None
        if not defer:
            deltas = {c: np.full((B, 2, d_max), _PAD[c],
                                 bool if c == "valid" else np.int32)
                      for c in _LANE_COLS}
        for r, (va, vb) in enumerate(views):
            segs_a, segs_b = va.segments(), vb.segments()
            ka = int(segs_a["sg_len"].shape[0])
            b_shift[r] = ka - int(self._uploaded_k[r])
            old_nb[r] = int(self._uploaded_n[r, 1])
            for t, (v, segs) in enumerate(((va, segs_a), (vb, segs_b))):
                a = v.arena
                n0 = int(self._uploaded_n[r, t])
                d = v.n - n0
                starts[r, t] = n0
                counts[r, t] = d
                if d and not defer:
                    sl = slice(n0, v.n)
                    deltas["hi"][r, t, :d] = a.ts[sl]
                    deltas["lo"][r, t, :d] = a.spec.pack_lo(
                        a.site[sl], a.tx[sl]
                    )
                    ci = a.cause_idx[sl]
                    deltas["cci"][r, t, :d] = np.where(
                        ci >= 0, ci + t * cap, -1
                    )
                    deltas["vc"][r, t, :d] = a.vclass[sl]
                    deltas["valid"][r, t, :d] = True
                    base = 0 if t == 0 else ka
                    deltas["seg"][r, t, :d] = (
                        segs["run_of_lane"][n0:v.n] + base
                    )
                self._uploaded_n[r, t] = v.n
            self._uploaded_k[r] = ka
            self._uploaded_rol[r] = (
                segs_a["run_of_lane"], segs_b["run_of_lane"]
            )
            if not defer:
                # small per-row tables, rebuilt on the host every wave
                row, _bases = concat_seg_tables(
                    [(segs_a, int(self._uploaded_n[r, 0])),
                     (segs_b, int(self._uploaded_n[r, 1]))],
                    cap, s_max,
                )
                for k in SEG_LANE_KEYS:
                    tables[k].append(row[k])

        if defer:
            # the resident lanes stay behind until the next full-width
            # wave re-uploads (see _full_wave)
            self._dev_stale = True
        else:
            _apply_deltas(self.dev, deltas, starts, counts, b_shift,
                          old_nb)
            if obs.enabled():
                # the resident splice counts as a dispatch, as the
                # reference's splice program does — outside any wave
                # window (update-time), so it counts globally; the
                # spliced lane total rides the NEXT wave.cost
                from ..obs import costmodel as _cm

                _cm.record_dispatch(f"session:splice:d{self.d_max}",
                                    site="session")
            for k in SEG_LANE_KEYS:
                self.dev[k] = torch.as_tensor(np.stack(tables[k])).to(
                    device=self.device, dtype=self.dev[k].dtype)
        self._last_delta_lanes = int(counts.sum())
        self._last_update_full = False
        self._views = views
        self.pairs = pairs

    def _uuid(self) -> str:
        """The fleet's document, named in the ladder's notes."""
        return str(self.pairs[0][0].ct.uuid)

    # ------------------------------------------------------------------
    def wave(self):
        """One merge wave over the resident state. Returns the [B]
        uint32 digest array (fetched); rank/visible stay on the device
        as ``self.last_rank`` / ``self.last_visible``.

        With a delta frontier established (a full wave ran and every
        divergent lane since stays inside the delta domain) the wave
        dispatches only the divergent window and splices the result
        into the resident weave. First contact, domain violations,
        window-budget overflow and every update()-level fallback run
        the full-width kernel instead, which re-establishes."""
        if _chaos.enabled():
            # the injectable seams: a stall fault sleeps here, a
            # budget-exhaust fault drops the delta frontier exactly like
            # a real window-budget exhaustion would — the declared
            # ladder handles both, bit-identically
            _chaos.stall_point("session")
            if self._delta is not None \
                    and _chaos.budget_exhaust("session"):
                obs.counter("session.delta_wave_invalidate").inc()
                _recovery.step("session", "delta", "full",
                               "budget-exhaustion", uuid=self._uuid())
                self._delta = None
        if self._delta is not None:
            out = self._delta_wave()
            if out is not None:
                return out
        return self._full_wave()

    def _full_wave(self):
        """The full-width wave: v5 kernel + digest over the whole
        resident batch, then (re-)establish the delta frontier from its
        ranks."""
        from ..weaver.torchw5 import batched_merge_weave_v5

        # a full wave recomputes every lane's rank, superseding any
        # unspliced window output; and it reads the resident lanes, so a
        # deferred-splice session re-uploads from the current views
        # first (the O(doc) cost the batched path deferred)
        self._pending_window = None
        if self._dev_stale:
            self._full_upload(self.pairs)
        if obs.enabled():
            from ..obs import costmodel as _cm

            _cm.wave_begin("session")
            # wedge-triage heartbeat: before the dispatch, so a live
            # monitor can pair "session wave started" with the
            # wave.digest that should follow (see parallel/wave.py)
            obs.event("run.heartbeat", stage="session.wave",
                      uuid=self._uuid(), pairs=len(self.pairs))

        def run():
            return batched_merge_weave_v5(
                *(self.dev[k] for k in LANE_KEYS5),
                u_max=self.u_max, k_max=self.u_max, device=self.device)

        with obs.span("session.wave", pairs=len(self.pairs),
                      u_max=int(self.u_max)):
            if obs.enabled():
                from ..obs import devprof

                run = devprof.profiled(
                    run, self.device, site="session", pipeline="v5",
                    B=len(self.pairs), N=2 * int(self.capacity),
                    u_max=int(self.u_max), k_max=int(self.u_max))
            r, v, _c, ov = _recovery.run_dispatch("session", run,
                                                  uuid=self._uuid())
            out = fetch_digest(replica_digest(self.dev["hi"],
                                              self.dev["lo"], r, v))
            if obs.enabled():
                from ..obs import costmodel as _cm

                _cm.record_dispatch(f"session:v5:u{int(self.u_max)}",
                                    site="session")
                _cm.record_dispatch("session:digest", site="session")
            self.last_rank = r
            self.last_visible = v
            self.last_overflow = ov
        if obs.enabled():
            # wave-boundary devprof sample: the session's whole point
            # is device residency, so its growth must be a curve
            from ..obs import devprof

            devprof.sample_device_memory("session", self.device)
        if bool(ov.any()):
            rows = torch.nonzero(ov).flatten().tolist()
            if obs.enabled():
                # an overflowed wave's digests are garbage — record
                # the incident, never feed them to the monitors; the
                # cost window is dropped too (fleet.session_overflow
                # is the incident record)
                from ..obs import costmodel as _cm
                from ..obs import semantic as _sem

                _sem.session_overflow(rows)
                _cm.wave_abandon()
            raise s.CausalError(
                "wave overflowed the session's token budget; raise "
                "u_headroom or re-create the session",
                {"causes": {"token-overflow"}, "rows": rows},
            )
        if obs.enabled():
            # every session digest is device-computed (overflow raised
            # above), so the whole wave feeds the divergence monitors
            sem = _observe_semantics(self.pairs, out,
                                     np.ones(len(self.pairs), bool),
                                     "session")
            # the cost-vs-divergence join, session flavor: delta ops
            # are the lanes the LAST update actually spliced (zero
            # after a full upload — that wave paid O(doc) transfer,
            # recorded as full_bag)
            from ..obs import costmodel as _cm

            _cm.wave_cost(
                uuid=self._uuid(),
                pairs=len(self.pairs),
                lanes=2 * int(self.capacity) * len(self.pairs),
                token_budget=int(self.u_max) * len(self.pairs),
                delta_ops=self._last_delta_lanes,
                full_bag=1 if self._last_update_full else 0,
                semantic=sem,
                path="full",
            )
            self._last_delta_lanes = 0
            self._last_update_full = False
        if self._delta_enabled:
            self._establish_delta(r, v)
        self._last_digest = out
        return out

    # ----------------------------------------------- delta-native wave
    def _fail_establish(self) -> None:
        self._delta_failures += 1
        obs.counter("session.delta_establish_fail").inc()

    def _establish_delta(self, rank_dev, vis_dev) -> None:
        """Derive the delta frontier from a completed full wave: the
        shared converged lane prefix per pair, the anchor (the prefix
        weave's final node), the frozen prefix digest contribution and
        the pow2 window budget. Any pair outside the domain disables the
        delta path until the next full wave (correct, just O(doc)).

        The shared-prefix precheck is host-only; the O(doc) rank fetch
        happens only after it passes, and the visibility fetch only
        after every pair's rank and domain checks pass."""
        self._delta = None
        if self._delta_failures >= self._DELTA_FAILURE_LIMIT:
            return
        B = len(self.pairs)
        cap = self.capacity
        N = 2 * cap
        s_arr = np.zeros(B, np.int32)
        anchor_arr = np.zeros(B, np.int32)
        pdig = np.zeros(B, np.uint32)
        w_now = 0
        for r, (va, vb) in enumerate(self._views):
            sp = lanecache.shared_prefix_len(va, vb)
            if sp < 1:
                return self._fail_establish()
            s_arr[r] = sp
        rank_np = rank_dev.cpu().numpy()
        for r, (va, vb) in enumerate(self._views):
            sp = int(s_arr[r])
            pr = np.minimum(rank_np[r, :sp], rank_np[r, cap:cap + sp])
            # the prefix must BE the weave's prefix: its ranks are
            # exactly {0..sp-1}, once each — anything else means some
            # divergent lane wove inside it and nothing can be frozen
            if not bool((pr < sp).all()) or int(pr.max()) != sp - 1 or \
                    int(np.bincount(pr, minlength=sp).max()) != 1:
                return self._fail_establish()
            anchor = int(np.argmax(pr))
            if int(va.arena.vclass[anchor]) > 0 or not (
                    delta_domain_ok(va, sp, anchor)
                    and delta_domain_ok(vb, sp, anchor)):
                # a special anchor breaks the host-jump locality
                return self._fail_establish()
            anchor_arr[r] = anchor
            w_now = max(w_now, va.n - sp, vb.n - sp)
        vis_np = vis_dev.cpu().numpy()
        for r, (va, _vb) in enumerate(self._views):
            sp = int(s_arr[r])
            arena = va.arena
            ra = rank_np[r, :sp]
            pr = np.minimum(ra, rank_np[r, cap:cap + sp])
            vis = np.where(ra < N, vis_np[r, :sp], vis_np[r, cap:cap + sp])
            hi = arena.ts[:sp].astype(np.int32)
            lo = arena.spec.pack_lo(arena.site[:sp], arena.tx[:sp])
            pdig[r] = np.uint32(
                mix32_np(hi, lo, pr.astype(np.int32), vis)
                .sum(dtype=np.uint64) & np.uint64(0xFFFFFFFF))
        self._delta_failures = 0
        self._delta = {
            "s": s_arr,
            "anchor": anchor_arr,
            "prefix_digest": pdig,
            # window budget: room for the current divergence plus one
            # round's appends, pow2-quantized; outgrowing it falls back
            # to a full wave, which re-establishes with the next bucket
            "w_cap": int(next_pow2(max(8, w_now + 1 + self.d_max))),
        }

    def _delta_wave(self):
        """The steady-state wave: weave the divergent window only,
        splice ranks and visibility into the resident weave, return
        digests bit-identical to the full wave's. Returns None when the
        dispatch overflowed (never, under the ``u_max = N_w`` budget
        rule — a safety net): the caller then runs the full wave."""
        from ..weaver import torchwd

        dstate = self._delta
        wcap = dstate["w_cap"]
        n_w = 2 * wcap
        # this wave's window covers a superset of any pending one's
        # lanes (same frontier, counts grow monotonically), so its
        # splice below supersedes the unflushed output bit for bit
        self._pending_window = None
        B = len(self.pairs)
        if obs.enabled():
            from ..obs import costmodel as _cm

            _cm.wave_begin("session")
            obs.event("run.heartbeat", stage="session.delta_wave",
                      uuid=self._uuid(), pairs=B)
        with obs.span("session.delta_wave", pairs=B, w_cap=int(wcap)):
            with obs.span("session.delta_assemble"):
                lanes, starts, counts = assemble_delta_window(
                    self._views, dstate["s"], dstate["anchor"], wcap, n_w)
            r0 = dstate["s"].astype(np.int32) - 1
            t = lanes_from_numpy(lanes, self.device)

            def run():
                return torchwd.batched_delta_weave(
                    *(t[k] for k in LANE_KEYS5), dstate["prefix_digest"],
                    r0, u_max=n_w, k_max=n_w, device=self.device)

            if obs.enabled():
                from ..obs import devprof

                run = devprof.profiled(
                    run, self.device, site="session", pipeline="delta",
                    B=B, N=int(n_w), u_max=int(n_w), k_max=int(n_w))
            rank_w, vis_w, digest, ovf = _recovery.run_dispatch(
                "session", run, uuid=self._uuid())
            out = fetch_digest(digest)
            if bool(ovf.any()):  # pragma: no cover - unreachable at u = N_w
                obs.counter("session.delta_wave_overflow").inc()
                self._delta = None
                if obs.enabled():
                    from ..obs import costmodel as _cm

                    _recovery.step("session", "delta", "full",
                                   "window-overflow", uuid=self._uuid())
                    _cm.wave_abandon()
                return None
            torchwd.splice_ranks(self.last_rank, self.last_visible, rank_w,
                                 vis_w, starts, counts, r0)
            self.last_overflow = ovf
            if obs.enabled():
                from ..obs import costmodel as _cm

                _cm.record_dispatch(f"session:delta:w{int(wcap)}",
                                    site="session")
                _cm.record_dispatch("session:delta_splice", site="session")
        if obs.enabled():
            from ..obs import devprof

            devprof.sample_device_memory("session", self.device)
            sem = _observe_semantics(self.pairs, out, np.ones(B, bool),
                                     "session")
            from ..obs import costmodel as _cm

            _cm.wave_cost(
                uuid=self._uuid(),
                pairs=B,
                lanes=2 * int(self.capacity) * B,
                tokens=int(counts.sum()) + 2 * B,
                token_budget=int(n_w) * B,
                delta_ops=self._last_delta_lanes,
                full_bag=0,
                semantic=sem,
                path="delta",
            )
            self._last_delta_lanes = 0
            self._last_update_full = False
        self._last_digest = out
        return out

    # ------------------------------------------ batched-serving hooks
    #
    # The assemble → dispatch → splice pipeline of _delta_wave, factored
    # so an external scheduler (serve.batch.BatchScheduler) can stack
    # MANY sessions' windows as rows of ONE dispatch per pow2 bucket:
    # window_pack() hands out the host-side window spec,
    # complete_window() absorbs this session's rows of the bucket
    # dispatch's output, and the rank/visibility splice is deferred
    # (_flush_window) until something reads the resident weave.

    @property
    def bucket_key(self) -> int:
        """The pow2 batch-bucket key: the established window budget, or
        0 when the next wave must run full width (no frontier)."""
        return int(self._delta["w_cap"]) if self._delta is not None \
            else 0

    def window_pack(self):
        """The host-side delta-window spec _delta_wave would assemble,
        for an external batch scheduler: the current views, the frozen
        frontier arrays and the pow2 window budget (the bucket key).
        None when no frontier is established — the caller falls back
        to :meth:`wave` (full-width re-establish)."""
        if self._delta is None:
            return None
        dstate = self._delta
        return {
            "views": self._views,
            "s": dstate["s"],
            "anchor": dstate["anchor"],
            "prefix_digest": dstate["prefix_digest"],
            "w_cap": int(dstate["w_cap"]),
            "rows": len(self.pairs),
        }

    def abandon_frontier(self, reason: str):
        """Drop the delta frontier: the batched scheduler's per-tenant
        fallback rung (bucket window overflow, injected budget
        exhaustion). The next wave runs full width and re-establishes —
        this tenant alone pays the slow path, its bucket-mates stay
        fast. ``reason`` names the ladder step (``recovery.step``)."""
        if self._delta is None:
            return
        obs.counter("session.delta_wave_invalidate").inc()
        _recovery.step("serve", "batch", "full", reason, uuid=self._uuid())
        self._delta = None

    def complete_window(self, rank_w, vis_w, digest, starts, counts):
        """Absorb this session's rows of a bucket dispatch's output:
        ``rank_w``/``vis_w`` the ``[rows, 2*w_cap]`` window tensors (left
        on the device), ``digest`` the rows' host uint32 digests,
        ``starts``/``counts`` the window's ``[rows, 2]`` splice
        coordinates. The digests are bit-identical to what _delta_wave
        would have returned — same window assembly, same program, same
        budget — so they become the checkpointable wave output directly;
        the rank/visibility splice is deferred to :meth:`_flush_window`
        (checkpoint/merged) because the next wave's window covers a
        superset of these lanes anyway."""
        dstate = self._delta
        if dstate is None:
            raise s.CausalError(
                "complete_window without an established frontier",
                {"causes": {"no-frontier"}},
            )
        out = np.asarray(digest)
        self._pending_window = {
            "rank_w": rank_w.to(self.device),
            "vis_w": vis_w.to(self.device),
            "starts": np.asarray(starts, np.int32),
            "counts": np.asarray(counts, np.int32),
            "r0": dstate["s"].astype(np.int32) - 1,
        }
        if obs.enabled():
            # per-tenant semantics are unchanged by batching: the
            # wave.digest agreement, staleness and lag resolution all
            # observe THIS session's digests, same as _delta_wave
            _observe_semantics(self.pairs, out,
                               np.ones(len(self.pairs), bool), "session")
        self._last_digest = out
        return out

    def _flush_window(self):
        """Splice the pending window output into the resident
        rank/visibility tensors (``torchwd.splice_ranks``, in place).
        Deferred from complete_window: in the batched steady state many
        waves pass between materializations, and each window supersedes
        the last, so the splice runs once per read instead of once per
        wave."""
        pw = self._pending_window
        if pw is None:
            return
        self._pending_window = None
        from ..weaver import torchwd

        torchwd.splice_ranks(self.last_rank, self.last_visible,
                             pw["rank_w"], pw["vis_w"], pw["starts"],
                             pw["counts"], pw["r0"])
        if obs.enabled():
            from ..obs import costmodel as _cm

            _cm.record_dispatch("session:delta_splice", site="session")

    def pop_divergence(self):
        """(delta_lanes, full_bag) shipped since the last read — the
        divergence evidence, reset on read. The batched scheduler drains
        every bucket member and sums them onto the bucket's single
        ``wave.cost`` event."""
        d = int(self._last_delta_lanes)
        f = 1 if self._last_update_full else 0
        self._last_delta_lanes = 0
        self._last_update_full = False
        return d, f

    def converge(self, tree: bool = True,
                 w_budget: Optional[int] = None):
        """Converge the WHOLE resident fleet — every replica of every
        pair — into one host handle: by default through the merge
        reduction tree (``parallel.tree``: ceil(log2(2B)) batched
        device rounds, level 0 full width, later levels on the delta
        window path), or with ``tree=False`` through the flat fold
        (n-1 sequential pairwise waves). The resident pair state is
        untouched either way."""
        from . import tree as _tree

        replicas = [h for pair in self.pairs for h in pair]
        if tree:
            return _tree.merge_tree(replicas, w_budget=w_budget,
                                    device=self.device)
        return _tree.flat_fold(replicas, device=self.device)

    def merged(self, i: int):
        """Materialize pair ``i``'s converged tree (host handle) from
        the last wave."""
        self._flush_window()
        res = WaveResult(
            self.pairs, self._views, self.capacity,
            self.last_rank.cpu().numpy(), self.last_visible.cpu().numpy(),
            np.zeros(len(self.pairs), np.uint32), {}, "v5",
        )
        return res.merged(i)

    # --------------------------------------------- checkpoint/restore

    CHECKPOINT_VERSION = 1

    def checkpoint(self) -> dict:
        """The session's resident state as one JSON-able dict, in the
        reference's format: the replica pairs (serde's tagged node-bag
        encoding), the last wave's rank/visibility/digest arrays and
        the delta frontier. ``restore`` resumes steady-state delta
        waves from it, paying one lane upload and one digest dispatch
        (the bit-identity gate). Requires a completed wave with no
        update since."""
        from .. import serde

        if self._last_digest is None or not hasattr(self, "last_rank"):
            raise s.CausalError(
                "nothing to checkpoint: the resident state is not a "
                "wave's output (run a wave first; an update since "
                "the last wave also invalidates it)",
                {"causes": {"no-wave"}},
            )
        self._flush_window()
        with obs.span("session.checkpoint", pairs=len(self.pairs)):
            obs.counter("session.checkpoint").inc()
            ck = {
                "~causal_session": self.CHECKPOINT_VERSION,
                "d_max": int(self.d_max),
                "u_headroom": float(self._u_headroom),
                "delta_enabled": bool(self._delta_enabled),
                "u_max": int(self.u_max),
                "capacity": int(self.capacity),
                "pairs": [[serde.to_data(a), serde.to_data(b)]
                          for a, b in self.pairs],
                "rank": _pack_arr(self.last_rank.cpu().numpy()),
                "visible": _pack_arr(self.last_visible.cpu().numpy()),
                "digest": _pack_arr(np.asarray(self._last_digest)),
            }
            if self._delta is not None:
                ck["delta"] = {
                    "s": _pack_arr(self._delta["s"]),
                    "anchor": _pack_arr(self._delta["anchor"]),
                    "prefix_digest": _pack_arr(self._delta["prefix_digest"]),
                    "w_cap": int(self._delta["w_cap"]),
                }
            return ck

    def checkpoint_to(self, path: str) -> None:
        """``checkpoint()`` straight to a JSON file, written to a
        temporary name, fsynced and renamed, so a crash mid-write never
        leaves a torn checkpoint."""
        blob = json.dumps(self.checkpoint())
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def restore(cls, data, device=None) -> "FleetSession":
        """Rebuild a session from :meth:`checkpoint` output (the dict,
        or a path to a ``checkpoint_to`` file). The restore is GATED on
        digest bit-identity: the uploaded lanes plus the restored
        rank/visibility must reproduce the checkpoint's digests (one
        digest dispatch), or it refuses (``causes
        {"checkpoint-mismatch"}``). The delta frontier is revalidated on
        the host against the rebuilt views; if it no longer holds, the
        session restores without it (the next wave runs full width)."""
        if isinstance(data, str):
            try:
                with open(data) as f:
                    data = json.load(f)
            except ValueError as e:
                # a torn pack refuses through the same declared gate as
                # a tampered one
                raise s.CausalError(
                    "checkpoint file undecodable (torn pack?)",
                    {"causes": {"checkpoint-mismatch"}, "why": str(e)},
                ) from None
        if not (isinstance(data, dict)
                and data.get("~causal_session") == cls.CHECKPOINT_VERSION):
            raise s.CausalError(
                "not a FleetSession checkpoint (or unknown version)",
                {"causes": {"checkpoint-mismatch"},
                 "version": (data or {}).get("~causal_session")
                 if isinstance(data, dict) else None},
            )
        with obs.span("session.restore"):
            return cls._restore_checked(data, device)

    @classmethod
    def _restore_checked(cls, data, device) -> "FleetSession":
        from .. import serde

        pairs = [(serde.from_data(ea), serde.from_data(eb))
                 for ea, eb in data["pairs"]]
        obj = cls.__new__(cls)
        obj.device = resolve_device(device)
        obj.d_max = int(data["d_max"])
        obj._bufs = WaveBuffers()
        obj._views = []
        obj._uploaded_n = None
        obj._uploaded_k = None
        obj.capacity = 0
        # pre-seed the restored budget: _full_upload keeps the max
        obj.u_max = int(data["u_max"])
        obj._u_headroom = float(data["u_headroom"])
        obj.dev = None
        obj._delta_enabled = bool(data["delta_enabled"])
        obj._delta = None
        obj._delta_failures = 0
        obj._last_delta_lanes = 0
        obj._last_update_full = False
        obj._last_digest = None
        for a, b in pairs:
            s.check_mergeable(a.ct, b.ct)
        obj._full_upload(pairs)
        if obj.capacity != int(data["capacity"]):
            raise s.CausalError(
                "checkpoint capacity mismatch (divergent rebuild)",
                {"causes": {"checkpoint-mismatch"},
                 "expected": int(data["capacity"]),
                 "got": int(obj.capacity)},
            )
        B = len(pairs)
        try:
            rank = _unpack_arr(data["rank"])
            visible = _unpack_arr(data["visible"])
            want = _unpack_arr(data["digest"])
        except (KeyError, TypeError, ValueError) as e:
            raise s.CausalError(
                "checkpoint arrays undecodable",
                {"causes": {"checkpoint-mismatch"}, "why": str(e)},
            ) from None
        shape = (B, 2 * obj.capacity)
        if rank.shape != shape or visible.shape != shape \
                or want.shape != (B,):
            raise s.CausalError(
                "checkpoint array shapes do not match the fleet",
                {"causes": {"checkpoint-mismatch"}},
            )
        obj.last_rank = torch.as_tensor(rank.astype(np.int32),
                                        device=obj.device)
        obj.last_visible = torch.as_tensor(visible.astype(bool),
                                           device=obj.device)
        obj.last_overflow = torch.zeros(B, dtype=torch.bool,
                                        device=obj.device)
        # THE restore gate: the rebuilt lanes + the checkpointed weave
        # outputs must reproduce the checkpointed digests bit for bit
        got = fetch_digest(replica_digest(
            obj.dev["hi"], obj.dev["lo"], obj.last_rank, obj.last_visible))
        if not np.array_equal(got, want):
            raise s.CausalError(
                "checkpoint digest mismatch: refusing to resume "
                "from unprovable state",
                {"causes": {"checkpoint-mismatch"},
                 "rows": np.flatnonzero(got != want).tolist()},
            )
        obj._last_digest = got
        delta_restored = False
        dck = data.get("delta")
        if dck is not None and obj._delta_enabled:
            frontier = {
                "s": _unpack_arr(dck["s"]),
                "anchor": _unpack_arr(dck["anchor"]),
                "prefix_digest": _unpack_arr(dck["prefix_digest"]),
                "w_cap": int(dck["w_cap"]),
            }
            if obj._frontier_valid(frontier):
                obj._delta = frontier
                delta_restored = True
            else:
                obs.counter("session.restore_frontier_drop").inc()
        _recovery.restore_recorded("session", B, delta_restored,
                                   uuid=str(pairs[0][0].ct.uuid))
        return obj

    def _frontier_valid(self, frontier: dict) -> bool:
        """Host-only revalidation of a restored delta frontier against
        the rebuilt views: the shared prefix still covers ``s``, the
        anchor is a live non-special lane, every divergent lane is still
        inside the delta domain, and the window fits the budget."""
        w_cap = int(frontier["w_cap"])
        for r, (va, vb) in enumerate(self._views):
            sp = int(frontier["s"][r])
            anchor = int(frontier["anchor"][r])
            if sp < 1 or anchor >= sp:
                return False
            if lanecache.shared_prefix_len(va, vb) < sp:
                return False
            if int(va.arena.vclass[anchor]) > 0:
                return False
            if va.n - sp > w_cap - 1 or vb.n - sp > w_cap - 1:
                return False
            if not (delta_domain_ok(va, sp, anchor)
                    and delta_domain_ok(vb, sp, anchor)):
                return False
        return True


def _pack_arr(arr: np.ndarray) -> dict:
    """A numpy array as a compact JSON-able dict (base64 of the raw
    bytes + dtype + shape), the reference's encoding."""
    arr = np.ascontiguousarray(arr)
    return {
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "b64": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def _unpack_arr(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["b64"])
    arr = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
    return arr.reshape([int(x) for x in d["shape"]]).copy()
