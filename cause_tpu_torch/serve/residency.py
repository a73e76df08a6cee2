"""LRU residency for hot documents: device memory as a cache, host
packs as the backing store — wrong answers structurally impossible.

A zipf-hot tenant population is larger than device memory by
assumption (millions of cold documents, a hot head in the thousands).
The residency manager keeps at most ``capacity`` tenants' device
state (their :class:`FleetSession`s — resident lanes, rank/visibility,
delta frontier) and spills the LRU tail to host:

- **evict** = a checkpoint-grade pack via serde
  (``FleetSession.checkpoint()`` — node bags + base64 arrays + the
  frontier), written to ``spill_dir`` when given (atomic rename) or
  held in memory; the session AND its host handles drop, so eviction
  genuinely frees both device and host working state (the session's
  CUDA tensors return to PyTorch's caching allocator);
- **touch** of an evicted tenant = ``FleetSession.restore`` on the
  package default device (``use_device``; without a card, asking for
  CUDA raises) — GATED
  on digest bit-identity (one lane upload + one digest dispatch must
  reproduce the packed digests or the restore REFUSES with
  ``checkpoint-mismatch``). A torn or tampered pack can cost a
  re-upload and a loud error; it can never cost a wrong answer.

Every transition is counted in ``stats`` (the reference also emits
``serve.evict`` / ``serve.restore`` events and the
``serve.resident_docs`` gauge; they come back with the telemetry
port).

Evict requires the session to be wave-current (an update since the
last wave makes the checkpoint unprovable — ``FleetSession`` refuses); the service guarantees that by waving every touched tenant
before sleeping, and :meth:`evict` surfaces the ``no-wave`` refusal
rather than dropping state it cannot pack.
"""

from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional


__all__ = ["ResidencyManager"]


class ResidencyManager:
    """See the module docstring. Single-threaded by design (the
    service's tick loop owns it); the soak's generator threads never
    touch residency directly."""

    # the owning service's batched-tick mode: every inserted/restored
    # session is marked for the deferred-splice path so a restored
    # tenant rejoins its bucket instead of paying per-tenant splices
    batched = False

    def __init__(self, capacity: int, spill_dir: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.spill_dir = spill_dir
        if spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        self._resident: "OrderedDict[str, object]" = OrderedDict()
        self._spilled: Dict[str, object] = {}  # uuid -> pack dict|path
        self.stats = {"evictions": 0, "restores": 0}

    # ------------------------------------------------------- queries

    @property
    def resident_docs(self) -> int:
        return len(self._resident)

    def resident(self) -> List[str]:
        return list(self._resident)

    def spilled(self) -> List[str]:
        return list(self._spilled)

    def __contains__(self, uuid: str) -> bool:
        return uuid in self._resident or uuid in self._spilled

    def buckets(self) -> Dict[int, List[str]]:
        """Resident tenants grouped by their pow2 batch-bucket key
        (``FleetSession.bucket_key``; 0 = next wave runs full width).
        The batched tick's marshaling unit: every tenant under one
        key rides one fused dispatch."""
        out: Dict[int, List[str]] = {}
        for uuid, sess in self._resident.items():
            out.setdefault(int(getattr(sess, "bucket_key", 0)),
                           []).append(uuid)
        return out

    # ----------------------------------------------------- transitions

    def insert(self, uuid: str, session) -> None:
        """Register a (new or restored) session as resident, evicting
        LRU tenants past capacity. The inserted tenant is the MRU."""
        uuid = str(uuid)
        session.defer_device = self.batched
        self._resident[uuid] = session
        self._resident.move_to_end(uuid)
        self._spilled.pop(uuid, None)
        while len(self._resident) > self.capacity:
            self.evict(next(iter(self._resident)))

    def evict(self, uuid: str) -> None:
        """Spill one resident tenant to a checkpoint-grade pack. The
        session must be wave-current (FleetSession.checkpoint's
        contract) — a ``no-wave`` refusal propagates loudly."""
        uuid = str(uuid)
        sess = self._resident[uuid]
        # pack FIRST, drop from the resident map only on success — a
        # no-wave/pack refusal must leave the tenant resident (loud
        # error, state intact), never in neither map
        if self.spill_dir:
            path = os.path.join(self.spill_dir, f"{uuid}.ckpt.json")
            sess.checkpoint_to(path)
            pack = path
        else:
            pack = sess.checkpoint()
        del self._resident[uuid]
        self._spilled[uuid] = pack
        self.stats["evictions"] += 1

    def get(self, uuid: str):
        """Touch one tenant: the resident session (MRU-bumped), or a
        digest-gated restore from its spill pack (evicting LRU
        tenants to make room), or None for a tenant this manager has
        never seen. A pack that fails the digest gate raises
        ``CausalError(checkpoint-mismatch)`` — never a silently wrong
        session."""
        uuid = str(uuid)
        sess = self._resident.get(uuid)
        if sess is not None:
            self._resident.move_to_end(uuid)
            return sess
        pack = self._spilled.get(uuid)
        if pack is None:
            return None
        from ..parallel.session import FleetSession

        # make room BEFORE the restore uploads device state: the
        # capacity bound must hold at every instant — transiently
        # holding capacity+1 sessions would OOM exactly in the
        # memory-pressure regime this manager exists to manage
        while len(self._resident) >= self.capacity:
            self.evict(next(iter(self._resident)))
        sess = FleetSession.restore(pack)  # the digest gate lives here
        self.stats["restores"] += 1
        if self.spill_dir and isinstance(pack, str):
            try:
                os.unlink(pack)
            except OSError:  # pragma: no cover - cleanup best-effort
                pass
        self.insert(uuid, sess)
        return sess

    def get_many(self, uuids: List[str]) -> "OrderedDict[str, object]":
        """Touch a GROUP for one batched tick: every named tenant
        resident and MRU-bumped before any of them updates, so the
        restores' evictions can only hit tenants OUTSIDE the group
        (wave-current between ticks — evictable). The group must fit
        device memory: more than ``capacity`` uuids cannot be
        co-resident, and silently splitting here would hide the
        working-set overflow the caller has to chunk around. Unknown
        uuids are simply absent from the result (the caller's
        unknown-tenant path stays loud)."""
        uuids = [str(u) for u in uuids]
        if len(uuids) > self.capacity:
            raise ValueError(
                f"get_many: group of {len(uuids)} exceeds residency "
                f"capacity {self.capacity} — chunk the group")
        out: "OrderedDict[str, object]" = OrderedDict()
        for uuid in uuids:
            sess = self.get(uuid)
            if sess is not None:
                out[uuid] = sess
        return out

    def sweep_spill(self) -> int:
        """Retention for the spill directory (spill packs join the
        post-checkpoint GC policy): remove every ``*.ckpt.json``
        pack no longer backing a spilled tenant — a restored tenant's
        leftover pack, a crashed process's stale tmp — and return the
        bytes reclaimed. Live packs (anything ``self._spilled`` points
        at) are never touched."""
        if not self.spill_dir:
            return 0
        live = {os.path.basename(p) for p in self._spilled.values()
                if isinstance(p, str)}
        freed = 0
        try:
            names = os.listdir(self.spill_dir)
        except OSError:
            return 0
        for name in names:
            if name in live:
                continue
            if not (name.endswith(".ckpt.json") or ".tmp." in name):
                continue
            fp = os.path.join(self.spill_dir, name)
            try:
                nb = os.path.getsize(fp)
                os.unlink(fp)
            except OSError:  # pragma: no cover - sweep is best-effort
                continue
            freed += nb
        return freed

    # ---------------------------------------------------- checkpointing

    def checkpoint_all(self, out_dir: str) -> Dict[str, dict]:
        """Pack EVERY tenant (resident sessions checkpointed, spilled
        packs copied) into ``out_dir`` — the drain's persistence step.
        Returns ``{uuid: {"file": relpath}}`` for the manifest."""
        os.makedirs(out_dir, exist_ok=True)
        out: Dict[str, dict] = {}
        for uuid, sess in self._resident.items():
            rel = f"{uuid}.ckpt.json"
            sess.checkpoint_to(os.path.join(out_dir, rel))
            out[uuid] = {"file": rel}
        for uuid, pack in self._spilled.items():
            rel = f"{uuid}.ckpt.json"
            dst = os.path.join(out_dir, rel)
            # tmp-fd fsync before each rename: post-checkpoint WAL GC
            # retires segments on the strength of these files, so a
            # torn pack after a crash is real data loss, not a retry.
            # The DIRECTORY entries are fsynced once by the caller
            # (service checkpoint fsync_dir after the manifest swap),
            # not per file here.
            if isinstance(pack, str):
                if os.path.abspath(pack) != os.path.abspath(dst):
                    blob = open(pack).read()
                    tmp = f"{dst}.tmp.{os.getpid()}"
                    with open(tmp, "w") as f:
                        f.write(blob)
                        f.flush()
                        os.fsync(f.fileno())
                    # the caller fsyncs out_dir once after the manifest swap
                    os.replace(tmp, dst)
            else:
                tmp = f"{dst}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    f.write(json.dumps(pack))
                    f.flush()
                    os.fsync(f.fileno())
                # the caller fsyncs out_dir once after the manifest swap
                os.replace(tmp, dst)
            out[uuid] = {"file": rel}
        return out
