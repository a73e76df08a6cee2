"""The port's batched serving tick against the JAX package's.

Mirrors ``tests/test_serve_batch.py`` (all six cases) and the residency
cases of ``tests/test_chaos.py`` (``:623``, eviction raced with a
checkpoint, and the torn spill pack after it), each scenario run in
both packages through ``test_torch_serve.both`` with the same documents
and op schedule: digests, documents, tick dicts and journal rows must
be equal. Where the reference counts device dispatches through its
telemetry (``wave_dispatches``, ``wave.cost``), these cases count the
calls of each package's ``batched_delta_weave`` instead: one a bucket
on the batched tick, one a tenant on the per-tenant path. The telemetry
halves (lag resolution, ``wave.digest`` agreement, ``recovery.step``
evidence, the ``serve.tick`` fields, ``wave.cost`` per bucket) are the
``<name>_obs`` cases (``test_torch_serve.py``'s ``obs_twin``).

Also holds the session's batched hooks (``window_pack`` /
``complete_window`` / ``_flush_window``) to the delta wave they factor:
the same digests, and after the deferred splice the same resident ranks.
"""

import json
import os

import numpy as np
import pytest

from cause_tpu.weaver import jaxwd as j_wd
from cause_tpu_torch.weaver import torchwd as t_wd

from test_torch_serve import (PORT, REF, _fresh_state, base, both,  # noqa: F401
                              delta_items, edn, journal_rows, obs_twin,
                              pair, pure_merge, site, twin_events)


@pytest.fixture
def count_dispatches(monkeypatch):
    """Count each package's ``batched_delta_weave`` calls (the delta
    window dispatch; one a bucket on the batched tick)."""
    calls = {"ref": 0, "port": 0}
    for name, mod in (("ref", j_wd), ("port", t_wd)):
        real = mod.batched_delta_weave

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(mod, "batched_delta_weave", counted)
    return calls


def _service(P, root, capacity=8, d_max=16, **kw):
    os.makedirs(str(root), exist_ok=True)
    jr = P.IngestJournal(os.path.join(str(root), "wal.jsonl"))
    q = P.IngestQueue(max_ops=4096, journal=jr)
    return P.SyncService(
        q, residency=P.ResidencyManager(capacity=capacity),
        checkpoint_dir=os.path.join(str(root), "ckpt"),
        d_max=d_max, **kw)


def _tenant(P, i, n=12, ea=("A",), eb=("B",)):
    """Tenant ``i``: a fresh document (its own uuid) as a replica pair."""
    return pair(P, base(P, n, uuid=f"tenant-{i:06d}"), ea, eb, i=i)


def _mint_schedule(P, tenants, rounds=4):
    """The reference test's deterministic multi-tenant offer schedule:
    per round a rotating subset of tenants mint a left and/or right op
    on their external replicas, recorded as wire bytes; ``None`` marks
    a tick."""
    log = []
    for k in range(rounds):
        for i, t in enumerate(tenants):
            if (i + k) % 3 == 0:
                nl = t["l"].conj(f"L{i}.{k}")
                log.append((t["uuid"], nl.ct.site_id,
                            delta_items(P, nl, t["l"])))
                t["l"] = nl
            if (i + k) % 2 == 0:
                nr = t["r"].conj(f"R{i}.{k}")
                log.append((t["uuid"], nr.ct.site_id,
                            delta_items(P, nr, t["r"])))
                t["r"] = nr
        log.append(None)
    return log


def _replay(svc, log):
    ticks = []
    for entry in log:
        if entry is None:
            ticks.append(svc.tick())
        else:
            uuid, st, items = entry
            assert svc.queue.offer(uuid, st, items).admitted
    return ticks


def test_batched_vs_unbatched_bit_identity(tmp_path):
    """THE pin: the same admitted-op schedule, batching on and off —
    identical digests, documents and journal contents per tenant, in
    each package and across them. Capacity under the tenant count on
    both arms, so the schedule crosses evict/restore and the batched
    arm's capacity-sized chunking."""
    def scen(P, root):
        svc_b = _service(P, root / "b", capacity=3, batched=True)
        assert svc_b.batched
        tenants = []
        for i in range(6):
            a, b = _tenant(P, i, 10 + i)
            d_max = 16 if i % 2 == 0 else 48  # two pow2 buckets
            svc_b.add_tenant(a, b, d_max=d_max)
            tenants.append({"uuid": str(a.ct.uuid), "l": a, "r": b,
                            "a": a, "b": b, "d_max": d_max})
        log = _mint_schedule(P, tenants)
        ticks_b = _replay(svc_b, log)
        dig_b = {t["uuid"]: svc_b.converged_digest(t["uuid"])
                 for t in tenants}
        edn_b = {t["uuid"]: edn(P, svc_b.materialize(t["uuid"]))
                 for t in tenants}
        svc_u = _service(P, root / "u", capacity=3, batched=False)
        assert not svc_u.batched
        for t in tenants:
            svc_u.add_tenant(t["a"], t["b"], d_max=t["d_max"])
        ticks_u = _replay(svc_u, log)
        for t in tenants:
            uuid = t["uuid"]
            assert svc_u.converged_digest(uuid) == dig_b[uuid]
            assert edn(P, svc_u.materialize(uuid)) == edn_b[uuid]
            oracle = pure_merge(P, t["l"], t["r"])
            assert edn_b[uuid] == edn(P, oracle)
        rows = journal_rows(root / "b" / "wal.jsonl")
        assert rows == journal_rows(root / "u" / "wal.jsonl")
        assert any(t["buckets"] == 2 for t in ticks_b)
        return dig_b, edn_b, rows, ticks_b, ticks_u, \
            svc_b.residency.stats, svc_u.residency.stats

    both(scen, tmp_path)


def test_batched_tick_one_dispatch_per_bucket(tmp_path, count_dispatches):
    """Steady state, 6 tenants in 2 pow2 buckets, capacity ample: the
    tick runs ONE delta-window dispatch per bucket, not one a tenant."""
    def scen(P, root):
        svc = _service(P, root, capacity=8, batched=True)
        tenants = []
        for i in range(6):
            a, b = _tenant(P, i, 8)
            svc.add_tenant(a, b, d_max=16 if i % 2 == 0 else 48)
            tenants.append({"uuid": str(a.ct.uuid), "l": a, "r": b})
        for t in tenants:
            nl = t["l"].conj("x")
            assert svc.queue.offer(t["uuid"], nl.ct.site_id,
                                   delta_items(P, nl, t["l"])).admitted
            t["l"] = nl
        before = count_dispatches[P.name]
        out = svc.tick()
        assert out["tenants"] == 6
        assert out["buckets"] == 2
        assert count_dispatches[P.name] - before == 2
        assert out["batch_rows"] >= 6
        assert svc._scheduler.last_fallbacks == 0
        assert sorted(svc.residency.buckets()) == [32, 64]
        return out, {t["uuid"]: svc.converged_digest(t["uuid"])
                     for t in tenants}

    both(scen, tmp_path)


def test_unbatched_tick_pays_per_tenant_dispatches(tmp_path,
                                                   count_dispatches):
    """The baseline: the per-tenant path runs one delta-window dispatch
    per touched tenant (the reference counts three: splice, window
    weave, rank splice), and no scheduler."""
    def scen(P, root):
        svc = _service(P, root, capacity=8, batched=False)
        tenants = []
        for i in range(4):
            a, b = _tenant(P, i, 8)
            svc.add_tenant(a, b)
            tenants.append({"uuid": str(a.ct.uuid), "l": a})
        for t in tenants:
            nl = t["l"].conj("x")
            assert svc.queue.offer(t["uuid"], nl.ct.site_id,
                                   delta_items(P, nl, t["l"])).admitted
            t["l"] = nl
        before = count_dispatches[P.name]
        out = svc.tick()
        assert out["tenants"] == 4
        assert out["buckets"] == 0
        assert count_dispatches[P.name] - before == 4
        return out, {t["uuid"]: svc.converged_digest(t["uuid"])
                     for t in tenants}

    both(scen, tmp_path)


def test_overflowing_tenant_falls_back_alone(tmp_path, count_dispatches):
    """One tenant's single batch exceeds its delta budget: it takes the
    full-width rung alone while its bucket-mates still share ONE fused
    dispatch, and it converges to the pure oracle."""
    def scen(P, root):
        svc = _service(P, root, capacity=8, d_max=16, batched=True)
        tenants = []
        for i in range(3):
            a, b = _tenant(P, i, 10 + i)
            svc.add_tenant(a, b)
            tenants.append({"uuid": str(a.ct.uuid), "l": a, "r": b})
        big = tenants[0]["l"]
        for j in range(20):
            big = big.conj(f"big{j}")
        assert svc.queue.offer(tenants[0]["uuid"], big.ct.site_id,
                               delta_items(P, big,
                                           tenants[0]["l"])).admitted
        for t in tenants[1:]:
            nl = t["l"].conj("x")
            assert svc.queue.offer(t["uuid"], nl.ct.site_id,
                                   delta_items(P, nl, t["l"])).admitted
            t["l"] = nl
        before = count_dispatches[P.name]
        out = svc.tick(max_ops=32)
        assert out["tenants"] == 3
        assert out["buckets"] == 1
        assert svc._scheduler.last_fallbacks == 1
        assert count_dispatches[P.name] - before == 1
        doc = edn(P, svc.materialize(tenants[0]["uuid"]))
        assert doc == edn(P, pure_merge(P, big, tenants[0]["r"]))
        return out, doc, {t["uuid"]: svc.converged_digest(t["uuid"])
                          for t in tenants}

    both(scen, tmp_path)


def test_checkpoint_round_trips_across_modes(tmp_path):
    """A batched service's drain restores as an unbatched service (and
    back) with bit-identical digests."""
    def scen(P, root):
        svc = _service(P, root / "one", capacity=4, batched=True)
        a, b = _tenant(P, 0)
        uuid = svc.add_tenant(a, b)
        nl = a.conj("x1").conj("x2")
        assert svc.queue.offer(uuid, nl.ct.site_id,
                               delta_items(P, nl, a)).admitted
        svc.tick()
        manifest = svc.drain()
        d0 = svc.converged_digest(uuid)
        svc2 = P.SyncService.restore(os.path.dirname(manifest),
                                     batched=False)
        assert not svc2.batched
        assert svc2.converged_digest(uuid) == d0
        l2, _r2 = svc2.residency.get(uuid).pairs[0]
        l3 = l2.conj("x3")
        assert svc2.queue.offer(uuid, l3.ct.site_id,
                                delta_items(P, l3, l2)).admitted
        svc2.tick()
        manifest2 = svc2.drain(os.path.join(str(root), "two"))
        d1 = svc2.converged_digest(uuid)
        svc3 = P.SyncService.restore(os.path.dirname(manifest2))
        assert svc3.batched
        assert svc3.converged_digest(uuid) == d1
        return d0, d1, edn(P, svc3.materialize(uuid))

    both(scen, tmp_path)


def test_residency_buckets_and_get_many(tmp_path):
    """Bucket-aware residency: resident tenants group by their pow2
    bucket key, and get_many refuses groups larger than capacity."""
    def scen(P, root):
        svc = _service(P, root, capacity=4, batched=True)
        uuids = []
        for i in range(4):
            a, b = _tenant(P, i, 10 + i)
            uuids.append(svc.add_tenant(a, b,
                                        d_max=16 if i < 2 else 48))
        bk = svc.residency.buckets()
        assert sorted(bk) == [32, 64]
        assert sorted(bk[32]) == sorted(uuids[:2])
        assert sorted(bk[64]) == sorted(uuids[2:])
        got = svc.residency.get_many(uuids)
        assert list(got) == uuids
        with pytest.raises(ValueError):
            svc.residency.get_many(uuids + ["one-too-many"])
        assert all(s.defer_device for s in got.values())
        return {k: sorted(v) for k, v in bk.items()}

    both(scen, tmp_path)


# ----------------------------------------------- residency under chaos


def test_eviction_raced_with_checkpoint_restores_bit_identically(
        tmp_path):
    """``tests/test_chaos.py:623``: a document evicted to host
    mid-session restores bit-identically; a checkpoint_all taken while
    it sits spilled round-trips the same digests; the touch resumes
    steady-state delta waves."""
    def scen(P, root):
        b0 = base(P, 30)
        rm = P.ResidencyManager(capacity=1, spill_dir=str(root / "sp"))
        a, b = pair(P, b0)
        hot = P.FleetSession([(a, b)] * 2)
        hot.wave()
        a, b = a.conj("h1"), b.conj("h2")
        hot.update([(a, b)] * 2)
        d_mid = hot.wave()
        rm.insert("victim", hot)
        a2, b2 = pair(P, b0, ("C",), ("D",), i=1)
        other = P.FleetSession([(a2, b2)] * 2)
        other.wave()
        rm.insert("other", other)
        assert rm.spilled() == ["victim"]
        out = rm.checkpoint_all(str(root / "ckpt"))
        assert set(out) == {"victim", "other"}
        from_pack = P.FleetSession.restore(
            str(root / "ckpt" / "victim.ckpt.json"))
        assert np.array_equal(from_pack._last_digest, d_mid)
        back = rm.get("victim")
        assert np.array_equal(back._last_digest, d_mid)
        assert back._delta is not None  # the frontier rode the pack
        a3, b3 = a.conj("x"), b.conj("y")
        back.update([(a3, b3)] * 2)
        d_next = back.wave()
        control = P.FleetSession([(a3, b3)] * 2, delta=False)
        assert np.array_equal(d_next, control.wave())
        return d_mid.tolist(), d_next.tolist(), rm.stats

    both(scen, tmp_path)


def test_restore_refuses_pack_torn_during_spill(tmp_path):
    """``tests/test_chaos.py``: a spill pack torn mid-write refuses
    restore through the checkpoint-mismatch gate; the other tenant
    still serves."""
    def scen(P, root):
        b0 = base(P)
        rm = P.ResidencyManager(capacity=1, spill_dir=str(root / "sp"))
        a, b = pair(P, b0)
        s1 = P.FleetSession([(a, b)] * 2)
        s1.wave()
        rm.insert("t1", s1)
        a2, b2 = pair(P, b0, ("C",), ("D",), i=1)
        s2 = P.FleetSession([(a2, b2)] * 2)
        s2.wave()
        rm.insert("t2", s2)
        (path,) = [rm._spilled[u] for u in rm.spilled()]
        blob = open(path).read()
        with open(path, "w") as f:
            f.write(blob[:len(blob) // 2])
        with pytest.raises(P.CausalError) as ei:
            rm.get("t1")
        assert "checkpoint-mismatch" in ei.value.info["causes"]
        assert np.array_equal(rm.get("t2")._last_digest,
                              s2._last_digest)
        return sorted(ei.value.info["causes"])

    both(scen, tmp_path)


# ------------------------------------------------ the session's hooks


def _steady_pair(P, i, edits):
    a, b = _tenant(P, i, 24)
    for e in range(edits):
        a, b = a.conj(f"a{e}"), b.conj(f"b{e}")
    return a, b


def test_complete_window_equals_the_delta_wave():
    """A bucket of one session's window, completed through the hooks,
    returns the delta wave's digests, and after the deferred splice the
    resident ranks and visibility equal the delta wave's, in both
    packages; the port's pending window stays a tensor until then."""
    import torch

    def scen(P):
        a, b = _steady_pair(P, 0, 2)
        s_hook = P.FleetSession([(a, b)] * 3, d_max=16)
        s_wave = P.FleetSession([(a, b)] * 3, d_max=16)
        s_hook.wave()
        s_wave.wave()
        a2, b2 = a.conj("n1").conj("n2"), b.conj("m1")
        s_hook.defer_device = True
        s_hook.update([(a2, b2)] * 3)
        s_wave.update([(a2, b2)] * 3)
        assert s_hook._dev_stale  # lanes stay behind the views
        assert s_hook.bucket_key == s_wave.bucket_key > 0
        d_max_lanes = s_hook.pop_divergence()
        assert d_max_lanes == (9, 0)
        sched = P.BatchScheduler()
        got = sched.wave_fleet({"t": s_hook})["t"]
        assert sched.last_buckets == 1 and sched.last_fallbacks == 0
        want = s_wave.wave()
        assert np.array_equal(got, want)
        if P is PORT:
            assert torch.is_tensor(s_hook._pending_window["rank_w"])
        s_hook._flush_window()
        assert s_hook._pending_window is None
        assert np.array_equal(np.asarray(s_hook.last_rank),
                              np.asarray(s_wave.last_rank))
        assert np.array_equal(np.asarray(s_hook.last_visible),
                              np.asarray(s_wave.last_visible))
        # a full wave from the stale residents re-uploads first
        s_hook.abandon_frontier("test")
        assert s_hook.bucket_key == 0
        assert np.array_equal(s_hook.wave(), want)
        assert not s_hook._dev_stale
        return got.tolist(), edn(P, s_hook.merged(1))

    both(scen)


# ------------------------------------------------ the telemetry halves


def test_batched_vs_unbatched_bit_identity_obs(tmp_path, obs_twin):
    """Both arms with telemetry on: the port's stream (every lag
    resolution, every wave digest) equals the reference's, each
    session's waves agree, and ops converge on both arms."""
    test_batched_vs_unbatched_bit_identity(tmp_path)
    digests = twin_events(obs_twin, "wave.digest")
    assert digests and all(e["fields"]["agreed"] for e in digests)
    wins = twin_events(obs_twin, "lag.window")
    assert wins and wins[-1]["fields"]["converged_total"] > 0


def test_batched_tick_one_dispatch_per_bucket_obs(tmp_path, obs_twin,
                                                  count_dispatches):
    test_batched_tick_one_dispatch_per_bucket(tmp_path, count_dispatches)
    (tick,) = twin_events(obs_twin, "serve.tick")
    costs = [e["fields"] for e in twin_events(obs_twin, "wave.cost")
             if e["fields"]["path"] == "batched"]
    assert len(costs) == 2 and all(f["dispatches"] == 1 for f in costs)
    assert sorted(f["bucket"] for f in costs) == [32, 64]
    assert sum(f["tenants"] for f in costs) == 6
    assert tick["fields"]["wave_dispatches"] == 2


def test_unbatched_tick_pays_per_tenant_dispatches_obs(
        tmp_path, obs_twin, count_dispatches):
    test_unbatched_tick_pays_per_tenant_dispatches(tmp_path,
                                                   count_dispatches)
    (tick,) = twin_events(obs_twin, "serve.tick")
    costs = [e["fields"] for e in twin_events(obs_twin, "wave.cost")
             if e["fields"]["source"] == "session"
             and e["fields"]["path"] == "delta"]
    assert len(costs) == 4
    # per tenant: the update's splice, the window weave, its rank splice
    assert tick["fields"]["wave_dispatches"] == 3 * 4


def test_overflowing_tenant_falls_back_alone_obs(tmp_path, obs_twin,
                                                 count_dispatches):
    test_overflowing_tenant_falls_back_alone(tmp_path, count_dispatches)
    steps = [e["fields"] for e in twin_events(obs_twin, "recovery.step")]
    assert any(f["from"] == "delta" and f["to"] == "full"
               for f in steps)
    (tick,) = twin_events(obs_twin, "serve.tick")
    assert tick["fields"]["fallbacks"] == 1
