"""Batched-serve smoke of the port: one fused dispatch per bucket. A port
of ``scripts/batched_smoke.py``.

    CAUSE_TPU_LEDGER=ledger.jsonl python -m cause_tpu_torch.batched_smoke
    python -m cause_tpu_torch.batched_smoke --cpu ...   # plain versions

Twelve tenants split across two pow2 buckets (delta budgets 16 and
48 -> window caps 32 and 64), one op each, ONE batched tick — then
the same admitted-op schedule through an unbatched service
(``one_tick``). Gates:

- the batched tick's device dispatch count (costmodel-counted)
  equals the BUCKET count, with zero per-tenant fallbacks;
- every tenant observed at least one agreeing ``wave.digest`` in
  that single tick (the fused dispatch is not skipping anyone);
- per-tenant converged digests are bit-identical between the
  batched and unbatched arms (batching changes WHEN device programs
  run, never what they compute);
- a ``--kind serve`` ledger row lands (value = dispatches per
  batched tick) for ``ledger --check`` to vet; its ``platform`` is the
  device's tag (``gpu`` or ``cpu``) and ``card`` the card's
  ``name, power.limit`` (null on the CPU).

Exit 0 clean; any gate miss raises (exit 1). Runs on the card unless
``--cpu`` asks for the plain versions on the CPU: without a card and
without ``--cpu`` it exits 2 with one line.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import cause_tpu_torch as c
from . import obs, serde, sync
from .collections import clist as c_list
from .collections.clist import CausalList
from .ids import new_site_id
from .obs import ledger, load_jsonl
from .serve import IngestJournal, IngestQueue, ResidencyManager, \
    SyncService


def _base(n=8):
    base = CausalList(c_list.weave(
        c.clist(weaver="torch").extend(["w"] * n).ct
    ))
    base.ct.lanes.segments()
    return base


def _pair(base):
    a = CausalList(base.ct.evolve(site_id=new_site_id()))
    b = CausalList(base.ct.evolve(site_id=new_site_id()))
    return a.conj("A"), b.conj("B")


def _delta_items(new, old):
    return serde.encode_node_items(
        sync.delta_nodes(new, sync.version_vector(old)))


def _service(root, capacity, batched):
    os.makedirs(root, exist_ok=True)
    jr = IngestJournal(os.path.join(root, "wal.jsonl"))
    q = IngestQueue(max_ops=4096, journal=jr)
    return SyncService(
        q, residency=ResidencyManager(capacity=capacity),
        checkpoint_dir=os.path.join(root, "ckpt"),
        d_max=64, batched=batched)


def _events(evs, name):
    return [e for e in evs if e.get("ev") == "event"
            and e.get("name") == name]


def one_tick(work: str, n: int):
    """``n`` tenants (every other one at delta budget 16, the rest at
    48), one op each, through ONE tick of a batched service under
    ``work``, then the same schedule through an unbatched service.
    Returns ``(dig_b, dig_u, out, tenants)``: each arm's converged
    digest by tenant uuid, the batched tick's record (``tick()``'s
    summary; its ``wave_dispatches`` count only with telemetry on) and
    the tenants."""
    svc_b = _service(os.path.join(work, "b"), capacity=n, batched=True)
    tenants = []
    for i in range(n):
        a, b = _pair(_base(8))
        # two delta budgets -> exactly two pow2 window buckets
        svc_b.add_tenant(a, b, d_max=16 if i % 2 == 0 else 48)
        tenants.append({"uuid": str(a.ct.uuid), "a": a, "b": b,
                        "d_max": 16 if i % 2 == 0 else 48})
    schedule = []
    for i, t in enumerate(tenants):
        nl = t["a"].conj(f"op{i}")
        schedule.append((t["uuid"], nl.ct.site_id,
                         _delta_items(nl, t["a"])))
    for uuid, site, items in schedule:
        assert svc_b.queue.offer(uuid, site, items).admitted
    out = svc_b.tick(max_ops=4 * n)
    dig_b = {t["uuid"]: svc_b.converged_digest(t["uuid"])
             for t in tenants}

    svc_u = _service(os.path.join(work, "u"), capacity=n, batched=False)
    assert not svc_u.batched
    for t in tenants:
        svc_u.add_tenant(t["a"], t["b"], d_max=t["d_max"])
    for uuid, site, items in schedule:
        assert svc_u.queue.offer(uuid, site, items).admitted
    svc_u.tick(max_ops=4 * n)
    dig_u = {t["uuid"]: svc_u.converged_digest(t["uuid"])
             for t in tenants}
    return dig_b, dig_u, out, tenants


def main(argv=None) -> int:
    from .bench import card_name_power
    from .device import claim_device
    from .obs.core import platform_of

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tenants", type=int, default=12)
    ap.add_argument("--obs-out", default=os.path.join(
        tempfile.gettempdir(), "obs_batched_smoke.jsonl"))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    dev = claim_device(args.cpu, "batched_smoke")
    card = card_name_power(dev)
    n = args.tenants

    if os.path.exists(args.obs_out):
        os.unlink(args.obs_out)
    obs.configure(enabled=True, out=args.obs_out)
    obs.set_platform(dev)
    work = tempfile.mkdtemp(prefix="batched_smoke_")
    try:
        dig_b, dig_u, out, tenants = one_tick(work, n)
        assert out["tenants"] == n, out
        assert out["buckets"] == 2, out
        # THE smoke gate: one fused dispatch per bucket, nothing more
        assert out["wave_dispatches"] == out["buckets"], out
        for t in tenants:
            assert dig_u[t["uuid"]] == dig_b[t["uuid"]]
    finally:
        obs.configure(enabled=False)
        shutil.rmtree(work, ignore_errors=True)

    evs = load_jsonl(args.obs_out)
    ticks = [e["fields"] for e in _events(evs, "serve.tick")]
    tick_b = ticks[0]  # the batched arm ticked first
    assert tick_b["buckets"] == 2 and tick_b["fallbacks"] == 0, tick_b
    assert tick_b["wave_dispatches"] == 2, tick_b
    assert tick_b["batch_rows"] >= n, tick_b
    # every tenant agreed inside the batched tick's fused waves: only
    # count digests observed BEFORE the unbatched arm's tick (the
    # stream is append-ordered, so stop at the second serve.tick)
    agreed = set()
    seen_ticks = 0
    for e in evs:
        if e.get("ev") != "event":
            continue
        if e.get("name") == "serve.tick":
            seen_ticks += 1
            if seen_ticks == 2:
                break
        if e.get("name") == "wave.digest" \
                and e["fields"].get("agreed"):
            agreed.add(e["fields"]["uuid"])
    missing = {t["uuid"] for t in tenants} - agreed
    assert not missing, f"tenants without an agreed wave.digest: " \
                        f"{sorted(missing)}"

    row = ledger.ingest_record(
        {
            "platform": platform_of(dev),
            "metric": "batched tick dispatches per bucket",
            "value": out["wave_dispatches"] / out["buckets"],
            "kernel": "serve",
            "config": f"tenants={n} buckets=2 batched=smoke",
            "smoke": True,
        },
        source="batched-smoke one-tick",
        obs_jsonl=args.obs_out,
        kind="serve",
        extra={"serve": {"tenants": n, "buckets": out["buckets"],
                         "wave_dispatches": out["wave_dispatches"],
                         "fallbacks": tick_b["fallbacks"],
                         "batch_rows": tick_b["batch_rows"],
                         "digest_bit_identical": True},
               "card": card},
    )
    print(f"batched smoke: {n} tenants, {out['buckets']} buckets, "
          f"{out['wave_dispatches']} dispatch(es) in one tick; "
          f"digests bit-identical to unbatched; ledger row "
          f"({row['platform']}) -> {ledger.default_path()}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
