"""The port's fault-injection engine and recovery ladder against the JAX
package's.

Mirrors the cases of ``tests/test_chaos.py`` that need neither the
telemetry layer nor the serving plane nor a subprocess — deterministic
injection by seed (``:159``), ``suspended`` (``:191``), the legacy
ingest seam (``:209``), every mangle mode rejected (``:243``), the
payload fuzzer (``:372``) — and, on their outcomes (digests, retries,
the ``injected()`` log), the stream reject at the boundary (``:298``),
the quarantine round trip (``:325``), the ladder's retry (``:413``) and
the session's dispatch and budget faults (``:447``); their reads of
telemetry events wait for the telemetry port (ROADMAP A.13). The
checkpoint cases (``:550``, ``:586``) are mirrored in
``tests/test_torch_session.py``; here a crash fault drives the
checkpoint -> restore cycle. ``:663`` needs the serving plane (A.12).

Scenarios run as twins: the same fleet (fixed site ids) and the same
plan in both packages, ``weaver="torch"`` in the port against
``weaver="jax"`` in the reference, with digests, weaves and the
injected-fault log (timestamps aside) compared exactly. Each package's
engine is its own: arming one does not arm the other.
"""

import json
import socket
import threading

import numpy as np
import pytest

import cause_tpu as c
from cause_tpu import chaos as j_chaos
from cause_tpu import serde as j_serde
from cause_tpu import sync as j_sync
from cause_tpu.parallel import recovery as j_recovery

import cause_tpu_torch as ct
from cause_tpu_torch import chaos as t_chaos
from cause_tpu_torch import serde as t_serde
from cause_tpu_torch import sync as t_sync
from cause_tpu_torch.collections import shared as t_shared
from cause_tpu_torch.parallel import recovery as t_recovery

from test_torch_session import JAX, PORT, chaos_pair, make_base, site

CHAOS = {c: j_chaos, ct: t_chaos}
SYNC = {c: j_sync, ct: t_sync}
TWINS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _fresh_state(monkeypatch):
    """Every test starts with both engines disarmed and both quarantine
    registries empty, on the CPU, and leaves none of it behind."""
    monkeypatch.delenv("CAUSE_TPU_CHAOS", raising=False)
    before = ct.default_device()
    ct.use_device("cpu")
    for pkg in (c, ct):
        CHAOS[pkg].reset()
        SYNC[pkg].quarantine_reset()
    yield
    for pkg in (c, ct):
        CHAOS[pkg].reset()
        SYNC[pkg].quarantine_reset()
    ct.use_device(before)


def log_of(pkg):
    return [{k: v for k, v in r.items() if k != "ts_us"}
            for r in CHAOS[pkg].injected()]


def edn_json(pkg, h):
    """A collection's rendered value as comparable JSON."""
    return json.dumps((j_serde if pkg is c else t_serde).to_data(
        h.causal_to_edn()))


# ------------------------------------------------ chaos-off invariance


def test_chaos_off_is_inert():
    """With no plan the hooks pass their input through, nothing is
    logged and no replica is quarantined, after a sync, a wave and a
    session pass on the device route."""
    assert t_chaos.enabled() is False
    base = make_base(PORT, 20)
    a, b = chaos_pair(PORT, base)
    a2, b2 = ct.sync_pair(a, b)
    assert a2.ct.weave == b2.ct.weave
    assert len(ct.merge_wave([(a, b)] * 2)) == 2
    ct.FleetSession([(a, b)] * 2).wave()
    enc = [[[1, "site", 0], [0, "r", 0], "v"]]
    assert t_chaos.mangle_items(enc) is enc
    assert t_chaos.dispatch_fault("wave") is None
    assert t_chaos.budget_exhaust("session") is False
    assert t_chaos.should_crash("session") is False
    assert t_chaos.stall_point("session") == 0.0
    assert t_chaos.injected() == [] and t_chaos.chaos_report()["injected"] == 0
    assert t_sync.quarantined() == frozenset()
    assert not t_sync.any_quarantined()


def test_engines_are_separate_and_read_one_plan(monkeypatch):
    """Arming the reference's engine does not arm the port's; the one
    ``CAUSE_TPU_CHAOS`` plan arms both when each reads it."""
    j_chaos.configure(plan={"seed": 1, "faults": [
        {"family": "crash", "site": "session", "at": [1]}]})
    assert j_chaos.enabled() and not t_chaos.enabled()
    j_chaos.reset()
    plan = {"seed": 3, "faults": [{"family": "crash", "site": "s",
                                   "at": [2]}]}
    monkeypatch.setenv("CAUSE_TPU_CHAOS", json.dumps(plan))
    for pkg in (c, ct):
        CHAOS[pkg].reset()
        assert CHAOS[pkg].enabled()
        assert [CHAOS[pkg].should_crash("s") for _ in range(3)] == [
            False, True, False]
    assert log_of(ct) == log_of(c)


# -------------------------------------------- deterministic injection


def _drive_hooks(chaos):
    fired = []
    for i in range(12):
        enc = [[[t, f"s{t}", 0], [0, "r", 0], f"v{t}"]
               for t in range(1, 4)]
        got = chaos.mangle_items(enc, "sync.delta")
        if got is not enc:
            fired.append(("payload", i, json.dumps(got)))
        try:
            chaos.dispatch_fault("session")
        except chaos.InjectedDispatchError:
            fired.append(("dispatch", i))
        if chaos.budget_exhaust("session"):
            fired.append(("exhaust", i))
        if chaos.should_crash("session"):
            fired.append(("crash", i))
    return fired


def test_each_family_fires_deterministically_by_seed():
    """``:159`` — the same plan over the same call sequence injects the
    same faults at the same points, mangled bytes included, in both
    packages; another seed moves the probabilistic firings."""
    plan = {"seed": 7, "faults": [
        {"family": "payload", "site": "sync.delta", "mode": "corrupt",
         "prob": 0.35},
        {"family": "dispatch", "site": "session", "mode": "raise",
         "at": [3, 9]},
        {"family": "dispatch", "site": "session", "mode": "exhaust",
         "at": [5]},
        {"family": "crash", "site": "session", "at": [7]},
    ]}
    runs = {}
    for pkg in (c, ct, ct):
        CHAOS[pkg].configure(plan=plan)
        runs.setdefault(pkg, []).append((_drive_hooks(CHAOS[pkg]),
                                         log_of(pkg)))
        CHAOS[pkg].reset()
    assert runs[ct][0] == runs[ct][1] == runs[c][0]
    assert {r["family"] for r in runs[ct][0][1]} == {
        "payload", "dispatch", "crash"}
    t_chaos.configure(plan={**plan, "seed": 8})
    other = _drive_hooks(t_chaos)
    assert [f for f in other if f[0] == "payload"] != \
        [f for f in runs[ct][0][0] if f[0] == "payload"]


def test_suspended_consumes_no_counters():
    """``:191``."""
    t_chaos.configure(plan={"seed": 1, "faults": [
        {"family": "crash", "site": "session", "at": [2]}]})
    assert not t_chaos.should_crash("session")
    with t_chaos.suspended():
        for _ in range(5):
            assert not t_chaos.should_crash("session")
    assert t_chaos.should_crash("session")


@pytest.mark.parametrize("spec", [
    {"family": "nope"},
    {"family": "payload", "mode": "smash"},
    {"family": "dispatch", "mode": "melt"},
    {"family": "net", "mode": "x"},
])
def test_bad_plans_fail_loudly(spec):
    for pkg in (c, ct):
        with pytest.raises(ValueError):
            CHAOS[pkg].configure(plan={"seed": 0, "faults": [spec]})


# --------------------------------- validated ingest: the legacy seam


def _peer_delta(pkg):
    base = pkg.clist(*"hello")
    base = type(base)(base.ct.evolve(site_id=site("BASE")))
    peer = type(base)(base.ct.evolve(site_id=site("PEER"))).conj("x")
    enc = SYNC[pkg].serde.encode_node_items(
        SYNC[pkg].delta_nodes(peer, SYNC[pkg].version_vector(base)))
    return base, enc


def test_legacy_malformed_payload_seam_is_pinned():
    """``:209`` — without the boundary, a truncated triple raises a bare
    ValueError deep in the decode and a malformed id is admitted; the
    boundary rejects both, in both packages alike."""
    for pkg in (c, ct):
        sync = SYNC[pkg]
        base, enc = _peer_delta(pkg)
        truncated = [list(x) for x in enc]
        truncated[0] = truncated[0][:2]
        with pytest.raises(ValueError):
            sync.apply_delta(base, sync.serde.decode_node_items(truncated))
        bad_id = [list(x) for x in enc]
        bad_id[0] = [[bad_id[0][0][0], 12345, bad_id[0][0][2]],
                     bad_id[0][1], bad_id[0][2]]
        admitted = sync.apply_delta(base,
                                    sync.serde.decode_node_items(bad_id))
        assert any(not isinstance(nid[1], str) for nid in admitted.ct.nodes)
        for bad in (truncated, bad_id):
            with pytest.raises(pkg.CausalError) as ei:
                sync.checked_decode(bad)
            assert "payload-invalid" in ei.value.info["causes"]


def test_validate_rejects_each_mangle_mode():
    """``:243`` — structure catches truncate/duplicate/reorder/bad ids,
    the checksum catches corrupt/drop; the same CRCs in both packages."""
    enc = [[[1, "sa", 0], [0, "root", 0], "a"],
           [[2, "sb", 0], [1, "sa", 0], "b"],
           [[3, "sc", 1], [2, "sb", 0], "c"]]
    crc = t_sync.payload_checksum(enc)
    assert crc == j_sync.payload_checksum(enc)
    t_sync.validate_node_items(enc)
    assert t_sync.checked_decode(enc, crc)
    cases = {
        "truncate": [enc[0][:2], enc[1], enc[2]],
        "duplicate": [enc[0], enc[0], enc[1], enc[2]],
        "reorder": [enc[2], enc[1], enc[0]],
        "bad-id": [[[1, 99, 0], enc[0][1], "a"], enc[1], enc[2]],
        "bad-cause": [[enc[0][0], [1, 2], "a"], enc[1], enc[2]],
        "not-a-list": {"nodes": 1},
    }
    for name, bad in cases.items():
        with pytest.raises(t_shared.CausalError) as ei:
            t_sync.checked_decode(bad, crc)
        assert "payload-invalid" in ei.value.info["causes"], name
    for name, mangled in {
        "corrupt": [[enc[0][0], enc[0][1], "POISON"], enc[1], enc[2]],
        "drop": [enc[0], enc[2]],
    }.items():
        with pytest.raises(t_shared.CausalError) as ei:
            t_sync.checked_decode(mangled, crc)
        assert "payload-checksum" in ei.value.info["causes"], name


def test_payload_fuzzer_validation_implies_roundtrip():
    """``:372`` — any one-character mutation of a real payload either
    fails validation and checksum, or decodes and re-encodes to exactly
    the admitted bytes; the port and the reference decide alike."""
    hypothesis = pytest.importorskip("hypothesis")
    from hypothesis import strategies as st

    base = ct.clist(*"fuzzme")
    peer = ct.CausalList(base.ct.evolve(site_id=site("FUZZ")))
    for i in range(6):
        peer = peer.conj(f"v{i}")
    enc = t_serde.encode_node_items(
        t_sync.delta_nodes(peer, t_sync.version_vector(base)))
    crc = t_sync.payload_checksum(enc)
    blob = json.dumps(enc)

    def verdict(sync, data):
        try:
            return sync.serde.encode_node_items(sync.checked_decode(data, crc))
        except (t_shared.CausalError, c.CausalError) as e:
            assert {"payload-invalid", "payload-checksum"} \
                & set(e.info["causes"])
            return sorted(e.info["causes"])

    @hypothesis.settings(max_examples=120, deadline=None)
    @hypothesis.given(st.integers(0, len(blob) - 1),
                      st.characters(min_codepoint=32, max_codepoint=126))
    def prop(pos, ch):
        try:
            data = json.loads(blob[:pos] + ch + blob[pos + 1:])
        except ValueError:
            return
        got = verdict(t_sync, data)
        assert got == verdict(j_sync, data)
        if got and isinstance(got[0], list):
            assert got == data == enc

    prop()


# ----------------------------------------------- the boundary in situ


def _stream_sync(pkg, a, b):
    s1, s2 = socket.socketpair()
    out, err = {}, {}

    def run(name, handle, sock):
        try:
            with sock.makefile("rwb") as stream:
                out[name] = SYNC[pkg].sync_stream(handle, stream)
        except Exception as e:  # noqa: BLE001 - surfaced below
            err[name] = e
        finally:
            sock.close()

    ts = [threading.Thread(target=run, args=("a", a, s1)),
          threading.Thread(target=run, args=("b", b, s2))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    if err:
        raise next(iter(err.values()))
    return out["a"], out["b"]


def test_stream_reject_at_boundary_document_untouched():
    """``:298`` on its outcomes — a corrupted delta frame over a real
    socket is rejected, the round heals over the validated full bag,
    both ends converge to the clean merge with no trace of the poison,
    and the one injected fault is logged alike in both packages."""
    plan = {"seed": 5, "faults": [
        {"family": "payload", "site": "sync.delta", "mode": "corrupt",
         "times": 1, "prob": 1.0}]}
    got = {}
    for tw in TWINS:
        pkg = tw.pkg
        CHAOS[pkg].configure(plan=plan)
        base = make_base(tw, 12)
        a = tw.handle(base.ct.evolve(site_id=site("SA"))).conj("!")
        b = tw.handle(base.ct.evolve(site_id=site("SB"))).cons("<")
        a2, b2 = _stream_sync(pkg, a, b)
        assert a2.ct.weave == b2.ct.weave == a.merge(b).ct.weave
        assert CHAOS[pkg].CORRUPT_MARKER not in json.dumps(
            a2.causal_to_edn(), default=str)
        # the reject counted against the sender, not yet quarantined
        assert not SYNC[pkg].any_quarantined()
        got[pkg] = (edn_json(pkg, a2), [r["family"] for r in log_of(pkg)],
                    [r["mode"] for r in log_of(pkg)])
    assert got[ct] == got[c]
    assert got[ct][1] == ["payload"]


def test_quarantine_roundtrip_full_bag_readmission():
    """``:325`` on its outcomes — QUARANTINE_AFTER consecutive rejects
    quarantine the sender; its pairs leave the device wave for the host
    merge (digests invalid, merged equal to the merge); the next sync
    round goes straight to the full bag and readmits it. Both packages
    alike, the port on the device route."""
    got = {}
    for tw in TWINS:
        pkg, sync = tw.pkg, SYNC[tw.pkg]
        base = make_base(tw, 20)
        a, b = chaos_pair(tw, base)
        peer = b.ct.site_id
        CHAOS[pkg].configure(plan={"seed": 2, "faults": [
            {"family": "payload", "site": "sync.delta", "mode": "corrupt",
             "prob": 1.0, "times": 2 * sync.QUARANTINE_AFTER}]})
        for i in range(sync.QUARANTINE_AFTER):
            b = b.conj(f"q{i}")
            a, b = sync.sync_pair(a, b)
            assert a.ct.weave == b.ct.weave
        assert sync.is_quarantined(peer) and peer in sync.quarantined()
        res = tw.merge_wave([(a, b), (a, b)])
        assert res.fallback == [0, 1] and not res.digest_valid.any()
        assert res.merged(0).ct.weave == a.merge(b).ct.weave
        b = b.conj("back")
        a, b = sync.sync_pair(a, b)
        assert a.ct.weave == b.ct.weave and not sync.is_quarantined(peer)
        got[pkg] = (edn_json(pkg, a), log_of(pkg))
    assert got[ct] == got[c]


def test_quarantined_pairs_host_merge_and_the_rest_dispatch():
    """The wave's quarantine check: of four pairs, the two holding a
    quarantined replica take the host merge, the other two dispatch;
    digests and merged trees equal the reference's and a clean wave's."""
    out = {}
    for tw in TWINS:
        base = make_base(tw, 30)
        pairs = []
        for p in range(4):
            a = tw.handle(base.ct.evolve(site_id=site("QA", p))).conj(f"a{p}")
            b = tw.handle(base.ct.evolve(site_id=site("QB", p))).conj(f"b{p}")
            pairs.append((a, b))
        clean = tw.merge_wave(pairs)
        sync = SYNC[tw.pkg]
        for _ in range(sync.QUARANTINE_AFTER):
            sync.note_reject(site("QB", 1))
            sync.note_reject(site("QA", 3))
        res = tw.merge_wave(pairs)
        assert res.fallback == [1, 3]
        assert res.digest_valid.tolist() == [True, False, True, False]
        assert np.array_equal(res.digest[[0, 2]], clean.digest[[0, 2]])
        for i in range(4):
            assert res.merged(i).ct.weave == clean.merged(i).ct.weave
        out[tw.pkg] = (res.digest.tolist(),
                       [edn_json(tw.pkg, res.merged(i)) for i in range(4)])
        sync.quarantine_reset()
    assert out[ct] == out[c]


def test_corrupt_quarantined_pair_lands_in_poisoned():
    """A quarantined pair whose replicas disagree on a node's body fails
    the host merge's validation: it is poisoned alone, the wave goes on."""
    for tw in TWINS:
        base = make_base(tw, 20)
        a, b = chaos_pair(tw, base)
        nid = sorted(a.ct.nodes)[-1]
        bad_nodes = dict(b.ct.nodes)
        bad_nodes[nid] = (a.ct.nodes[nid][0], "EVIL")
        evil = tw.handle(b.ct.evolve(nodes=bad_nodes))
        for _ in range(SYNC[tw.pkg].QUARANTINE_AFTER):
            SYNC[tw.pkg].note_reject(evil.ct.site_id)
        res = tw.merge_wave([(a, b), (a, evil)])
        # pair 0 holds the same quarantined site: a clean host merge
        assert res.poisoned == [1] and res.fallback == [0]
        with pytest.raises(tw.pkg.CausalError):
            res.merged(1)
        assert res.merged(0).ct.weave == a.merge(b).ct.weave
        SYNC[tw.pkg].quarantine_reset()


# --------------------------------------------------- recovery ladder


def test_ladder_order_and_transient_retry():
    """``:413`` on its outcomes — the declared order; an injected
    transient costs a retry, a hard error propagates at once, and
    exhaustion re-raises."""
    assert t_recovery.LADDER == j_recovery.LADDER == (
        "delta", "full", "double_budget", "host")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise t_chaos.InjectedDispatchError("flake")
        return "ok"

    assert t_recovery.run_dispatch("wave", flaky, backoff_s=0) == "ok"
    assert len(calls) == 2
    hard = []

    def broken():
        hard.append(1)
        raise ValueError("hard")

    with pytest.raises(ValueError):
        t_recovery.run_dispatch("wave", broken, backoff_s=0)
    assert hard == [1]
    forever = []

    def always():
        forever.append(1)
        raise t_chaos.InjectedDispatchError("forever")

    with pytest.raises(t_chaos.InjectedDispatchError) as ei:
        t_recovery.run_dispatch("tree", always, retries=1, backoff_s=0,
                                uuid="doc")
    assert len(forever) == 2
    assert any("tree (doc)" in n for n in ei.value.__notes__)


@pytest.mark.parametrize("exc, transient", [
    (t_chaos.InjectedDispatchError("x"), True),
    (t_recovery.TransientDispatchError("x"), True),
    (j_chaos.InjectedDispatchError("x"), False),   # the other engine's
    (RuntimeError("CUDA error: an illegal memory access"), False),
    (MemoryError("out of memory"), False),
    (ValueError("shape"), False),
])
def test_is_transient_only_for_the_ports_transients(exc, transient):
    assert t_recovery.is_transient(exc) is transient


def _session_rounds(tw, plan):
    """The session scenario of ``:447``: a full wave and two rounds of
    edits, with ``plan`` armed (or none)."""
    base = make_base(tw, 20)
    a, b = chaos_pair(tw, base)
    if plan:
        CHAOS[tw.pkg].configure(plan=plan)
    sess = tw.Session([(a, b)] * 2)
    full = []
    real_full = sess._full_wave
    sess._full_wave = lambda: full.append(1) or real_full()
    digests, paths = [sess.wave()], []
    for r in range(2):
        a, b = a.conj(f"x{r}"), b.conj(f"y{r}")
        sess.update([(a, b)] * 2)
        n_full = len(full)
        digests.append(sess.wave())
        paths.append("full" if len(full) > n_full else "delta")
    log = log_of(tw.pkg)
    CHAOS[tw.pkg].reset()
    return [d.tolist() for d in digests], paths, log


def test_session_dispatch_fault_retried_and_budget_exhaust_steps():
    """``:447`` on its outcomes — a ``raise`` fault at the session's
    dispatch seam is retried (digests equal the clean run's) and a
    budget-exhaust fault drops the frontier so that wave runs full width
    (digests unchanged); the same log in both packages."""
    plan = {"seed": 9, "faults": [
        {"family": "dispatch", "site": "session", "mode": "raise",
         "at": [1]},
        {"family": "dispatch", "site": "session", "mode": "exhaust",
         "at": [2]},
    ]}
    got = {}
    for tw in TWINS:
        control, control_paths, _ = _session_rounds(tw, None)
        digests, paths, log = _session_rounds(tw, plan)
        assert digests == control
        assert [r["mode"] for r in log] == ["raise", "exhaust"]
        assert control_paths == ["delta", "delta"]
        assert paths == ["delta", "full"]
        got[tw.pkg] = (digests, paths, log)
    assert got[ct] == got[c]


def test_session_fault_log_matches_reference():
    plan = {"seed": 9, "faults": [
        {"family": "dispatch", "site": "session", "mode": "raise",
         "at": [1]},
        {"family": "dispatch", "site": "session", "mode": "exhaust",
         "at": [2]},
        {"family": "stall", "site": "session", "ms": 1, "at": [3]},
    ]}
    logs = {}
    for tw in TWINS:
        base = make_base(tw, 20)
        a, b = chaos_pair(tw, base)
        CHAOS[tw.pkg].configure(plan=plan)
        sess = tw.Session([(a, b)] * 2)
        sess.wave()
        for r in range(2):
            a, b = a.conj(f"x{r}"), b.conj(f"y{r}")
            sess.update([(a, b)] * 2)
            sess.wave()
        logs[tw.pkg] = log_of(tw.pkg)
        assert CHAOS[tw.pkg].chaos_report()["by_family"] == {
            "dispatch": 2, "stall": 1}
        CHAOS[tw.pkg].reset()
    assert logs[ct] == logs[c]


def test_wave_dispatch_fault_is_retried():
    """One injected fault at the wave's seam: the retried ``merge_wave``
    gives the clean wave's digests; one record in the log, as in the
    reference."""
    got = {}
    for tw in TWINS:
        base = make_base(tw, 30)
        pairs = [chaos_pair(tw, base, (f"a{i}",), (f"b{i}",))
                 for i in range(3)]
        clean = tw.merge_wave(pairs)
        CHAOS[tw.pkg].configure(plan={"seed": 4, "faults": [
            {"family": "dispatch", "site": "wave", "mode": "raise",
             "at": [1]}]})
        res = tw.merge_wave(pairs)
        assert np.array_equal(res.digest, clean.digest)
        assert res.digest_valid.all() and not res.fallback
        got[tw.pkg] = (res.digest.tolist(), log_of(tw.pkg))
        CHAOS[tw.pkg].reset()
    assert got[ct] == got[c] and len(got[ct][1]) == 1


def test_tree_budget_exhaust_bounces_a_level_to_full_width():
    """A ``budget_exhaust("tree")`` fault turns one delta level into a
    full-width level: the root is unchanged, and the level paths equal
    the reference's under the same plan."""
    def fleet(tw):
        base = make_base(tw, 30)
        return [tw.handle(base.ct.evolve(site_id=site("T", i))).extend(
                    [f"t{i}.{k}" for k in range(3)]) for i in range(8)]

    from cause_tpu.parallel.tree import merge_tree_report as j_report

    reports = {}
    for tw, report in ((JAX, j_report), (PORT, ct.merge_tree_report)):
        hs = fleet(tw)
        clean_root, clean = report(hs)
        CHAOS[tw.pkg].configure(plan={"seed": 1, "faults": [
            {"family": "dispatch", "site": "tree", "mode": "exhaust",
             "at": [1]}]})
        root, rep = report(hs)
        CHAOS[tw.pkg].reset()
        assert [lv["path"] for lv in clean["levels"]] == [
            "full", "delta", "delta"]
        assert [lv["path"] for lv in rep["levels"]] == [
            "full", "full", "delta"]
        assert root.ct.weave == clean_root.ct.weave
        reports[tw.pkg] = ([lv["path"] for lv in rep["levels"]],
                           edn_json(tw.pkg, root))
    assert reports[ct] == reports[c]


def test_crash_fault_drives_checkpoint_restore():
    """A ``crash`` fault tells the harness to drop the session and bring
    it back from its checkpoint: the restored session's waves equal the
    never-crashed control's, in both packages."""
    got = {}
    for tw in TWINS:
        base = make_base(tw, 30)
        a, b = chaos_pair(tw, base)
        control = tw.Session([(a, b)] * 2)
        CHAOS[tw.pkg].configure(plan={"seed": 6, "faults": [
            {"family": "crash", "site": "session", "at": [2]}]})
        sess = tw.Session([(a, b)] * 2)
        digests = []
        for r in range(3):
            if r:
                a, b = a.conj(f"c{r}"), b.conj(f"d{r}")
                sess.update([(a, b)] * 2)
                control.update([(a, b)] * 2)
            d = sess.wave()
            assert np.array_equal(d, control.wave())
            digests.append(d.tolist())
            if CHAOS[tw.pkg].should_crash("session"):
                ck = json.loads(json.dumps(sess.checkpoint()))
                sess = tw.Session.restore(ck)
                assert sess._delta is not None
        got[tw.pkg] = (digests, log_of(tw.pkg))
        CHAOS[tw.pkg].reset()
    assert got[ct] == got[c] and len(got[ct][1]) == 1


def test_injected_wave_fault_fires_before_the_dispatch():
    """The seam injects before the dispatch runs: with one fault at the
    wave's seam the device program runs once (the retry), never
    twice."""
    from cause_tpu_torch.weaver import torchwd

    base = make_base(PORT, 20)
    pairs = [chaos_pair(PORT, base)]
    calls = []
    real = torchwd.batched_weave_digest
    t_chaos.configure(plan={"seed": 0, "faults": [
        {"family": "dispatch", "site": "wave", "mode": "raise", "at": [1]}]})
    try:
        torchwd.batched_weave_digest = lambda *a, **k: calls.append(1) or \
            real(*a, **k)
        ct.merge_wave(pairs)
    finally:
        torchwd.batched_weave_digest = real
    assert calls == [1]
    assert [r["site"] for r in t_chaos.injected()] == ["wave"]
