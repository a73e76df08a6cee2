"""The port's anti-entropy sync against the JAX package's.

Mirrors ``tests/test_sync.py`` — version vectors, delta exchange,
convergence over real sockets, the full-bag fallback, the frame
protocol's rejections, base-level sync and undo after it — apart from
its two cases on the network transport's ``FrameStream`` (``:279``,
``:316``), which wait for the transport's port. Also the ``sync_pair``
half of ``tests/test_delta_weave.py:202`` (a session over sync-shared
suffix nodes). Each scenario runs as twins in both packages (uid
generators seeded alike: the same uuids and site ids) under
``weaver="pure"`` and ``"torch"`` in the port and ``"pure"`` and
``"jax"`` in the reference; their results are compared through each
package's serde encoding. A ``weaver="torch"`` round applies each delta
with one device reweave a side (on the CPU through the kernels' plain
versions).
"""

import io
import socket
import threading
import time

import numpy as np
import pytest

import cause_tpu as c
from cause_tpu import sync as j_sync
from cause_tpu.parallel import merge_wave as j_merge_wave
from cause_tpu.parallel.session import FleetSession as JSession

import cause_tpu_torch as ct
from cause_tpu_torch import sync as t_sync
from cause_tpu_torch.parallel.session import FleetSession as TSession
from cause_tpu_torch.weaver import torchw

from test_torch_base import seeded, twin

SYNC = {c: j_sync, ct: t_sync}


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's device paths on the CPU, and empty quarantine
    registries, for each test."""
    before = ct.default_device()
    ct.use_device("cpu")
    t_sync.quarantine_reset()
    j_sync.quarantine_reset()
    yield
    ct.use_device(before)


def fork(pkg, handle):
    return type(handle)(handle.ct.evolve(site_id=pkg.new_site_id()))


def stream_sync(pkg, a, b, timeout=30):
    """One ``sync_stream`` round over a real socketpair between two
    threads; returns ``({"a": a', "b": b'}, {name: error})``."""
    s1, s2 = socket.socketpair()
    out, errs = {}, {}

    def side(name, handle, sock):
        with sock, sock.makefile("rwb") as stream:
            try:
                out[name] = SYNC[pkg].sync_stream(handle, stream)
            except pkg.CausalError as e:
                errs[name] = e

    ts = [threading.Thread(target=side, args=("a", a, s1), daemon=True),
          threading.Thread(target=side, args=("b", b, s2), daemon=True)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "sync deadlocked"
    return out, errs


def test_version_vector_and_delta():
    def run(pkg, w):
        sync = SYNC[pkg]
        cl = pkg.clist(*"abc", weaver=w)
        vv = sync.version_vector(cl)
        mid = dict(vv)
        mid[cl.get_site_id()] = [mid[cl.get_site_id()][0] - 1, 0]
        return (vv, sync.delta_nodes(cl, vv), sync.delta_nodes(cl, {}),
                sync.delta_nodes(cl, mid), cl)

    vv, none, every, suffix, cl = twin(run)["device"]
    assert vv[cl.get_site_id()] == [cl.get_ts(), 0]
    assert none == {} and len(every) == len(cl.get_nodes())
    assert len(suffix) == 1


def test_sync_pair_converges_and_is_idempotent():
    def run(pkg, w):
        sync = SYNC[pkg]
        base = pkg.clist(*"hello", weaver=w)
        a = fork(pkg, base).conj("!").conj("?")
        b = fork(pkg, base).cons("<")
        a2, b2 = sync.sync_pair(a, b)
        a3, b3 = sync.sync_pair(a2, b2)
        return (a2, b2, a3.get_nodes() == a2.get_nodes(),
                sync.delta_nodes(a2, sync.version_vector(b2)))

    for w, (a2, b2, stable, rest) in twin(run).items():
        assert a2.get_nodes() == b2.get_nodes()
        assert a2.causal_to_edn() == b2.causal_to_edn()
        assert a2.ct.weave == b2.ct.weave
        assert stable and rest == {}
        assert a2.ct.weaver == ("pure" if w == "pure" else "torch")


def test_sync_pair_maps_and_sets():
    def run(pkg, w):
        K, sync = pkg.K, SYNC[pkg]
        base = pkg.cmap(weaver=w).append(K("title"), "draft")
        a = fork(pkg, base).append(K("title"), "v2")
        b = fork(pkg, base).append(K("author"), "bo")
        sbase = pkg.cset("x", weaver=w)
        sa = fork(pkg, sbase).add("y")
        sb = fork(pkg, sbase).discard("x")
        return sync.sync_pair(a, b) + sync.sync_pair(sa, sb)

    a2, b2, sa2, sb2 = twin(run)["device"]
    assert a2.causal_to_edn() == b2.causal_to_edn()
    assert a2.causal_to_edn()[ct.K("author")] == "bo"
    assert sa2.causal_to_edn() == sb2.causal_to_edn() == {"y"}


def test_sync_over_real_sockets_equals_sync_pair():
    def run(pkg, w):
        base = pkg.clist(*"shared", weaver=w)
        a = fork(pkg, base).extend(["A1", "A2"])
        b = fork(pkg, base).extend(["B1"])
        out, errs = stream_sync(pkg, a, b)
        assert errs == {}
        return out["a"], out["b"], SYNC[pkg].sync_pair(a, b)

    for a2, b2, (pa, pb) in twin(run).values():
        assert a2.get_nodes() == b2.get_nodes() == pa.get_nodes()
        assert a2.ct.weave == b2.ct.weave == pa.ct.weave == pb.ct.weave
        got = a2.causal_to_edn()
        assert "A2" in got and "B1" in got


def test_sync_uuid_mismatch_rejected():
    for pkg in (c, ct):
        _out, errs = stream_sync(pkg, pkg.clist("x"), pkg.clist("x"))
        assert "uuid-missmatch" in errs["a"].info["causes"]
        assert "uuid-missmatch" in errs["b"].info["causes"]


def _gapped(pkg, w):
    """Two replicas where ``b`` holds ``x3`` but not ``x1``: its siteX
    yarn is not a prefix, so ``a``'s delta misses a cause."""
    doc = pkg.clist(weaver=w)
    x1 = ((1, "siteX________", 0), pkg.root_id, "x1")
    z2 = ((2, "siteZ________", 0), pkg.root_id, "z2")
    x3 = ((3, "siteX________", 0), z2[0], "x3")
    w4 = ((4, "siteW________", 0), x1[0], "w4")
    return doc.insert(x1).insert(z2).insert(x3).insert(w4), \
        doc.insert(z2).insert(x3)


def test_sync_fallback_on_nonprefix_history():
    def run(pkg, w):
        out, errs = stream_sync(pkg, *_gapped(pkg, w))
        assert errs == {}
        return out["a"], out["b"]

    for a2, b2 in twin(run).values():
        assert a2.get_nodes() == b2.get_nodes()
        edn = a2.causal_to_edn()
        assert "x1" in edn and "w4" in edn


def test_sync_pair_nonprefix_fallback():
    def run(pkg, w):
        return SYNC[pkg].sync_pair(*_gapped(pkg, w))

    a2, b2 = twin(run)["device"]
    assert a2.get_nodes() == b2.get_nodes() and len(b2.get_nodes()) == 5


def _evil_round(pkg, base, hello):
    s1, s2 = socket.socketpair()
    errs = {}

    def good(sock):
        with sock, sock.makefile("rwb") as stream:
            try:
                SYNC[pkg].sync_stream(base, stream)
            except pkg.CausalError as e:
                errs["good"] = e

    def evil(sock):
        with sock, sock.makefile("rwb") as stream:
            SYNC[pkg].send_frame(stream, hello)
            try:
                SYNC[pkg].recv_frame(stream)
            except pkg.CausalError:
                pass

    t1 = threading.Thread(target=good, args=(s1,), daemon=True)
    t2 = threading.Thread(target=evil, args=(s2,), daemon=True)
    t1.start(); t2.start(); t1.join(5); t2.join(5)
    return errs


def test_malformed_frames_raise_causal_errors():
    for pkg in (c, ct):
        errs = _evil_round(pkg, pkg.clist("x"), {"op": "hello"})
        assert "bad-frame" in errs["good"].info["causes"]


@pytest.mark.parametrize("bad_vv", [
    "not-a-dict", {"s": "newest"}, {"s": [1]}, {"s": [1, 2, 3]},
    {"s": [1.5, 0]}, {"s": [True, 0]},
])
def test_malformed_version_vector_rejected_as_bad_frame(bad_vv):
    for pkg in (c, ct):
        base = pkg.clist("x")
        errs = _evil_round(pkg, base, {
            "op": "hello", "uuid": base.ct.uuid, "type": base.ct.type,
            "vv": bad_vv})
        assert "bad-frame" in errs["good"].info["causes"], (pkg, bad_vv)


class _DribbleStream:
    """Returns at most one byte per read: the short reads of a raw
    transport that buffered streams hide."""

    def __init__(self):
        self.buf = bytearray()

    def write(self, data):
        self.buf.extend(data)
        return len(data)

    def flush(self):
        pass

    def read(self, n):
        if not self.buf:
            return b""
        out = bytes(self.buf[:1])
        del self.buf[:1]
        return out


def test_recv_frame_survives_short_reads():
    stream = _DribbleStream()
    t_sync.send_frame(stream, {"op": "done", "k": [1, "x"]})
    raw = bytes(stream.buf)
    assert t_sync.recv_frame(stream) == {"op": "done", "k": [1, "x"]}
    ref = _DribbleStream()
    j_sync.send_frame(ref, {"op": "done", "k": [1, "x"]})
    assert bytes(ref.buf) == raw  # the same frame bytes on the wire
    stream2 = _DribbleStream()
    t_sync.send_frame(stream2, {"op": "done"})
    stream2.buf = stream2.buf[:3]
    with pytest.raises(ct.CausalError) as ei:
        t_sync.recv_frame(stream2)
    assert "eof" in ei.value.info["causes"]


def test_exchange_frame_surfaces_recv_error_while_send_blocked():
    class _BlockedWriter(io.RawIOBase):
        def write(self, data):
            time.sleep(60)
            return len(data)

        def flush(self):
            pass

        def read(self, n):
            return b""

    t0 = time.monotonic()
    with pytest.raises(ct.CausalError) as ei:
        t_sync.exchange_frame(_BlockedWriter(), {"op": "hello",
                                                 "pad": "x" * 1024})
    assert "eof" in ei.value.info["causes"]
    assert time.monotonic() - t0 < 30, "exchange_frame hung on join"


def test_sync_stream_socket_deadline_on_silent_peer():
    """The buffered-stream half of the reference's deadline test: a
    socket timeout armed by the caller maps to the uniform
    read-timeout reject."""
    s1, s2 = socket.socketpair()
    s1.settimeout(0.3)
    t0 = time.monotonic()
    with s1, s1.makefile("rwb") as stream:
        with pytest.raises(ct.CausalError) as ei:
            t_sync.sync_stream(ct.clist("x"), stream)
        assert "read-timeout" in ei.value.info["causes"]
    assert time.monotonic() - t0 < 5.0
    s2.close()


def test_same_ts_tx_run_partial_peer_heals():
    def run(pkg, w):
        sync, site = SYNC[pkg], "siteT________"
        doc = pkg.clist(weaver=w)
        run_ = [((1, site, 0), pkg.root_id, "t0"),
                ((1, site, 1), (1, site, 0), "t1"),
                ((1, site, 2), (1, site, 1), "t2")]
        a = doc.insert(run_[0]).insert(run_[1]).insert(run_[2])
        b = doc.insert(run_[0]).insert(run_[1])
        return (sync.version_vector(b)[site],
                sync.delta_nodes(a, sync.version_vector(b)),
                *sync.sync_pair(a, b))

    vv, d, a2, b2 = twin(run)["device"]
    assert vv == [1, 1] and list(d) == [(1, "siteT________", 2)]
    assert a2.get_nodes() == b2.get_nodes() and len(b2.get_nodes()) == 4


def test_large_deltas_do_not_deadlock_sockets():
    """Frames larger than the socket buffers, both ways at once, on the
    device weaver: two 9,000-op deltas, one device reweave a side."""
    base = ct.clist("seed", weaver="torch")
    a = fork(ct, base).extend([f"a{i}" * 4 for i in range(9000)])
    b = fork(ct, base).extend([f"b{i}" * 4 for i in range(9000)])
    out, errs = stream_sync(ct, a, b, timeout=120)
    assert errs == {}
    assert out["a"].get_nodes() == out["b"].get_nodes()
    assert len(out["a"].get_nodes()) == 2 + 18000
    want = ct.CausalList(a.ct.evolve(weaver="pure")).merge_many(
        [ct.CausalList(b.ct.evolve(weaver="pure"))])
    assert out["a"].ct.weave == out["b"].ct.weave == want.ct.weave


def test_sync_round_reweaves_once_a_side_on_the_device_route():
    """A ``weaver="torch"`` round applies each side's delta through
    ``merge_many``: one device reweave a side (the route that puts a
    sync round on the card)."""
    base = ct.clist(*"abcdef", weaver="torch")
    a = fork(ct, base).conj("A")
    b = fork(ct, base).conj("B")
    calls = []
    real = torchw.merge_many_list_trees
    try:
        torchw.merge_many_list_trees = lambda cts: calls.append(
            len(cts)) or real(cts)
        a2, b2 = ct.sync_pair(a, b)
    finally:
        torchw.merge_many_list_trees = real
    assert calls == [2, 2]
    assert a2.ct.weave == b2.ct.weave


def test_sync_base_pair_converges_and_undo_still_works():
    def run(pkg, w):
        K = pkg.K
        cb = pkg.transact(pkg.base(weaver=w), [[None, None,
                                                {K("title"): "draft"}]])
        a = pkg.CausalBase(cb.cb.evolve(site_id=pkg.new_site_id()))
        b = pkg.CausalBase(cb.cb.evolve(site_id=pkg.new_site_id()))
        r = pkg.get_uuid(pkg.get_collection(a))
        a = pkg.transact(a, [[r, K("author"), "ada"]])
        b = pkg.transact(b, [[r, K("status"), "wip"]])
        b = pkg.transact(b, [[r, K("tags"), ["x", "y"]]])
        a2, b2 = pkg.sync_base_pair(a, b)
        a3 = pkg.undo(a2)
        a4, b4 = pkg.sync_base_pair(a2, b2)
        return a2, b2, a3, a4

    a2, b2, a3, a4 = twin(run)["device"]
    K = ct.K
    ea = a2.causal_to_edn()
    assert ea == b2.causal_to_edn()
    assert ea[K("author")] == "ada" and ea[K("status")] == "wip"
    assert set(a2.cb.collections) == set(b2.cb.collections)
    assert a2.cb.history == b2.cb.history
    e3 = a3.causal_to_edn()
    assert K("author") not in e3 and e3[K("status")] == "wip"
    assert a4.causal_to_edn() == ea and a4.cb.history == a2.cb.history


def test_sync_base_uuid_and_root_guards():
    with pytest.raises(ct.CausalError):
        ct.sync_base_pair(ct.base(), ct.base())
    blank = ct.base()
    a = ct.CausalBase(blank.cb.evolve(site_id=ct.new_site_id()))
    b = ct.CausalBase(blank.cb.evolve(site_id=ct.new_site_id()))
    a = ct.transact(a, [[None, None, {ct.K("x"): 1}]])
    b = ct.transact(b, [[None, None, {ct.K("y"): 2}]])
    with pytest.raises(ct.CausalError) as e:
        ct.sync_base_pair(a, b)
    assert "root-missmatch" in e.value.info["causes"]


@pytest.mark.parametrize("weaver", ["pure", "torch"])
def test_delta_merge_validates_malicious_payload(weaver):
    cl = ct.clist(*"ab", weaver=weaver)
    nid = sorted(cl.get_nodes())[1]
    with pytest.raises(ct.CausalError):
        t_sync.apply_delta(cl, {nid: (cl.get_nodes()[nid][0], "EVIL")})


def test_undo_chain_survives_clock_fast_forward():
    def run(pkg, w):
        K = pkg.K
        cb = pkg.transact(pkg.base(weaver=w), [[None, None, {K("seed"): 0}]])
        a = pkg.CausalBase(cb.cb.evolve(site_id=pkg.new_site_id()))
        b = pkg.CausalBase(cb.cb.evolve(site_id=pkg.new_site_id()))
        r = pkg.get_uuid(pkg.get_collection(a))
        a = pkg.transact(a, [[r, K("a1"), 1]])
        for i in range(4):
            b = pkg.transact(b, [[r, K(f"b{i}"), i]])
        a2, _ = pkg.sync_base_pair(a, b)
        a2 = pkg.transact(a2, [[r, K("a2"), 2]])
        u1 = pkg.undo(a2)
        u2 = pkg.undo(u1)
        return u1, u2, pkg.redo(u2)

    u1, u2, r1 = twin(run)["device"]
    K = ct.K
    assert K("a2") not in u1.causal_to_edn()
    e2 = u2.causal_to_edn()
    assert K("a1") not in e2 and e2[K("b3")] == 3
    assert K("a1") in r1.causal_to_edn()


def test_random_sync_network_converges():
    def run(pkg, w):
        import random as _random

        sync = SYNC[pkg]
        rng = _random.Random(2026)
        base = pkg.clist(*"doc", weaver=w)
        n = 4
        reps = [fork(pkg, base) for _ in range(n)]
        for step in range(30):
            i = rng.randrange(n)
            r = reps[i]
            kind = rng.random()
            if kind < 0.6:
                reps[i] = r.conj(f"v{step}")
            elif kind < 0.8 and len(r.get_weave()) > 1:
                nid = rng.choice([nd[0] for nd in r.get_weave()[1:]])
                reps[i] = r.append(nid, pkg.hide)
            else:
                a, b = rng.sample(range(n), 2)
                reps[a], reps[b] = sync.sync_pair(reps[a], reps[b])
        expected = reps[0].merge_many(reps[1:])
        for a in range(n):
            for b in range(a + 1, n):
                reps[a], reps[b] = sync.sync_pair(reps[a], reps[b])
        return reps, expected

    reps, expected = twin(run)["device"]
    for r in reps:
        assert r.get_nodes() == expected.get_nodes()
        assert r.ct.weave == expected.ct.weave


def test_session_over_sync_shared_suffix_nodes():
    """The ``sync_pair`` half of ``tests/test_delta_weave.py:202``: both
    trees of a pair hold the same divergent nodes (synced in) plus fresh
    private edits; the session's waves equal a fresh ``merge_wave`` in
    both packages, digest for digest."""
    def make(pkg, w):
        h = pkg.clist(weaver=w)
        h = type(h)(h.ct.evolve(site_id="sBASE00000000"))
        base = type(h)(pkg.collections.clist.weave(
            h.extend([f"w{i}" for i in range(40)]).ct))
        base.ct.lanes.segments()
        return base

    def run(pkg, w, Session, merge_wave):
        base = make(pkg, w)
        a2 = type(base)(base.ct.evolve(site_id="sA00000000000")).extend(
            ["p", "q"])
        b2 = type(base)(base.ct.evolve(site_id="sB00000000000")).extend(
            ["r"])
        a2s, b2s = SYNC[pkg].sync_pair(a2, b2)
        sess = Session([(a2s, b2s)] * 2)
        digests = [sess.wave()]
        p3 = [(a2s, b2s)] * 2
        for rnd in range(3):
            p3 = [(x.conj(f"m{rnd}"), y.conj(f"s{rnd}"))
                  for x, y in p3[:1]] * 2
            sess.update(p3)
            digests.append(sess.wave())
            assert np.array_equal(digests[-1], merge_wave(p3).digest)
        return digests, [sess.merged(i) for i in range(2)], p3

    with seeded(5):
        j_dig, j_merged, _ = run(c, "jax", JSession, j_merge_wave)
    with seeded(5):
        t_dig, t_merged, p3 = run(ct, "torch", TSession, ct.merge_wave)
    for got, want in zip(t_dig, j_dig):
        assert np.array_equal(got, want)
    for i, (x, y) in enumerate(p3):
        assert t_merged[i].ct.weave == x.merge(y).ct.weave
        assert t_merged[i].causal_to_edn() == j_merged[i].causal_to_edn()
