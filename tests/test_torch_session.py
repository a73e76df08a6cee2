"""The port's resident fleet session against the JAX package's.

Each scenario is replayed in both packages from the same op script with
the same site ids, so both mint the same nodes and both interners hand
out the same site ranks: the marshalled lanes are equal, and so are the
digests, bit for bit. A scenario records, wave by wave, the digests, the
path the wave took (delta when a frontier was established before it,
else full width), the delta frontier and the materialized weaves; the
port's record must EQUAL the reference's, and the port's digests must
equal its own ``merge_wave`` on the same pairs. On the CPU the port's
kernels run through their plain versions.

Mirrors ``tests/test_session.py`` (all five cases) and the checkpoint
cases of ``tests/test_chaos.py``; also holds the checkpoint dict to the
reference's format and ``serde`` to the reference's encoding.
"""

import json

import numpy as np
import pytest

import cause_tpu as c
from cause_tpu import serde as j_serde
from cause_tpu.collections import clist as j_clist
from cause_tpu.parallel import merge_wave as j_merge_wave
from cause_tpu.parallel.session import FleetSession as JSession

import cause_tpu_torch as ct
from cause_tpu_torch import serde as t_serde
from cause_tpu_torch.collections import clist as t_clist
from cause_tpu_torch.collections import shared as t_shared
from cause_tpu_torch.parallel.session import FleetSession as TSession


class Twin:
    """One package's side of a replayed scenario."""

    def __init__(self, pkg, clist_mod, weaver, merge_wave, session):
        self.pkg = pkg
        self.clist = clist_mod
        self.weaver = weaver
        self.merge_wave = merge_wave
        self.Session = session
        self.port = pkg is ct

    def handle(self, ct_):
        return self.clist.CausalList(ct_)


JAX = Twin(c, j_clist, "jax", j_merge_wave, JSession)
PORT = Twin(ct, t_clist, "torch", ct.merge_wave, TSession)


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's device paths on the CPU for each test."""
    before = ct.default_device()
    ct.use_device("cpu")
    yield
    ct.use_device(before)


def site(tag: str, i: int = 0) -> str:
    """A fixed 13-character site id."""
    return f"s{tag}{i:0{12 - len(tag)}d}"


def make_base(tw, n=50, tag="BASE", uuid=None):
    h = tw.handle(tw.pkg.clist(weaver=tw.weaver).ct.evolve(
        site_id=site(tag)))
    if uuid is not None:
        h = tw.handle(h.ct.evolve(uuid=uuid))
    base = tw.handle(tw.clist.weave(
        h.extend([f"w{i}" for i in range(n)]).ct))
    base.ct.lanes.segments()
    return base


def replica(tw, base, tag, i):
    return tw.handle(base.ct.evolve(site_id=site(tag, i)))


def make_pairs(tw, n_pairs, n_base=50, n_div=6, n_div_b=None):
    base = make_base(tw, n_base)
    n_div_b = n_div if n_div_b is None else n_div_b
    return [(replica(tw, base, "A", p).extend(
                [f"a{p}.{i}" for i in range(n_div)]),
             replica(tw, base, "B", p).extend(
                [f"b{p}.{i}" for i in range(n_div_b)]))
            for p in range(n_pairs)]


def weave_ids(h):
    return [n[0] for n in h.ct.weave]


def frontier(sess):
    d = sess._delta
    if d is None:
        return None
    return (d["s"].tolist(), d["anchor"].tolist(),
            d["prefix_digest"].tolist(), int(d["w_cap"]))


class Recorder:
    """Waves one package's session and records what the reference's
    record is compared with."""

    def __init__(self, tw, sess):
        self.tw = tw
        self.sess = sess
        self.log = []

    def wave(self, check_pairs=None):
        path = "delta" if self.sess._delta is not None else "full"
        d = self.sess.wave()
        assert d.dtype == np.uint32
        if self.tw.port and check_pairs is not None:
            ref = self.tw.merge_wave(check_pairs)
            assert np.array_equal(d, ref.digest)
        self.log.append(("wave", path, d.tolist(), frontier(self.sess)))
        return d

    def update(self, pairs):
        self.sess.update(pairs)
        self.log.append(("update", frontier(self.sess)))

    def merged(self, pairs):
        for i in range(len(pairs)):
            got = self.sess.merged(i)
            self.log.append(("merged", i, weave_ids(got),
                             got.causal_to_edn()))
            if self.tw.port:
                a, b = pairs[i]
                assert got.causal_to_edn() == a.merge(b).causal_to_edn()


def twin_run(scenario):
    """``scenario(tw)`` -> its Recorder log, in both packages; the logs
    must be equal."""
    want = scenario(JAX)
    got = scenario(PORT)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    return got


def paths(log):
    return [e[1] for e in log if e[0] == "wave"]


# ------------------------------------------- tests/test_session.py


def test_session_waves_match_pairwise_merges():
    def scenario(tw):
        pairs = make_pairs(tw, 5)
        rec = Recorder(tw, tw.Session(pairs))
        d0 = rec.wave(pairs)
        rec.merged(pairs)
        pairs2 = [(a.conj("xa").extend(["ya", "za"]), b.conj("xb"))
                  for a, b in pairs]
        rec.update(pairs2)
        d1 = rec.wave(pairs2)
        assert not np.array_equal(d0, d1)
        rec.merged(pairs2)
        pairs3 = [(a.append(list(a)[-1][0], tw.pkg.hide),
                   b.extend(["tail"])) for a, b in pairs2]
        rec.update(pairs3)
        rec.wave(pairs3)
        rec.merged(pairs3)
        return rec.log

    twin_run(scenario)


def test_session_full_reupload_fallbacks():
    def scenario(tw):
        pairs = make_pairs(tw, 3)
        rec = Recorder(tw, tw.Session(pairs, d_max=4))
        rec.wave()
        # a delta larger than d_max forces (and survives) a full
        # re-upload
        pairs2 = [(a.extend([f"big{i}" for i in range(9)]), b)
                  for a, b in pairs]
        rec.update(pairs2)
        rec.wave(pairs2)
        # a dropped cache (mid-order foreign insert) also falls back
        a0, b0 = pairs2[0]
        foreign = ((0, "zzzzzzzzzzzzz", 0), tw.pkg.root_id, "old")
        pairs3 = [(a0.insert(foreign), b0)] + pairs2[1:]
        rec.update(pairs3)
        rec.wave(pairs3)
        rec.merged(pairs3)
        return rec.log

    twin_run(scenario)


def test_session_capacity_growth():
    def scenario(tw):
        pairs = make_pairs(tw, 2, n_base=10, n_div=2)
        rec = Recorder(tw, tw.Session(pairs, d_max=8))
        rec.wave()
        pairs2 = [(pairs[0][0].extend([f"g{i}" for i in range(40)]),
                   pairs[0][1])] + pairs[1:]
        rec.update(pairs2)
        rec.wave(pairs2)
        assert rec.sess.capacity == 64
        return rec.log

    twin_run(scenario)


def test_session_detects_interior_stab_restructuring():
    def scenario(tw):
        pairs = make_pairs(tw, 3)
        rec = Recorder(tw, tw.Session(pairs))
        rec.wave()
        a0, b0 = rec.sess.pairs[0]
        victim = list(a0)[5][0]  # interior element
        pairs2 = [(a0.append(victim, tw.pkg.hide), b0)] + pairs[1:]
        rec.update(pairs2)
        rec.wave(pairs2)
        rec.merged(pairs2)
        return rec.log

    twin_run(scenario)


def test_session_detects_rank_reassignment():
    def scenario(tw):
        pairs = make_pairs(tw, 3)
        rec = Recorder(tw, tw.Session(pairs))
        rec.wave()
        rec.sess._views[0][0].interner._reassign()
        pairs2 = [(a.conj("post-reassign"), b) for a, b in rec.sess.pairs]
        rec.update(pairs2)
        assert rec.sess._delta is None  # the full upload dropped it
        rec.wave(pairs2)
        assert rec.sess._delta is not None
        return rec.log

    twin_run(scenario)


def tombstoned_fleet_pairs(tw, n_replicas=8, n_base=60, n_div=20,
                          hide_every=8):
    """``benchgen.tree_fleet_handles(..., hide_every)``'s fleet with
    fixed site ids, paired as ``chip_smoke.py`` pairs it, each handle
    given its lane cache by one reweave: every ``hide_every``-th suffix
    op a tombstone of its predecessor, so some replica's suffix ends in
    one."""
    base = tw.handle(tw.pkg.clist(weaver="pure").ct.evolve(
        site_id=site("BASE"))).extend([f"w{i}" for i in range(n_base)])
    base = tw.handle(tw.clist.weave(base.ct))
    base = tw.handle(base.ct.evolve(weaver=tw.weaver))
    hs = []
    for r in range(n_replicas):
        vals = []
        for i in range(n_div):
            vals.append(f"r{r}.{i}")
            if i and (i + r) % hide_every == 0:
                vals.append(tw.pkg.hide)
        hs.append(replica(tw, base, "R", r).extend(vals))
    return [tuple(tw.handle(tw.clist.weave(h.ct)) for h in hs[i:i + 2])
            for i in range(0, n_replicas, 2)]


def test_session_edit_after_tombstoned_tail_runs_full_once():
    """``chip_smoke.py``'s session rounds: the first round of appends
    after a suffix that ends in a tombstone restructures that tree's
    segment ordinals, so its update re-uploads and the wave runs full
    width; the second round rides the delta path. Both packages take
    the same paths."""
    def scenario(tw):
        pairs = tombstoned_fleet_pairs(tw)
        rec = Recorder(tw, tw.Session(pairs))
        rec.wave(pairs)
        for rnd in (1, 2):
            pairs = [(a.conj(f"e{rnd}.{i}a").extend([f"e{rnd}.{i}b"]),
                      b.conj(f"e{rnd}.{i}c"))
                     for i, (a, b) in enumerate(pairs)]
            rec.update(pairs)
            rec.wave(pairs)
        rec.merged(pairs)
        return rec.log

    log = twin_run(scenario)
    assert paths(log) == ["full", "full", "delta"]


def test_session_is_resident_and_spliced_in_place():
    """The residents are updated in place: an update writes the deltas
    into the uploaded lane tensors, and a delta wave splices into the
    last full wave's rank/visibility tensors (the objects the session
    holds stay the same), so ``merged`` after a delta wave reads the
    spliced weave."""
    pairs = make_pairs(PORT, 2, n_div=3)
    sess = TSession(pairs)
    sess.wave()
    lanes = {k: sess.dev[k] for k in ("hi", "lo", "cci", "vc", "valid",
                                      "seg")}
    rank, vis = sess.last_rank, sess.last_visible
    pairs2 = [(a.conj("x"), b.conj("y")) for a, b in pairs]
    sess.update(pairs2)
    assert sess._delta is not None
    assert all(sess.dev[k] is t for k, t in lanes.items())
    d = sess.wave()
    assert sess.last_rank is rank and sess.last_visible is vis
    assert np.array_equal(d, ct.merge_wave(pairs2).digest)
    full = ct.merge_wave(pairs2)
    assert np.array_equal(rank.numpy(), full.rank)
    assert np.array_equal(vis.numpy(), full.visible)
    for i, (a, b) in enumerate(pairs2):
        assert sess.merged(i).causal_to_edn() == a.merge(b).causal_to_edn()


def test_session_needs_the_card_unless_asked():
    """Like every device entry point, the session resolves its device
    up front: no card and no ``device=``/``use_device`` raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    pairs = make_pairs(PORT, 1, n_div=2)
    ct.use_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TSession(pairs)
    assert TSession(pairs, device="cpu").device.type == "cpu"


# ---------------------------------- checkpoints (tests/test_chaos.py)


def chaos_pair(tw, base, ea=("A",), eb=("B",)):
    a = replica(tw, base, "CA", 0)
    b = replica(tw, base, "CB", 0)
    for v in ea:
        a = a.conj(v)
    for v in eb:
        b = b.conj(v)
    return a, b


def test_checkpoint_restore_digest_identity_and_delta_resume():
    """Restore is gated on digest bit-identity, restores the frontier,
    and the restored session's first wave rides the delta path with
    digests equal to the original session's and a full-width
    control's."""
    def scenario(tw):
        base = make_base(tw, 40)
        a, b = chaos_pair(tw, base)
        sess = tw.Session([(a, b)] * 4)
        sess.wave()
        a, b = a.conj("x"), b.conj("y")
        sess.update([(a, b)] * 4)
        d1 = sess.wave()
        assert sess._delta is not None
        blob = json.dumps(sess.checkpoint())
        restored = tw.Session.restore(json.loads(blob))
        assert restored._delta is not None, "frontier lost in restore"
        assert np.array_equal(restored._last_digest, d1)
        assert frontier(restored) == frontier(sess)
        a2, b2 = a.conj("p"), b.conj("q")
        restored.update([(a2, b2)] * 4)
        assert restored._delta is not None  # the wave below is delta
        d2 = restored.wave()
        control = tw.Session([(a2, b2)] * 4, delta=False)
        assert np.array_equal(d2, control.wave())
        sess.update([(a2, b2)] * 4)
        assert np.array_equal(d2, sess.wave())
        return [d1.tolist(), d2.tolist(), frontier(restored)]

    assert scenario(PORT) == scenario(JAX)


def test_checkpoint_restore_to_file_and_gates(tmp_path):
    """checkpoint_to/restore(path) round-trips; a tampered digest
    refuses restore; an unwaved session has nothing to checkpoint; a
    frontier that no longer validates is dropped (the session restores
    full width, still correct); an unknown version is refused."""
    from cause_tpu_torch.parallel.session import _pack_arr, _unpack_arr

    base = make_base(PORT, 20)
    a, b = chaos_pair(PORT, base)
    sess = TSession([(a, b)] * 2)
    sess.wave()
    path = str(tmp_path / "sess.ckpt.json")
    sess.checkpoint_to(path)
    restored = TSession.restore(path)
    assert np.array_equal(restored._last_digest, sess._last_digest)

    ck = json.load(open(path))
    ck["digest"] = _pack_arr(_unpack_arr(ck["digest"]) + 1)  # tamper
    with pytest.raises(t_shared.CausalError) as ei:
        TSession.restore(ck)
    assert "checkpoint-mismatch" in ei.value.info["causes"]

    with pytest.raises(t_shared.CausalError) as ei:
        TSession([(a, b)] * 2).checkpoint()  # no wave yet
    assert "no-wave" in ei.value.info["causes"]

    ck2 = json.load(open(path))
    assert ck2.get("delta") is not None
    ck2["delta"]["w_cap"] = 1  # the window can no longer fit: drop
    r2 = TSession.restore(ck2)
    assert r2._delta is None
    assert np.array_equal(r2._last_digest, sess._last_digest)

    with pytest.raises(t_shared.CausalError) as ei:
        TSession.restore({"~causal_session": 999})
    assert "checkpoint-mismatch" in ei.value.info["causes"]


def test_restore_refuses_a_torn_pack(tmp_path):
    """A checkpoint file torn mid-write (truncated JSON) refuses restore
    through the declared checkpoint-mismatch gate, never a bare json
    error."""
    base = make_base(PORT, 20)
    a, b = chaos_pair(PORT, base)
    sess = TSession([(a, b)] * 2)
    sess.wave()
    path = str(tmp_path / "torn.ckpt.json")
    sess.checkpoint_to(path)
    blob = open(path).read()
    with open(path, "w") as f:
        f.write(blob[:len(blob) // 2])
    with pytest.raises(t_shared.CausalError) as ei:
        TSession.restore(path)
    assert "checkpoint-mismatch" in ei.value.info["causes"]


def test_checkpoint_format_matches_reference():
    """The port's checkpoint has the reference's keys, version and
    array packs (dtype, shape, base64 bytes) for the same twin fleet,
    and its ``pairs`` entries are the reference's ``serde.to_data`` of
    the same handles, but for the weaver's name."""
    def checkpoint(tw):
        base = make_base(tw, 30, uuid="checkpointFormatTwin0")
        a, b = chaos_pair(tw, base)
        sess = tw.Session([(a, b), (b, a)])
        sess.wave()
        a, b = a.conj("x"), b.conj("y")
        sess.update([(a, b), (b, a)])
        sess.wave()
        return sess.checkpoint()

    got, want = checkpoint(PORT), checkpoint(JAX)
    assert got.keys() == want.keys()
    assert got["~causal_session"] == want["~causal_session"] == 1
    for k in ("d_max", "u_headroom", "delta_enabled", "u_max", "capacity",
              "rank", "visible", "digest", "delta"):
        assert got[k] == want[k], k
    for gp, wp in zip(got["pairs"], want["pairs"]):
        for g, w in zip(gp, wp):
            assert g.pop("weaver") == "torch" and w.pop("weaver") == "jax"
            assert g == w


# ------------------------------------------------------------- serde


def test_serde_round_trip_matches_reference():
    """A list with specials, keywords, tuples, sets, dicts and
    non-finite floats encodes to the reference's data and JSON, and
    decodes to an equal list in both directions."""
    def build(tw):
        h = tw.handle(tw.pkg.clist(weaver="pure").ct.evolve(
            site_id=site("SERDE"), uuid="serdeRoundTripTwin000"))
        vals = ["s", 1, 2.5, float("inf"), None, True, (1, "t"),
                frozenset({1, 2}), {"k": [1, 2]}]
        h = h.extend(vals)
        return h.append(list(h)[2][0], tw.pkg.hide)

    jh, th = build(JAX), build(PORT)
    assert t_serde.to_data(th) == j_serde.to_data(jh)
    assert t_serde.dumps(th) == j_serde.dumps(jh)
    back = t_serde.loads(j_serde.dumps(jh))
    assert weave_ids(back) == weave_ids(th)
    assert back.causal_to_edn() == th.causal_to_edn()
    assert t_serde.loads(t_serde.dumps(th)) == th


def test_serde_refuses_what_is_not_ported():
    """Bases and refs serialize (the base module is ported): a base with
    nested collections and an undo, and a ref, encode to the reference's
    data and JSON, and each package decodes the other's bytes to an
    equal value. What is not serializable still raises."""
    def build(pkg):
        pkg.ids._rng.seed(8)
        cb = pkg.base()
        cb = pkg.transact(cb, [[None, None, [pkg.K("div"),
                                             {pkg.K("t"): "hi"}, "ab"]]])
        refs = [n[2] for n in pkg.get_collection(cb) if pkg.is_ref(n[2])]
        cb = pkg.transact(cb, [[refs[0].uuid, None, {pkg.K("t"): "yo"}]])
        return pkg.undo(cb), refs[0]

    (jb, jref), (tb, tref) = build(c), build(ct)
    c.ids._rng.seed()
    ct.ids._rng.seed()
    for t_val, j_val in ((tb, jb), (tref, jref)):
        assert t_serde.to_data(t_val) == j_serde.to_data(j_val)
        assert t_serde.dumps(t_val) == j_serde.dumps(j_val)
        assert j_serde.dumps(j_serde.loads(t_serde.dumps(t_val))) == \
            j_serde.dumps(j_val)
    back = t_serde.loads(j_serde.dumps(jb))
    assert isinstance(back, ct.CausalBase)
    assert t_serde.dumps(back) == t_serde.dumps(tb)
    assert back.causal_to_edn() == tb.causal_to_edn()
    assert t_serde.loads(j_serde.dumps(jref)) == tref
    with pytest.raises(t_shared.CausalError):
        t_serde.to_data(object())
