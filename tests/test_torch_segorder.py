"""A1 (``weaver/segorder.py``, ``csrc/seg_order.cu``): phase A of the v5
wave after B1's segment sort.

On the CPU: a numpy model of the kernel's algorithm (three passes over a
row in tiles: the twin test against the carried neighbour, the two
carried scans, the group table written at group starts with E1's
bytes, the search over an index of every k-th group min and then the
mins between two samples, the byte flags) against the plain chain on
marshalled batches of every typing mix, on an adversarial fuzz and on
edge rows, at several tile widths and index sizes; a change to either
changes the model too. The wrapper's checks and the span's contract.

On the card (the ``card`` marker; skips without one): the kernel
against the plain version, output for output and exactly, at a
``pairs_full``-shaped batch, a ``pairs_random``-shaped batch, a fleet
row of over 40,000 segments, the edge rows and a fuzz. This file imports no
JAX; on the card run it as ``python -m pytest --noconftest
tests/test_torch_segorder.py``.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from cause_tpu_torch import benchgen, kernels
from cause_tpu_torch.weaver import bitonic, segorder

BIG = 2 ** 31 - 1
KEY_MIN = -(2 ** 63)
KEY_MAX = 2 ** 63 - 1
SG_KEYS = ("sg_max_hi", "sg_max_lo", "sg_len", "sg_lane0", "sg_dense",
           "sg_tail_special", "sg_valid", "sg_vsum")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda:0")


# ------------------------------------------------------------ inputs


def seg_args(v5: dict, device) -> tuple:
    """``seg_order``'s operands for a marshalled batch: the lanes, B1's
    sort of the segments as ``torchw5._v5_ab`` makes it, the tables."""
    t = benchgen.lanes_from_numpy(v5, device)
    B, S = t["sg_len"].shape
    kh = torch.where(t["sg_valid"], t["sg_min_hi"], BIG)
    kl = torch.where(t["sg_valid"], t["sg_min_lo"], BIG)
    sidx = torch.arange(S, dtype=torch.int32,
                        device=kh.device).expand(B, S).contiguous()
    s_mh, s_ml, s_src = bitonic.sort_pairs((kh, kl, sidx), num_keys=2)
    return (t["hi"], t["lo"], t["cci"], t["vc"], s_mh, s_ml, s_src,
            *(t[k] for k in SG_KEYS))


def marshalled(kind: str, seed: int, rows: int, n_base: int, n_div: int,
               cap: int) -> dict:
    """A batch of ``rows`` documents of the benchmark's generator
    (``chain``, ``random`` or ``runs`` typing), or one fleet row of
    ``rows`` replicas (``fleet``), through the port's marshal."""
    from weavebench import gen
    from weavebench.entries.common import marshal

    mixes = {"chain": dict(base_run_mean=None, div_run_mean=None,
                           hides="previous"),
             "random": dict(base_run_mean=1, div_run_mean=1,
                            hides="uniform"),
             "runs": dict(base_run_mean=4, div_run_mean=3, hides="uniform")}
    rng = gen.rng_for(seed, 0)
    if kind == "fleet":
        cfg = dict(replicas=rows, base_nodes=n_base, divergent_nodes=n_div,
                   capacity=cap, hide_p=0.125)
        v5 = marshal(gen.fleet_row(rng, cfg, mixes["chain"]), cap)
        return {k: np.asarray(v)[None] for k, v in v5.items()}
    cfg = dict(documents=rows, base_nodes=n_base, divergent_nodes=n_div,
               capacity=cap, hide_p=0.125)
    return marshal(gen.pair_batch(rng, cfg, mixes[kind]), cap)


def _v5_dict(hi, lo, cci, vclass, segs) -> dict:
    """One row's v5 inputs from its lanes and a list of segments, each
    ``(min, max, len, lane0, dense, tail_special, valid, vsum)`` with
    ids as (hi, lo) pairs."""
    N = len(hi)
    cols = {k: [] for k in ("sg_min_hi", "sg_min_lo", "sg_max_hi",
                            "sg_max_lo", "sg_len", "sg_lane0", "sg_dense",
                            "sg_tail_special", "sg_valid", "sg_vsum")}
    for (mn, mx, ln, l0, dense, tsp, va, vsum) in segs:
        for k, v in zip(cols, (mn[0], mn[1], mx[0], mx[1], ln, l0, dense,
                               tsp, va, vsum)):
            cols[k].append(v)
    v5 = {"hi": hi, "lo": lo, "cci": cci, "vc": vclass,
          "valid": np.ones(N, bool), "seg": np.zeros(N, np.int32)}
    v5.update(cols)
    return {k: np.array(v)[None] for k, v in v5.items()}


def _lanes(n):
    return (np.zeros(n, np.int32), np.arange(n, dtype=np.int32),
            np.full(n, -1, np.int32), np.zeros(n, np.int32))


def _run(k, ln=4, dense=True, tsp=False, va=True, vsum=7, base=0):
    """Segment k of four-lane runs: lanes base + 4k ..., ids (0, lane)."""
    l0 = base + ln * k
    return ((0, l0), (0, l0 + ln - 1), ln, l0, dense, tsp, va, vsum)


def edge_rows() -> dict:
    """Rows the benchmark's traffic may not reach, by what each pins."""
    out = {}
    hi, lo, cci, vc = _lanes(16)
    out["all_invalid"] = _v5_dict(hi, lo, cci, vc, [
        _run(k, va=False) for k in range(4)])
    # a head whose cause lies inside its own segment: a stab, at slot 0,
    # which is also the row's last
    hi, lo, cci, vc = _lanes(4)
    cci[0] = 2
    out["one_segment"] = _v5_dict(hi, lo, cci, vc, [_run(0)])
    # every segment its own group (G == S) and a head cause inside the
    # last group: the stab lands in the row's last slot, the dump slot of
    # the plain version's scatter
    hi, lo, cci, vc = _lanes(16)
    cci[0] = 13
    out["last_slot_stab"] = _v5_dict(hi, lo, cci, vc, [
        _run(k) for k in range(4)])
    # a twin pair (replica copies of lanes 0-3 at lanes 8-11) whose
    # interior another head's cause stabs: the whole group explodes
    hi, lo, cci, vc = _lanes(16)
    lo[8:12] = np.arange(4)
    cci[12] = 1
    out["stabbed_twins"] = _v5_dict(hi, lo, cci, vc, [
        _run(0), ((0, 0), (0, 3), 4, 8, True, False, True, 7),
        ((0, 12), (0, 15), 4, 12, True, False, True, 7)])
    # the same twins, unstabbed: one survives, one is dropped
    cci[12] = -1
    out["quiet_twins"] = _v5_dict(hi, lo, cci, vc, [
        _run(0), ((0, 0), (0, 3), 4, 8, True, False, True, 7),
        ((0, 12), (0, 15), 4, 12, True, False, True, 7)])
    # a cause below every group min: pg = -1
    hi, lo, cci, vc = _lanes(16)
    hi[15] = -5
    cci[4] = 15
    out["below_every_group"] = _v5_dict(hi, lo, cci, vc, [
        _run(k) for k in range(3)])
    # causes at a group's max: a special tail over more than one lane is
    # stabbed (segment 2), a plain tail is not (segment 1), nor a special
    # tail of one lane (segment 3)
    hi, lo, cci, vc = _lanes(16)
    cci[0], cci[4], cci[8] = 11, 7, 12
    out["cause_at_max"] = _v5_dict(hi, lo, cci, vc, [
        _run(0), _run(1), _run(2, tsp=True),
        ((0, 12), (0, 12), 1, 12, True, True, True, 7)])
    # the largest ids: a segment ending at (INT32_MAX, INT32_MAX), a
    # head cause there, in a row of S groups (the search's last slot is
    # a group) and in a row with a twin (it is an empty slot)
    hi, lo, cci, vc = _lanes(8)
    hi[4:8], lo[4:8] = BIG, np.arange(BIG - 3, BIG + 1)
    cci[0] = 7
    top = ((BIG, BIG - 3), (BIG, BIG), 4, 4, True, True, True, 7)
    out["max_ids"] = _v5_dict(hi, lo, cci, vc, [_run(0), top])
    out["max_ids_fewer_groups"] = _v5_dict(hi, lo, cci, vc, [
        _run(0), _run(0), top])
    return out


def fuzz_row(rng, B: int, N: int, S: int) -> dict:
    """Adversarial rows: segments drawn from a few prototypes (so that
    sorted neighbours are often exact twins), ids in a narrow range with
    the int32 extremes, causes out of range, lanes out of range,
    invalid segments keyed like valid ones."""
    ids = np.array([-3, -1, 0, 1, 2, BIG - 1, BIG, -(2 ** 31)], np.int64)
    hi = rng.choice(ids, (B, N), p=[.1, .15, .3, .2, .1, .05, .05, .05])
    lo = rng.choice(ids, (B, N), p=[.1, .15, .3, .2, .1, .05, .05, .05])
    cci = rng.integers(-2, N + 2, (B, N))
    vc = rng.integers(0, 3, (B, N))
    P = max(1, S // 3)
    proto = {
        "mh": rng.choice(ids[:5], (B, P)), "ml": rng.choice(ids, (B, P)),
        "Mh": rng.choice(ids, (B, P)), "Ml": rng.choice(ids, (B, P)),
        "len": rng.integers(0, 4, (B, P)),
        "l0": rng.integers(-2, N + 1, (B, P)),
        "dense": rng.random((B, P)) < .8, "tsp": rng.random((B, P)) < .4,
        "va": rng.random((B, P)) < .85, "vsum": rng.integers(0, 2, (B, P)),
    }
    pick = rng.integers(0, P, (B, S))
    g = {k: np.take_along_axis(v, pick, 1) for k, v in proto.items()}
    # a few segments keyed (INT32_MAX, INT32_MAX) while valid
    top = rng.random((B, S)) < .05
    g["mh"] = np.where(top, BIG, g["mh"])
    g["ml"] = np.where(top, BIG, g["ml"])
    v5 = {"hi": hi, "lo": lo, "cci": cci, "vc": vc,
          "valid": np.ones((B, N), bool), "seg": np.zeros((B, N), np.int32),
          "sg_min_hi": g["mh"], "sg_min_lo": g["ml"], "sg_max_hi": g["Mh"],
          "sg_max_lo": g["Ml"], "sg_len": g["len"], "sg_lane0": g["l0"],
          "sg_dense": g["dense"], "sg_tail_special": g["tsp"],
          "sg_valid": g["va"], "sg_vsum": g["vsum"]}
    return v5


# ------------------------------------------------------------ the model


def _key(h, lo_):
    return int(h) * (1 << 32) + (int(lo_) + (1 << 31))


def _take(x, n):
    x = x + n if x < 0 else x
    return min(max(x, 0), n - 1)


def _count_le(a, lo_, hi_, q) -> int:
    """The count of a[lo_:hi_] (ascending) at or below q, by the kernel's
    binary search."""
    base, n = lo_, hi_ - lo_
    while n > 0:
        h = n >> 1
        if a[base + h] <= q:
            base += h + 1
            n -= h + 1
        else:
            n = h
    return base - lo_


def a1_model(args, tile: int, samples: int = 4096) -> tuple:
    """``csrc/seg_order.cu``'s algorithm, pass for pass, in numpy: tiles
    of ``tile`` segments carrying the group count, the running max key
    and the last segment; the group table at starts; the index of at
    most ``samples`` mins and the search through it; the flags."""
    a = [x.numpy().astype(np.int64) for x in args]
    hi, lo, cci, vc, s_mh, s_ml, s_src = a[:7]
    Mh_t, Ml_t, len_t, l0_t, dense_t, tsp_t, va_t, vsum_t = a[7:]
    B, N = hi.shape
    S = s_mh.shape[1]
    names = ("s_va", "s_len", "s_lane0", "s_tsp", "grp", "grp_start",
             "explode", "survive")
    out = {k: np.zeros((B, S), np.int64) for k in names}
    none_max = _key(-1, -1)
    for b in range(B):
        qk = [0] * S
        has_c = [False] * S
        gmin, gmax = [None] * S, [None] * S
        gfl = [[None] * 4 for _ in range(S)]
        carry_cnt, carry_max, carry_seg = 0, KEY_MIN, None
        for t0 in range(0, S, tile):
            segs = []
            for i in range(t0, min(S, t0 + tile)):
                src = _take(int(s_src[b, i]), S)
                va = bool(va_t[b, src])
                tsp = bool(tsp_t[b, src])
                l0 = int(l0_t[b, src])
                l0c = min(max(l0, 0), N - 1)
                cl = int(cci[b, l0c])
                hc = va and cl >= 0
                c = min(max(cl, 0), N - 1)
                s = dict(mh=int(s_mh[b, i]), ml=int(s_ml[b, i]),
                         Mh=int(Mh_t[b, src]), Ml=int(Ml_t[b, src]),
                         len=int(len_t[b, src]) if va else 0,
                         hvc=int(vc[b, l0c]), vsum=int(vsum_t[b, src]),
                         chi=int(hi[b, c]) if hc else -1,
                         clo=int(lo[b, c]) if hc else -1,
                         fl=int(tsp) | (int(bool(dense_t[b, src]) and va)
                                        << 1))
                segs.append((i, s, va, tsp, l0, hc))
            cnt, run_max = carry_cnt, carry_max
            for j, (i, s, va, tsp, l0, hc) in enumerate(segs):
                p = segs[j - 1][1] if j else carry_seg
                twin = (i > 0 and bool(s["fl"] & 2) and p["fl"] == s["fl"]
                        and all(s[k] == p[k] for k in (
                            "mh", "ml", "Mh", "Ml", "len", "hvc", "vsum",
                            "chi", "clo")))
                start = not twin
                cnt += start
                grp = cnt - 1
                reach = none_max if i == 0 else run_max
                run_max = max(run_max, _key(s["Mh"], s["Ml"]) if va
                              else none_max)
                for k, v in zip(names[:6], (va, s["len"], l0, tsp, grp,
                                            start)):
                    out[k][b, i] = v
                qk[i] = _key(s["chi"], s["clo"])
                has_c[i] = hc
                if start:
                    mn = _key(s["mh"], s["ml"]) if va else KEY_MAX
                    gmin[grp] = mn
                    gmax[grp] = _key(s["Mh"], s["Ml"]) if va else none_max
                    gfl[grp][0] = va and mn <= reach
                    gfl[grp][2] = False
                    gfl[grp][3] = tsp and s["len"] > 1
                    if i > 0:
                        gfl[grp - 1][1] = mn <= _key(p["Mh"], p["Ml"])
                if i == S - 1:
                    gfl[grp][1] = _key(s["Mh"], s["Ml"]) == KEY_MAX
            carry_cnt, carry_max, carry_seg = cnt, run_max, segs[-1][1]
        G = carry_cnt
        assert all(None not in f for f in gfl[:G])  # every byte written
        step = -(-G // samples)
        ns = -(-G // step)
        index = [gmin[j * step] for j in range(ns)]
        for i in range(S):
            if not has_c[i]:
                continue
            q = qk[i]
            if q == KEY_MAX and G < S:
                continue
            below = _count_le(index, 0, ns, q)
            if below == 0:
                continue
            lo_ = (below - 1) * step + 1
            pg = lo_ + _count_le(gmin, lo_, min(below * step, G), q) - 1
            if q < gmax[pg] or (q == gmax[pg] and gfl[pg][3]):
                gfl[pg][2] = True
        for i in range(S):
            f = gfl[out["grp"][b, i]]
            ex = bool(out["s_va"][b, i]) and (f[0] or f[1] or f[2])
            out["explode"][b, i] = ex
            out["survive"][b, i] = (out["s_va"][b, i] and not ex
                                    and out["grp_start"][b, i])
    return tuple(out[k] for k in names)


def assert_same(got, want, what=""):
    for name, g, w in zip(segorder.SegOrder._fields, got, want):
        g = g.cpu().numpy() if torch.is_tensor(g) else g
        w = w.cpu().numpy() if torch.is_tensor(w) else w
        assert g.shape == w.shape, (what, name)
        bad = np.argwhere(g.astype(np.int64) != w.astype(np.int64))
        assert not len(bad), (what, name, bad[:5].tolist())


# ------------------------------------------------------------ CPU


@pytest.mark.parametrize("kind", ["chain", "random", "runs"])
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 17])
def test_model_and_dispatch_equal_the_chain_on_marshalled_batches(kind, seed):
    args = seg_args(marshalled(kind, seed, 4, 40, 24, 80), "cpu")
    want = segorder.seg_order_plain(*args)
    assert_same(segorder.seg_order(*args), want, kind)
    for tile, samples in ((1, 4096), (5, 7), (256, 1), (256, 2)):
        assert_same(a1_model(args, tile, samples), want, (kind, tile))


@pytest.mark.parametrize("seed", range(12))
def test_model_equals_the_chain_on_a_fuzz(seed):
    rng = np.random.default_rng(seed)
    S = int(rng.integers(1, 60))
    args = seg_args(fuzz_row(rng, 3, int(rng.integers(1, 40)), S), "cpu")
    want = segorder.seg_order_plain(*args)
    for tile, samples in ((1, 4096), (3, 2), (32, 5), (32, 1)):
        assert_same(a1_model(args, tile, samples), want, (seed, tile))


# what each edge row's plain outputs must show, that the edge is reached
EDGE_FACTS = {
    "all_invalid": lambda o: not o.s_va.any() and not o.explode.any(),
    "one_segment": lambda o: o.s_va.all() and o.explode.all(),
    "last_slot_stab": lambda o: o.grp[0, -1] == 3 and o.explode[0, -1]
    and not o.explode[0, :-1].any(),
    "stabbed_twins": lambda o: o.explode[0, :2].all()
    and not o.grp_start[0, 1],
    "quiet_twins": lambda o: o.survive[0, 0] and not o.survive[0, 1]
    and not o.explode.any(),
    "below_every_group": lambda o: not o.explode.any(),
    "cause_at_max": lambda o: o.explode[0].tolist()
    == [False, False, True, False],
    "max_ids": lambda o: o.explode[0].tolist() == [False, True],
    "max_ids_fewer_groups": lambda o: o.explode[0].tolist()
    == [False, False, True],
}


@pytest.mark.parametrize("name", sorted(EDGE_FACTS))
def test_model_equals_the_chain_on_edge_rows(name):
    args = seg_args(edge_rows()[name], "cpu")
    want = segorder.seg_order_plain(*args)
    assert EDGE_FACTS[name](want), name
    for tile, samples in ((1, 4096), (2, 1), (256, 2)):
        assert_same(a1_model(args, tile, samples), want, (name, tile))


def _ops(S=6, N=5):
    v5 = fuzz_row(np.random.default_rng(3), 2, N, S)
    return list(seg_args(v5, "cpu"))


@pytest.mark.parametrize("bad, err", [
    (lambda a: a.__setitem__(0, a[0].long()), TypeError),        # int64 hi
    (lambda a: a.__setitem__(13, a[13].to(torch.int32)), TypeError),
    (lambda a: a.__setitem__(4, a[4].t().contiguous().t()), ValueError),
    (lambda a: a.__setitem__(1, a[1][:, :2].contiguous()), ValueError),
    (lambda a: a.__setitem__(9, a[9][:1].contiguous()), ValueError),
])
def test_wrapper_checks_its_inputs(bad, err):
    ops = _ops()
    bad(ops)
    with pytest.raises(err):
        segorder.seg_order_cuda(*ops)


def test_model_at_the_kernels_index_size_on_many_groups():
    """Rows of more groups than the kernel's index holds (its
    ``CAUSE_A1_SAMPLES``, read from the source): the search goes through
    samples k > 1 apart."""
    src = (kernels.CSRC / "seg_order.cu").read_text()
    samples = int(re.search(r"#define CAUSE_A1_SAMPLES (\d+)", src)[1])
    rng = np.random.default_rng(7)
    S = 3 * samples + 5
    v5 = fuzz_row(rng, 1, 64, S)
    # distinct mins, so that nearly every segment is its own group
    v5["sg_min_hi"] = np.zeros((1, S), np.int64)
    v5["sg_min_lo"] = np.arange(S)[None] * 3
    v5["sg_max_hi"] = np.zeros((1, S), np.int64)
    v5["sg_max_lo"] = v5["sg_min_lo"] + rng.integers(0, 5, (1, S))
    v5["lo"] = rng.integers(0, 3 * S, (1, 64))
    v5["hi"] = np.zeros((1, 64), np.int64)
    args = seg_args(v5, "cpu")
    want = segorder.seg_order_plain(*args)
    assert int(want.grp[0, -1]) + 1 > 2 * samples
    assert want.explode.any() and want.survive.any()
    assert_same(a1_model(args, 1024, samples), want)


def test_span_carries_the_contract():
    from cause_tpu_torch import obs

    args = _ops(S=6, N=5)
    obs.reset()
    try:
        obs.configure(enabled=True)
        out = segorder.seg_order(*args)
        recs = [e for e in obs.events() if e.get("name") == "kernel.a1"]
    finally:
        obs.reset()
    assert len(recs) == 1
    B, S = args[4].shape
    # 3 sorted + 5 int32 tables, 3 bool tables; out 3 int32, 5 bool;
    # 4 lanes a segment
    assert recs[0]["attrs"]["bytes"] == B * S * (8 * 4 + 3 + 3 * 4 + 5
                                                 + 16)
    assert recs[0]["attrs"]["form"] == "plain"
    assert recs[0]["attrs"]["segments"] == S
    assert len(out) == 8


def test_roofline_reader_reads_the_spans_and_the_kernel():
    from weavebench.metrics import _spans
    from weavebench.metrics.a1_roofline_pct import read

    assert _spans.library_kernels("seg_order") == {"seg_order_kernel"}
    recs = []
    for w in range(2):
        recs.append({"ev": "span", "name": "v5", "id": 10 * w,
                     "profiled": True, "dev_us": 9.0})
        recs.append({"ev": "span", "name": "kernel.a1", "id": 10 * w + 1,
                     "profiled": True, "attrs": {"bytes": 4_000_000}})
    device = [("void seg_order_kernel<256, true>(A1Args)", "kernel", 0.0,
               40.0),
              ("void sort_rows_radix_kernel<8, 2>(SortArgs, int, int)",
               "kernel", 40.0, 90.0)]
    trace = {"device": device, "spans": [], "ops": [], "t0": 0.0,
             "t1": 100.0, "waves": 2}
    ctx = {"trace": trace, "peak_bytes_per_s": 4.0e12, "spans": recs}
    # 4 MB a wave at 4 TB/s is 1 us, over 20 us a wave of A1's kernel
    assert read(ctx) == pytest.approx(5.0)
    assert read(dict(ctx, spans=recs[:1] + recs[2:3])) is None  # no A1
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, peak_bytes_per_s=None)) is None
    no_kernel = dict(trace, device=device[1:])
    assert read(dict(ctx, trace=no_kernel)) is None


# ------------------------------------------------------------ card

CARD_SHAPES = {
    # name: (kind, seed, rows, base nodes, divergent nodes, capacity)
    "pairs_full": ("chain", 2 ** 31 + 101, 64, 9000, 1000, 10240),
    "pairs_random": ("random", 2 ** 31 + 102, 16, 9000, 1000, 10240),
    "fleet_past_smem": ("fleet", 2 ** 31 + 103, 192, 9000, 1000, 10240),
}


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(CARD_SHAPES))
def test_kernel_equals_plain_on_the_card(card, shape):
    kind, seed, rows, nb, nd, cap = CARD_SHAPES[shape]
    args = seg_args(marshalled(kind, seed, rows, nb, nd, cap), card)
    if shape == "fleet_past_smem":
        assert args[4].shape[1] >= 40_000
    want = segorder.seg_order_plain(*args)
    before = kernels.launches["seg_order"]
    got = segorder.seg_order(*args)
    torch.cuda.synchronize()
    assert kernels.launches["seg_order"] == before + 1
    assert_same(got, want, shape)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(EDGE_FACTS))
def test_edge_rows_on_the_card(card, name):
    args = seg_args(edge_rows()[name], card)
    want = segorder.seg_order_plain(*args)
    got = segorder.seg_order_cuda(*args)
    torch.cuda.synchronize()
    assert_same(got, want, name)


@pytest.mark.card
@pytest.mark.parametrize("seed", range(6))
def test_fuzz_on_the_card(card, seed):
    rng = np.random.default_rng(100 + seed)
    S = (1, 300, 4096, 4097, 9000, 30000)[seed]
    args = seg_args(fuzz_row(rng, 16, 300, S), card)
    want = segorder.seg_order_plain(*args)
    got = segorder.seg_order_cuda(*args)
    torch.cuda.synchronize()
    assert_same(got, want, seed)


@pytest.mark.card
def test_wrapper_raises_on_the_card(card):
    args = list(seg_args(fuzz_row(np.random.default_rng(5), 4, 20, 30),
                         card))
    with pytest.raises(TypeError):
        segorder.seg_order_cuda(*args[:13], args[13].to(torch.int32),
                                args[14])
    strided = torch.cat([args[5], args[5]], dim=1)[:, ::2]
    with pytest.raises(ValueError):
        segorder.seg_order_cuda(*args[:5], strided, *args[6:])
    with pytest.raises(ValueError):
        segorder.seg_order(*args[:4], *(x.cpu() for x in args[4:]))
