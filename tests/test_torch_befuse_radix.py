"""The radix forms of the port's K2 and K4 kernels, modelled in numpy.

On the card, K2 (``csrc/befuse_k2.cu``) and K4 (``csrc/befuse_k4.cu``)
sort with ``csrc/radix.cuh`` at 256 <= P <= 8192: K4 its lane keys and
its successor keys, K2 its sibling keys. Those kernels run only on the
card, so their algorithm is modelled here: the keys are built from
pipeline inputs as the kernels build them (the successor keys and the
sibling keys padded from Kp to P slots with INT32_MAX), sorted by
``_radix_row`` (tests/test_torch_kernels.py: range compression,
composite packing, per-row pass count, stable 8-bit passes with the
kernel's per-warp ranking), and turned into the kernels' outputs as the
kernels turn them (K4: ``lk``, ``tb_l`` and the successor scatter behind
``vict_tail``; K2: the ``ns`` / ``fc`` scatters). Those outputs are held
against ``cause_tpu``'s Pallas kernels in interpret mode (rows that do
not overflow; overflow rows leave them unspecified) and against the
port's plain versions (every row). Inputs are the port's recorded K2/K4
inputs of ``batched_merge_weave_v5f`` on ``batched_pair_lanes`` batches,
at the shapes of tests/test_torch_befuse.py. Every value is an integer,
so every comparison is EXACT.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cause_tpu.weaver import pallas_befuse as pb

from cause_tpu_torch import benchgen as tbench
from cause_tpu_torch.weaver import befuse, euler

from test_torch_befuse import _v5_case, record_kernel_inputs
from test_torch_kernels import _radix_row

I32_MAX = np.iinfo(np.int32).max


def _ipt(P):
    """Items a thread of the radix forms (radix.cuh's radix_ipt)."""
    return 16 if P > 4096 else 8


def _padded(x, P):
    """A Kp-wide key row padded to the kernel's P slots with INT32_MAX."""
    out = np.full(P, I32_MAX, np.int32)
    out[:len(x)] = x
    return out


def _k4_model_row(args, r, U, k_max, N):
    """K4's radix form on row r of its inputs: (lk, tb_l, vict_tail) and
    the (bits, passes) of its lane and successor sorts."""
    (base_run, hc, h_w, run_id, keep, sv_len, sv_vc, sv_lane, _glued,
     prev_kept, cause_su, scal2) = (np.asarray(x)[r] for x in args)
    Kp, P = len(base_run), len(keep)
    n_runs, sp_last = int(scal2[0]), int(scal2[2])
    n_valid = min(n_runs, k_max)

    kl = np.where(keep != 0, sv_len, 0).astype(np.int64)
    wstart = np.cumsum(kl) - kl
    rid = np.clip(run_id, 0, Kp - 1)
    rank = np.where(keep != 0, base_run[rid] + (wstart - h_w[rid]),
                    N).astype(np.int32)
    lane_key = np.where((keep != 0) & (rank < N), sv_lane, N).astype(np.int32)
    (lk,), pos, l_passes, l_bits = _radix_row(lane_key[None], _ipt(P))
    tb_l = rank[pos]

    bkey = _padded(base_run[:n_valid], P)
    (bs,), spos, s_passes, s_bits = _radix_row(bkey[None], _ipt(P))
    assert sorted(spos[:Kp].tolist()) == list(range(Kp))  # padding last
    succ = np.empty(Kp, np.int64)
    for j in range(Kp):
        nxt = j < Kp - 1 and bs[j + 1] != I32_MAX
        succ[spos[j]] = spos[j + 1] if nxt else -1

    def tail_kill(k):
        s = succ[k]
        if k >= n_valid or s < 0:
            return N
        s_c = int(np.clip(hc[np.clip(s, 0, Kp - 1)], 0, U - 1))
        if sv_vc[s_c] not in (1, 2):  # VCLASS_HIDE, VCLASS_H_HIDE
            return N
        nxt_head = hc[k + 1 if k + 1 < Kp else 0]
        tail_tok = (max(sp_last >> 1, 0) if k + 1 == n_runs
                    else prev_kept[np.clip(nxt_head, 0, U - 1)])
        if cause_su[s_c] != tail_tok:
            return N
        t = int(np.clip(tail_tok, 0, U - 1))
        return sv_lane[t] + sv_len[t] - 1

    vict_tail = np.array([tail_kill(k) for k in range(Kp)], np.int32)
    return (lk, tb_l, vict_tail), (l_bits, l_passes), (s_bits, s_passes)


def _k2_model_row(ins, outs, r, k_max, Kp):
    """K2's sibling sort on row r, its keys built from K2's head tables:
    (ns, fc) and the sort's (bits, passes)."""
    keep, sv_vc = np.asarray(ins[3])[r], np.asarray(ins[1])[r]
    hc, parent_up = np.asarray(outs[4])[r], np.asarray(outs[2])[r]
    P = len(keep)
    special = (keep != 0) & (sv_vc > 0)
    parent_sort = np.where(parent_up >= 0, parent_up, k_max)
    packed = (parent_sort * 2 + (~special[hc]).astype(np.int64)).astype(
        np.int32)
    keys = np.stack([_padded(packed, P), _padded(-hc, P)])
    (s0, _s1), pos, passes, bits = _radix_row(keys, _ipt(P))
    assert sorted(pos[:Kp].tolist()) == list(range(Kp))  # padding last
    ns = np.empty(Kp, np.int32)
    fc = np.full(Kp, -1, np.int32)
    for j in range(Kp):
        ps = s0[j] >> 1
        same_next = j < Kp - 1 and (s0[j + 1] >> 1) == ps
        ns[pos[j]] = pos[j + 1] if same_next else -1
        if (j == 0 or (s0[j - 1] >> 1) != ps) and 0 <= ps < k_max:
            fc[ps] = pos[j]
    return (ns, fc), (bits, passes)


# (B, nb, nd, cap, he), U over the budget, k_max (None: the budget), and
# a row whose tokens are all made unkept (None: none)
CASES = {
    "P=256": ((3, 120, 40, 256, 8), 0, None, None),
    "Kp<P": ((4, 100, 60, 192, 4), 160, None, None),
    "overflow": ((4, 100, 60, 192, 4), 0, 16, None),
    "no kept token": ((3, 120, 40, 256, 8), 0, None, 1),
}


def _case(monkeypatch, tag):
    """The port's K2 and K4 inputs of one case, with the plain outputs of
    K2 (and, for a row made unkept, K2's inputs, outputs and the walk's
    bases rebuilt for it)."""
    shape, du, k_max, unkept = CASES[tag]
    v5, u = _v5_case(*shape)
    U, k_max = u + du, u if k_max is None else k_max
    seen, _ = record_kernel_inputs(monkeypatch, v5, U, k_max)
    in2, kw2 = seen["k2_runs"]
    in4, kw4 = seen["k4_rank_kills"]
    if unkept is not None:
        in2 = list(in2)
        in2[3] = in2[3].clone()
        in2[3][unkept] = 0
        out2 = befuse.k2_runs_plain(*in2, **kw2)
        base = euler.euler_walk_plain(*out2[:4])
        in4 = (base, out2[4], out2[5], out2[6], in2[3], in2[0], in2[1],
               in4[7], out2[7], out2[8], in4[10], out2[9])
    assert kw4["U"] == U and kw4["k_max"] == k_max
    return tuple(in2), kw2, tuple(in4), kw4, unkept


@pytest.mark.parametrize("tag", list(CASES))
def test_k4_radix_form_matches_pallas_and_plain(monkeypatch, tag):
    in2, kw2, in4, kw4, unkept = _case(monkeypatch, tag)
    U, k_max, N = kw4["U"], kw4["k_max"], kw4["N"]
    plain = befuse.k4_rank_kills_plain(*in4, **kw4)
    ref = jax.vmap(lambda *a: pb.k4_rank_kills(*a, U=U, k_max=k_max, N=N))(
        *(jnp.asarray(x.numpy()) for x in in4))
    n_runs = in4[-1][:, 0].numpy()
    B = n_runs.shape[0]
    for r in range(B):
        got, (l_bits, l_passes), (s_bits, s_passes) = _k4_model_row(
            in4, r, U, k_max, N)
        for g, j, name in zip(got, (0, 1, 3), ("lk", "tb_l", "vict_tail")):
            assert np.array_equal(g, plain[j][r].numpy()), (tag, r, name)
            if n_runs[r] <= k_max:
                assert np.array_equal(g, np.asarray(ref[j])[r]), (tag, r,
                                                                  name)
        # lanes in [0, N] and bases below N: at most two 8-bit passes
        assert l_bits <= 16 and s_bits <= 16
        assert l_passes == -(-l_bits // 8) and s_passes == -(-s_bits // 8)
        if r == unkept:  # every key equal: no pass at all
            assert n_runs[r] == 0 and l_passes == 0 and s_passes == 0
    if tag == "overflow":
        assert (n_runs > k_max).any()


@pytest.mark.parametrize("tag", list(CASES))
def test_k2_radix_sibling_sort_matches_pallas_and_plain(monkeypatch, tag):
    in2, kw2, _in4, _kw4, unkept = _case(monkeypatch, tag)
    U, k_max, Kp = kw2["U"], kw2["k_max"], kw2["Kp"]
    plain = befuse.k2_runs_plain(*in2, **kw2)
    ref = jax.vmap(lambda *a: pb.k2_runs(*a, U=U, k_max=k_max, Kp=Kp))(
        *(jnp.asarray(x.numpy()) for x in in2))
    n_runs = plain[9][:, 0].numpy()
    P = in2[0].shape[1]
    if tag == "Kp<P":
        assert Kp < P
    for r in range(n_runs.shape[0]):
        (ns, fc), (bits, passes) = _k2_model_row(in2, plain, r, k_max, Kp)
        assert np.array_equal(ns, plain[1][r].numpy()), (tag, r, "ns")
        assert np.array_equal(fc, plain[0][r].numpy()), (tag, r, "fc")
        if n_runs[r] <= k_max:
            assert np.array_equal(ns, np.asarray(ref[1])[r]), (tag, r, "ns")
            assert np.array_equal(fc, np.asarray(ref[0])[r]), (tag, r, "fc")
        # packed < 2P and -hc in (-P, 0], padding included: 32-bit
        # composites (the kernel's radix area has no 64-bit room)
        assert bits <= 2 * P.bit_length() + 1 <= 32
        assert passes == -(-bits // 8)
        if r == unkept:
            assert n_runs[r] == 0
    if tag == "overflow":
        assert (n_runs > k_max).any()


def test_radix_key_widths_at_a_north_star_row(monkeypatch):
    """One row of the north-star batch (10k-node lists, N = 20480,
    P = Kp = 4096) through the port's plain v5f on the CPU: K4's lane and
    successor keys take two passes, K2's sibling composite four (26
    bits), and the model's outputs equal the plain versions'."""
    batch = tbench.batched_pair_lanes(1, 9000, 1000, 10240, hide_every=8)
    v5 = tbench.batched_v5_inputs(batch, 10240)
    u = befuse.next_pow2(tbench.v5_token_budget(v5))
    assert u == 4096
    rec, out = record_kernel_inputs(monkeypatch, v5, u, u)
    assert not out[3].any()
    in2, kw2 = rec["k2_runs"]
    in4, kw4 = rec["k4_rank_kills"]
    plain2 = befuse.k2_runs_plain(*in2, **kw2)
    plain4 = befuse.k4_rank_kills_plain(*in4, **kw4)
    (ns, fc), (bits, passes) = _k2_model_row(in2, plain2, 0, u, u)
    assert np.array_equal(ns, plain2[1][0].numpy())
    assert np.array_equal(fc, plain2[0][0].numpy())
    assert bits == 26 and passes == 4
    got, lane, succ = _k4_model_row(in4, 0, kw4["U"], u, kw4["N"])
    for g, j in zip(got, (0, 1, 3)):
        assert np.array_equal(g, plain4[j][0].numpy())
    assert lane[0] <= 16 and lane[1] == 2
    assert succ[0] <= 16 and succ[1] == 2
