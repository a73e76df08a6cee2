"""Full-width waves of replica pairs.

Each wave is ``cause_tpu_torch.weaver.torchwd.batched_weave_digest``
over one of ``batches`` distinct batches, resident on the device from
set-up; consecutive waves take the batches in turn, so no wave reuses
the inputs of the one before. A wave's answer is its ``[B]`` digests
and overflow flags; its rank and visibility stay on the device, the
last of each batch kept for the check.
"""

from __future__ import annotations

from cause_tpu_torch import benchgen
from cause_tpu_torch.weaver import torchwd

from .. import gen
from .common import batches, budget, marshal, nbytes, ref_lanes


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.docs_per_wave = cfg["documents"]

    @staticmethod
    def make_lanes(cfg: dict, mix: dict, seed: int) -> list:
        """The generated lanes of each batch, on the host."""
        return batches(cfg, mix, seed, gen.pair_batch)

    def setup(self) -> None:
        cap = self.cfg["capacity"]
        self.lanes = self.make_lanes(self.cfg, self.mix, self.seed)
        self.args, self.u = [], []
        for lanes in self.lanes:
            v5 = marshal(lanes, cap)
            self.u.append(budget(v5))
            dev = benchgen.lanes_from_numpy(v5, self.device)
            self.args.append([dev[k] for k in benchgen.LANE_KEYS5])
        self.last = [None] * len(self.lanes)

    def issue(self, i: int):
        b = i % len(self.args)
        u = self.u[b]
        rank, vis, dig, ovf = torchwd.batched_weave_digest(
            *self.args[b], u_max=u, k_max=u, device=self.device)
        self.last[b] = (rank, vis)
        return b, dig, ovf

    def outputs(self) -> list:
        return self.last

    def reference_lanes(self) -> list:
        return [ref_lanes(x) for x in self.lanes]

    def wave_bytes(self) -> int:
        """What a wave must move: its inputs read once, rank (int32),
        visibility (bool) and the digest (int32) written once."""
        B, N = self.args[0][0].shape
        return sum(nbytes(x) for x in self.args[0]) + B * N * 5 + B * 4

    def free(self) -> None:
        self.args = None
