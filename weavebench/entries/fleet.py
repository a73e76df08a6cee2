"""Converging a fleet: all replicas of one document in one row.

Each step is ``cause_tpu_torch.weaver.torchw5.merge_weave_kernel_v5``
over one of ``batches`` distinct fleets, resident on the device from
set-up, then ``cause_tpu_torch.parallel.mesh.replica_digest`` of the
converged weave; steps take the fleets in turn. A step's answer is the
fleet's digest and overflow flag; its rank and visibility stay on the
device, the last of each fleet kept for the check.
"""

from __future__ import annotations

from cause_tpu_torch import benchgen
from cause_tpu_torch.parallel import mesh
from cause_tpu_torch.weaver import torchw5

from .. import gen
from .common import batches, budget, marshal, nbytes, ref_lanes


class Entry:
    docs_per_wave = 1

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device

    @staticmethod
    def make_lanes(cfg: dict, mix: dict, seed: int) -> list:
        """The generated lanes of each batch, on the host."""
        return batches(cfg, mix, seed, gen.fleet_row)

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
        a = self.args[b]
        rank, vis, _conflict, ovf = torchw5.merge_weave_kernel_v5(
            *a, u_max=u, k_max=u, device=self.device)
        dig = mesh.replica_digest(a[0][None], a[1][None], rank[None],
                                  vis[None])
        self.last[b] = (rank[None], vis[None])
        return b, dig, ovf.reshape(1)

    def outputs(self) -> list:
        return self.last

    def reference_lanes(self) -> list:
        return [ref_lanes(x) for x in self.lanes]

    def wave_bytes(self) -> int:
        """What a step must move: its inputs read once, rank (int32),
        visibility (bool) and the digest (int32) written once."""
        N = self.args[0][0].shape[0]
        return sum(nbytes(x) for x in self.args[0]) + N * 5 + 4

    def free(self) -> None:
        self.args = None
