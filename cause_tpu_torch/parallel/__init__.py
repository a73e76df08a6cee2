"""Batched merge waves, resident fleet sessions, the merge reduction
tree, the convergence digest and the replica mesh (the sharded steps
over ``torch.distributed``)."""

from .mesh import (  # noqa: F401
    REPLICA_AXIS,
    make_mesh,
    replica_digest,
    sharded_merge_weave,
    sharded_merge_weave_v4,
    sharded_merge_weave_v5,
)
from . import recovery  # noqa: F401
from .session import FleetSession  # noqa: F401
from .tree import (  # noqa: F401
    flat_fold,
    merge_tree,
    merge_tree_report,
    tree_rounds,
)
from .wave import WaveBuffers, WaveResult, merge_wave  # noqa: F401
