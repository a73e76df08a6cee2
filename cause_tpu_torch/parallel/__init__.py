"""Batched merge waves, resident fleet sessions, the merge reduction
tree and the convergence digest."""

from . import recovery  # noqa: F401
from .session import FleetSession  # noqa: F401
from .tree import flat_fold, merge_tree, merge_tree_report  # noqa: F401
from .wave import WaveBuffers, WaveResult, merge_wave  # noqa: F401
