"""Batched merge waves and the convergence digest."""

from . import recovery  # noqa: F401
from .wave import WaveBuffers, WaveResult, merge_wave  # noqa: F401
