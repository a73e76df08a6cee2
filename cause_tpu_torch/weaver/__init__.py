"""Weavers: the pure host oracle, the marshal, and the device weaver
(the v5 segment-union kernel and its CUDA kernels)."""

from . import pure  # noqa: F401
