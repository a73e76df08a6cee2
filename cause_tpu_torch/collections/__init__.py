"""Causal collection types: the shared causal-tree core plus the
CausalList and CausalMap types (reference: src/causal/collections/)
and the CausalSet / CausalCounter types the reference's roadmap
wished for (README.md:249-250)."""

from . import shared  # noqa: F401
