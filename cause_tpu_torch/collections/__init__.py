"""Causal collections (lists so far)."""

from . import shared  # noqa: F401
