"""Gathers, scatters and searches with the JAX kernels' index semantics.

The JAX package indexes with ``table[idx]`` and ``.at[idx].set/add``,
whose out-of-range behaviour differs from PyTorch's: a JAX gather
counts a negative index from the end and clamps anything still out of
range, and a JAX scatter counts negatives from the end and DROPS what
is still out of range, where ``torch.gather``/``scatter_`` raise or
trip a device-side assert. The v5 kernel relies on both (dump slots,
clipped lookups), so every such site in the port goes through these
helpers, which reproduce the JAX semantics exactly. One implementation
each: the TPU-only strategies of ``cause_tpu.weaver.gatherops``
(rowgather, matrix, hint) have no counterpart here.

All functions work along the LAST axis of batched ``[B, n]`` tensors.
"""

from __future__ import annotations

import torch

__all__ = ["take1d", "at_set", "at_add", "searchsorted_iota_right",
           "searchsorted_targets_left"]


def _norm(idx: torch.Tensor, n: int) -> torch.Tensor:
    i = idx.long()
    return torch.where(i < 0, i + n, i)


def take1d(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[..., idx]`` row by row, negatives from the end, then
    clamped into range (the JAX gather)."""
    n = table.shape[-1]
    return torch.gather(table, -1, _norm(idx, n).clamp_(0, n - 1))


def _scatter(base, idx, vals, add: bool):
    n = base.shape[-1]
    i = _norm(idx, n)
    i = torch.where((i >= 0) & (i < n), i, n)  # dump column at n
    out = torch.cat([base, base[..., :1]], dim=-1)
    if not torch.is_tensor(vals):
        vals = torch.full(i.shape, vals, dtype=base.dtype,
                          device=base.device)
    vals = vals.to(base.dtype).expand(i.shape)
    if add:
        out.scatter_add_(-1, i, vals)
    else:
        out.scatter_(-1, i, vals)
    return out[..., :n]


def at_set(base: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``base.at[..., idx].set(vals)`` with out-of-range writes dropped.
    Callers keep their index streams unique where values differ."""
    return _scatter(base, idx, vals, add=False)


def at_add(base: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """``base.at[..., idx].add(vals)`` with out-of-range writes dropped."""
    return _scatter(base, idx, vals, add=True)


def searchsorted_iota_right(keys_cum: torch.Tensor, q: int) -> torch.Tensor:
    """``searchsorted(keys_cum, arange(q), side="right")`` per row for a
    NON-DECREASING ``keys_cum``: the count of keys <= t for each target
    t (the JAX package's histogram-and-prefix-sum form counts the
    same)."""
    B = keys_cum.shape[0]
    tgt = torch.arange(q, dtype=keys_cum.dtype, device=keys_cum.device)
    tgt = tgt.expand(B, q).contiguous()
    return torch.searchsorted(keys_cum.contiguous(), tgt,
                              right=True).to(torch.int32)


def searchsorted_targets_left(keys_cum: torch.Tensor, k: int) -> torch.Tensor:
    """``searchsorted(keys_cum, arange(1, k + 1), side="left")`` for a
    NON-DECREASING ``keys_cum``: keys strictly below t are keys <= t-1,
    so this is the iota/right count above under another contract."""
    return searchsorted_iota_right(keys_cum, k)
