"""Computation reduction (paper §II-B-a): magnitude pruning and zero
accounting (counterpart of ``repro.quant.pruning``).

Magnitude pruning zeroes an exact fraction of the smallest |w| by rank;
structured N:M pruning keeps the n largest of every m along the last dim.
The masks equal the reference's on the same arrays, ties included.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.quant.ptq import is_quantizable


def _masked(w: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``w`` where ``keep``, else +0.0 (the reference's ``w * keep``, which
    XLA emits as a select: a pruned negative weight is +0.0, not -0.0)."""
    return torch.where(keep, w, torch.zeros((), dtype=w.dtype,
                                            device=w.device))


def magnitude_prune(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Zero exactly the ``sparsity`` fraction of smallest-|w| entries
    (rank-based: a stable argsort, so equal magnitudes fall in index order,
    as ``jnp.argsort(stable=True)`` orders them)."""
    if sparsity <= 0.0:
        return w
    k = int(w.numel() * sparsity)
    if k == 0:
        return w
    flat = torch.abs(w).reshape(-1)
    order = torch.argsort(flat, stable=True)
    keep = torch.ones_like(flat, dtype=torch.bool)
    keep[order[:k]] = False
    return _masked(w.reshape(-1), keep).reshape(w.shape)


def nm_prune(w: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """Structured N:M pruning along the last dim (keep the n largest of
    every m; an |entry| equal to the n-th largest is kept too)."""
    if w.shape[-1] % m != 0:
        raise ValueError(f"last dim {w.shape[-1]} is not a multiple of {m}")
    g = w.reshape(*w.shape[:-1], w.shape[-1] // m, m)
    mag = torch.abs(g)
    kth = torch.sort(mag, dim=-1).values[..., m - n][..., None]
    keep = mag >= kth
    return _masked(g, keep).reshape(w.shape)


def prune_tree(params: Dict[str, torch.Tensor], sparsity: float,
               structured: bool = False
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """Prune every quantizable weight (``ptq.is_quantizable``) ->
    (tree, {"zero_weight_frac"}); norms and biases pass unchanged."""
    out, zeros, total = {}, 0.0, 0
    for path, w in params.items():
        if is_quantizable(path, w):
            out[path] = nm_prune(w) if structured else \
                magnitude_prune(w, sparsity)
            zeros += float(torch.mean((out[path] == 0).to(torch.float32))) \
                * w.numel()
            total += w.numel()
        else:
            out[path] = w
    return out, {"zero_weight_frac": zeros / max(total, 1)}


def zero_weight_fraction(params: Dict[str, torch.Tensor]) -> float:
    zeros, total = 0.0, 0
    for path, w in params.items():
        if is_quantizable(path, w):
            zeros += float(torch.mean((w == 0).to(torch.float32))) * w.numel()
            total += w.numel()
    return zeros / max(total, 1)
