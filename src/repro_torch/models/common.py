"""Shared LM building blocks: norms, RoPE, activations, embedding (the
counterpart of ``repro.models.common``), as plain tensor functions."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b=None,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x * w.to(torch.float32)
    if b is not None:
        x = x + b.to(torch.float32)
    return x.to(dt)


def norm(x: torch.Tensor, w: torch.Tensor, kind: str) -> torch.Tensor:
    return rmsnorm(x, w) if kind == "rmsnorm" else layernorm(x, w)


def rope_angles(positions: torch.Tensor, d_head: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., d_head//2)."""
    half = d_head // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, Dh); cos/sin: (S, Dh//2) or (B, S, Dh//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``.  On a mesh each rank looks the
    tokens up in its own vocab shard of the table (zeros for the tokens it
    does not hold) and one sum over 'model' completes the rows: indexing a
    DTensor would gather the whole table onto every rank.  On one model
    rank the lookup and its gradient are the one-device path's, bit for
    bit."""
    if mesh is None:
        return table[tokens]
    from repro_torch.sharding import (P, batch_axes, constrain, dp_size,
                                      shard_map, tp_size, with_partial)
    bspec = batch_axes(mesh) if tokens.shape[0] % dp_size(mesh) == 0 \
        else None
    rows = P(bspec, None, None)
    if table.shape[0] % tp_size(mesh):         # the rule left it whole
        return shard_map(lambda t, tok: t[tok], mesh,
                         (P(None, None), P(bspec, None)), rows)(table, tokens)

    def body(t, tok):
        idx = tok - mesh.get_local_rank("model") * t.shape[0]
        mine = (idx >= 0) & (idx < t.shape[0])
        got = t[idx.clamp(0, t.shape[0] - 1)]
        return torch.where(mine[..., None], got, torch.zeros(
            (), dtype=got.dtype, device=got.device))

    out = shard_map(body, mesh, (P("model", None), P(bspec, None)),
                    with_partial(rows, mesh, ("model",)))(table, tokens)
    return constrain(out, mesh, rows)


def unembed(x: torch.Tensor, table_or_head: torch.Tensor,
            tied: bool) -> torch.Tensor:
    """x: (..., d) -> logits (..., Vp)."""
    if tied:
        return torch.matmul(x, table_or_head.t())
    return torch.matmul(x, table_or_head)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_real: int) -> torch.Tensor:
    """Masked CE over the *real* vocab (padded logits excluded)."""
    logits = logits.to(torch.float32)
    neg = torch.finfo(torch.float32).min
    mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_real
    logits = torch.where(mask, logits, torch.full((), neg,
                                                  device=logits.device))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())
    return torch.mean(logz[..., None] - gold)
