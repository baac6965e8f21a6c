"""Shared LM building blocks: norms, RoPE, activations, embedding (the
counterpart of ``repro.models.common``), as plain tensor functions."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            n: Optional[int] = None) -> torch.Tensor:
    """RMS norm over the last dim; ``n``: the mean is over its first ``n``
    channels, the rest being zeros (heads padded onto a mesh)."""
    dt = x.dtype
    x = x.to(torch.float32)
    ms = (torch.mean(x * x, dim=-1, keepdim=True) if n is None
          else torch.sum(x * x, dim=-1, keepdim=True) / n)
    x = x * torch.rsqrt(ms + eps)
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
    from repro_torch.sharding import (P, batch_entry, constrain, shard_map,
                                      tp_size, with_partial)
    bspec = batch_entry(tokens.shape[0], mesh)
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
            tied: bool, mesh=None) -> torch.Tensor:
    """x: (..., d) -> logits (..., Vp).  On a mesh each rank multiplies its
    rows by its own vocab shard of the table (tied, ``P("model", None)``)
    or of the head (``P(None, "model")``), and the logits come back
    vocab-sharded, ``P(batch, ..., "model")``, as GSPMD partitions the
    reference's einsum: a product on DTensors would reshard the table to
    the hidden dim and return partial sums over the whole vocab on every
    rank.  On one model rank the product is the one-device path's."""
    def product(a, w):
        return torch.matmul(a, w.t() if tied else w)

    if mesh is None:
        return product(x, table_or_head)
    from repro_torch.sharding import P, batch_axes, dp_size, shard_map, tp_size
    bspec = batch_axes(mesh) if x.shape[0] % dp_size(mesh) == 0 else None
    rest = (None,) * (x.ndim - 2)
    vocab = table_or_head.shape[0 if tied else 1]
    if vocab % tp_size(mesh):                  # the rule left it whole
        wspec, vspec = P(None, None), None
    else:
        wspec = P("model", None) if tied else P(None, "model")
        vspec = "model"
    return shard_map(product, mesh, (P(bspec, *rest, None), wspec),
                     P(bspec, *rest, vspec))(x, table_or_head)


def _masked_f32(logits: torch.Tensor, vocab_real: int,
                offset: int = 0) -> torch.Tensor:
    """f32 logits with the columns at or past ``vocab_real`` (global
    index: ``offset`` plus the local one) set to f32's lowest value."""
    logits = logits.to(torch.float32)
    neg = torch.finfo(torch.float32).min
    cols = torch.arange(logits.shape[-1], device=logits.device) + offset
    return torch.where(cols < vocab_real, logits,
                       torch.full((), neg, device=logits.device))


# f32 values of one chunk of rows in the cross-entropy (256 MB)
CE_CHUNK_ELEMS = 1 << 26


class _ShardCE(torch.autograd.Function):
    """Logits (..., V) holding the vocab's columns from ``offset`` on,
    labels (...) -> (lse, gold), f32 (...): each row's log-sum-exp over its
    real columns (global index below ``vocab_real``) and its gold logit
    where these columns hold the label, else 0.

    The rows go in chunks of ``CE_CHUNK_ELEMS`` f32 values, forward and
    backward, and the backward recomputes a chunk's f32 logits from the
    saved ones: no f32 tensor of all the rows exists, where autograd of
    ``torch.logsumexp`` and ``torch.gather`` would keep the masked f32
    logits and make four more of their size in the backward.  The
    gradient is theirs, op for op: ``g_lse * exp(x - lse)``, plus
    ``g_gold`` at the label, zero on the padded columns, cast to the
    logits' dtype."""

    @staticmethod
    def _chunks(n: int, v: int):
        step = max(1, CE_CHUNK_ELEMS // max(v, 1))
        return [slice(i, min(i + step, n)) for i in range(0, n, step)]

    @staticmethod
    def forward(ctx, logits, labels, vocab_real: int, offset: int):
        v = logits.shape[-1]
        rows = logits.reshape(-1, v)
        idx = labels.reshape(-1).long() - offset
        lse = torch.empty(rows.shape[0], dtype=torch.float32,
                          device=logits.device)
        gold = torch.empty_like(lse)
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        for sl in _ShardCE._chunks(rows.shape[0], v):
            x = _masked_f32(rows[sl], vocab_real, offset)
            lse[sl] = torch.logsumexp(x, dim=-1)
            i = idx[sl]
            got = torch.gather(x, -1, i.clamp(0, v - 1)[:, None])[:, 0]
            gold[sl] = torch.where((i >= 0) & (i < v), got, zero)
        ctx.save_for_backward(logits, labels, lse)
        ctx.vocab_real, ctx.offset = vocab_real, offset
        return lse.view(labels.shape), gold.view(labels.shape)

    @staticmethod
    def backward(ctx, g_lse, g_gold):
        logits, labels, lse = ctx.saved_tensors
        v = logits.shape[-1]
        rows = logits.reshape(-1, v)
        idx = labels.reshape(-1).long() - ctx.offset
        g_lse, g_gold = g_lse.reshape(-1), g_gold.reshape(-1)
        real = (torch.arange(v, device=logits.device) + ctx.offset
                < ctx.vocab_real)
        zero = torch.zeros((), dtype=torch.float32, device=logits.device)
        grad = torch.empty_like(rows)
        for sl in _ShardCE._chunks(rows.shape[0], v):
            x = _masked_f32(rows[sl], ctx.vocab_real, ctx.offset)
            gx = g_lse[sl, None] * (x - lse[sl, None]).exp()
            i = idx[sl]
            gx.scatter_add_(-1, i.clamp(0, v - 1)[:, None], torch.where(
                (i >= 0) & (i < v), g_gold[sl], zero)[:, None])
            grad[sl] = torch.where(real, gx, zero).to(grad.dtype)
        return grad.view(logits.shape), None, None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_real: int, mesh=None) -> torch.Tensor:
    """Masked CE over the *real* vocab (padded logits excluded), row by
    row through :class:`_ShardCE`.

    On a mesh the vocab stays sharded: each rank takes, on its own columns,
    the log-sum-exp of its rows (``lse_r``) and the gold logit where it
    holds the label (0 elsewhere, a partial sum over 'model', as
    :func:`embed_lookup` does).  Across 'model', ``logz = M + log(sum_r
    exp(lse_r - M))`` with ``M = max_r lse_r`` (an all-reduce max, no
    gradient through it) and the sum an all-reduce.  No rank holds a
    tensor of the whole vocab.  On one model rank ``logz`` is ``lse_0``
    and its gradient factor 1.0, so the loss and its gradient are the
    one-device path's, bit for bit."""
    if mesh is None:
        lse, gold = _ShardCE.apply(logits, labels, vocab_real, 0)
        return torch.mean(lse - gold)
    from repro_torch.sharding import (P, batch_axes, constrain, dp_size,
                                      shard_map, tp_size, with_partial)
    bspec = batch_axes(mesh) if labels.shape[0] % dp_size(mesh) == 0 \
        else None
    rest = (None,) * (labels.ndim - 1)
    rows = P(bspec, *rest)
    if logits.shape[-1] % tp_size(mesh):       # the rule left it whole
        def whole(lg, lb):
            lse, gold = _ShardCE.apply(lg, lb, vocab_real, 0)
            return lse - gold

        return torch.mean(shard_map(whole, mesh, (P(bspec, *rest, None),
                                                  rows), rows)(logits,
                                                               labels))

    def body(lg, lb):
        lse, gold = _ShardCE.apply(
            lg, lb, vocab_real, mesh.get_local_rank("model") * lg.shape[-1])
        return lse[None], gold

    # lse_r stacked over 'model' on a leading dim, the gold a partial sum
    lse, gold = shard_map(body, mesh, (P(bspec, *rest, "model"), rows),
                          [P("model", bspec, *rest),
                           with_partial(rows, mesh, ("model",))])(logits,
                                                                  labels)
    m = constrain(lse.detach().amax(dim=0), mesh, rows)
    logz = m + torch.log(torch.exp(lse - m[None]).sum(dim=0))
    return torch.mean(logz - constrain(gold, mesh, rows))
