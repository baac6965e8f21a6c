"""Attention: GQA with RoPE, sliding-window support, chunked prefill, KV-cache
decode (counterpart of ``repro.models.attention``).

Prefill attention is computed in query chunks so the (B, H, S, S) score
tensor is never materialized; per-row softmax stays exact because each
chunk row sees all keys (or, banded, all keys its window can reach).  The
reference's ``lax.scan`` over chunks becomes a Python loop.

The reference computes attention in plain ``jnp`` with no Pallas kernel, so
the port follows it step by step in plain PyTorch: the scores are an f32
product of the upcast operands (the reference's einsum with
``preferred_element_type=f32``), cast to the score dtype and scaled there,
masked with that dtype's lowest value, and the softmax runs in the score
dtype as ``jax.nn.softmax`` writes it.  ``F.scaled_dot_product_attention``
would round bf16 at other places; it is a yardstick only.

Perf knobs (``repro_torch.perf.FLAGS``, read at call time):
  * grouped GQA (scores per kv-head group, the repeated kv tensor is never
    materialized);
  * banded SWA prefill (only the in-window key band is computed per q
    chunk);
  * bf16 score tensors when the activations are bf16.
The reference's head-sharding constraint (``_constrain_heads``) and its
``mesh`` arguments have no counterpart on one card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import perf
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_rope, rope_angles

Q_CHUNK = 1024  # query-block size for chunked attention
PAD_POS = -10 ** 9     # position of the keys padded in front of a band
EMPTY_POS = 10 ** 9    # position of a cache slot not written yet


class LayerAttnParams(NamedTuple):
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None


def _proj_qkv(x: torch.Tensor, p: LayerAttnParams, cfg: ModelConfig):
    B, S, _ = x.shape
    q = torch.matmul(x, p.wq)
    k = torch.matmul(x, p.wk)
    v = torch.matmul(x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, H, Dh) by group repetition."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: Optional[int],
          causal: bool) -> torch.Tensor:
    """qpos: (Q,), kpos: (K,) -> bool (Q, K) of *allowed* links."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim, step by step in s's dtype."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _sdpa_chunk(q, k, v, qpos, kpos, window, causal, scale, grouped: bool):
    """q: (B, Qc, H, Dh); k/v: (B, S, Hkv, Dh) -> (B, Qc, H, Dh).

    grouped=True computes scores per kv group without repeating k/v."""
    B, Qc, H, Dh = q.shape
    Hkv = k.shape[2]
    m = _mask(qpos, kpos, window, causal)
    sdt = torch.bfloat16 if (perf.FLAGS.attn_bf16_scores
                             and q.dtype == torch.bfloat16) else torch.float32
    neg = torch.finfo(sdt).min
    scale_t = torch.tensor(scale, dtype=sdt, device=q.device)
    if grouped and Hkv != H:
        G = H // Hkv
        qg = q.reshape(B, Qc, Hkv, G, Dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()
                         ).to(sdt) * scale_t
        s = s.masked_fill(~m, neg)
        prob = _softmax(s).to(v.dtype)
        o = torch.einsum("bhgqk,bkhd->bqhgd", prob, v)
        return o.reshape(B, Qc, H, Dh)
    kx = _expand_kv(k, H)
    vx = _expand_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()).to(sdt) \
        * scale_t
    s = s.masked_fill(~m, neg)
    prob = _softmax(s).to(vx.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", prob, vx)


def prefill_route(cfg: ModelConfig, S: int, causal: bool = True,
                  cross: bool = False) -> str:
    """Which schedule :func:`attention` runs for S queries: ``"unchunked"``
    (S <= Q_CHUNK or ragged), ``"banded"`` (SWA, ``FLAGS.swa_banded``, the
    window a multiple of Q_CHUNK, no cross-attention) or ``"chunked"``."""
    qc, win = Q_CHUNK, cfg.sliding_window
    if S <= qc or S % qc != 0:
        return "unchunked"
    if (perf.FLAGS.swa_banded and win is not None and causal and not cross
            and win % qc == 0):
        return "banded"
    return "chunked"


def attend(q, k, v, positions, kpos, cfg: ModelConfig, causal: bool = True,
           cross: bool = False) -> torch.Tensor:
    """Scores, mask, softmax and the value product for the whole sequence:
    q (B,S,H,Dh), k/v (B,Sk,Hkv,Dh) after RoPE -> (B,S,H,Dh), on the
    schedule :func:`prefill_route` picks."""
    S = q.shape[1]
    scale = cfg.head_dim ** -0.5
    grouped = perf.FLAGS.gqa_grouped
    win = cfg.sliding_window
    qc = Q_CHUNK
    route = prefill_route(cfg, S, causal, cross)
    if route == "unchunked":
        return _sdpa_chunk(q, k, v, positions, kpos, win, causal, scale,
                           grouped)
    outs = []
    if route == "banded":
        # per q chunk only keys in [chunk_start - window, chunk_end) can
        # attend: pad keys in front so every chunk slices a fixed-size band
        band = win + qc
        pad = band - qc
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
        kpos_p = torch.nn.functional.pad(kpos, (pad, 0), value=PAD_POS)
        for start in range(0, S, qc):     # band ends at chunk end
            outs.append(_sdpa_chunk(
                q[:, start:start + qc], kp[:, start:start + band],
                vp[:, start:start + band], positions[start:start + qc],
                kpos_p[start:start + band], win, causal, scale, grouped))
    else:
        for start in range(0, S, qc):
            sl = slice(start, start + qc)
            outs.append(_sdpa_chunk(q[:, sl], k, v, positions[sl], kpos, win,
                                    causal, scale, grouped))
    return torch.cat(outs, dim=1)


def attention(x: torch.Tensor, p: LayerAttnParams, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              kv_override=None):
    """Full-sequence attention (prefill / encoder).

    kv_override: (k, v, kpos) for cross-attention (q from x, kv precomputed).
    Returns (out (B,S,d), k, v) — k/v returned for cache population at
    prefill (after RoPE)."""
    B, S, _ = x.shape
    q, k, v = _proj_qkv(x, p, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if kv_override is not None:
        k, v, kpos = kv_override
    else:
        if cfg.rope_theta > 0:
            cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        kpos = positions
    out = attend(q, k, v, positions, kpos, cfg, causal,
                 cross=kv_override is not None)
    out = out.reshape(B, S, cfg.q_dim)
    return torch.matmul(out, p.wo), k, v


def cache_size(cfg: ModelConfig, seq_len: int) -> int:
    """Allocated cache length: SWA archs keep a ring buffer of window size."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def decode_attention(x: torch.Tensor, p: LayerAttnParams, cfg: ModelConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, index: int,
                     *, kv_override=None):
    """Single-token decode.  x: (B, 1, d); cache_k/v: (B, Smax, Hkv*Dh)
    *flattened* on the kv dim; index: host int, the tokens already in the
    cache.

    RoPE is applied at insertion, so SWA ring buffers need no re-rotation.
    Returns (out, new_cache_k, new_cache_v): new tensors, the caches passed
    in are left as they were."""
    B = x.shape[0]
    q, k, v = _proj_qkv(x, p, cfg)
    scale = cfg.head_dim ** -0.5
    dev = x.device
    if kv_override is not None:
        ko, vo, _ = kv_override
        out = _sdpa_chunk(q, ko.to(q.dtype), vo.to(q.dtype),
                          torch.zeros(1, dtype=torch.long, device=dev),
                          torch.zeros(ko.shape[1], dtype=torch.long,
                                      device=dev),
                          None, False, scale, perf.FLAGS.gqa_grouped)
        out = out.reshape(B, 1, cfg.q_dim)
        return torch.matmul(out, p.wo), cache_k, cache_v

    if cfg.rope_theta > 0:
        cos, sin = rope_angles(torch.tensor([index], device=dev),
                               cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    smax = cache_k.shape[1]
    slot = index % smax if cfg.sliding_window is not None else index
    # the reference's dynamic_update_slice clamps a start past the end
    slot = min(slot, smax - 1)
    cache_k = cache_k.clone()
    cache_v = cache_v.clone()
    cache_k[:, slot] = k.reshape(B, cfg.kv_dim).to(cache_k.dtype)
    cache_v[:, slot] = v.reshape(B, cfg.kv_dim).to(cache_v.dtype)

    kc = cache_k.reshape(B, smax, cfg.n_kv_heads, cfg.head_dim).to(q.dtype)
    vc = cache_v.reshape(B, smax, cfg.n_kv_heads, cfg.head_dim).to(q.dtype)
    valid = torch.arange(smax, device=dev) <= min(index, smax - 1)
    kpos = torch.where(valid, 0, EMPTY_POS)  # unwritten slots fail causality
    out = _sdpa_chunk(q, kc, vc, torch.zeros(1, dtype=torch.long, device=dev),
                      kpos, None, True, scale, perf.FLAGS.gqa_grouped)
    out = out.reshape(B, 1, cfg.q_dim)
    return torch.matmul(out, p.wo), cache_k, cache_v
