"""Whisper-style encoder-decoder (counterpart of ``repro.models.encdec``).

The conv/mel audio frontend is a stub: the encoder consumes precomputed
frame embeddings (B, enc_seq, d_model).  Learned absolute positions
(``enc_pos`` / ``dec_pos``), pre-LayerNorm, GELU MLPs, cross-attention from
the decoder to the encoder output.  The reference's layer scans become
Python loops over slices of the stacked trees, as in ``transformer``.

The frames must come in the model's dtype: the reference promotes mixed
f32/bf16 operands, while ``torch.matmul`` refuses them.  ``mesh=`` and
``tp_total`` are ``transformer.forward``'s (DTensor parameters on a device
mesh).  :func:`abstract_decode_state` gives the decode state's leaves as
meta tensors without running the encoder (the dry-run's input).
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention, decode_attention
from repro_torch.models.common import embed_lookup, norm, unembed
from repro_torch.models.transformer import (_attn_params, _layer, _mlp,
                                            layer_tree, run_layer)
from repro_torch.sharding import heads_view, mesh_scope, pin_residual


def encode(params: Dict[str, torch.Tensor], frames: torch.Tensor,
           cfg: ModelConfig, remat: bool = False, mesh=None) -> torch.Tensor:
    """frames: (B, enc_seq, d) stub embeddings -> (B, enc_seq, d).
    ``remat`` checkpoints each layer, as in ``transformer.forward``."""
    with mesh_scope(mesh):
        return _encode(params, frames, cfg, remat, mesh)


def _encode(params, frames, cfg: ModelConfig, remat: bool, mesh):
    if frames.dtype != params["enc_pos"].dtype:
        raise ValueError(f"{cfg.name}: frames are {frames.dtype}, the model "
                         f"is {params['enc_pos'].dtype}")
    x = frames + params["enc_pos"][None, : frames.shape[1]]
    lt = layer_tree(params, "enc/")
    positions = torch.arange(frames.shape[1], device=x.device)

    def layer(x, lp):
        xn = norm(x, lp["attn_norm/w"], cfg.norm)
        a, _, _ = attention(xn, _attn_params(lp), cfg, positions=positions,
                            causal=False, mesh=mesh)
        x = pin_residual(x + a, mesh)
        return pin_residual(
            x + _mlp(norm(x, lp["mlp_norm/w"], cfg.norm), lp, cfg), mesh)

    for i in range(cfg.enc_layers):
        x = run_layer(layer, remat, x, _layer(lt, i))
    return norm(x, params["enc_final_norm/w"], cfg.norm)


def _cross_kv(enc_out: torch.Tensor, lp: Dict[str, torch.Tensor]):
    """The cross-attention's k and v, flat (B, enc_seq, Hkv*Dh): on a mesh
    on their own model shards, which ``attention.attention`` takes as its
    route needs them."""
    return (torch.matmul(enc_out, lp["cross/wk"]),
            torch.matmul(enc_out, lp["cross/wv"]))


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            frames: torch.Tensor, cfg: ModelConfig, *, mesh=None,
            tp_total: int = 1, remat: bool = False,
            collect_cache: bool = False):
    """Teacher-forced decode pass.  tokens: (B, S); frames: (B, enc_seq, d)
    -> (logits (B, S, Vp), aux); with ``collect_cache`` also the stacked
    per-layer (k, v, cross_k, cross_v) in :class:`EncDecDecodeState`'s
    layouts: k and v flat (L, B, S, Hkv*Dh), cross k and v (L, B, enc_seq,
    Hkv, Dh).
    ``remat`` checkpoints every encoder and decoder layer."""
    del tp_total          # no MoE in the encoder-decoder
    with mesh_scope(mesh):
        return _forward(params, tokens, frames, cfg, mesh, remat,
                        collect_cache)


def _forward(params, tokens, frames, cfg: ModelConfig, mesh, remat,
             collect_cache):
    enc_out = encode(params, frames, cfg, remat=remat, mesh=mesh)
    S = tokens.shape[1]
    x = embed_lookup(params["embed/table"], tokens, mesh)
    x = x + params["dec_pos"][None, :S].to(x.dtype)
    positions = torch.arange(S, device=x.device)
    enc_pos = torch.arange(enc_out.shape[1], device=x.device)
    lt = layer_tree(params)

    def layer(x, lp):
        xn = norm(x, lp["attn_norm/w"], cfg.norm)
        a, k, v = attention(xn, _attn_params(lp), cfg, positions=positions,
                            mesh=mesh)
        x = pin_residual(x + a, mesh)
        ck, cv = _cross_kv(enc_out, lp)
        xn = norm(x, lp["cross_norm/w"], cfg.norm)
        c, _, _ = attention(xn, _attn_params(lp, "cross"), cfg,
                            positions=positions, causal=False,
                            kv_override=(ck, cv, enc_pos), mesh=mesh)
        x = pin_residual(x + c, mesh)
        x = pin_residual(
            x + _mlp(norm(x, lp["mlp_norm/w"], cfg.norm), lp, cfg), mesh)
        return x, (k, v, ck, cv)

    caches = []
    for i in range(cfg.n_layers):
        x, cache = run_layer(layer, remat, x, _layer(lt, i))
        if collect_cache:
            caches.append(cache)
    x = norm(x, params["final_norm/w"], cfg.norm)
    logits = unembed(x, params["lm_head/w"], False, mesh)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero}
    if collect_cache:
        k, v, ck, cv = (torch.stack(t) for t in zip(*caches))
        shape = ck.shape[:3] + (cfg.n_kv_heads, cfg.head_dim)
        ck, cv = (heads_view(t, shape, cfg.n_kv_heads, mesh)
                  for t in (ck, cv))
        return logits, aux, (k, v, ck, cv)
    return logits, aux


class EncDecDecodeState(NamedTuple):
    cache_k: torch.Tensor    # (L, B, Smax, Hkv*Dh) decoder self-attn (flat kv)
    cache_v: torch.Tensor
    cross_k: torch.Tensor    # (L, B, enc_seq, Hkv, Dh) precomputed from encoder
    cross_v: torch.Tensor
    index: int               # tokens already in the state


def init_decode_state(params: Dict[str, torch.Tensor], frames: torch.Tensor,
                      cfg: ModelConfig, batch: int, seq_len: int,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> EncDecDecodeState:
    """Runs the encoder and precomputes per-layer cross k/v."""
    enc_out = encode(params, frames, cfg)
    lt = layer_tree(params)
    heads = (cfg.n_kv_heads, cfg.head_dim)
    ck, cv = zip(*(_cross_kv(enc_out, _layer(lt, i))
                   for i in range(cfg.n_layers)))
    k = torch.zeros((cfg.n_layers, batch, seq_len, cfg.kv_dim), dtype=dtype,
                    device=enc_out.device)
    return EncDecDecodeState(k, torch.zeros_like(k),
                             torch.stack(ck).unflatten(-1, heads).to(dtype),
                             torch.stack(cv).unflatten(-1, heads).to(dtype),
                             0)


def abstract_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> EncDecDecodeState:
    """The shapes :func:`init_decode_state` gives, as meta tensors, built
    directly: the encoder does not run.  ``index`` is the port's host int
    0, where the reference's is a 0-d int32."""
    L = cfg.n_layers
    k = torch.empty((L, batch, seq_len, cfg.kv_dim), dtype=dtype,
                    device="meta")
    c = torch.empty((L, batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim),
                    dtype=dtype, device="meta")
    return EncDecDecodeState(k, torch.empty_like(k), c, torch.empty_like(c),
                             0)


def decode_step(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                state: EncDecDecodeState, cfg: ModelConfig, *, mesh=None,
                tp_total: int = 1, donate: bool = False):
    """tokens: (B, 1) -> (logits, new state).  Each layer's new k/v slot
    is written into its self-attention cache in place, and ``donate``
    takes the state as :func:`repro_torch.models.transformer.decode_step`
    takes it: without it the caches are copied first, and ``state`` is
    left as it was."""
    del tp_total          # no MoE in the encoder-decoder
    if not donate:
        state = state._replace(cache_k=state.cache_k.clone(),
                               cache_v=state.cache_v.clone())
    with mesh_scope(mesh), torch.no_grad():
        return _decode_step(params, tokens, state, cfg, mesh)


def _decode_step(params, tokens, state: EncDecDecodeState, cfg: ModelConfig,
                 mesh):
    idx = state.index
    x = embed_lookup(params["embed/table"], tokens, mesh)
    dec_pos = params["dec_pos"]
    # the reference's dynamic_slice_in_dim clamps past the table's last row
    row = min(idx, dec_pos.shape[0] - 1)
    x = pin_residual(x + dec_pos[None, row:row + 1].to(x.dtype), mesh)
    lt = layer_tree(params)
    for i in range(cfg.n_layers):
        lp = _layer(lt, i)
        xn = norm(x, lp["attn_norm/w"], cfg.norm)
        a, _, _ = decode_attention(xn, _attn_params(lp), cfg,
                                   state.cache_k[i], state.cache_v[i], idx,
                                   mesh=mesh, donate=True)
        x = pin_residual(x + a, mesh)
        xn = norm(x, lp["cross_norm/w"], cfg.norm)
        c, _, _ = decode_attention(
            xn, _attn_params(lp, "cross"), cfg, None, None, idx,
            kv_override=(state.cross_k[i], state.cross_v[i], None), mesh=mesh)
        x = pin_residual(x + c, mesh)
        x = pin_residual(
            x + _mlp(norm(x, lp["mlp_norm/w"], cfg.norm), lp, cfg), mesh)
    x = norm(x, params["final_norm/w"], cfg.norm)
    logits = unembed(x, params["lm_head/w"], False, mesh)
    return logits, state._replace(index=idx + 1)
