"""Decoder-only LM assembly (counterpart of ``repro.models.transformer``),
for the ssm, hybrid and dense families.

Layers stay stacked on a leading L dim, as the reference keeps them; its
``lax.scan`` over layers becomes a Python loop over slices of the stacked
tree.  MoE, the vision stub and the encoder-decoder raise
``NotImplementedError``: they wait in ROADMAP Queue 1 (the LM side).  The
FFN after the mixer runs where the config has one (the reduced smoke
configs do; mamba2-1.3b has none).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.configs import require_lm_family
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (LayerAttnParams, attention,
                                          cache_size, decode_attention)
from repro_torch.models.common import embed_lookup, gelu, norm, swiglu, unembed
from repro_torch.models.ssm import SSMLayerParams, SSMState, init_ssm_state

LAYER_PREFIX = "layers/"


def layer_tree(params: Dict[str, torch.Tensor],
               prefix: str = LAYER_PREFIX) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def _layer(lt: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s slice of the stacked tree (views, no copies)."""
    return {k: v[i] for k, v in lt.items()}


def _attn_params(lp: Dict[str, torch.Tensor],
                 prefix: str = "attn") -> LayerAttnParams:
    return LayerAttnParams(
        wq=lp[f"{prefix}/wq"], wk=lp[f"{prefix}/wk"], wv=lp[f"{prefix}/wv"],
        wo=lp[f"{prefix}/wo"],
        bq=lp.get(f"{prefix}/bq"), bk=lp.get(f"{prefix}/bk"),
        bv=lp.get(f"{prefix}/bv"))


def _ssm_params(lp: Dict[str, torch.Tensor]) -> SSMLayerParams:
    return SSMLayerParams(
        w_z=lp["ssm/w_z"], w_x=lp["ssm/w_x"], w_bc=lp["ssm/w_bc"],
        w_dt=lp["ssm/w_dt"], conv=lp["ssm/conv"], A_log=lp["ssm/A_log"],
        D=lp["ssm/D"], dt_bias=lp["ssm/dt_bias"], norm_w=lp["ssm/norm_w"],
        w_out=lp["ssm/w_out"])


def _mlp(x, lp, cfg: ModelConfig):
    if cfg.act == "swiglu":
        h = swiglu(torch.matmul(x, lp["mlp/w_gate"]),
                   torch.matmul(x, lp["mlp/w_up"]))
        return torch.matmul(h, lp["mlp/w_down"])
    h = gelu(torch.matmul(x, lp["mlp/w_up"]) + lp["mlp/b_up"])
    return torch.matmul(h, lp["mlp/w_down"]) + lp["mlp/b_down"]


def _token_mixer(x, lp, cfg: ModelConfig, positions):
    """Full-sequence mixer for one layer; returns (dx, (k, v, ssm_state))."""
    k = v = ssm_state = None
    if cfg.family == "ssm":
        xn = norm(x, lp["ssm_norm/w"], cfg.norm)
        dx, ssm_state = ssm_mod.ssm_block(xn, _ssm_params(lp), cfg)
    elif cfg.hybrid:
        xn = norm(x, lp["attn_norm/w"], cfg.norm)
        a, k, v = attention(xn, _attn_params(lp), cfg, positions=positions)
        s, ssm_state = ssm_mod.ssm_block(norm(x, lp["ssm_norm/w"], cfg.norm),
                                         _ssm_params(lp), cfg)
        dx = 0.5 * (a + s)
    else:
        xn = norm(x, lp["attn_norm/w"], cfg.norm)
        dx, k, v = attention(xn, _attn_params(lp), cfg, positions=positions)
    return dx, (k, v, ssm_state)


def _channel_mixer(x, lp, cfg: ModelConfig) -> Optional[torch.Tensor]:
    """FFN part: dx, or None when the config has no FFN.  Without MoE there
    are no aux losses."""
    if cfg.d_ff > 0:
        return _mlp(norm(x, lp["mlp_norm/w"], cfg.norm), lp, cfg)
    return None


def embed_inputs(params, cfg: ModelConfig, tokens, patch_embeds=None):
    """Token embeddings (the vision stub's patches wait with its family)."""
    return embed_lookup(params["embed/table"], tokens)


def _logits(params, x, cfg: ModelConfig):
    x = norm(x, params["final_norm/w"], cfg.norm)
    return unembed(x, params["embed/table"] if cfg.tie_embeddings
                   else params["lm_head/w"], cfg.tie_embeddings)


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: ModelConfig, *, patch_embeds=None,
            collect_cache: bool = False):
    """tokens: (B, S) -> (logits (B, S, Vp), aux dict).

    With ``collect_cache`` also returns the stacked per-layer (k, v,
    ssm_state) for the prefill->decode handoff: k and v (L,B,S,Hkv,Dh)
    after RoPE, or None for the ssm family; SSMState(ssd (L,B,H,P,N), conv
    (L,B,K-1,conv_dim)), or None for the dense family."""
    require_lm_family(cfg)
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    positions = torch.arange(tokens.shape[1], device=x.device)
    lt = layer_tree(params)
    caches = []
    for i in range(cfg.n_layers):
        lp = _layer(lt, i)
        dx, cache = _token_mixer(x, lp, cfg, positions)
        x = x + dx
        dx = _channel_mixer(x, lp, cfg)
        if dx is not None:
            x = x + dx
        if collect_cache:
            caches.append(cache)
    logits = _logits(params, x, cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero}
    if collect_cache:
        k, v, st = zip(*caches)
        k = None if k[0] is None else torch.stack(k)
        v = None if v[0] is None else torch.stack(v)
        st = None if st[0] is None else SSMState(
            ssd=torch.stack([s.ssd for s in st]),
            conv=torch.stack([s.conv for s in st]))
        return logits, aux, (k, v, st)
    return logits, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    cache_k: Optional[torch.Tensor]   # (L, B, Smax, Hkv*Dh) — kv dim flattened
    cache_v: Optional[torch.Tensor]
    ssm_ssd: Optional[torch.Tensor]   # (L, B, H*P, N) f32 — head dim flattened
    ssm_conv: Optional[torch.Tensor]  # (L, B, K-1, conv_dim)
    index: int                        # tokens already in the state


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = None) -> DecodeState:
    require_lm_family(cfg)
    L = cfg.n_layers
    ck = cv = sd = sc = None
    if cfg.family != "ssm":
        smax = cache_size(cfg, seq_len)
        ck = torch.zeros((L, batch, smax, cfg.kv_dim), dtype=dtype,
                         device=device)
        cv = torch.zeros_like(ck)
    if cfg.family in ("ssm", "hybrid"):
        st = init_ssm_state(cfg, batch, dtype, device)
        sd = torch.zeros((L, batch, cfg.d_inner, cfg.ssm.d_state),
                         dtype=torch.float32, device=device)
        sc = st.conv[None].expand((L,) + tuple(st.conv.shape))
    return DecodeState(ck, cv, sd, sc, 0)


def decode_step(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                state: DecodeState, cfg: ModelConfig):
    """tokens: (B, 1) -> (logits (B, 1, Vp), new DecodeState).  The state
    passed in is left as it was."""
    require_lm_family(cfg)
    x = embed_lookup(params["embed/table"], tokens)
    lt = layer_tree(params)
    B = x.shape[0]
    idx = state.index
    new_k, new_v, new_sd, new_sc = [], [], [], []

    def ssm_step(xn, lp, i):
        H, Pd, N = cfg.n_ssm_heads, cfg.ssm.d_head, cfg.ssm.d_state
        sd = state.ssm_ssd[i].reshape(B, H, Pd, N)
        dx, st = ssm_mod.ssm_decode(xn, _ssm_params(lp), cfg,
                                    SSMState(sd, state.ssm_conv[i]))
        new_sd.append(st.ssd.reshape(B, cfg.d_inner, N))
        new_sc.append(st.conv)
        return dx

    def attn_step(xn, lp, i):
        dx, nk, nv = decode_attention(xn, _attn_params(lp), cfg,
                                      state.cache_k[i], state.cache_v[i], idx)
        new_k.append(nk)
        new_v.append(nv)
        return dx

    for i in range(cfg.n_layers):
        lp = _layer(lt, i)
        if cfg.family == "ssm":
            dx = ssm_step(norm(x, lp["ssm_norm/w"], cfg.norm), lp, i)
        elif cfg.hybrid:
            a = attn_step(norm(x, lp["attn_norm/w"], cfg.norm), lp, i)
            s = ssm_step(norm(x, lp["ssm_norm/w"], cfg.norm), lp, i)
            dx = 0.5 * (a + s)
        else:
            dx = attn_step(norm(x, lp["attn_norm/w"], cfg.norm), lp, i)
        x = x + dx
        dx = _channel_mixer(x, lp, cfg)
        if dx is not None:
            x = x + dx
    logits = _logits(params, x, cfg)

    def stacked(ts):
        return torch.stack(ts) if ts else None

    return logits, DecodeState(stacked(new_k), stacked(new_v),
                               stacked(new_sd), stacked(new_sc), idx + 1)
