"""Decoder-only LM assembly (counterpart of ``repro.models.transformer``):
the dense, MoE, ssm, hybrid and vision-stub families.

Layers stay stacked on a leading L dim, as the reference keeps them; its
``lax.scan`` over layers becomes a Python loop over slices of the stacked
tree.  The channel mixer after the token mixer is the MoE block, or the FFN
where the config has one (the reduced smoke configs do; mamba2-1.3b has
none).

``mesh=`` runs a model whose parameters (and tokens) are DTensors on a
device mesh, placed by :mod:`repro_torch.sharding`'s rules: the layers'
layout pins and the expert-parallel MoE block read it, everything else
follows DTensor's sharding propagation (as the reference's follows
GSPMD's) inside :func:`repro_torch.sharding.mesh_scope`.  ``tp_total`` is
the number of model ranks the MoE experts are stored for.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (LayerAttnParams, attention,
                                          cache_size, decode_attention)
from repro_torch.models.common import embed_lookup, gelu, norm, swiglu, unembed
from repro_torch.models.moe import MoELayerParams, moe_block
from repro_torch.models.ssm import SSMLayerParams, SSMState, init_ssm_state
from repro_torch.sharding import (heads_view, mesh_scope, pin, pin_residual,
                                  residual_spec)

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


def _moe_params(lp: Dict[str, torch.Tensor]) -> MoELayerParams:
    return MoELayerParams(router=lp["moe/router"], w_gate=lp["moe/w_gate"],
                          w_up=lp["moe/w_up"], w_down=lp["moe/w_down"])


def _mlp(x, lp, cfg: ModelConfig):
    if cfg.act == "swiglu":
        h = swiglu(torch.matmul(x, lp["mlp/w_gate"]),
                   torch.matmul(x, lp["mlp/w_up"]))
        return torch.matmul(h, lp["mlp/w_down"])
    h = gelu(torch.matmul(x, lp["mlp/w_up"]) + lp["mlp/b_up"])
    return torch.matmul(h, lp["mlp/w_down"]) + lp["mlp/b_down"]


def _token_mixer(x, lp, cfg: ModelConfig, positions,
                 ssd_kernel: Optional[bool] = None, mesh=None):
    """Full-sequence mixer for one layer; returns (dx, (k, v, ssm_state)).
    ``ssd_kernel`` is ``ssm_block``'s ``use_kernel`` (None: auto)."""
    k = v = ssm_state = None
    if cfg.family == "ssm":
        xn = norm(x, lp["ssm_norm/w"], cfg.norm)
        dx, ssm_state = ssm_mod.ssm_block(xn, _ssm_params(lp), cfg,
                                          use_kernel=ssd_kernel, mesh=mesh)
    elif cfg.hybrid:
        xn = norm(x, lp["attn_norm/w"], cfg.norm)
        a, k, v = attention(xn, _attn_params(lp), cfg, positions=positions,
                            mesh=mesh)
        s, ssm_state = ssm_mod.ssm_block(norm(x, lp["ssm_norm/w"], cfg.norm),
                                         _ssm_params(lp), cfg,
                                         use_kernel=ssd_kernel, mesh=mesh)
        dx = 0.5 * (a + s)
    else:
        xn = norm(x, lp["attn_norm/w"], cfg.norm)
        dx, k, v = attention(xn, _attn_params(lp), cfg, positions=positions,
                             mesh=mesh)
    return dx, (k, v, ssm_state)


def _channel_mixer(x, lp, cfg: ModelConfig, mesh=None, tp_total: int = 1):
    """FFN / MoE part -> (dx, (lb, z)): dx is None when the config has
    neither, (lb, z) the MoE aux losses or None without MoE."""
    if cfg.moe is not None:
        xn = norm(x, lp["mlp_norm/w"], cfg.norm)
        dx, lb, z = moe_block(xn, _moe_params(lp), cfg, mesh, tp_total)
        return dx, (lb, z)
    if cfg.d_ff > 0:
        return _mlp(norm(x, lp["mlp_norm/w"], cfg.norm), lp, cfg), None
    return None, None


def embed_inputs(params, cfg: ModelConfig, tokens, patch_embeds=None,
                 mesh=None):
    """Token embeddings; for the vision stub the projected patches replace
    the first ``n_patches`` positions (the sequence keeps its length when it
    is at least ``n_patches`` long, as in the reference)."""
    x = embed_lookup(params["embed/table"], tokens, mesh)
    if cfg.n_patches and patch_embeds is not None:
        pe = torch.matmul(patch_embeds.to(x.dtype), params["vision_proj/w"])
        if mesh is not None:
            pe = pin(pe, mesh, residual_spec(pe.shape[0], mesh))
        x = torch.cat([pe, x[:, cfg.n_patches:, :]], dim=1)
    return x


def _logits(params, x, cfg: ModelConfig, mesh=None):
    x = norm(x, params["final_norm/w"], cfg.norm)
    return unembed(x, params["embed/table"] if cfg.tie_embeddings
                   else params["lm_head/w"], cfg.tie_embeddings, mesh)


def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            cfg: ModelConfig, *, mesh=None, tp_total: int = 1,
            patch_embeds=None, remat: bool = False,
            collect_cache: bool = False, ssd_kernel: Optional[bool] = None):
    """tokens: (B, S) -> (logits (B, S, Vp), aux dict).

    With ``collect_cache`` also returns the stacked per-layer (k, v,
    ssm_state) for the prefill->decode handoff: k and v flat
    (L,B,S,Hkv*Dh), the decode cache's layout, after RoPE, or None for the
    ssm family; SSMState(ssd (L,B,H,P,N), conv (L,B,K-1,conv_dim)), or None
    for the dense family.  ``aux`` holds the MoE losses averaged over the
    layers (zeros without MoE).

    ``remat`` runs each layer under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scanned layer): backward
    recomputes the layer's activations instead of keeping them, and the
    numbers are unchanged.  ``ssd_kernel`` is passed to ``ssm_block`` as
    ``use_kernel``: None takes the scan kernel on a CUDA tensor, False the
    oracle, which training needs (the kernel has no backward)."""
    with mesh_scope(mesh):
        return _forward(params, tokens, cfg, mesh, tp_total, patch_embeds,
                        remat, collect_cache, ssd_kernel)


def _forward(params, tokens, cfg: ModelConfig, mesh, tp_total, patch_embeds,
             remat, collect_cache, ssd_kernel):
    x = embed_inputs(params, cfg, tokens, patch_embeds, mesh)
    positions = torch.arange(tokens.shape[1], device=x.device)
    lt = layer_tree(params)

    def layer(x, lb, z, lp):
        dx, cache = _token_mixer(x, lp, cfg, positions, ssd_kernel, mesh)
        x = pin_residual(x + dx, mesh)
        dx, moe_aux = _channel_mixer(x, lp, cfg, mesh, tp_total)
        if dx is not None:
            x = pin_residual(x + dx, mesh)
        if moe_aux is not None:
            lb = lb + moe_aux[0]
            z = z + moe_aux[1]
        return x, lb, z, cache

    caches = []
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, lb, z, cache = run_layer(layer, remat, x, lb, z, _layer(lt, i))
        if collect_cache:
            caches.append(cache)
    logits = _logits(params, x, cfg, mesh)
    aux = {"lb_loss": lb / cfg.n_layers, "z_loss": z / cfg.n_layers}
    if collect_cache:
        k, v, st = zip(*caches)
        k = None if k[0] is None else torch.stack(k)
        v = None if v[0] is None else torch.stack(v)
        st = None if st[0] is None else SSMState(
            ssd=torch.stack([s.ssd for s in st]),
            conv=torch.stack([s.conv for s in st]))
        return logits, aux, (k, v, st)
    return logits, aux


def run_layer(layer, remat: bool, *args):
    """``layer(*args)``; under ``remat`` through activation checkpointing
    (non-reentrant, so gradients also reach the tensors ``layer`` closes
    over)."""
    if remat:
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    cache_k: Optional[torch.Tensor]   # (L, B, Smax, Hkv*Dh) — kv dim flattened
    cache_v: Optional[torch.Tensor]
    ssm_ssd: Optional[torch.Tensor]   # (L, B, H*P, N) f32 — head dim flattened;
    # kept flat through ssm_decode where ssm.decodes_flat (a mesh whose model
    # axis does not divide the SSD heads)
    ssm_conv: Optional[torch.Tensor]  # (L, B, K-1, conv_dim)
    index: int                        # tokens already in the state


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = None) -> DecodeState:
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
        # every layer's conv state its own storage: a donated step writes
        # each layer's in place
        sc = st.conv[None].repeat((L,) + (1,) * st.conv.ndim)
    return DecodeState(ck, cv, sd, sc, 0)


def abstract_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                          dtype: torch.dtype = torch.bfloat16) -> DecodeState:
    """:func:`init_decode_state` on the meta device: the same leaves with
    no storage (the reference's ``jax.eval_shape`` of it).  ``index`` is
    the port's host int 0, where the reference's is a 0-d int32."""
    return init_decode_state(cfg, batch, seq_len, dtype, device="meta")


def decode_step(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                state: DecodeState, cfg: ModelConfig, *, mesh=None,
                tp_total: int = 1, donate: bool = False):
    """tokens: (B, 1) -> (logits (B, 1, Vp), new DecodeState).  The MoE aux
    losses are dropped, and the vision stub's patches take no part, as in
    the reference.

    Each layer's new k/v slot and SSM state are written into the state's
    tensors in place (on a mesh into their stored shards), and the
    returned state holds those tensors with ``index + 1`` (but a conv
    state in another dtype than the model's, which is cast to it once).
    ``donate`` is the reference's ``donate_argnums`` on the state: the
    step writes into ``state``'s own tensors.  Without it, it writes into
    copies, and ``state`` is left as it was.  The step records no autograd
    graph."""
    if not donate:
        state = DecodeState(*(t.clone() if isinstance(t, torch.Tensor) else t
                              for t in state))
    with mesh_scope(mesh), torch.no_grad():
        return _decode_step(params, tokens, state, cfg, mesh, tp_total)


def _decode_step(params, tokens, state: DecodeState, cfg: ModelConfig, mesh,
                 tp_total):
    x = pin_residual(embed_lookup(params["embed/table"], tokens, mesh), mesh)
    lt = layer_tree(params)
    B = x.shape[0]
    idx = state.index
    if state.ssm_conv is not None and state.ssm_conv.dtype != x.dtype:
        # the new conv state is the model's dtype (the reference's too),
        # and the step reads the old one cast to it: a conv state made in
        # another dtype takes the model's once, as XLA cannot alias a
        # buffer of one dtype with an output of another
        state = state._replace(ssm_conv=state.ssm_conv.to(x.dtype))

    def ssm_step(xn, lp, i):
        H, Pd, N = cfg.n_ssm_heads, cfg.ssm.d_head, cfg.ssm.d_state
        # the flat state passes through ssm_decode as it is stored where a
        # head view of its channel shards would gather it over 'model'
        flat = ssm_mod.decodes_flat(cfg, mesh)
        sd = state.ssm_ssd[i]
        if not flat:
            sd = heads_view(sd, (B, H, Pd, N), H, mesh)
        dx, _ = ssm_mod.ssm_decode(xn, _ssm_params(lp), cfg,
                                   SSMState(sd, state.ssm_conv[i]), mesh)
        return dx

    def attn_step(xn, lp, i):
        dx, _, _ = decode_attention(xn, _attn_params(lp), cfg,
                                    state.cache_k[i], state.cache_v[i], idx,
                                    mesh=mesh, donate=True)
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
        x = pin_residual(x + dx, mesh)
        dx, _ = _channel_mixer(x, lp, cfg, mesh, tp_total)
        if dx is not None:
            x = pin_residual(x + dx, mesh)
    logits = _logits(params, x, cfg, mesh)
    return logits, state._replace(index=idx + 1)
