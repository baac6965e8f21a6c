"""Mixture-of-Experts block (counterpart of ``repro.models.moe``): the
one-device path.

Capacity-based token selection, as the reference does it: each expert
takes at most ``cap`` of the token slots routed to it, in slot order, cut
from one argsort of the slots by expert; its SwiGLU FFN runs on those rows
and its weighted output is scatter-added back.  The experts run one after
another in expert order, one ``index_add_`` each, so bf16 sums round in the
reference's sequence.  The gathers are computed for all experts at once on
the device, so the loop waits on no host copy.

``moe_shard_body`` keeps the reference's per-rank arguments (``tp_total``,
``rank``).  Without a mesh ``moe_block`` runs it for the whole model on one
device.  On a device mesh it runs under
:func:`repro_torch.sharding.shard_map` with the reference's ep x tp layout:
rank ``r`` on 'model' holds tp-slice ``r % tp`` of experts
``[(r//tp)*E/ep, (r//tp+1)*E/ep)`` (expert weights stored as ``(tp_total,
E/ep, d, f/tp)``, dim 0 over 'model'), tokens over the data axes when they
divide them, replicated over 'model'.  The body sees plain local tensors,
so the routing's sort, gathers and ``index_add_`` never meet DTensor; each
rank's output is one term of a sum over 'model' (the reference's
``psum``), and the aux losses are averaged over the data axes when the
tokens are sharded there (its ``pmean``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import swiglu
from repro_torch.models.params import moe_factors
from repro_torch.sharding import (P, batch_axes, constrain, dp_size,
                                  shard_map, tp_size, with_partial)


class MoELayerParams(NamedTuple):
    router: torch.Tensor   # (d, E)
    w_gate: torch.Tensor   # (tp_total, E/ep, d, f/tp)
    w_up: torch.Tensor
    w_down: torch.Tensor   # (tp_total, E/ep, f/tp, d)


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """x: (T, d) -> (probs (T,k) f32, experts (T,k) int64, logits (T,E) f32).

    Equal logits go to the lower expert index first, as ``jax.lax.top_k``
    orders them: a stable descending sort keeps ties in index order."""
    logits = torch.matmul(x.to(torch.float32), router_w.to(torch.float32))
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    probs = torch.softmax(vals[:, :top_k], dim=-1)
    return probs, idx[:, :top_k], logits


def aux_losses(logits: torch.Tensor, experts: torch.Tensor,
               n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(load-balance loss, router z-loss) — the Switch/ST-MoE auxiliaries."""
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    me = probs.mean(dim=0)                                   # mean router prob
    ce = F.one_hot(experts[:, 0], n_experts).to(torch.float32).mean(dim=0)
    lb = n_experts * torch.sum(me * ce)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return lb, z


def _expert_ffn(xe, wg, wu, wd):
    """xe: (C, d); wg/wu: (d, fl); wd: (fl, d)."""
    h = swiglu(torch.matmul(xe, wg), torch.matmul(xe, wu))
    return torch.matmul(h, wd)


def moe_shard_body(x: torch.Tensor, p: MoELayerParams, cfg: ModelConfig,
                   tp_total: int, rank: int):
    """One model rank's share.  x: (T, d); p.w_*: the rank's block (1, E/ep,
    d, fl) / (1, E/ep, fl, d).  Returns (out (T, d), lb, z)."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    ep, tp = moe_factors(E, tp_total)
    e_loc = E // ep
    T = x.shape[0]
    n = T * k
    cap = max(int(math.ceil(T * k * m.capacity_factor / E)), 1)
    cap = min(cap, T)
    dev = x.device

    probs, experts, logits = route(x, p.router, k)
    flat_e = experts.reshape(-1)                             # (T*k,)
    flat_p = probs.reshape(-1)
    slots = torch.arange(n, device=dev)
    flat_tok = slots // k
    # group the slots by expert; the int64 keys are unique, so the order is
    # the reference's whatever the sort
    order = torch.argsort(flat_e * n + slots)
    sorted_e = flat_e[order]
    # a fixed-size count (bincount's output size depends on the data, which
    # a traced step on fake tensors cannot give)
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))                  # (E,)
    starts = torch.cumsum(counts, 0) - counts

    ids = (rank // tp) * e_loc + torch.arange(e_loc, device=dev)
    # the reference's dynamic_slice clamps a start to n - cap; the slots of
    # the experts before that the clamp pulls in fail `valid`, and a segment's
    # tail beyond `cap` never enters the slice (capacity dropping)
    start = torch.clamp(starts[ids], max=n - cap)
    pos = start[:, None] + torch.arange(cap, device=dev)     # (e_loc, cap)
    slot_idx = order[pos]
    pos_in_seg = pos - starts[ids][:, None]
    valid = (sorted_e[pos] == ids[:, None]) & \
        (pos_in_seg < torch.clamp(counts[ids], max=cap)[:, None])
    tok = flat_tok[slot_idx]
    w = (flat_p[slot_idx] * valid).to(x.dtype)
    keep = valid.to(x.dtype)

    out = torch.zeros_like(x)
    wg, wu, wd = p.w_gate[0], p.w_up[0], p.w_down[0]         # (E/ep, ...)
    for j in range(e_loc):
        xe = x[tok[j]] * keep[j, :, None]
        ye = _expert_ffn(xe, wg[j], wu[j], wd[j])
        out.index_add_(0, tok[j], ye * w[j, :, None])
    lb, z = aux_losses(logits, experts, E)
    return out, lb, z


def moe_block(x: torch.Tensor, p: MoELayerParams, cfg: ModelConfig,
              mesh=None, tp_total: int = None):
    """x: (B, S, d) -> (y (B,S,d), load-balance loss, z loss).

    ``tp_total`` (default: the expert weights' leading dim) is the number
    of model ranks the weights are stored for; more than one needs a mesh
    whose 'model' axis has that many ranks."""
    B, S, d = x.shape
    if tp_total is None:
        tp_total = p.w_gate.shape[0]
    if p.w_gate.shape[0] != tp_total:
        raise ValueError(f"expert weights stored for {p.w_gate.shape[0]} "
                         f"model ranks; tp_total is {tp_total}")
    if mesh is None:
        if tp_total != 1:
            raise ValueError(
                f"{cfg.name}: expert weights stored for {tp_total} model "
                "ranks run on a device mesh with that many on 'model' "
                "(pass mesh=)")
        y, lb, z = moe_shard_body(x.reshape(B * S, d), p, cfg, 1, 0)
        return y.reshape(B, S, d), lb, z
    return _moe_on_mesh(x, p, cfg, mesh, tp_total)


def _moe_on_mesh(x, p: MoELayerParams, cfg: ModelConfig, mesh,
                 tp_total: int):
    """The reference's ``shard_map`` path of ``moe_block``."""
    B, S, d = x.shape
    if tp_total not in (1, tp_size(mesh)):
        raise ValueError(f"expert weights stored for {tp_total} model ranks "
                         f"on a mesh with {tp_size(mesh)} on 'model'")
    xt = x.reshape(B * S, d)
    dp = batch_axes(mesh)
    # tiny decode batches can't shard over dp: replicate tokens instead
    # (each data shard redundantly computes them)
    tok_spec = P(dp, None) if (B * S) % dp_size(mesh) == 0 else P(None, None)
    dp_axes = dp if tok_spec[0] is not None else ()
    split = tp_total > 1
    w_spec = P("model", None, None, None) if split else P()
    # y: one term per model rank (psum); lb/z: averaged over the data
    # shards (pmean), and each model rank holds 1/tp of the equal values
    # so that their gradient is counted once
    y_pl = with_partial(tok_spec, mesh, ("model",)) if split else tok_spec
    aux_pl = with_partial(P(), mesh, dp_axes, "avg")
    if split:
        aux_pl = with_partial(aux_pl, mesh, ("model",))

    def body(xt, router, wg, wu, wd):
        rank = mesh.get_local_rank("model") if split else 0
        y, lb, z = moe_shard_body(xt, MoELayerParams(router, wg, wu, wd),
                                  cfg, tp_total, rank)
        if split:
            lb, z = lb / tp_total, z / tp_total
        return y, lb, z

    y, lb, z = shard_map(body, mesh, (tok_spec, P(), w_spec, w_spec, w_spec),
                         [y_pl, aux_pl, aux_pl],
                         out_shapes=[(B * S, d), None, None])(
        xt, p.router, p.w_gate, p.w_up, p.w_down)
    y = constrain(y, mesh, tok_spec)
    lb, z = constrain(lb, mesh, P()), constrain(z, mesh, P())
    return y.reshape(B, S, d), lb, z
