"""Train step factory (counterpart of ``repro.runtime.train``).

Remat, gradient accumulation over microbatches, optional int8 gradient
compression with error feedback, then AdamW.  The step is functional, as
the reference's jitted step is: it returns new tensors and never writes to
the state it was given, which the fault-tolerant loop's restart relies on.

On a device mesh (DP x TP, + pod) the state and batch are DTensors:
:func:`state_shardings` places the parameters by the sharding rules and the
moments ZeRO-1 (additionally over 'data'), :func:`batch_shardings` the
batch over the data axes, and ``make_train_step(mesh=...)`` runs the same
step on them, DTensor's sharding propagation placing the collectives (the
gradient all-reduce among them) as GSPMD places the reference's.
:func:`jit_train_step` is the reference's ``jax.jit`` with in/out
shardings: it places the state and batch on entry and the new state on
exit, eagerly.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, is_dtensor, resolve_device
from repro_torch.models.params import params_from_jax, tensor_from_numpy
from repro_torch.optim.adamw import (OptConfig, OptState, apply_updates,
                                     init_opt_state)
from repro_torch.quant import gradcomp
from repro_torch.runtime.model_api import loss_fn
from repro_torch.sharding import (P, NamedSharding, batch_axes, constrain,
                                  mesh_scope, opt_state_spec, param_sharding,
                                  place_tree, tp_size)


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: OptState
    err_fb: Optional[Dict[str, torch.Tensor]]  # gradient-compression residuals


def init_train_state(params: Dict[str, torch.Tensor],
                     grad_compress: bool = False) -> TrainState:
    err = gradcomp.init_error_state(params) if grad_compress else None
    return TrainState(params=params, opt=init_opt_state(params), err_fb=err)


def state_shardings(cfg: ModelConfig, state_shape: TrainState, mesh
                    ) -> TrainState:
    """NamedShardings for a TrainState (params rule + ZeRO-1 moments)."""
    del cfg
    p_sh = param_sharding(state_shape.params, mesh)

    def moments(tree):
        return {k: NamedSharding(mesh, opt_state_spec(k, v.shape, mesh))
                for k, v in tree.items()}

    return TrainState(
        params=p_sh,
        opt=OptState(mu=moments(state_shape.opt.mu),
                     nu=moments(state_shape.opt.nu),
                     count=NamedSharding(mesh, P())),
        err_fb=(None if state_shape.err_fb is None
                else moments(state_shape.err_fb)))


def batch_shardings(batch_shape: Dict, mesh) -> Dict[str, NamedSharding]:
    dp = batch_axes(mesh)
    return {k: NamedSharding(mesh, P(dp, *([None] * (v.ndim - 1))))
            for k, v in batch_shape.items()}


def _grads_of(params: Dict[str, torch.Tensor], batch, cfg: ModelConfig,
              remat: bool, mesh=None, tp_total: int = 1):
    """-> (metrics, grads): the gradient of ``loss_fn`` with respect to every
    parameter, in the parameter's dtype (zeros for one the loss does not
    reach, as ``jax.grad`` gives), from leaves detached from ``params``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch, cfg, mesh=mesh,
                                tp_total=tp_total, remat=remat)
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(leaves, gs)}
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *, mesh=None,
                    tp_total: int = 1, remat: bool = True,
                    grad_compress: bool = False, microbatches: int = 1,
                    unroll: bool = False):
    """Returns ``step(state, batch) -> (state, metrics)``; metrics are
    ``loss``, ``ce``, ``lb_loss``, ``z_loss`` (of the last microbatch),
    ``grad_norm`` and ``lr``, as 0-d tensors.

    With ``microbatches`` > 1 the batch splits on its first dim; the f32
    gradient sums ``g / microbatches`` in microbatch order, as the
    reference's scan does.  ``unroll`` is accepted and has no effect: the
    port's layer and microbatch loops are Python loops already.

    ``mesh``: the state and batch are DTensors on it (``tp_total`` the
    model ranks the MoE experts are stored for); each microbatch is the
    reference's rows of the batch, sharded over the data axes again.  The
    returned state's layouts are whatever the ops left;
    :func:`jit_train_step` pins them."""
    del unroll

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with mesh_scope(mesh):
            return _step(state, batch)

    def _step(state, batch):
        if microbatches > 1:
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in state.params.items()}
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                if mesh is not None:
                    mb = {k: constrain(v, mesh, P(batch_axes(mesh),
                                                  *([None] * (v.ndim - 1))))
                          for k, v in mb.items()}
                metrics, g = _grads_of(state.params, mb, cfg, remat, mesh,
                                       tp_total)
                grads = {k: grads[k] + g[k] / microbatches for k in grads}
        else:
            metrics, grads = _grads_of(state.params, batch, cfg, remat, mesh,
                                       tp_total)
        if mesh is not None:
            # complete the gradient reductions onto the parameters' layouts
            # (the data-parallel all-reduce): the optimizer's nonlinear ops
            # must not see partial sums, whose terms can round a square
            # below zero
            grads = {k: g.redistribute(placements=state.params[k].placements)
                     for k, g in grads.items()}

        err_fb = state.err_fb
        if grad_compress:
            grads, err_fb = gradcomp.compress_tree(grads, err_fb)

        params, opt, opt_metrics = apply_updates(state.params, grads,
                                                 state.opt, opt_cfg)
        return TrainState(params, opt, err_fb), {**metrics, **opt_metrics}

    return step


def jit_train_step(cfg: ModelConfig, opt_cfg: OptConfig, mesh,
                   state_shape: TrainState, batch_shape: Dict, *,
                   remat: bool = True, grad_compress: bool = False,
                   microbatches: int = 1, donate: bool = True):
    """The mesh step with explicit in/out shardings, the reference's
    ``jax.jit(step, in_shardings=, out_shardings=)``, run eagerly: the
    state and batch are placed by :func:`state_shardings` and
    :func:`batch_shardings` on entry (plain tensors holding the global
    values, or DTensors), the new state is placed by them on exit, and the
    metrics come back as plain 0-d tensors, the same on every rank.
    ``donate`` is accepted and does nothing: the eager step frees the old
    state's tensors when the caller drops them."""
    del donate
    step = make_train_step(cfg, opt_cfg, mesh=mesh, tp_total=tp_size(mesh),
                           remat=remat, grad_compress=grad_compress,
                           microbatches=microbatches)
    st_sh = state_shardings(cfg, state_shape, mesh)
    b_sh = batch_shardings(batch_shape, mesh)

    def run(state: TrainState, batch: Dict[str, torch.Tensor]):
        state = place_tree(state, st_sh)
        batch = {k: b_sh[k].place(v) for k, v in batch.items()}
        new, metrics = step(state, batch)
        return place_tree(new, st_sh), {k: _global(v)
                                         for k, v in metrics.items()}

    return run


def _global(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def train_state_from_jax(state_np, cfg: ModelConfig,
                         device: DeviceLike) -> TrainState:
    """A reference ``TrainState`` whose leaves are numpy arrays (bf16 ones
    ``ml_dtypes`` arrays) -> a :class:`TrainState` on ``device``, bit for
    bit: the parameters through ``params_from_jax``, the f32 moments, the
    int32 count and the bf16 error-feedback residuals."""
    dev = resolve_device(device)
    params = params_from_jax(state_np.params, cfg, dev)
    opt = state_np.opt

    def moments(tree: Mapping[str, np.ndarray], what: str):
        if set(tree) != set(params):
            raise ValueError(f"{what} names do not match the parameters")
        return {k: tensor_from_numpy(f"{what}/{k}", np.asarray(tree[k]),
                                     torch.float32).to(dev)
                for k in params}

    count = np.asarray(opt.count)
    if count.dtype != np.int32 or count.shape != ():
        raise ValueError(f"count: {count.dtype} {count.shape}, expected a "
                         "0-d int32")
    err = None
    if state_np.err_fb is not None:
        err = {k: tensor_from_numpy(f"err_fb/{k}",
                                    np.asarray(state_np.err_fb[k]),
                                    torch.bfloat16).to(dev)
               for k in params}
    return TrainState(params=params,
                      opt=OptState(mu=moments(opt.mu, "mu"),
                                   nu=moments(opt.nu, "nu"),
                                   count=torch.from_numpy(count.copy()).to(dev)),
                      err_fb=err)
