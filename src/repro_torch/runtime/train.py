"""Train step factory (counterpart of ``repro.runtime.train``).

One device: remat, gradient accumulation over microbatches, optional int8
gradient compression with error feedback, then AdamW.  The step is
functional, as the reference's jitted step is: it returns new tensors and
never writes to the state it was given, which the fault-tolerant loop's
restart relies on.  The mesh path (``state_shardings``,
``batch_shardings``, ``jit_train_step`` and ``make_train_step(mesh=...)``)
waits with the distributed writer, ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import params_from_jax, tensor_from_numpy
from repro_torch.optim.adamw import (OptConfig, OptState, apply_updates,
                                     init_opt_state)
from repro_torch.quant import gradcomp
from repro_torch.runtime.model_api import loss_fn


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: OptState
    err_fb: Optional[Dict[str, torch.Tensor]]  # gradient-compression residuals


def init_train_state(params: Dict[str, torch.Tensor],
                     grad_compress: bool = False) -> TrainState:
    err = gradcomp.init_error_state(params) if grad_compress else None
    return TrainState(params=params, opt=init_opt_state(params), err_fb=err)


def _grads_of(params: Dict[str, torch.Tensor], batch, cfg: ModelConfig,
              remat: bool):
    """-> (metrics, grads): the gradient of ``loss_fn`` with respect to every
    parameter, in the parameter's dtype (zeros for one the loss does not
    reach, as ``jax.grad`` gives), from leaves detached from ``params``."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, metrics = loss_fn(leaves, batch, cfg, remat=remat)
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
    port's layer and microbatch loops are Python loops already.  ``mesh``
    and ``tp_total`` > 1 raise ``NotImplementedError``: the sharded step
    waits with the distributed writer (ROADMAP Queue 1 item 6)."""
    if mesh is not None or tp_total != 1:
        raise NotImplementedError(
            "make_train_step runs on one device; the mesh path (mesh=, "
            "tp_total > 1, state_shardings, batch_shardings, jit_train_step) "
            "waits with the distributed writer, ROADMAP Queue 1 item 6")
    del unroll

    def step(state: TrainState, batch: Dict[str, torch.Tensor]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if microbatches > 1:
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in state.params.items()}
            for i in range(microbatches):
                mb = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                metrics, g = _grads_of(state.params, mb, cfg, remat)
                grads = {k: grads[k] + g[k] / microbatches for k in grads}
        else:
            metrics, grads = _grads_of(state.params, batch, cfg, remat)

        err_fb = state.err_fb
        if grad_compress:
            grads, err_fb = gradcomp.compress_tree(grads, err_fb)

        params, opt, opt_metrics = apply_updates(state.params, grads,
                                                 state.opt, opt_cfg)
        return TrainState(params, opt, err_fb), {**metrics, **opt_metrics}

    return step


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
