"""AdamW with cosine schedule, global-norm clipping and f32 moments
(counterpart of ``repro.optim.adamw``).

Plain functions over flat dicts of tensors (the layout of
``repro_torch.models.params``), in the reference's order of operations, so
one state steps the same way in both packages.  ``torch.optim.AdamW`` is
not used: its update order and bias correction round differently.  The
moments' ZeRO-1 layout on a device mesh is placed by
``runtime.train.state_shardings``; the update itself runs on whatever the
tensors are (DTensors on a mesh).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    mu: Dict[str, torch.Tensor]    # f32, like the parameters
    nu: Dict[str, torch.Tensor]    # f32
    count: torch.Tensor            # () int32: updates applied


def init_opt_state(params: Dict[str, torch.Tensor]) -> OptState:
    """Zero f32 moments beside each parameter, a zero int32 count on the
    parameters' device."""
    dev = next(iter(params.values())).device
    return OptState(
        mu={k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()},
        nu={k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then cosine down to ``min_lr_frac * lr``,
    as an f32 tensor; ``step`` is an int or an integer tensor."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree.values()))


_NO_DECAY = ("norm/w", "norm_w", "/b", "bias", "A_log", "dt_bias", "/D",
             "bq", "bk", "bv", "b_up", "b_down")


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state: OptState,
                  cfg: OptConfig
                  ) -> Tuple[Dict[str, torch.Tensor], OptState,
                             Dict[str, torch.Tensor]]:
    """One AdamW step -> (new params, new state, {grad_norm, lr}).  New
    tensors throughout: the arguments are left as they were.  The clip
    scale, the f32 bias corrections ``1 - b**count`` and the decay test
    (a path suffix in ``_NO_DECAY`` skips it) follow the reference; each
    parameter is updated in f32 and cast back to its dtype."""
    count = state.count + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-6), max=1.0)
    lr = schedule(cfg, count)
    b1, b2 = cfg.betas
    bc1 = 1 - b1 ** count.to(torch.float32)
    bc2 = 1 - b2 ** count.to(torch.float32)

    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * g * g
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        if cfg.weight_decay > 0 and not any(k.endswith(s) for s in _NO_DECAY):
            upd = upd + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * upd).to(p.dtype)
        new_mu[k], new_nu[k] = mu, nu
    metrics = {"grad_norm": gn, "lr": lr}
    return new_p, OptState(new_mu, new_nu, count), metrics
