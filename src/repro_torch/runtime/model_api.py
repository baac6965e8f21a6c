"""Family dispatch: one API over decoder-only / enc-dec / vlm models
(counterpart of ``repro.runtime.model_api``).

``batch`` dicts:
  LM:        {tokens (B,S), labels (B,S)}
  audio:     {tokens, labels, frames (B, enc_seq, d)}
  vlm:       {tokens, labels, patches (B, n_patches, d)}

``loss_fn`` is the training objective: the masked cross-entropy over the
real vocab plus the MoE auxiliaries.  ``mesh``/``tp_total`` pass through to
the models (DTensor parameters and batch on a device mesh).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.common import cross_entropy
from repro_torch.sharding import mesh_scope


def forward_logits(params, batch: Dict, cfg: ModelConfig, *, mesh=None,
                   tp_total: int = 1, remat: bool = False, ssd_kernel=None):
    """-> (logits (B, S, Vp), aux).  ``remat`` checkpoints every layer;
    ``ssd_kernel`` is ``transformer.forward``'s (None: the scan kernel on a
    CUDA tensor, False: the oracle)."""
    if cfg.family == "audio":
        return encdec.forward(params, batch["tokens"], batch["frames"], cfg,
                              mesh=mesh, tp_total=tp_total, remat=remat)
    return transformer.forward(params, batch["tokens"], cfg, mesh=mesh,
                               tp_total=tp_total,
                               patch_embeds=batch.get("patches"),
                               remat=remat, ssd_kernel=ssd_kernel)


def loss_fn(params, batch: Dict, cfg: ModelConfig, *, mesh=None,
            tp_total: int = 1, remat: bool = False, lb_coef: float = 0.01,
            z_coef: float = 1e-3
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (loss, metrics {loss, ce, lb_loss, z_loss}): ``ce +
    lb_coef*lb_loss + z_coef*z_loss``.  The SSM scan takes the oracle
    (the scan kernel has no backward), as the reference's training does."""
    with mesh_scope(mesh):
        logits, aux = forward_logits(params, batch, cfg, mesh=mesh,
                                     tp_total=tp_total, remat=remat,
                                     ssd_kernel=False)
        ce = cross_entropy(logits, batch["labels"], cfg.vocab, mesh)
        loss = ce + lb_coef * aux["lb_loss"] + z_coef * aux["z_loss"]
    metrics = {"loss": loss, "ce": ce, **aux}
    return loss, metrics


def init_decode_state(params, batch: Dict, cfg: ModelConfig, batch_size: int,
                      seq_len: int, dtype: torch.dtype = torch.bfloat16):
    """The empty decode state, on the device the parameters live on (for the
    encoder-decoder: the encoder run on ``batch["frames"]``)."""
    if cfg.family == "audio":
        return encdec.init_decode_state(params, batch["frames"], cfg,
                                        batch_size, seq_len, dtype)
    return transformer.init_decode_state(cfg, batch_size, seq_len, dtype,
                                         params["embed/table"].device)


def decode_step(params, tokens, state, cfg: ModelConfig, *, mesh=None,
                tp_total: int = 1, donate: bool = False):
    """One decode step -> (logits, new state).  ``donate`` (the reference's
    ``donate_argnums`` on the state) writes the new state into ``state``'s
    own tensors and returns them; without it the step writes into a copy,
    and ``state`` is left as it was."""
    if cfg.family == "audio":
        return encdec.decode_step(params, tokens, state, cfg, mesh=mesh,
                                  tp_total=tp_total, donate=donate)
    return transformer.decode_step(params, tokens, state, cfg, mesh=mesh,
                                   tp_total=tp_total, donate=donate)
