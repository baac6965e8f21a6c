"""Family dispatch: one API over decoder-only / enc-dec / vlm models
(counterpart of ``repro.runtime.model_api``).

``batch`` dicts:
  LM:        {tokens (B,S), labels (B,S)}
  audio:     {tokens, labels, frames (B, enc_seq, d)}
  vlm:       {tokens, labels, patches (B, n_patches, d)}

``loss_fn`` waits for the training slice (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, transformer


def forward_logits(params, batch: Dict, cfg: ModelConfig):
    if cfg.family == "audio":
        return encdec.forward(params, batch["tokens"], batch["frames"], cfg)
    return transformer.forward(params, batch["tokens"], cfg,
                               patch_embeds=batch.get("patches"))


def init_decode_state(params, batch: Dict, cfg: ModelConfig, batch_size: int,
                      seq_len: int, dtype: torch.dtype = torch.bfloat16):
    """The empty decode state, on the device the parameters live on (for the
    encoder-decoder: the encoder run on ``batch["frames"]``)."""
    if cfg.family == "audio":
        return encdec.init_decode_state(params, batch["frames"], cfg,
                                        batch_size, seq_len, dtype)
    return transformer.init_decode_state(cfg, batch_size, seq_len, dtype,
                                         params["embed/table"].device)


def decode_step(params, tokens, state, cfg: ModelConfig):
    if cfg.family == "audio":
        return encdec.decode_step(params, tokens, state, cfg)
    return transformer.decode_step(params, tokens, state, cfg)
