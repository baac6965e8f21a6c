"""Family dispatch: one API over the LM families (counterpart of
``repro.runtime.model_api``).

``batch`` dicts:
  LM:        {tokens (B,S), labels (B,S)}
  audio:     {tokens, labels, frames (B, enc_seq, d)}  — not ported yet
  vlm:       {tokens, labels, patches (B, n_patches, d)}  — not ported yet

``loss_fn`` waits for the training slice (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _no_audio(cfg: ModelConfig) -> None:
    if cfg.family == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (audio) family waits in ROADMAP "
            f"Queue 1 (the LM side)")


def forward_logits(params, batch: Dict, cfg: ModelConfig):
    _no_audio(cfg)
    return transformer.forward(params, batch["tokens"], cfg,
                               patch_embeds=batch.get("patches"))


def init_decode_state(params, batch: Dict, cfg: ModelConfig, batch_size: int,
                      seq_len: int, dtype: torch.dtype = torch.bfloat16):
    """The empty decode state, on the device the parameters live on."""
    _no_audio(cfg)
    return transformer.init_decode_state(cfg, batch_size, seq_len, dtype,
                                         params["embed/table"].device)


def decode_step(params, tokens, state, cfg: ModelConfig):
    _no_audio(cfg)
    return transformer.decode_step(params, tokens, state, cfg)
