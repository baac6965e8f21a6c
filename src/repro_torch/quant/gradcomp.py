"""int8 gradient compression with error feedback (counterpart of
``repro.quant.gradcomp``): the paper's precision scaling applied to the
training-time collective.

Gradients are quantized to int8 (per-tensor symmetric scale) before the
data-parallel all-reduce and dequantized after; the quantization residual
is carried in a bf16 error-feedback buffer, so the compression is unbiased
over time.  On one device there is no all-reduce: the step applies the
quantize-dequantize round trip and the residual, as the reference's
single-device step does.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def init_error_state(grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=torch.bfloat16, device=v.device)
            for k, v in grads.items()}


def _q_int8(x: torch.Tensor):
    """-> (int8 codes, f32 scale); ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    s = torch.clamp(torch.max(torch.abs(x)), min=1e-8) / 127.0
    c = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return c, s


def compress_decompress(g: torch.Tensor, err: torch.Tensor):
    """Quantize ``g + err`` to int8 -> (dequantized in g's dtype, new bf16
    residual)."""
    x = g.to(torch.float32) + err.to(torch.float32)
    c, s = _q_int8(x)
    deq = c.to(torch.float32) * s
    return deq.to(g.dtype), (x - deq).to(torch.bfloat16)


def compress_tree(grads: Dict[str, torch.Tensor],
                  err: Dict[str, torch.Tensor]
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    new_g, new_e = {}, {}
    for k, g in grads.items():
        new_g[k], new_e[k] = compress_decompress(g, err[k])
    return new_g, new_e
