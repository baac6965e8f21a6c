"""Fixed-point (Qm.n) arithmetic (counterpart of ``repro.quant.fixedpoint``).

Fake-quantization keeps values on the exact 2^-frac grid in f32.  Rounding is
half to even: ``torch.round`` rounds like ``jnp.round``."""
from __future__ import annotations

import torch

from repro_torch.quant.qtypes import QType


def quantize(x: torch.Tensor, qt: QType) -> torch.Tensor:
    """Round to the Qm.n grid and saturate.  Returns the *integer code* (f32)."""
    if qt.is_float:
        return x
    inv = 2.0 ** qt.frac
    code = torch.round(x.to(torch.float32) * inv)
    return torch.clamp(code, qt.qmin, qt.qmax)


def dequantize(code: torch.Tensor, qt: QType) -> torch.Tensor:
    if qt.is_float:
        return code
    return code * qt.scale


def fake_quant(x: torch.Tensor, qt: QType) -> torch.Tensor:
    """x -> nearest representable Qm.n value (straight-through estimator grad)."""
    if qt.is_float:
        return x
    y = dequantize(quantize(x, qt), qt)
    return x + (y - x).detach()


def quant_error(x: torch.Tensor, qt: QType) -> torch.Tensor:
    """The largest |fake_quant(x) - x|."""
    return (fake_quant(x, qt) - x).abs().max()


def zero_fraction(x: torch.Tensor, qt: QType) -> torch.Tensor:
    """Fraction of values that quantize to exactly 0 (Table II 'Zero-weights')."""
    if qt.is_float:
        return (x == 0).to(torch.float32).mean()
    return (quantize(x, qt) == 0).to(torch.float32).mean()
