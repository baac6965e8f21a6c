"""Plain PyTorch versions of the quantized matmul (counterpart of
``repro.kernels.qmatmul.ref``).

The fully-integer oracle :func:`qmatmul_int8_act_ref` is the specification
the CUDA kernel ``csrc/qgemm.cu`` is held to, bit for bit: integer
accumulation, then ``acc * s_eff`` (or ``acc * xs[m] * s[n]`` with a per-row
activation scale), then ``+ bias``, each rounded on its own (never fused into
one fma), then ReLU and the fixed-point requant with round-half-even.  They
run on any device: torch has no int32 matmul on CUDA, so :func:`int_dot`
computes in f32 where that is provably exact and in f64 otherwise — exact
either way.  The float-activation oracles :func:`qgemm_ref` and
:func:`qmatmul_ref` dequantize first and then take the f32 dot (the kernel
sums x * code and scales after, so the two agree to f32 rounding, not bit
for bit).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.quant.ptq import derive_view

# static spec of the fused activation quant: (frac, qmin, qmax)
ActQt = Tuple[int, int, int]


def epilogue_code_ref(y: torch.Tensor, relu: bool,
                      act_qt: ActQt) -> torch.Tensor:
    """ReLU + fixed-point quantization, returning the *integer code* (still
    f32: ``clip(round(y * 2^frac))``) — round-half-even + saturate, identical
    to ``fixedpoint.quantize``."""
    if relu:
        y = torch.clamp_min(y, 0.0)
    frac, qmin, qmax = act_qt
    return torch.clamp(torch.round(y * (2.0 ** frac)), qmin, qmax)


def epilogue_ref(y: torch.Tensor, relu: bool = False,
                 act_qt: Optional[ActQt] = None) -> torch.Tensor:
    """ReLU + fixed-point activation fake-quant (powers of two are exact)."""
    if act_qt is None:
        return torch.clamp_min(y, 0.0) if relu else y
    frac = act_qt[0]
    return epilogue_code_ref(y, relu, act_qt) * (2.0 ** -frac)


def exact_in_f32(k_dim: int) -> bool:
    """True when an integer dot over ``k_dim`` int8 codes is exact in f32:
    every product and partial sum stays below 2^24.  Activation codes reach
    -128 while weight codes are clipped to [-127, 127]."""
    return k_dim * 128 * 127 <= 2 ** 24


def int_dot(x_codes: torch.Tensor, w_codes: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul of code matrices on any device: f32 when provably
    exact, f64 otherwise (|sum| < 2^53 for any real K).  Returns f32 — the
    f64 -> f32 cast rounds to nearest even, as int32 -> f32 does."""
    dt = torch.float32 if exact_in_f32(x_codes.shape[-1]) else torch.float64
    return (x_codes.to(dt) @ w_codes.to(dt)).to(torch.float32)


def fold_scale(scale: torch.Tensor, x_scale: float, bits: int,
               packed: bool) -> torch.Tensor:
    """The per-channel scale the kernels apply: the weight scale times the
    power-of-two sub-byte step (packed fields hold ``view / step``) times the
    scalar power-of-two activation scale (1.0 where there is none, or where
    it is per row) — every factor a power of two but the first, so the fold
    is exact."""
    step = float(1 << (8 - bits)) if packed else 1.0
    return scale.reshape(-1).to(torch.float32) * (step * float(x_scale))


def qmatmul_ref(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                bits: int = 8, out_dtype: torch.dtype = torch.bfloat16
                ) -> torch.Tensor:
    """The dequant matmul's oracle: x (M, K) float times the dequantized
    ``bits``-bit view of the (K, N) int8 master codes, scale (N,) or (1, N)
    f32, in f32, cast to ``out_dtype``."""
    w = derive_view(codes, bits).to(torch.float32) * \
        scale.reshape(1, -1).to(torch.float32)
    return (x.to(torch.float32) @ w).to(out_dtype)


def qgemm_ref(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, bits: int = 8,
              relu: bool = False, act_qt: Optional[ActQt] = None,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Float-activation oracle: x (M, K) float times the dequantized
    ``bits``-bit view of the (K, N) int8 master codes, in f32 (TF32 stays
    off: PyTorch's default for matmuls), then bias and the fused epilogue."""
    w = derive_view(codes, bits).to(torch.float32) * \
        scale.reshape(1, -1).to(torch.float32)
    y = x.to(torch.float32) @ w
    if bias is not None:
        y = y + bias.reshape(1, -1).to(torch.float32)
    return epilogue_ref(y, relu, act_qt).to(out_dtype)


def qmatmul_int8_act_ref(x_codes: torch.Tensor, x_scale,
                         codes: torch.Tensor, scale: torch.Tensor,
                         bits: int = 8, bias: Optional[torch.Tensor] = None,
                         relu: bool = False, act_qt: Optional[ActQt] = None,
                         out_code: bool = False,
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fully-integer oracle: x_codes (M, K) int8.  A scalar power-of-two
    ``x_scale`` (a float or a one-element tensor) is folded into the
    per-channel weight scale before the accumulator multiply; a per-row
    ``(M,)`` tensor is applied to the accumulator first,
    ``acc * xs[m] * s[n]``.  Then the fused epilogue; ``out_code=True``
    returns the int8 code of the quantized output (``act_qt`` required)."""
    w = derive_view(codes, bits)
    acc = int_dot(x_codes, w)
    s = scale.reshape(1, -1).to(torch.float32)
    if isinstance(x_scale, torch.Tensor) and x_scale.numel() > 1:
        y = acc * x_scale.reshape(-1, 1).to(torch.float32) * s
    else:
        y = acc * (s * float(x_scale))
    if bias is not None:
        y = y + bias.reshape(1, -1).to(torch.float32)
    if out_code:
        if act_qt is None:
            raise ValueError("out_code needs the output act_qt")
        return epilogue_code_ref(y, relu, act_qt).to(torch.int8)
    return epilogue_ref(y, relu, act_qt).to(out_dtype)
