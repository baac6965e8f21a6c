"""Post-training quantization (counterpart of ``repro.quant.ptq``).

The Table II fixed-point path (:func:`quantize_tree_fixed` for the weights
of a ``Dx-Wy`` point, :class:`ActQuant` for the activations, from ranges
:func:`calibrate_acts` records), the int8 master-code rule
(:func:`quantize_channelwise`), the nested W4/W2 views
(:func:`derive_view`), the per-FIFO activation-code qtypes
(:func:`act_code_scales`), the graph weight statistics, and the MDC
substrate — a parameter tree quantized once
to int8 master codes (:class:`QuantizedParams`,
:func:`quantize_tree_native`) whose working points are dequantized views
(:func:`dequantize_tree`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import as_tensor
from repro_torch.quant.fixedpoint import fake_quant, zero_fraction
from repro_torch.quant.qtypes import DatatypeConfig, QType, fixed_for_range

# parameters that stay in high precision (norms, scalar gains, recurrence)
_SKIP_SUFFIXES = ("norm/w", "norm_w", "A_log", "dt_bias", "/D", "/b", "bias",
                  "/mean", "/var", "/scale", "bq", "bk", "bv", "b_up", "b_down",
                  "enc_pos", "dec_pos")


def is_quantizable(path: str, arr) -> bool:
    return arr.ndim >= 2 and not any(path.endswith(s) for s in _SKIP_SUFFIXES)


def weight_qtype(w, bits: int) -> QType:
    if bits >= 32:
        return QType(32, None)
    return fixed_for_range(bits, float(as_tensor(w).abs().max()))


def effective_weight_dt(graph, init_name: str,
                        default_dt: Optional[DatatypeConfig] = None
                        ) -> Optional[DatatypeConfig]:
    """The per-layer datatype governing an initializer: its (first) consumer
    node's ``Node.dtconfig``, falling back to ``default_dt``."""
    users = graph.consumer_index().get(init_name, [])
    if users and users[0].dtconfig is not None:
        return users[0].dtconfig
    return default_dt


def graph_weight_stats(graph, default_dt: Optional[DatatypeConfig] = None
                       ) -> Dict[str, float]:
    """Zero-weight fraction of an IR graph under per-layer precision (the
    Table II "Zero weights" column)."""
    zeros, total = 0.0, 0
    for name, arr in graph.initializers.items():
        if arr.ndim < 2:
            continue
        dt = effective_weight_dt(graph, name, default_dt)
        w = as_tensor(np.asarray(arr))
        qt = weight_qtype(w, dt.weight_bits if dt else 32)
        zeros += float(zero_fraction(w, qt)) * arr.size
        total += arr.size
    return {"zero_weight_frac": zeros / max(total, 1)}


def quantize_tree_fixed(params: Dict[str, torch.Tensor], dt: DatatypeConfig
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """Fake-quantize the quantizable weights to Wy (each on the Qm.n grid
    its own max |w| picks); everything else, and every weight at 32 bits,
    passes through.  Returns (new params, stats): ``zero_weight_frac`` over
    the quantized weights alone."""
    out, zeros, total = {}, 0.0, 0
    for path, w in params.items():
        w = as_tensor(w)
        if is_quantizable(path, w) and dt.weight_bits < 32:
            qt = weight_qtype(w, dt.weight_bits)
            out[path] = fake_quant(w, qt)
            zeros += float(zero_fraction(w, qt)) * w.numel()
            total += w.numel()
        else:
            out[path] = w
    return out, {"zero_weight_frac": zeros / max(total, 1)}


@dataclass
class ActQuant:
    """Runtime activation quantizer for Dx (calibrated per site)."""
    bits: int
    ranges: Dict[str, float]    # site name -> calibrated max |act|

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.bits >= 32:
            return x
        qt = fixed_for_range(self.bits, self.ranges.get(name, 8.0))
        return fake_quant(x, qt)


def calibrate_acts(capture_fn: Callable[[], Dict[str, torch.Tensor]]
                   ) -> Dict[str, float]:
    """``capture_fn`` runs the model on a calibration batch and returns named
    intermediate activations; returns each site's max |x|."""
    return {k: float(as_tensor(v).abs().max()) for k, v in capture_fn().items()}


def top1_agreement(logits, ref) -> float:
    """Fraction of rows whose argmax matches the float reference's."""
    a, b = as_tensor(logits), as_tensor(ref)
    return float((a.argmax(-1).cpu() == b.argmax(-1).cpu())
                 .to(torch.float32).mean())


def act_code_qtype(bits: int, act_range: float) -> QType:
    """The integer-code qtype of one activation FIFO: a power-of-two scale
    (``2^-frac``) sized so the calibrated range fits ``min(bits, 8)`` signed
    integers."""
    return fixed_for_range(min(bits, 8), act_range)


def act_code_scales(act_ranges: Dict[str, float], bits: int = 8
                    ) -> Dict[str, QType]:
    """Per-FIFO activation-code qtypes from calibrated ranges."""
    return {name: act_code_qtype(bits, r) for name, r in act_ranges.items()}


def _channel_scale(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel scale; channel = last dim."""
    m = torch.amax(w.to(torch.float32).abs(), dim=tuple(range(w.ndim - 1)),
                   keepdim=True)
    return torch.clamp_min(m, 1e-8) / 127.0


def quantize_channelwise(w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 master codes, per-out-channel f32 scale) — THE master-code rule,
    computed on the tensor's device."""
    w = as_tensor(w)
    s = _channel_scale(w)
    codes = torch.clamp(torch.round(w.to(torch.float32) / s),
                        -127, 127).to(torch.int8)
    return codes, s.to(torch.float32)


def derive_view(code_i8: torch.Tensor, bits: int) -> torch.Tensor:
    """Nested truncation: int8 master -> effective int-``bits`` codes, still in
    int8 domain (granularity 2^(8-bits)); shares the master's scale."""
    if bits >= 8:
        return code_i8
    step = 1 << (8 - bits)
    q = torch.clamp(torch.round(code_i8.to(torch.float32) / step),
                    -(2 ** (bits - 1)), 2 ** (bits - 1) - 1)
    return (q * step).to(torch.int8)


def dequant(code_i8: torch.Tensor, scale: torch.Tensor, bits: int = 8,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (derive_view(code_i8, bits).to(torch.float32) * scale).to(dtype)


# ---------------------------------------------------------------------------
# The MDC substrate: one int8 master tree, working points derived on read
# ---------------------------------------------------------------------------

@dataclass
class QuantizedParams:
    """int8 master codes + per-channel scales; low-bit views derived on read."""
    codes: Dict[str, torch.Tensor]        # int8, same shape as the weight
    scales: Dict[str, torch.Tensor]       # f32, broadcastable (per out-channel)
    passthrough: Dict[str, torch.Tensor]  # unquantized params (norms, biases)
    bits: int = 8                         # active working point (8 / 4 / 2)

    def tree(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"codes": self.codes, "scales": self.scales,
                "passthrough": self.passthrough}


def quantize_tree_native(params: Dict[str, torch.Tensor],
                         quant_embeddings: bool = False) -> QuantizedParams:
    """Quantize every quantizable parameter once to int8 master codes with
    the per-channel rule; the rest (1-D params, norms, and unless
    ``quant_embeddings`` the ``embed/`` and ``lm_head/`` tables) passes
    through."""
    codes, scales, passthrough = {}, {}, {}
    for path, w in params.items():
        w = as_tensor(w)
        quantize = is_quantizable(path, w)
        if not quant_embeddings and path.startswith(("embed/", "lm_head/")):
            quantize = False
        if quantize:
            codes[path], scales[path] = quantize_channelwise(w)
        else:
            passthrough[path] = w
    return QuantizedParams(codes, scales, passthrough)


def dequantize_tree(qp: QuantizedParams, bits: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, torch.Tensor]:
    """The working point's parameter tree: every master code dequantized at
    its ``bits``-bit view in ``dtype``; passthrough params as they are."""
    b = qp.bits if bits is None else bits
    out = dict(qp.passthrough)
    for path, c in qp.codes.items():
        out[path] = dequant(c, qp.scales[path], b, dtype)
    return out


def quant_memory_bytes(qp: QuantizedParams, bits: int,
                       packed: bool = True) -> int:
    """Weight-storage footprint at a working point (packed sub-byte storage)."""
    per_val = bits / 8.0 if packed else 1.0
    n_q = sum(c.numel() for c in qp.codes.values())
    n_s = sum(s.numel() * 4 for s in qp.scales.values())
    n_p = sum(p.numel() * p.element_size() for p in qp.passthrough.values())
    return int(n_q * per_val) + n_s + n_p
