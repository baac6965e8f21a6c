"""Plain PyTorch version of the fully-integer direct depthwise conv
(counterpart of ``repro.kernels.qconv_dw.ref``).

The specification the CUDA kernel ``csrc/qconv_dw.cu`` is held to, bit for
bit: the ``kh*kw`` shifted-window products summed in the code domain (exact
in f32 for any real window), the per-channel scale applied once after the
window sum, then the shared epilogue of :mod:`repro_torch.kernels.qmatmul.ref`.
Also home to the canonical spatial padding math (XLA's SAME/VALID), shared
with the writers' im2col and the float reference conv.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.qmatmul.ref import (ActQt, epilogue_code_ref,
                                             epilogue_ref, exact_in_f32)
from repro_torch.quant.ptq import derive_view

__all__ = ["pad_amounts", "normalize_pads", "out_spatial",
           "qconv_dw_int8_act_ref", "ActQt"]


def pad_amounts(size: int, k: int, s: int, pads) -> Tuple[int, Tuple[int, int]]:
    """(out_dim, (lo, hi)) for one spatial dim — matches XLA's SAME/VALID."""
    if pads == "SAME":
        o = -(-size // s)
        pad = max((o - 1) * s + k - size, 0)
        return o, (pad // 2, pad - pad // 2)
    if pads == "VALID":
        return (size - k) // s + 1, (0, 0)
    lo, hi = pads
    return (size + lo + hi - k) // s + 1, (int(lo), int(hi))


def normalize_pads(pads):
    """Canonical *hashable* padding spec: ``"SAME"`` / ``"VALID"`` pass
    through; explicit pads normalize to ``((top, bottom), (left, right))``
    from either that pair-of-pairs form or the flat ONNX ``[t, l, b, r]``."""
    if isinstance(pads, str):
        return pads
    p = list(pads)
    if len(p) == 4 and not hasattr(p[0], "__len__"):
        t, l, b, r = (int(v) for v in p)
        return ((t, b), (l, r))
    return tuple((int(lo), int(hi)) for lo, hi in p)


def _split_pads(pads):
    if isinstance(pads, str):
        return pads, pads
    return pads[0], pads[1]


def out_spatial(h: int, w: int, kh: int, kw: int, strides, pads
                ) -> Tuple[int, int, Tuple[int, int], Tuple[int, int]]:
    """(OH, OW, (ph_lo, ph_hi), (pw_lo, pw_hi)) for a conv window."""
    ph, pw = _split_pads(normalize_pads(pads))
    oh, hpad = pad_amounts(h, kh, strides[0], ph)
    ow, wpad = pad_amounts(w, kw, strides[1], pw)
    return oh, ow, hpad, wpad


def _pad_nhwc(x: torch.Tensor, hpad, wpad) -> torch.Tensor:
    return F.pad(x, (0, 0, wpad[0], wpad[1], hpad[0], hpad[1]))


def qconv_dw_int8_act_ref(x_codes: torch.Tensor, x_scale: float,
                          codes: torch.Tensor, scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None, *,
                          kh: int, kw: int, strides=(1, 1), pads="SAME",
                          bits: int = 8, relu: bool = False,
                          act_qt: Optional[ActQt] = None,
                          out_code: bool = False,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fully-integer depthwise conv oracle: x_codes (B, H, W, C) int8, codes
    (kh*kw, C) int8 master tap rows, the scalar power-of-two producer scale
    folded into the per-channel weight scale, integer window accumulation
    and the shared requant epilogue.  ``out_code=True`` returns int8 codes."""
    B, H, W, C = x_codes.shape
    sh, sw = strides
    oh, ow, hpad, wpad = out_spatial(H, W, kh, kw, strides, pads)
    wmat = derive_view(codes, bits)
    dt = torch.float32 if exact_in_f32(kh * kw) else torch.float64
    xp = _pad_nhwc(x_codes.to(dt), hpad, wpad)
    wf = wmat.to(dt)
    acc = torch.zeros((B, oh, ow, C), dtype=dt, device=x_codes.device)
    for dy in range(kh):
        for dx in range(kw):
            seg = xp[:, dy:dy + sh * (oh - 1) + 1:sh,
                     dx:dx + sw * (ow - 1) + 1:sw, :]
            acc = acc + seg * wf[dy * kw + dx].reshape(1, 1, 1, -1)
    acc = acc.to(torch.float32)
    y = acc * (scale.reshape(1, 1, 1, -1).to(torch.float32) * float(x_scale))
    if bias is not None:
        y = y + bias.reshape(1, 1, 1, -1).to(torch.float32)
    if out_code:
        if act_qt is None:
            raise ValueError("out_code needs the output act_qt")
        return epilogue_code_ref(y, relu, act_qt).to(torch.int8)
    return epilogue_ref(y, relu, act_qt).to(out_dtype)
