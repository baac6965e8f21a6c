"""Plain PyTorch versions of the direct depthwise conv (counterpart of
``repro.kernels.qconv_dw.ref``).

The specification the CUDA kernel ``csrc/qconv_dw.cu`` is held to, bit for
bit, in both modes: the ``kh*kw`` shifted-window products summed in tap
order (dy-major, then dx) — in the code domain over int8 activation codes
(exact in f32 for any real window), or in f32 over float activations, each
product and sum rounded on its own — the per-channel scale applied once
after the window sum, then the shared epilogue of
:mod:`repro_torch.kernels.qmatmul.ref`.
Also home to the canonical spatial padding math (XLA's SAME/VALID), shared
with the writers' im2col and the float reference conv, and to
:func:`expand_dw_codes`, the dense block-diagonal weights of the im2col
depthwise baseline.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.qmatmul.ref import (ActQt, epilogue_code_ref,
                                             epilogue_ref, exact_in_f32)
from repro_torch.quant.ptq import derive_view

__all__ = ["pad_amounts", "normalize_pads", "out_spatial", "expand_dw_codes",
           "qconv_dw_ref", "qconv_dw_int8_act_ref", "ActQt"]


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


def expand_dw_codes(codes: torch.Tensor) -> torch.Tensor:
    """Depthwise HWIO codes (kh, kw, 1, C) -> the block-diagonal dense
    (kh*kw*C, C) matrix the im2col + qgemm baseline consumes, on the codes'
    device and in their dtype.

    Row ``pos*C + cin`` holds the weight of patch position ``pos`` (dy-major,
    then dx) and input channel ``cin`` for every output channel: zero except
    at ``cin == cout``, matching the writer's im2col patch layout.  Nested
    truncation maps zeros to zeros, so the ``bits``-bit view of the expansion
    is the expansion of the ``bits``-bit view."""
    kh, kw, one, c = codes.shape
    if one != 1:
        raise ValueError(f"depthwise codes must be (kh, kw, 1, C), got "
                         f"{tuple(codes.shape)}")
    eye = torch.eye(c, dtype=codes.dtype, device=codes.device)
    k2 = codes.reshape(kh * kw, c)
    return (k2[:, None, :] * eye[None, :, :]).reshape(kh * kw * c, c)


def _pad_nhwc(x: torch.Tensor, hpad, wpad) -> torch.Tensor:
    return F.pad(x, (0, 0, wpad[0], wpad[1], hpad[0], hpad[1]))


def _accumulate(xp: torch.Tensor, wmat: torch.Tensor, oh: int, ow: int,
                kh: int, kw: int, strides) -> torch.Tensor:
    """The kernel-ordered window sum: xp (B, Hp, Wp, C) padded input, wmat
    (kh*kw, C) per-tap weights, both of one dtype -> (B, oh, ow, C)."""
    sh, sw = strides
    acc = torch.zeros((xp.shape[0], oh, ow, xp.shape[3]), dtype=xp.dtype,
                      device=xp.device)
    for dy in range(kh):
        for dx in range(kw):
            seg = xp[:, dy:dy + sh * (oh - 1) + 1:sh,
                     dx:dx + sw * (ow - 1) + 1:sw, :]
            acc = acc + seg * wmat[dy * kw + dx].reshape(1, 1, 1, -1)
    return acc


def qconv_dw_ref(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, kh: int, kw: int,
                 strides=(1, 1), pads="SAME", bits: int = 8,
                 relu: bool = False, act_qt: Optional[ActQt] = None,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Float-activation depthwise conv over the ``bits``-bit code view:
    x (B, H, W, C) float, codes (kh*kw, C) int8 master tap rows, scale (C,)
    f32.  The x * code products are summed in f32 and the scale applied once
    after the window sum (the kernel's order, not dequant-first), then the
    shared epilogue."""
    B, H, W, C = x.shape
    oh, ow, hpad, wpad = out_spatial(H, W, kh, kw, strides, pads)
    xp = _pad_nhwc(x.to(torch.float32), hpad, wpad)
    wmat = derive_view(codes, bits).to(torch.float32)
    acc = _accumulate(xp, wmat, oh, ow, kh, kw, strides)
    y = acc * scale.reshape(1, 1, 1, -1).to(torch.float32)
    if bias is not None:
        y = y + bias.reshape(1, 1, 1, -1).to(torch.float32)
    return epilogue_ref(y, relu, act_qt).to(out_dtype)


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
    oh, ow, hpad, wpad = out_spatial(H, W, kh, kw, strides, pads)
    wmat = derive_view(codes, bits)
    dt = torch.float32 if exact_in_f32(kh * kw) else torch.float64
    xp = _pad_nhwc(x_codes.to(dt), hpad, wpad)
    acc = _accumulate(xp, wmat.to(dt), oh, ow, kh, kw,
                      strides).to(torch.float32)
    y = acc * (scale.reshape(1, 1, 1, -1).to(torch.float32) * float(x_scale))
    if bias is not None:
        y = y + bias.reshape(1, 1, 1, -1).to(torch.float32)
    if out_code:
        if act_qt is None:
            raise ValueError("out_code needs the output act_qt")
        return epilogue_code_ref(y, relu, act_qt).to(torch.int8)
    return epilogue_ref(y, relu, act_qt).to(out_dtype)
