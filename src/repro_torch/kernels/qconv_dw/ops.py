"""Public entry points of the direct depthwise conv (counterpart of
``repro.kernels.qconv_dw.ops``).

Two entry points dispatch on the activation tensor's device:

* ``qconv_dw_int8_act`` — the fully-integer mode: a CUDA tensor launches
  ``csrc/qconv_dw.cu`` through :func:`qconv_dw`, a CPU tensor runs
  :func:`~repro_torch.kernels.qconv_dw.ref.qconv_dw_int8_act_ref`;
* ``qconv_dw_float`` — the float-activation mode (the reference's
  ``qconv_dw``): a CUDA tensor launches the kernel's f32 mode through
  :func:`qconv_dw_f32`, a CPU tensor runs
  :func:`~repro_torch.kernels.qconv_dw.ref.qconv_dw_ref`.

The kernel stages the unpadded (B, H, W, C) input in shared memory with the
SAME halo zero-filled, so the host makes none of the reference's padding and
reshape copies.  In this package :func:`qconv_dw` names the int8-mode launch
wrapper.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import check, load_kernels
from repro_torch.kernels.qconv_dw.ref import (ActQt, normalize_pads,
                                              out_spatial,
                                              qconv_dw_int8_act_ref,
                                              qconv_dw_ref)
from repro_torch.kernels.qmatmul.ops import (_bias_f32, _expect,
                                             check_epilogue, scalar_scale)
from repro_torch.kernels.qmatmul.ref import fold_scale
from repro_torch.quant.pack import unpack_rows

# split-row packing alignment for depthwise tap rows: a 3x3 window packs its
# 9 tap rows into 16, not the matmul path's 128
DW_PACK_ALIGN = 8

# the kernel stages a channel tile's taps in shared memory (MAX_TAPS in
# qconv_dw.cu)
MAX_TAPS = 64

__all__ = ["qconv_dw", "qconv_dw_f32", "qconv_dw_float",
           "qconv_dw_float_plain", "qconv_dw_int8_act",
           "qconv_dw_int8_act_plain", "DW_PACK_ALIGN", "ActQt"]


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor,
            s_eff: torch.Tensor, bias: Optional[torch.Tensor], *, kh: int,
            kw: int, strides: Tuple[int, int], pads, bits: int, packed: bool,
            relu: bool, act_qt: Optional[ActQt],
            out_code: bool) -> torch.Tensor:
    """Check the operands of either mode, allocate the output and launch the
    C entry point ``entry``; returns the output (empty when there is no
    work)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} launches the CUDA kernel; got a {dev} "
                         "tensor")
    if bits not in (8, 4, 2) or (packed and bits == 8):
        raise ValueError(f"unsupported bits={bits} (packed={packed})")
    taps = kh * kw
    if taps > MAX_TAPS:
        raise ValueError(f"window {kh}x{kw} exceeds {MAX_TAPS} taps")
    B, H, W, C = x.shape
    _expect(w, "w", torch.uint8 if packed else torch.int8, 2, dev)
    rows = w.shape[0]
    if w.shape[1] != C:
        raise ValueError(f"weight has {w.shape[1]} channels, input {C}")
    if packed and rows * (8 // bits) < taps:
        raise ValueError(f"packed tap rows {rows} (x{8 // bits}) do not cover "
                         f"the {taps}-tap window")
    if not packed and rows != taps:
        raise ValueError(f"weight tap rows {rows} != window size {taps}")
    _expect(s_eff, "s_eff", torch.float32, 1, dev)
    if s_eff.shape[0] != C:
        raise ValueError(f"s_eff has {s_eff.shape[0]} channels, expected {C}")
    if bias is not None:
        _expect(bias, "bias", torch.float32, 1, dev)
        if bias.shape[0] != C:
            raise ValueError(f"bias has {bias.shape[0]} channels, expected {C}")
    sh, sw = (int(v) for v in strides)
    oh, ow, (pt, _), (pl, _) = out_spatial(H, W, kh, kw, (sh, sw),
                                           normalize_pads(pads))
    out = torch.empty((B, oh, ow, C),
                      dtype=torch.int8 if out_code else torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    frac, qmin, qmax = act_qt if act_qt is not None else (0, 0, 0)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), w.data_ptr(), s_eff.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, W, C, oh, ow, kh, kw, sh, sw, pt, pl, bits, int(packed),
            rows if packed else taps, int(relu), int(act_qt is not None),
            int(out_code), qmin, qmax, 2.0 ** frac, 2.0 ** -frac, stream)
    check(rc, entry)
    return out


def qconv_dw(x_codes: torch.Tensor, w: torch.Tensor, s_eff: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *, kh: int, kw: int,
             strides: Tuple[int, int], pads, bits: int, packed: bool,
             relu: bool, act_qt: Optional[ActQt],
             out_code: bool) -> torch.Tensor:
    """Launch ``csrc/qconv_dw.cu`` in its int8-activation mode on the
    current CUDA stream.

    x_codes (B, H, W, C) int8; w (kh*kw, C) int8 tap rows, or with
    ``packed`` the split-row (kp_rows, C) uint8 buffer with
    kp_rows * 8/bits >= kh*kw; s_eff (C,) f32 folded scale; bias (C,) f32 or
    None.  Returns (B, OH, OW, C) int8 codes when ``out_code``, else f32.
    Counts launches in ``qconv_dw.launches``."""
    check_epilogue(act_qt, out_code)
    _expect(x_codes, "x_codes", torch.int8, 4, x_codes.device)
    out = _launch("repro_qconv_dw_i8", x_codes, w, s_eff, bias, kh=kh, kw=kw,
                  strides=strides, pads=pads, bits=bits, packed=packed,
                  relu=relu, act_qt=act_qt, out_code=out_code)
    if out.numel():
        qconv_dw.launches += 1
    return out


qconv_dw.launches = 0


def qconv_dw_f32(x: torch.Tensor, w: torch.Tensor, s_eff: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, kh: int, kw: int,
                 strides: Tuple[int, int], pads, bits: int, packed: bool,
                 relu: bool, act_qt: Optional[ActQt]) -> torch.Tensor:
    """Launch ``csrc/qconv_dw.cu`` in its float-activation mode on the
    current CUDA stream: x (B, H, W, C) f32, the weight operands as for
    :func:`qconv_dw`, s_eff (C,) the channel scale with the sub-byte step
    folded in.  Returns (B, OH, OW, C) f32.  Counts launches in
    ``qconv_dw_f32.launches``."""
    _expect(x, "x", torch.float32, 4, x.device)
    out = _launch("repro_qconv_dw_f32", x, w, s_eff, bias, kh=kh, kw=kw,
                  strides=strides, pads=pads, bits=bits, packed=packed,
                  relu=relu, act_qt=act_qt, out_code=False)
    if out.numel():
        qconv_dw_f32.launches += 1
    return out


qconv_dw_f32.launches = 0


def _check_packed(codes: torch.Tensor, k2: int, bits: int,
                  packed: bool) -> None:
    if packed and codes.shape[0] * (8 // bits) < k2:
        raise ValueError(f"packed tap rows {codes.shape[0]} do not cover the "
                         f"{k2}-tap window")


def qconv_dw_int8_act_plain(x_codes: torch.Tensor, x_scale: float,
                            codes: torch.Tensor, scale: torch.Tensor,
                            bias: Optional[torch.Tensor] = None, *, kh: int,
                            kw: int, strides, pads, bits: int, relu: bool,
                            act_qt: Optional[ActQt], out_code: bool,
                            packed: bool,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """The kernel's plain version on any device, with the kernel's operands:
    a packed tap buffer is unpacked to its view first."""
    c = unpack_rows(codes, bits)[:kh * kw] if packed else codes
    return qconv_dw_int8_act_ref(x_codes, x_scale, c, scale, bias, kh=kh,
                                 kw=kw, strides=strides, pads=pads, bits=bits,
                                 relu=relu, act_qt=act_qt, out_code=out_code,
                                 out_dtype=out_dtype)


def qconv_dw_int8_act(x_codes: torch.Tensor, x_scale, codes: torch.Tensor,
                      scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      *, kh: int, kw: int, strides=(1, 1), pads="SAME",
                      bits: int = 8, relu: bool = False,
                      act_qt: Optional[ActQt] = None, out_code: bool = False,
                      packed: bool = False,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fully-integer direct depthwise conv: x_codes (B, H, W, C) int8
    activation codes, int32 window MACs, the producer's scalar power-of-two
    ``x_scale`` folded into the per-channel weight scale, and
    ``out_code=True`` emitting the consumer's int8 codes.  ``codes`` is
    (kh*kw, C) int8 or, with ``packed=True``, the split-row
    (align(kh*kw, 8)/r, C) uint8 buffer."""
    xs = scalar_scale(x_scale)
    if xs is None:
        raise ValueError("the depthwise int8-act path takes a scalar "
                         "(per-tensor) activation scale")
    check_epilogue(act_qt, out_code)
    _check_packed(codes, kh * kw, bits, packed)
    pads = normalize_pads(pads)
    if x_codes.device.type == "cuda":
        s_eff = fold_scale(scale, xs, bits, packed).contiguous()
        y = qconv_dw(x_codes.contiguous(), codes.contiguous(), s_eff,
                     _bias_f32(bias), kh=kh, kw=kw, strides=strides,
                     pads=pads, bits=bits, packed=packed, relu=relu,
                     act_qt=act_qt, out_code=out_code)
        return y if out_code else y.to(out_dtype)
    if x_codes.device.type == "cpu":
        return qconv_dw_int8_act_plain(
            x_codes, xs, codes, scale, bias, kh=kh, kw=kw, strides=strides,
            pads=pads, bits=bits, relu=relu, act_qt=act_qt, out_code=out_code,
            packed=packed, out_dtype=out_dtype)
    raise ValueError(f"no qconv_dw_int8_act path for device {x_codes.device}")


def qconv_dw_float_plain(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *, kh: int,
                         kw: int, strides, pads, bits: int, relu: bool,
                         act_qt: Optional[ActQt], packed: bool,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """The float mode's plain version on any device; a packed tap buffer is
    unpacked to its view first."""
    c = unpack_rows(codes, bits)[:kh * kw] if packed else codes
    return qconv_dw_ref(x, c, scale, bias, kh=kh, kw=kw, strides=strides,
                        pads=pads, bits=bits, relu=relu, act_qt=act_qt,
                        out_dtype=out_dtype)


def qconv_dw_float(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *, kh: int, kw: int,
                   strides=(1, 1), pads="SAME", bits: int = 8,
                   relu: bool = False, act_qt: Optional[ActQt] = None,
                   packed: bool = False) -> torch.Tensor:
    """Float-activation direct depthwise conv with the fused epilogue (the
    reference's ``qconv_dw``): x (B, H, W, C) float NHWC; ``codes`` (kh*kw,
    C) int8 master tap rows or, with ``packed=True``, the split-row
    (align(kh*kw, 8)/r, C) uint8 buffer; scale (C,) f32; bias (C,) or None.
    Returns (B, OH, OW, C) in x's dtype."""
    _check_packed(codes, kh * kw, bits, packed)
    pads = normalize_pads(pads)
    if x.device.type == "cuda":
        s_eff = fold_scale(scale, 1.0, bits, packed).contiguous()
        y = qconv_dw_f32(x.to(torch.float32).contiguous(), codes.contiguous(),
                         s_eff, _bias_f32(bias), kh=kh, kw=kw,
                         strides=strides, pads=pads, bits=bits, packed=packed,
                         relu=relu, act_qt=act_qt)
        return y.to(x.dtype)
    if x.device.type == "cpu":
        return qconv_dw_float_plain(
            x, codes, scale, bias, kh=kh, kw=kw, strides=strides, pads=pads,
            bits=bits, relu=relu, act_qt=act_qt, packed=packed,
            out_dtype=x.dtype)
    raise ValueError(f"no qconv_dw_float path for device {x.device}")
