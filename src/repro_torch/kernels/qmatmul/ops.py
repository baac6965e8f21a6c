"""Public entry points of the fully-integer quantized matmul (counterpart of
``repro.kernels.qmatmul.ops``, int8-activation mode).

``qmatmul_int8_act`` dispatches on the activation tensor's device: a CUDA
tensor launches the hand-written kernel ``csrc/qgemm.cu`` through
:func:`qgemm`; a CPU tensor runs the plain version
(:func:`repro_torch.kernels.qmatmul.ref.qmatmul_int8_act_ref`).  There is no
fallback between the two and no shape rule: any M >= 1 runs the kernel, which
masks ragged M/N/K edges itself, so no padded copies are made.

Not ported yet: the float-activation mode (the reference's ``qgemm`` /
``qmatmul``, bf16 activations) and the per-row activation-scale mode.  In
this package :func:`qgemm` names the CUDA kernel's launch wrapper.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import check, load_kernels
from repro_torch.kernels.qmatmul.ref import (ActQt, fold_scale,
                                             qmatmul_int8_act_ref)
from repro_torch.quant.pack import unpack_rows

__all__ = ["qgemm", "qmatmul_int8_act", "qmatmul_int8_act_plain",
           "scalar_scale", "ActQt"]


def scalar_scale(x_scale) -> float:
    """The per-tensor activation scale as a Python float (the writer hot
    path's power of two); per-row scales are not ported."""
    if isinstance(x_scale, torch.Tensor):
        if x_scale.numel() != 1:
            raise NotImplementedError(
                "per-row activation scales are not ported; the integer path "
                "takes one per-tensor (power-of-two) scale")
        return float(x_scale.reshape(()).item())
    return float(x_scale)


def check_epilogue(act_qt: Optional[ActQt], out_code: bool) -> None:
    if out_code:
        if act_qt is None:
            raise ValueError("out_code needs the output act_qt")
        if act_qt[1] < -128 or act_qt[2] > 127:
            raise ValueError(f"act_qt {act_qt} does not fit int8 codes")


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def qgemm(x_codes: torch.Tensor, w: torch.Tensor, s_eff: torch.Tensor,
          bias: Optional[torch.Tensor] = None, *, bits: int, packed: bool,
          relu: bool, act_qt: Optional[ActQt],
          out_code: bool) -> torch.Tensor:
    """Launch ``csrc/qgemm.cu`` on the current CUDA stream.

    x_codes (M, K) int8; w (K, N) int8 master codes, or with ``packed`` the
    split-row (kp_rows, N) uint8 buffer with kp_rows * 8/bits >= K; s_eff (N,)
    f32 — the channel scale with the activation scale and, when packed, the
    sub-byte step folded in; bias (N,) f32 or None.  Returns (M, N) int8
    codes when ``out_code``, else f32.  Counts launches in
    ``qgemm.launches``."""
    dev = x_codes.device
    if dev.type != "cuda":
        raise ValueError(f"qgemm launches the CUDA kernel; got a {dev} tensor")
    if bits not in (8, 4, 2) or (packed and bits == 8):
        raise ValueError(f"unsupported bits={bits} (packed={packed})")
    check_epilogue(act_qt, out_code)
    _expect(x_codes, "x_codes", torch.int8, 2, dev)
    M, K = x_codes.shape
    _expect(w, "w", torch.uint8 if packed else torch.int8, 2, dev)
    rows, N = w.shape
    if packed and rows * (8 // bits) < K:
        raise ValueError(f"packed weight rows {rows} (x{8 // bits}) do not "
                         f"cover the reduction dim {K}")
    if not packed and rows != K:
        raise ValueError(f"weight rows {rows} != reduction dim {K}")
    _expect(s_eff, "s_eff", torch.float32, 1, dev)
    if s_eff.shape[0] != N:
        raise ValueError(f"s_eff has {s_eff.shape[0]} channels, expected {N}")
    if bias is not None:
        _expect(bias, "bias", torch.float32, 1, dev)
        if bias.shape[0] != N:
            raise ValueError(f"bias has {bias.shape[0]} channels, expected {N}")
    out = torch.empty((M, N), dtype=torch.int8 if out_code else torch.float32,
                      device=dev)
    if M == 0 or N == 0:
        return out
    frac, qmin, qmax = act_qt if act_qt is not None else (0, 0, 0)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_qgemm_i8(
            x_codes.data_ptr(), w.data_ptr(), s_eff.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, K, N, bits, int(packed), rows if packed else K, int(relu),
            int(act_qt is not None), int(out_code), qmin, qmax,
            2.0 ** frac, 2.0 ** -frac, stream)
    check(rc, "qgemm")
    qgemm.launches += 1
    return out


qgemm.launches = 0


def qmatmul_int8_act_plain(x_codes: torch.Tensor, x_scale: float,
                           codes: torch.Tensor, scale: torch.Tensor,
                           bias: Optional[torch.Tensor] = None, *, bits: int,
                           relu: bool, act_qt: Optional[ActQt], out_code: bool,
                           packed: bool,
                           out_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """The kernel's plain version on any device, with the kernel's operands:
    a packed weight is unpacked to its view first."""
    K = x_codes.shape[-1]
    c = unpack_rows(codes, bits)[:K] if packed else codes
    return qmatmul_int8_act_ref(x_codes, x_scale, c, scale, bits, bias=bias,
                                relu=relu, act_qt=act_qt, out_code=out_code,
                                out_dtype=out_dtype)


def qmatmul_int8_act(x_codes: torch.Tensor, x_scale, codes: torch.Tensor,
                     scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                     *, bits: int = 8, relu: bool = False,
                     act_qt: Optional[ActQt] = None, out_code: bool = False,
                     packed: bool = False,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fully-integer Gemm: x_codes (..., K) int8 activation codes, int32 MACs,
    the fused epilogue re-quantizing straight to the consumer's code.

    ``x_scale`` is the producer FIFO's per-tensor activation scale (a power
    of two), folded into the per-channel weight scale.  ``codes`` is (K, N)
    int8 or, with ``packed=True``, the split-row (K'/r, N) uint8 buffer.
    ``out_code=True`` returns int8 codes (``act_qt`` required), else the
    decoded float in ``out_dtype``."""
    lead = x_codes.shape[:-1]
    K = x_codes.shape[-1]
    N = codes.shape[-1]
    x2 = x_codes.reshape(-1, K)
    xs = scalar_scale(x_scale)
    check_epilogue(act_qt, out_code)
    if packed and codes.shape[0] * (8 // bits) < K:
        raise ValueError(f"packed weight rows {codes.shape[0]} do not cover "
                         f"the reduction dim {K}")
    if x2.device.type == "cuda":
        s_eff = fold_scale(scale, xs, bits, packed).contiguous()
        b = None if bias is None else \
            bias.reshape(-1).to(torch.float32).contiguous()
        y = qgemm(x2.contiguous(), codes.contiguous(), s_eff, b, bits=bits,
                  packed=packed, relu=relu, act_qt=act_qt, out_code=out_code)
        if not out_code:
            y = y.to(out_dtype)
    elif x2.device.type == "cpu":
        y = qmatmul_int8_act_plain(x2, xs, codes, scale, bias, bits=bits,
                                   relu=relu, act_qt=act_qt,
                                   out_code=out_code, packed=packed,
                                   out_dtype=out_dtype)
    else:
        raise ValueError(f"no qmatmul_int8_act path for device {x2.device}")
    return y.reshape(*lead, N)
