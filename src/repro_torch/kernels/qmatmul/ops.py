"""Public entry points of the quantized matmul (counterpart of
``repro.kernels.qmatmul.ops``).

Three entry points dispatch on the activation tensor's device:

* ``qmatmul_int8_act`` — the fully-integer mode (int8 activation codes, a
  scalar or per-row activation scale): a CUDA tensor launches
  ``csrc/qgemm.cu`` through :func:`qgemm`, a CPU tensor runs the plain
  version (:func:`~repro_torch.kernels.qmatmul.ref.qmatmul_int8_act_ref`);
* ``qgemm_float`` — the float-activation mode (the reference's ``qgemm``):
  a CUDA tensor launches the same kernel's f32 mode through
  :func:`qgemm_f32`, a CPU tensor runs
  :func:`~repro_torch.kernels.qmatmul.ref.qgemm_ref`;
* ``qmatmul`` — the dequant matmul (the reference's ``qmatmul``: bf16-rounded
  activations, no epilogue): a CUDA tensor launches the f32 mode on the
  activations rounded to bf16, a CPU tensor runs :func:`qmatmul_plain`.
  Where ``min(M, K, N) < 8`` it takes
  :func:`~repro_torch.kernels.qmatmul.ref.qmatmul_ref` on every device, with
  no bf16 rounding, as the reference does.

There is no fallback between kernel and plain version and no shape rule: any
M >= 1 runs the kernel, which masks ragged M/N/K edges itself, so no padded
copies are made.  :func:`pick_tiles` (the counterpart of the reference's
``pick_blocks``, without its timing sweep) chooses the kernel's mapping on
the host and passes it to the C entry point.  In this package
:func:`qgemm` names the int8-mode launch wrapper.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import check, load_kernels
from repro_torch.kernels.qmatmul.ref import (ActQt, fold_scale, qgemm_ref,
                                             qmatmul_int8_act_ref,
                                             qmatmul_ref)
from repro_torch.quant.pack import unpack_rows
from repro_torch.quant.ptq import derive_view

__all__ = ["qgemm", "qgemm_f32", "qgemm_float", "qgemm_float_plain",
           "qmatmul", "qmatmul_plain", "qmatmul_int8_act",
           "qmatmul_int8_act_plain", "scalar_scale",
           "pick_tiles", "Tiles", "truncate_view_cuda", "ActQt"]

# the card the tile choice fills: an H100 SXM's streaming multiprocessors
NUM_SMS = 132
# the skinny mapping (qgemm.cu's SK_MAX_M, SK_WARPS, SK_CLUSTER): at most one
# 64-row tile of M, and a K long enough to give each of a CTA's 8 warps a
# 32-wide step; K is split across a cluster of 8 CTAs
SKINNY_MAX_M = 64
SKINNY_MIN_K = 8 * 32
SKINNY_CLUSTER = 8


@dataclass(frozen=True)
class Tiles:
    """The kernel's mapping of one call.  ``skinny``: one cluster of
    ``splits`` CTAs per ``bn`` output columns, K split across the cluster's
    CTAs and their warps, M (``bm`` = M padded to 16) held whole.
    ``tiled``: ``bm`` x ``bn`` output tiles, k steps of ``bk``."""

    mapping: str
    bm: int
    bn: int
    bk: int
    splits: int = 1


def _fit(n: int, sizes: Tuple[int, ...]) -> int:
    """The smallest size that holds ``n``, else the largest."""
    return next((v for v in sizes if v >= n), sizes[-1])


def pick_tiles(M: int, K: int, N: int, float_mode: bool = False) -> Tiles:
    """The mapping ``csrc/qgemm.cu`` runs an (M, K, N) call with.

    * skinny when M fits one 64-row tile and K is long: the classifier FC
      (8 x 1568 x 10) and decode-like calls, where a tiled grid would leave
      one CTA to walk all of K.  BN is fitted to N (8, 16 or 32); K is split
      across a cluster of 8 CTAs.
    * tiled otherwise.  BN is fitted to N (8, 16, 32 or 64).  The int8 mode
      (a CTA of 4 warps over BM/16 bands of 16 rows) takes the largest BM of
      64 or 32 that still gives two or one CTAs per SM, else 16; its k step
      is the MMA's 32.
      The float mode's CTA is 128 threads of one row and 4 columns each, so
      BM = 512 / BN, and its k step is fitted to K (8, 16 or 32)."""
    if M <= 0 or K < 0 or N <= 0:
        raise ValueError(f"no qgemm tiles for M={M} K={K} N={N}")
    if M <= SKINNY_MAX_M and K >= SKINNY_MIN_K:
        return Tiles("skinny", bm=16 * -(-M // 16), bn=_fit(N, (8, 16, 32)),
                     bk=32, splits=SKINNY_CLUSTER)
    bn = _fit(N, (8, 16, 32, 64))
    if float_mode:
        return Tiles("tiled", bm=512 // bn, bn=bn, bk=_fit(K, (8, 16, 32)))
    gn = -(-N // bn)
    bm = 16
    for cand, per_sm in ((64, 2), (32, 1)):
        if -(-M // cand) * gn >= per_sm * NUM_SMS:
            bm = cand
            break
    return Tiles("tiled", bm=bm, bn=bn, bk=32)


def scalar_scale(x_scale) -> Optional[float]:
    """The per-tensor activation scale as a Python float (the writer hot
    path's power of two), or None when ``x_scale`` is a per-row tensor."""
    if isinstance(x_scale, torch.Tensor):
        if x_scale.numel() != 1:
            return None
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


def _check_weight(w: torch.Tensor, K: int, bits: int, packed: bool,
                  dev: torch.device) -> int:
    """Validate the (K, N) int8 codes or the packed buffer; returns N."""
    if bits not in (8, 4, 2) or (packed and bits == 8):
        raise ValueError(f"unsupported bits={bits} (packed={packed})")
    _expect(w, "w", torch.uint8 if packed else torch.int8, 2, dev)
    rows, N = w.shape
    if packed and rows * (8 // bits) < K:
        raise ValueError(f"packed weight rows {rows} (x{8 // bits}) do not "
                         f"cover the reduction dim {K}")
    if not packed and rows != K:
        raise ValueError(f"weight rows {rows} != reduction dim {K}")
    return N


def _check_channels(t: Optional[torch.Tensor], name: str, N: int,
                    dev: torch.device) -> None:
    if t is None:
        return
    _expect(t, name, torch.float32, 1, dev)
    if t.shape[0] != N:
        raise ValueError(f"{name} has {t.shape[0]} entries, expected {N}")


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor,
            xs: Optional[torch.Tensor], s_eff: torch.Tensor,
            bias: Optional[torch.Tensor], out: torch.Tensor, *, bits: int,
            packed: bool, relu: bool, act_qt: Optional[ActQt],
            out_code: bool) -> None:
    M, K = x.shape
    N = out.shape[1]
    frac, qmin, qmax = act_qt if act_qt is not None else (0, 0, 0)
    tiles = pick_tiles(M, K, N, float_mode=x.dtype == torch.float32)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), w.data_ptr(), None if xs is None else xs.data_ptr(),
            s_eff.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), M, K, N, bits, int(packed),
            w.shape[0] if packed else K, int(relu), int(act_qt is not None),
            int(out_code), qmin, qmax,
            int(tiles.mapping == "skinny"), tiles.bm, tiles.bn, tiles.bk,
            tiles.splits, 2.0 ** frac, 2.0 ** -frac, stream)
    check(rc, entry)


def qgemm(x_codes: torch.Tensor, w: torch.Tensor, s_eff: torch.Tensor,
          bias: Optional[torch.Tensor] = None, *, bits: int, packed: bool,
          relu: bool, act_qt: Optional[ActQt], out_code: bool,
          xs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch ``csrc/qgemm.cu`` in its int8-activation mode on the current
    CUDA stream.

    x_codes (M, K) int8; w (K, N) int8 master codes, or with ``packed`` the
    split-row (kp_rows, N) uint8 buffer with kp_rows * 8/bits >= K; s_eff (N,)
    f32 — the channel scale with the sub-byte step and, when ``xs`` is None,
    the scalar activation scale folded in; xs (M,) f32 per-row activation
    scale or None; bias (N,) f32 or None.  Returns (M, N) int8 codes when
    ``out_code``, else f32.  Counts launches in ``qgemm.launches``."""
    dev = x_codes.device
    if dev.type != "cuda":
        raise ValueError(f"qgemm launches the CUDA kernel; got a {dev} tensor")
    check_epilogue(act_qt, out_code)
    _expect(x_codes, "x_codes", torch.int8, 2, dev)
    M, K = x_codes.shape
    N = _check_weight(w, K, bits, packed, dev)
    _check_channels(s_eff, "s_eff", N, dev)
    _check_channels(bias, "bias", N, dev)
    _check_channels(xs, "xs", M, dev)
    out = torch.empty((M, N), dtype=torch.int8 if out_code else torch.float32,
                      device=dev)
    if M == 0 or N == 0:
        return out
    _launch("repro_qgemm_i8", x_codes, w, xs, s_eff, bias, out, bits=bits,
            packed=packed, relu=relu, act_qt=act_qt, out_code=out_code)
    qgemm.launches += 1
    return out


qgemm.launches = 0


def qgemm_f32(x: torch.Tensor, w: torch.Tensor, s_eff: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, bits: int, packed: bool,
              relu: bool, act_qt: Optional[ActQt]) -> torch.Tensor:
    """Launch ``csrc/qgemm.cu`` in its float-activation mode on the current
    CUDA stream: x (M, K) f32, the weight operands as for :func:`qgemm`,
    s_eff (N,) the channel scale with the sub-byte step folded in.  Returns
    (M, N) f32.  Counts launches in ``qgemm_f32.launches``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"qgemm_f32 launches the CUDA kernel; got a {dev} "
                         "tensor")
    _expect(x, "x", torch.float32, 2, dev)
    M, K = x.shape
    N = _check_weight(w, K, bits, packed, dev)
    _check_channels(s_eff, "s_eff", N, dev)
    _check_channels(bias, "bias", N, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    _launch("repro_qgemm_f32", x, w, None, s_eff, bias, out, bits=bits,
            packed=packed, relu=relu, act_qt=act_qt, out_code=False)
    qgemm_f32.launches += 1
    return out


qgemm_f32.launches = 0


def truncate_view_cuda(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """The kernels' integer truncation of int8 master codes to their
    ``bits``-bit view, run on the card (``repro_truncate_view``), for holding
    it against ``quant.ptq.derive_view``."""
    if codes.device.type != "cuda":
        raise ValueError(f"truncate_view_cuda runs on the card; got a "
                         f"{codes.device} tensor")
    if bits not in (8, 4, 2):
        raise ValueError(f"unsupported bits={bits}")
    _expect(codes, "codes", torch.int8, codes.ndim, codes.device)
    out = torch.empty_like(codes)
    lib = load_kernels()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.repro_truncate_view(codes.data_ptr(), out.data_ptr(),
                                     codes.numel(), bits, stream)
    check(rc, "repro_truncate_view")
    return out


def _bias_f32(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if bias is None else \
        bias.reshape(-1).to(torch.float32).contiguous()


def qmatmul_int8_act_plain(x_codes: torch.Tensor, x_scale,
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

    ``x_scale`` is the producer FIFO's activation scale: a scalar (the writer
    path's power of two, folded into the per-channel weight scale) or a
    per-row tensor with one entry per row of ``x_codes`` (the reference's
    dynamic-range path, applied to the accumulator first).  ``codes`` is
    (K, N) int8 or, with ``packed=True``, the split-row (K'/r, N) uint8
    buffer.  ``out_code=True`` returns int8 codes (``act_qt`` required), else
    the decoded float in ``out_dtype``."""
    lead = x_codes.shape[:-1]
    K = x_codes.shape[-1]
    N = codes.shape[-1]
    x2 = x_codes.reshape(-1, K)
    xs = scalar_scale(x_scale)
    if xs is None and x_scale.numel() != x2.shape[0]:
        raise ValueError(f"per-row x_scale has {x_scale.numel()} entries for "
                         f"{x2.shape[0]} rows")
    check_epilogue(act_qt, out_code)
    if packed and codes.shape[0] * (8 // bits) < K:
        raise ValueError(f"packed weight rows {codes.shape[0]} do not cover "
                         f"the reduction dim {K}")
    if x2.device.type == "cuda":
        rows = None
        if xs is None:
            rows = x_scale.reshape(-1).to(x2.device, torch.float32).contiguous()
        s_eff = fold_scale(scale, 1.0 if xs is None else xs, bits,
                           packed).contiguous()
        y = qgemm(x2.contiguous(), codes.contiguous(), s_eff, _bias_f32(bias),
                  bits=bits, packed=packed, relu=relu, act_qt=act_qt,
                  out_code=out_code, xs=rows)
        if not out_code:
            y = y.to(out_dtype)
    elif x2.device.type == "cpu":
        y = qmatmul_int8_act_plain(x2, x_scale if xs is None else xs, codes,
                                   scale, bias, bits=bits, relu=relu,
                                   act_qt=act_qt, out_code=out_code,
                                   packed=packed, out_dtype=out_dtype)
    else:
        raise ValueError(f"no qmatmul_int8_act path for device {x2.device}")
    return y.reshape(*lead, N)


def qgemm_float_plain(x: torch.Tensor, codes: torch.Tensor,
                      scale: torch.Tensor,
                      bias: Optional[torch.Tensor] = None, *, bits: int,
                      relu: bool, act_qt: Optional[ActQt], packed: bool,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The float mode's plain version on any device (the reference's
    ``qgemm_ref``: dequantize, then the dot); a packed weight is unpacked to
    its view first."""
    K = x.shape[-1]
    c = unpack_rows(codes, bits)[:K] if packed else codes
    return qgemm_ref(x, c, scale, bias, bits=bits, relu=relu, act_qt=act_qt,
                     out_dtype=out_dtype)


def qgemm_float(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None, *, bits: int = 8,
                relu: bool = False, act_qt: Optional[ActQt] = None,
                packed: bool = False) -> torch.Tensor:
    """Float-activation Gemm with the fused epilogue (the reference's
    ``qgemm``): x (..., K) float; ``codes`` (K, N) int8 master or, with
    ``packed=True``, the split-row (K'/r, N) uint8 buffer; scale (N,) f32;
    bias (N,) or None; ``act_qt`` the consumer's fixed-point activation
    quant.  Returns (..., N) in x's dtype."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    N = codes.shape[-1]
    x2 = x.reshape(-1, K)
    if packed and codes.shape[0] * (8 // bits) < K:
        raise ValueError(f"packed weight rows {codes.shape[0]} do not cover "
                         f"the reduction dim {K}")
    if x2.device.type == "cuda":
        s_eff = fold_scale(scale, 1.0, bits, packed).contiguous()
        y = qgemm_f32(x2.to(torch.float32).contiguous(), codes.contiguous(),
                      s_eff, _bias_f32(bias), bits=bits, packed=packed,
                      relu=relu, act_qt=act_qt).to(x.dtype)
    elif x2.device.type == "cpu":
        y = qgemm_float_plain(x2, codes, scale, bias, bits=bits, relu=relu,
                              act_qt=act_qt, packed=packed, out_dtype=x.dtype)
    else:
        raise ValueError(f"no qgemm_float path for device {x2.device}")
    return y.reshape(*lead, N)


def _qmatmul_operands(x: torch.Tensor, codes: torch.Tensor):
    """(x as (M, K), N, whether the call takes the oracle: some dim < 8)."""
    K = x.shape[-1]
    if codes.ndim != 2 or codes.shape[0] != K:
        raise ValueError(f"codes {tuple(codes.shape)} do not match the "
                         f"reduction dim {K}")
    x2 = x.reshape(-1, K)
    N = codes.shape[1]
    return x2, N, min(x2.shape[0], K, N) < 8


def qmatmul_plain(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                  *, bits: int = 8) -> torch.Tensor:
    """:func:`qmatmul`'s plain version on any device: the activations
    rounded to bf16, the f32 dot with the ``bits``-bit view of the codes,
    one multiply by the channel scale, cast to x's dtype (the oracle where
    ``min(M, K, N) < 8``)."""
    x2, N, small = _qmatmul_operands(x, codes)
    if small:
        y = qmatmul_ref(x2, codes, scale, bits, out_dtype=x.dtype)
    else:
        xb = x2.to(torch.bfloat16).to(torch.float32)
        y = (xb @ derive_view(codes, bits).to(torch.float32)) * \
            scale.reshape(1, -1).to(torch.float32)
        y = y.to(x.dtype)
    return y.reshape(*x.shape[:-1], N)


def qmatmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
            bits: int = 8) -> torch.Tensor:
    """Dequant matmul (the reference's ``qmatmul``): x (..., K) float;
    codes (K, N) int8 master; scale (N,) f32 -> (..., N) in x's dtype.

    Where ``min(M, K, N) >= 8`` the activations are rounded to bf16 (exact
    in f32) and a CUDA tensor launches ``csrc/qgemm.cu``'s f32 mode with the
    channel scale, no bias and no ReLU (the kernel sums x * code in f32 and
    scales once); a CPU tensor runs :func:`qmatmul_plain`.  Otherwise the
    oracle :func:`~repro_torch.kernels.qmatmul.ref.qmatmul_ref` runs on any
    device, with no bf16 rounding.  Counts the kernel's launches in
    ``qmatmul.launches``."""
    x2, N, small = _qmatmul_operands(x, codes)
    if small or x2.device.type == "cpu":
        return qmatmul_plain(x, codes, scale, bits=bits)
    if x2.device.type != "cuda":
        raise ValueError(f"no qmatmul path for device {x2.device}")
    xb = x2.to(torch.bfloat16).to(torch.float32).contiguous()
    y = qgemm_f32(xb, codes.contiguous(),
                  scale.reshape(-1).to(torch.float32).contiguous(),
                  bits=bits, packed=False, relu=False, act_qt=None)
    qmatmul.launches += 1
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


qmatmul.launches = 0
