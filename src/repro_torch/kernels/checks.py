"""Kernel-against-plain-version sweeps (no counterpart in ``repro``).

Each sweep feeds the same seeded inputs to a kernel's entry point and to its
plain PyTorch version on the same device.  The integer modes, the per-row
activation scale and the float depthwise conv must agree exactly (same
operations in the same order, each rounded on its own).  The float ``qgemm``
(the plain version dequantizes first), the dequant matmul ``qmatmul`` (f32
sums in another order) and ``conv2d_stream`` (the plain
version's tap dots sum in cuBLAS's order) and ``ssd_scan`` (f32 sums in
another order) are held to stated tolerances.
On a CUDA device the entry point launches the hand-written kernel; on the
CPU it runs the plain version itself (which only exercises the sweep).  The
sweeps hold the kernels at their static host mappings (``timed=False``: no
timing sweep at each of their many shapes); the candidate checks
(:func:`qgemm_candidates_check`, :func:`qconv_dw_candidates_check`) hold
every mapping a timed pick may return at the shapes the paths tune.
``chip_smoke.py`` and ``tests/test_torch_kernels_cuda.py`` run these on the
card.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.conv2d_stream.ops import conv2d_stream
from repro_torch.kernels.conv2d_stream.ref import conv2d_stream_plain
from repro_torch.kernels.qconv_dw.ops import (DW_PACK_ALIGN,
                                              candidate_dw_tiles, qconv_dw,
                                              qconv_dw_f32, qconv_dw_float,
                                              qconv_dw_float_plain,
                                              qconv_dw_int8_act,
                                              qconv_dw_int8_act_plain)
from repro_torch.kernels.qconv_dw.ref import normalize_pads, out_spatial
from repro_torch.kernels.qmatmul.ops import (candidate_tiles, encode_tiles,
                                             qgemm, qgemm_f32, qgemm_float,
                                             qgemm_float_plain, qmatmul,
                                             qmatmul_int8_act,
                                             qmatmul_int8_act_plain,
                                             qmatmul_plain)
from repro_torch.kernels.qmatmul.ref import fold_scale
from repro_torch.kernels.ssd_scan.ops import (ssd_chunk_scan,
                                              ssd_chunk_states,
                                              ssd_chunked_kernel,
                                              ssd_state_pass)
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_scan_plain,
                                              ssd_chunk_states_plain,
                                              ssd_chunked_plain,
                                              ssd_state_pass_plain)
from repro_torch.quant.pack import PACK_ALIGN, pack_rows

# (M, K, N) of every qgemm call of the slice's main path at batch 8:
# separable-cnn stem (im2col 3x3x1), pw0, pw1, fc; mnist-cnn conv0, conv1, fc
QGEMM_PATH_SHAPES = ((6272, 9, 8), (1568, 8, 16), (392, 16, 32), (8, 1568, 10),
                     (6272, 9, 16), (1568, 144, 32))
QGEMM_RAGGED = tuple(itertools.product((1, 7, 6272), (8, 9, 1568, 1100),
                                       (8, 10, 32, 130)))
# both sides of the switch between the tiled and the skinny mapping
# (M <= 64 and K >= 256), at the FC's K and at a long ragged one
QGEMM_SWITCH = tuple(itertools.product((1, 8, 16, 63, 64, 65),
                                       (8, 1568, 4100), (10, 32)))
# the im2col depthwise baseline (dw_mode="im2col") on separable-cnn: dw0 and
# dw1 as (B*OH*OW, 9*C, C) matmuls over the dense block-diagonal codes, at
# batch 8 and 32 (K = 72 rows are 8-byte, not 16-byte, aligned)
QGEMM_DW_IM2COL_SHAPES = ((1568, 72, 8), (392, 144, 16), (6272, 72, 8),
                          (1568, 144, 16))
# every qgemm call of both CNNs at batch 32, the design-space explorer's
# calibration batch: separable stem, pw0, pw1, fc; mnist conv0, conv1
QGEMM_B32_SHAPES = ((25088, 9, 8), (6272, 8, 16), (1568, 16, 32),
                    (32, 1568, 10), (25088, 9, 16), (6272, 144, 32))
QGEMM_SHAPES = (QGEMM_PATH_SHAPES + QGEMM_RAGGED + QGEMM_SWITCH
                + QGEMM_DW_IM2COL_SHAPES + QGEMM_B32_SHAPES)
# (M, K, N) of the dequant matmul qmatmul: the reference's test shapes
# (tests/test_kernels.py), its batched and ragged (2, 3, 100) x (100, 50) as
# 6 rows (below 8, so the oracle runs), and the classifier FC's 8 x 1568 x 10
# (the skinny mapping)
QMATMUL_SHAPES = ((128, 128, 128), (256, 512, 384), (128, 1024, 256),
                  (384, 256, 128), (6, 100, 50), (8, 1568, 10))
QMATMUL_DTYPES = (torch.bfloat16, torch.float32)
# (B, H, W, C) of the depthwise inputs: separable-cnn dw0/dw1 at batch 8,
# then ragged ones (odd spatial sizes, C not a multiple of 8 or of 32), then
# dw0/dw1 at batch 32
QCONV_DW_SHAPES = ((8, 14, 14, 8), (8, 14, 14, 16), (1, 11, 10, 130),
                   (7, 9, 9, 8), (2, 28, 28, 32), (3, 5, 7, 10),
                   (32, 14, 14, 8), (32, 14, 14, 16))
DW_STRIDES = ((1, 1), (2, 2), (1, 2))
DW_PADS = ("SAME", "VALID")
# (kh, kw, pads or None for every pad of the sweep): the 3x3 window of both
# CNNs (the kernel's specialised instance, the sweeps' default), then
# windows that run its generic instance
DW_WINDOWS = ((3, 3, None), (1, 3, None), (5, 5, None), (2, 2, ("VALID",)))

# (B, H, W, Cin, Cout, k) of conv2d_stream: the stream target's convs at
# batch 8 (mnist-cnn conv1, conv2; separable-cnn stem, pw0, pw1) and the
# same five at batch 32, the reference's test shapes, ragged ones (odd
# sizes, several Cout tiles), then rows wider than a block's first 48 KB
# holds (W-tiled, dynamic shared memory): 52,992 B, 175,680 B and
# 175,872 B of line buffer plus one channel's filter
CONV_STREAM_PATH_SHAPES = ((8, 28, 28, 1, 16, 3), (8, 14, 14, 16, 32, 3),
                           (8, 28, 28, 1, 8, 3), (8, 14, 14, 8, 16, 1),
                           (8, 7, 7, 16, 32, 1))
CONV_STREAM_B32_SHAPES = tuple((32,) + s[1:] for s in CONV_STREAM_PATH_SHAPES)
CONV_STREAM_WIDE_SHAPES = ((1, 64, 64, 64, 64, 3), (1, 4, 300, 48, 8, 3),
                           (2, 16, 224, 64, 32, 3))
CONV_STREAM_SHAPES = CONV_STREAM_PATH_SHAPES + CONV_STREAM_B32_SHAPES + (
    (2, 28, 28, 1, 16, 3), (1, 14, 14, 16, 32, 3), (3, 8, 8, 4, 8, 5),
    (2, 7, 7, 32, 16, 3), (1, 28, 28, 3, 8, 1),
    (3, 9, 13, 5, 37, 3), (1, 5, 6, 33, 7, 3), (2, 11, 3, 3, 130, 1),
    (1, 17, 40, 24, 70, 5)) + CONV_STREAM_WIDE_SHAPES
# (x dtype, w dtype): the stream target's f32, compose_adaptive's bf16 input
# and bf16 weights, and the mixed pairs behind its BatchNormalization
CONV_STREAM_DTYPES = ((torch.float32, torch.float32),
                      (torch.bfloat16, torch.bfloat16),
                      (torch.float32, torch.bfloat16),
                      (torch.bfloat16, torch.float32))

# (B, S, H, P, G, N, Q) of ssd_scan: the reference's test shapes
# (tests/test_kernels.py), ragged lengths (S not a multiple of Q), G > 1,
# then the prefill calls at full width (batch 4 x 2048 tokens) of
# mamba2-1.3b and of hymba-1.5b's SSM half (50 heads, N = 16)
SSD_FULL_WIDTH = (4, 2048, 64, 64, 1, 128, 64)
SSD_HYMBA_FULL_WIDTH = (4, 2048, 50, 64, 1, 16, 64)
SSD_TEST_SHAPES = ((2, 128, 4, 16, 2, 8, 32), (1, 64, 2, 8, 1, 16, 16),
                   (2, 96, 6, 32, 3, 4, 32), (1, 256, 8, 64, 1, 128, 64),
                   (1, 100, 4, 16, 1, 8, 32), (2, 100, 4, 16, 2, 8, 32),
                   (1, 2000, 4, 64, 1, 128, 64), (3, 37, 6, 32, 3, 4, 16))
SSD_SHAPES = SSD_TEST_SHAPES + (SSD_FULL_WIDTH, SSD_HYMBA_FULL_WIDTH)
# the per-phase check: the full-width prefill calls and a ragged length at
# mamba2's widths
SSD_PHASE_SHAPES = (SSD_FULL_WIDTH, (1, 2000, 4, 64, 1, 128, 64),
                    SSD_HYMBA_FULL_WIDTH)

# weight working points: (bits, packed)
WEIGHT_VARIANTS = ((8, False), (4, False), (2, False), (4, True), (2, True))
# epilogues: int8 codes, decoded 16-bit fake-quant, plain float
EPILOGUES = ("code", "fq", "float")


# float-mode epilogues: 8-bit and 16-bit fake-quant, plain float
FLOAT_EPILOGUES = ("fq8", "fq", "float")


def float_qgemm_tol(want: torch.Tensor,
                    act_qt: Optional[Tuple[int, int, int]] = None) -> float:
    """The float ``qgemm`` contract: the reference's ``max|y|*2^-7 + 1e-6``,
    or one quantum ``2^-frac`` of the output's fixed-point type where that is
    larger (a saturating 8-bit requant): an f32 summation-order difference
    can flip one requant to the next code."""
    tol = (float(want.abs().max()) if want.numel() else 0.0) * 2.0 ** -7 \
        + 1e-6
    return max(tol, 2.0 ** -act_qt[0]) if act_qt is not None else tol


def conv_stream_tol(want: torch.Tensor) -> torch.Tensor:
    """Elementwise bound for ``conv2d_stream`` against its plain version:
    ``1e-4 + 1e-4*|y|`` in f32 (the reference's tolerance), and one bf16 ulp
    (``2^-7*|y|``) plus 1e-4 when the output is bf16, where an f32
    summation-order difference can flip the final rounding."""
    w = want.to(torch.float32).abs()
    rtol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 1e-4
    return 1e-4 + rtol * w


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _act_qt(kind: str, frac: int) -> Optional[Tuple[int, int, int]]:
    if kind in ("code", "fq8"):
        return (frac, -128, 127)
    if kind == "fq":
        return (frac, -(2 ** 15), 2 ** 15 - 1)
    return None


def _frac_for(y: torch.Tensor) -> int:
    """A requant exponent that puts the largest |y| a little past 127, so
    both rounding and saturation are exercised."""
    m = float(y.abs().max())
    return int(math.floor(math.log2(127.0 / m))) + 1 if m > 0 else 0


def _weights(g: torch.Generator, k: int, n: int):
    w = torch.randn((k, n), generator=g) * 0.3
    s = torch.clamp_min(w.abs().amax(0), 1e-8) / 127.0
    codes = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return codes, s.to(torch.float32)


def _variants(epilogues: Sequence[str] = EPILOGUES
              ) -> Iterator[Tuple[int, bool, str, bool, bool]]:
    for (bits, packed), epi, relu, bias in itertools.product(
            WEIGHT_VARIANTS, epilogues, (False, True), (False, True)):
        yield bits, packed, epi, relu, bias


def _compare(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.dtype != want.dtype or got.shape != want.shape:
        return math.inf
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max()) \
        if got.numel() else 0.0


def qgemm_sweep(device, shapes: Optional[Sequence[Tuple[int, int, int]]] = None,
                per_row: bool = False) -> Dict[str, object]:
    """``qmatmul_int8_act`` against its plain version over bits {8,4,2} x
    packed x epilogue x ReLU x bias at ``shapes`` (default: the path's shapes
    plus the ragged product).  ``per_row`` gives every row its own
    activation scale (the reference's dynamic-range mode) instead of the
    writer path's scalar power of two."""
    shapes = list(shapes or QGEMM_SHAPES)
    dev = torch.device(device)
    cases, worst, failures = 0, 0.0, []
    for si, (M, K, N) in enumerate(shapes):
        g = _gen(1000 + si)
        x = torch.randint(-128, 128, (M, K), generator=g,
                          dtype=torch.int8).to(dev)
        codes, s = _weights(g, K, N)
        b = (torch.randn((N,), generator=g) * 0.1).to(dev)
        codes, s = codes.to(dev), s.to(dev)
        xs = (torch.rand((M,), generator=g) * 0.05 + 1e-3).to(dev) \
            if per_row else 2.0 ** -4
        packs = {bits: pack_rows(codes, bits, PACK_ALIGN) for bits in (4, 2)}
        for bits, packed, epi, relu, bias in _variants():
            w = packs[bits] if packed else codes
            common = dict(bits=bits, relu=relu, packed=packed)
            y0 = qmatmul_int8_act_plain(x, xs, w, s, b, act_qt=None,
                                        out_code=False, **common)
            aqt = _act_qt(epi, _frac_for(y0))
            args = (x, xs, w, s, b if bias else None)
            got = qmatmul_int8_act(*args, act_qt=aqt, out_code=epi == "code",
                                   timed=False, **common)
            want = qmatmul_int8_act_plain(*args, act_qt=aqt,
                                          out_code=epi == "code", **common)
            err = _compare(got, want)
            cases += 1
            worst = max(worst, err)
            if err != 0.0 or not torch.equal(got, want):
                failures.append(dict(M=M, K=K, N=N, bits=bits, packed=packed,
                                     epilogue=epi, relu=relu, bias=bias,
                                     err=err))
    return {"cases": cases, "max_abs_err": worst, "failures": failures}


def _tile_case(err: float, tol: float, tiles, worst: Dict[str, float],
               failures: list) -> None:
    worst["cases"] += 1
    worst["max_abs_err"] = max(worst["max_abs_err"], err)
    worst["max_tol_frac"] = max(worst["max_tol_frac"],
                                err / tol if tol else (0.0 if err == 0
                                                       else math.inf))
    if err > tol:
        failures.append(dict(tiles=tiles, err=err, tol=tol))


def qgemm_candidates_check(device, M: int, K: int, N: int, *, bits: int,
                           packed: bool, int8_act: bool,
                           seed: int = 5000) -> Dict[str, object]:
    """Every mapping :func:`~repro_torch.kernels.qmatmul.ops.candidate_tiles`
    offers for an (M, K, N) call, each launched with its tiles on the same
    seeded operands, against the plain version, with the path's epilogue
    (bias, ReLU, requant): the int8 mode to int8 codes, bit for bit; the
    float mode to a 16-bit fake-quant, within :func:`float_qgemm_tol` (the
    skinny mapping sums K in another order than the tiled one).  On the CPU
    each case runs the plain version (which only exercises the check)."""
    dev = torch.device(device)
    g = _gen(seed)
    codes, s = _weights(g, K, N)
    b = torch.randn((N,), generator=g) * 0.1
    w = pack_rows(codes, bits, PACK_ALIGN) if packed else codes
    if int8_act:
        x = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
    else:
        x = torch.randn((M, K), generator=g) * 0.5
    x, w, s, b = x.to(dev), w.to(dev), s.to(dev), b.to(dev)
    common = dict(bits=bits, packed=packed, relu=True)
    if int8_act:
        xs = 2.0 ** -4
        y0 = qmatmul_int8_act_plain(x, xs, w, s, b, act_qt=None,
                                    out_code=False, **common)
        aqt = _act_qt("code", _frac_for(y0))
        want = qmatmul_int8_act_plain(x, xs, w, s, b, act_qt=aqt,
                                      out_code=True, **common)
        s_eff = fold_scale(s, xs, bits, packed).contiguous()
    else:
        y0 = qgemm_float_plain(x, w, s, b, act_qt=None, **common)
        aqt = _act_qt("fq", _frac_for(y0))
        want = qgemm_float_plain(x, w, s, b, act_qt=aqt, **common)
        s_eff = fold_scale(s, 1.0, bits, packed).contiguous()
    tol = 0.0 if int8_act else float_qgemm_tol(want, aqt)
    worst = {"cases": 0, "max_abs_err": 0.0, "max_tol_frac": 0.0}
    failures: List[dict] = []
    for t in candidate_tiles(M, K, N, float_mode=not int8_act):
        if dev.type != "cuda":
            got = (qmatmul_int8_act(x, xs, w, s, b, act_qt=aqt, out_code=True,
                                    **common) if int8_act else
                   qgemm_float(x, w, s, b, act_qt=aqt, **common))
        elif int8_act:
            got = qgemm(x, w, s_eff, b, act_qt=aqt, out_code=True, tiles=t,
                        **common)
        else:
            got = qgemm_f32(x, w, s_eff, b, act_qt=aqt, tiles=t, **common)
        err = _compare(got, want)
        if int8_act and not torch.equal(got, want):
            err = max(err, math.ulp(0.0))
        _tile_case(err, tol, list(encode_tiles(t)), worst, failures)
    return {**worst, "failures": failures}


def qconv_dw_candidates_check(device, B: int, H: int, W: int, C: int, *,
                              kh: int, kw: int, strides, pads, bits: int,
                              packed: bool, int8_act: bool,
                              seed: int = 6000) -> Dict[str, object]:
    """Every tile :func:`~repro_torch.kernels.qconv_dw.ops.candidate_dw_tiles`
    offers for a depthwise call, each launched with its (ct, owb) on the
    same seeded operands, against the plain version bit for bit in both
    modes (each channel's taps are summed in the same order whatever the
    tile), with the path's epilogue (bias, ReLU; int8 codes out, or a
    16-bit fake-quant).  On the CPU each case runs the plain version."""
    dev = torch.device(device)
    sh, sw = (int(v) for v in strides)
    pads = normalize_pads(pads)
    _, OW, _, _ = out_spatial(H, W, kh, kw, (sh, sw), pads)
    g = _gen(seed)
    codes, s = _weights(g, kh * kw, C)
    b = torch.randn((C,), generator=g) * 0.1
    w = pack_rows(codes, bits, DW_PACK_ALIGN) if packed else codes
    if int8_act:
        x = torch.randint(-128, 128, (B, H, W, C), generator=g,
                          dtype=torch.int8)
    else:
        x = torch.randn((B, H, W, C), generator=g) * 0.5
    x, w, s, b = x.to(dev), w.to(dev), s.to(dev), b.to(dev)
    common = dict(kh=kh, kw=kw, strides=(sh, sw), pads=pads, bits=bits,
                  packed=packed, relu=True)
    xs = 2.0 ** -6
    if int8_act:
        y0 = qconv_dw_int8_act_plain(x, xs, w, s, b, act_qt=None,
                                     out_code=False, **common)
        aqt = _act_qt("code", _frac_for(y0))
        want = qconv_dw_int8_act_plain(x, xs, w, s, b, act_qt=aqt,
                                       out_code=True, **common)
        s_eff = fold_scale(s, xs, bits, packed).contiguous()
    else:
        y0 = qconv_dw_float_plain(x, w, s, b, act_qt=None, **common)
        aqt = _act_qt("fq", _frac_for(y0))
        want = qconv_dw_float_plain(x, w, s, b, act_qt=aqt, **common)
        s_eff = fold_scale(s, 1.0, bits, packed).contiguous()
    worst = {"cases": 0, "max_abs_err": 0.0, "max_tol_frac": 0.0}
    failures: List[dict] = []
    for t in candidate_dw_tiles(C, OW, kh=kh, kw=kw, sw=sw,
                                float_mode=not int8_act):
        if dev.type != "cuda":
            got = (qconv_dw_int8_act(x, xs, w, s, b, act_qt=aqt,
                                     out_code=True, **common) if int8_act
                   else qconv_dw_float(x, w, s, b, act_qt=aqt, **common))
        elif int8_act:
            got = qconv_dw(x, w, s_eff, b, act_qt=aqt, out_code=True,
                           tile=t, **common)
        else:
            got = qconv_dw_f32(x, w, s_eff, b, act_qt=aqt, tile=t, **common)
        err = _compare(got, want)
        if not torch.equal(got, want):
            err = max(err, math.ulp(0.0))
        _tile_case(err, 0.0, list(t), worst, failures)
    return {**worst, "failures": failures}


def _dw_cases(shapes, strides, pads, windows, seed: int, make_x):
    """Each (shape, window, stride, pad) of a depthwise sweep with its seeded
    operands: x from ``make_x(g, shape)``, the window's (kh*kw, C) master
    codes and scale, a bias, and the W4/W2 packs of the codes."""
    for si, (B, H, W, C) in enumerate(shapes):
        for wi, (kh, kw, wpads) in enumerate(windows):
            g = _gen(seed + si + 100 * wi)
            x = make_x(g, (B, H, W, C))
            codes, s = _weights(g, kh * kw, C)
            b = torch.randn((C,), generator=g) * 0.1
            packs = {bits: pack_rows(codes, bits, DW_PACK_ALIGN)
                     for bits in (4, 2)}
            for st, pd in itertools.product(strides, pads):
                if wpads is None or pd in wpads:
                    yield (B, H, W, C), (kh, kw), st, pd, x, codes, s, b, packs


def qconv_dw_sweep(device,
                   shapes: Optional[Sequence[Tuple[int, int, int, int]]] = None,
                   strides: Sequence[Tuple[int, int]] = DW_STRIDES,
                   pads: Sequence[str] = DW_PADS,
                   windows: Sequence[Tuple] = DW_WINDOWS[:1]
                   ) -> Dict[str, object]:
    """``qconv_dw_int8_act`` against its plain version over windows x bits
    {8,4,2} x packed x strides x SAME/VALID x epilogue x ReLU x bias."""
    shapes = list(shapes or QCONV_DW_SHAPES)
    dev = torch.device(device)
    cases, worst, failures = 0, 0.0, []

    def make_x(g, shape):
        return torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)

    for shape, (kh, kw), st, pd, x, codes, s, b, packs in _dw_cases(
            shapes, strides, pads, windows, 2000, make_x):
        x, codes, s, b = x.to(dev), codes.to(dev), s.to(dev), b.to(dev)
        packs = {k: v.to(dev) for k, v in packs.items()}
        xs = 2.0 ** -6
        for bits, packed, epi, relu, bias in _variants():
            w = packs[bits] if packed else codes
            common = dict(kh=kh, kw=kw, strides=st, pads=pd, bits=bits,
                          relu=relu, packed=packed)
            y0 = qconv_dw_int8_act_plain(x, xs, w, s, b, act_qt=None,
                                         out_code=False, **common)
            aqt = _act_qt(epi, _frac_for(y0))
            args = (x, xs, w, s, b if bias else None)
            got = qconv_dw_int8_act(*args, act_qt=aqt,
                                    out_code=epi == "code", timed=False,
                                    **common)
            want = qconv_dw_int8_act_plain(*args, act_qt=aqt,
                                           out_code=epi == "code", **common)
            err = _compare(got, want)
            cases += 1
            worst = max(worst, err)
            if err != 0.0 or not torch.equal(got, want):
                failures.append(dict(shape=list(shape), window=[kh, kw],
                                     strides=st, pads=pd, bits=bits,
                                     packed=packed, epilogue=epi, relu=relu,
                                     bias=bias, err=err))
    return {"cases": cases, "max_abs_err": worst, "failures": failures}


def qgemm_float_sweep(device,
                      shapes: Optional[Sequence[Tuple[int, int, int]]] = None
                      ) -> Dict[str, object]:
    """``qgemm_float`` against its plain version (dequantize, then the dot)
    over bits {8,4,2} x packed x epilogue x ReLU x bias, each case within
    :func:`float_qgemm_tol`; ``max_tol_frac`` is the worst error over its
    tolerance."""
    shapes = list(shapes or QGEMM_SHAPES)
    dev = torch.device(device)
    cases, worst, worst_frac, failures = 0, 0.0, 0.0, []
    for si, (M, K, N) in enumerate(shapes):
        g = _gen(3000 + si)
        x = (torch.randn((M, K), generator=g) * 0.5).to(dev)
        codes, s = _weights(g, K, N)
        b = (torch.randn((N,), generator=g) * 0.1).to(dev)
        codes, s = codes.to(dev), s.to(dev)
        packs = {bits: pack_rows(codes, bits, PACK_ALIGN) for bits in (4, 2)}
        for bits, packed, epi, relu, bias in _variants(FLOAT_EPILOGUES):
            w = packs[bits] if packed else codes
            common = dict(bits=bits, relu=relu, packed=packed)
            y0 = qgemm_float_plain(x, w, s, b, act_qt=None, **common)
            aqt = _act_qt(epi, _frac_for(y0))
            args = (x, w, s, b if bias else None)
            got = qgemm_float(*args, act_qt=aqt, timed=False, **common)
            want = qgemm_float_plain(*args, act_qt=aqt, **common)
            err, tol = _compare(got, want), float_qgemm_tol(want, aqt)
            cases += 1
            worst = max(worst, err)
            worst_frac = max(worst_frac, err / tol)
            if err > tol:
                failures.append(dict(M=M, K=K, N=N, bits=bits, packed=packed,
                                     epilogue=epi, relu=relu, bias=bias,
                                     err=err, tol=tol))
    return {"cases": cases, "max_abs_err": worst, "failures": failures,
            "max_tol_frac": worst_frac}


def qmatmul_sweep(device,
                  shapes: Sequence[Tuple[int, int, int]] = QMATMUL_SHAPES
                  ) -> Dict[str, object]:
    """``qmatmul`` against its plain version over bits {8,4,2} x bf16/f32
    activations, each case within :func:`float_qgemm_tol` (one bf16 ulp of
    max|y|: the output of a bf16 call is bf16); ``max_tol_frac`` is the
    worst error over its tolerance."""
    dev = torch.device(device)
    cases, worst, worst_frac, failures = 0, 0.0, 0.0, []
    for si, (M, K, N) in enumerate(shapes):
        g = _gen(3500 + si)
        x = torch.randn((M, K), generator=g)
        codes, s = _weights(g, K, N)
        codes, s = codes.to(dev), s.to(dev)
        for bits, dtype in itertools.product((8, 4, 2), QMATMUL_DTYPES):
            xd = x.to(dtype).to(dev)
            got = qmatmul(xd, codes, s, bits=bits, timed=False)
            want = qmatmul_plain(xd, codes, s, bits=bits)
            err, tol = _compare(got, want), float_qgemm_tol(want)
            cases += 1
            worst = max(worst, err)
            worst_frac = max(worst_frac, err / tol)
            if err > tol:
                failures.append(dict(M=M, K=K, N=N, bits=bits,
                                     dtype=str(dtype), err=err, tol=tol))
    return {"cases": cases, "max_abs_err": worst, "failures": failures,
            "max_tol_frac": worst_frac}


def qconv_dw_float_sweep(device,
                         shapes: Optional[Sequence[Tuple[int, int, int, int]]]
                         = None,
                         strides: Sequence[Tuple[int, int]] = DW_STRIDES,
                         pads: Sequence[str] = DW_PADS,
                         windows: Sequence[Tuple] = DW_WINDOWS[:1]
                         ) -> Dict[str, object]:
    """``qconv_dw_float`` against its plain version over windows x bits
    {8,4,2} x packed x strides x SAME/VALID x epilogue x ReLU x bias: exact
    equality (the same f32 operations in the same order)."""
    shapes = list(shapes or QCONV_DW_SHAPES)
    dev = torch.device(device)
    cases, worst, failures = 0, 0.0, []

    def make_x(g, shape):
        return torch.randn(shape, generator=g) * 0.5

    for shape, (kh, kw), st, pd, x, codes, s, b, packs in _dw_cases(
            shapes, strides, pads, windows, 4000, make_x):
        x, codes, s, b = x.to(dev), codes.to(dev), s.to(dev), b.to(dev)
        packs = {k: v.to(dev) for k, v in packs.items()}
        for bits, packed, epi, relu, bias in _variants(FLOAT_EPILOGUES):
            w = packs[bits] if packed else codes
            common = dict(kh=kh, kw=kw, strides=st, pads=pd, bits=bits,
                          relu=relu, packed=packed)
            y0 = qconv_dw_float_plain(x, w, s, b, act_qt=None, **common)
            aqt = _act_qt(epi, _frac_for(y0))
            args = (x, w, s, b if bias else None)
            got = qconv_dw_float(*args, act_qt=aqt, timed=False, **common)
            want = qconv_dw_float_plain(*args, act_qt=aqt, **common)
            err = _compare(got, want)
            cases += 1
            worst = max(worst, err)
            if err != 0.0 or not torch.equal(got, want):
                failures.append(dict(shape=list(shape), window=[kh, kw],
                                     strides=st, pads=pd, bits=bits,
                                     packed=packed, epilogue=epi, relu=relu,
                                     bias=bias, err=err))
    return {"cases": cases, "max_abs_err": worst, "failures": failures}


def conv2d_stream_sweep(device,
                        shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                        dtypes: Sequence[Tuple[torch.dtype, torch.dtype]]
                        = CONV_STREAM_DTYPES) -> Dict[str, object]:
    """``conv2d_stream`` against its plain version over ``shapes`` x
    (x, w) dtypes x bias on/off, each element within
    :func:`conv_stream_tol`; ``max_tol_frac`` is the worst error over its
    bound."""
    shapes = list(shapes or CONV_STREAM_SHAPES)
    dev = torch.device(device)
    cases, worst, worst_frac, failures = 0, 0.0, 0.0, []
    for si, (B, H, W, cin, cout, k) in enumerate(shapes):
        g = _gen(5000 + si)
        x = torch.randn((B, H, W, cin), generator=g)
        w = torch.randn((k, k, cin, cout), generator=g) / math.sqrt(k * k * cin)
        b = torch.randn((cout,), generator=g) * 0.1
        for (xdt, wdt), bias in itertools.product(dtypes, (False, True)):
            xd, wd = x.to(dev, xdt), w.to(dev, wdt)
            bd = b.to(dev) if bias else None
            got = conv2d_stream(xd, wd, bd)
            want = conv2d_stream_plain(xd, wd, bd)
            if got.dtype != want.dtype or got.shape != want.shape:
                err, frac = math.inf, math.inf
            else:
                d = (got.to(torch.float32) - want.to(torch.float32)).abs()
                err = float(d.max())
                frac = float((d / conv_stream_tol(want)).max())
            cases += 1
            worst = max(worst, err)
            worst_frac = max(worst_frac, frac)
            if frac > 1.0:
                failures.append(dict(B=B, H=H, W=W, Cin=cin, Cout=cout, k=k,
                                     x=str(xdt), w=str(wdt), bias=bias,
                                     err=err))
    return {"cases": cases, "max_abs_err": worst, "failures": failures,
            "max_tol_frac": worst_frac}


def ssd_scan_tol(y_want: torch.Tensor, s_want: torch.Tensor):
    """Elementwise bounds for ``ssd_scan`` against its plain version: y
    within ``1e-5*max|y|`` (the reference's test_kernels.py tolerance), plus
    one bf16 ulp (``2^-7*|y|``) when y is bf16, where an f32 summation-order
    difference can flip the final rounding; the f32 state within
    ``1e-4*max(1, max|state|)`` (the reference's atol 1e-4, relative once
    the state grows past 1 at full width)."""
    yw = y_want.to(torch.float32).abs()
    y_tol = 1e-5 * float(yw.max()) if yw.numel() else 1e-5
    y_tol = torch.full_like(yw, max(y_tol, 1e-30))
    if y_want.dtype == torch.bfloat16:
        y_tol = y_tol + 2.0 ** -7 * yw
    s_tol = 1e-4 * max(1.0, float(s_want.abs().max()) if s_want.numel()
                       else 1.0)
    return y_tol, s_tol


def ssd_inputs(shape: Tuple[int, ...], seed: int, dtype: torch.dtype,
               device, fused: bool = False):
    """The reference test's input distributions for ``shape`` = (B, S, H, P,
    G, N, Q): x ~ N(0,1), dt = softplus(N(0,1)), A = -exp(0.5 N(0,1)), B and
    C ~ 0.3 N(0,1), D ~ N(0,1).  With ``fused`` x, B and C are strided views
    into one (B, S, H*P + 2*G*N) tensor, the layout the model hands over."""
    Bsz, S, H, P, G, N, _ = shape
    g = _gen(seed)
    dev = torch.device(device)
    xbc = torch.randn((Bsz, S, H * P + 2 * G * N), generator=g)
    xbc[..., H * P:] *= 0.3
    dt = torch.nn.functional.softplus(torch.randn((Bsz, S, H), generator=g))
    A = -torch.exp(torch.randn((H,), generator=g) * 0.5)
    D = torch.randn((H,), generator=g)
    xbc = xbc.to(dev, dtype)
    if not fused:
        xbc = xbc.clone()
    x = xbc[..., :H * P].reshape(Bsz, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
    C = xbc[..., H * P + G * N:].reshape(Bsz, S, G, N)
    if not fused:
        x, Bm, C = x.contiguous(), Bm.contiguous(), C.contiguous()
    return x, dt.to(dev), A.to(dev), Bm, C, D.to(dev)


def ssd_scan_sweep(device, shapes: Optional[Sequence[Tuple[int, ...]]] = None,
                   dtypes: Sequence[torch.dtype] = (torch.float32,
                                                    torch.bfloat16),
                   layouts: Sequence[bool] = (False, True),
                   warm: Sequence[bool] = (False, True)
                   ) -> Dict[str, object]:
    """``ssd_chunked_kernel`` against ``ssd_chunked_plain`` over ``shapes``
    x dtypes x (contiguous, fused strided views) x (zero, seeded initial
    state), each element within :func:`ssd_scan_tol`; ``max_tol_frac`` is
    the worst error over its bound and ``max_abs_err`` the worst |y|
    difference."""
    shapes = list(shapes or SSD_SHAPES)
    cases, worst, worst_frac, failures = 0, 0.0, 0.0, []
    by = {}             # worst fraction per (dtype, y or state)
    for si, shape in enumerate(shapes):
        Bsz, _, H, P, _, N, Q = shape
        for dt_, fused, w in itertools.product(dtypes, layouts, warm):
            x, dt, A, Bm, C, D = ssd_inputs(shape, 6000 + si, dt_, device,
                                            fused)
            s0 = torch.randn((Bsz, H, P, N), generator=_gen(7000 + si)).to(
                device) if w else None
            y, s = ssd_chunked_kernel(x, dt, A, Bm, C, D, Q, s0)
            yw, sw = ssd_chunked_plain(x, dt, A, Bm, C, D, Q, s0)
            if y.dtype != yw.dtype or y.shape != yw.shape \
                    or s.shape != sw.shape:
                err, frac = math.inf, math.inf
            else:
                y_tol, s_tol = ssd_scan_tol(yw, sw)
                dy = (y.to(torch.float32) - yw.to(torch.float32)).abs()
                ds = (s - sw).abs()
                err = float(dy.max()) if dy.numel() else 0.0
                fy = float((dy / y_tol).max()) if dy.numel() else 0.0
                fs = float(ds.max()) / s_tol if ds.numel() else 0.0
                frac = max(fy, fs)
                for key, f in ((f"{dt_}".split(".")[-1] + " y", fy),
                               (f"{dt_}".split(".")[-1] + " state", fs)):
                    by[key] = max(by.get(key, 0.0), f)
            cases += 1
            worst = max(worst, err)
            worst_frac = max(worst_frac, frac)
            if not frac <= 1.0:
                failures.append(dict(shape=list(shape), dtype=str(dt_),
                                     fused=fused, warm=w, err=err,
                                     tol_frac=frac))
    return {"cases": cases, "max_abs_err": worst, "failures": failures,
            "max_tol_frac": worst_frac, "max_tol_frac_by": by}


def ssd_scan_f64_gap(device, shape: Tuple[int, ...] = SSD_FULL_WIDTH,
                     seed: int = 6000) -> Dict[str, float]:
    """The kernel's and the plain version's own errors against an f64 run of
    the plain version on the same f32 inputs: the y error over max|y| and
    the state error over max(1, max|state|)."""
    Q = shape[-1]
    x, dt, A, Bm, C, D = ssd_inputs(shape, seed, torch.float32, device)
    y64, s64 = ssd_chunked_plain(x.double(), dt.double(), A.double(),
                                 Bm.double(), C.double(), D.double(), Q)
    ym = float(y64.abs().max())
    sm = max(1.0, float(s64.abs().max()))
    out = {}
    for name, fn in (("kernel", ssd_chunked_kernel),
                     ("plain", ssd_chunked_plain)):
        y, s = fn(x, dt, A, Bm, C, D, Q)
        out[f"{name}_y_rel"] = float((y.double() - y64).abs().max()) / ym
        out[f"{name}_state_rel"] = float((s.double() - s64).abs().max()) / sm
    return out


def ssd_scan_phase_check(device, shapes: Sequence[Tuple[int, ...]]
                         = SSD_PHASE_SHAPES,
                         dtypes: Sequence[torch.dtype] = (torch.float32,
                                                          torch.bfloat16)
                         ) -> Dict[str, object]:
    """Each phase of the scan on ``device`` against its plain version, fed
    the plain version's output of the phase before it, on x/B/C views of a
    fused tensor from a given initial state: phase 1's chunk states and
    decays, and phase 3's y, within :func:`ssd_scan_tol` (the states and
    decays under the state's rule); phase 2's entering states and final
    state exactly (the same two roundings, a multiply then an add, in the
    same order).  ``max_tol_frac_by`` is the worst error over its bound per
    phase and output, ``max_abs_err`` the worst |y| difference."""
    dev = torch.device(device)
    cases, worst, worst_frac, failures, by = 0, 0.0, 0.0, [], {}
    for si, shape in enumerate(shapes):
        Bsz, _, H, P, _, N, Q = shape
        for dt_ in dtypes:
            x, dt, A, Bm, C, D = ssd_inputs(shape, 8000 + si, dt_, dev,
                                            fused=True)
            s0 = torch.randn((Bsz, H, P, N), generator=_gen(9000 + si)).to(dev)
            st_k, dc_k = ssd_chunk_states(x, dt, A, Bm, Q)
            st_p, dc_p = ssd_chunk_states_plain(x, dt, A, Bm, Q)
            ent_k, fin_k = ssd_state_pass(st_p.clone(), dc_p, s0)
            ent_p, fin_p = ssd_state_pass_plain(st_p, dc_p, s0)
            y_k = ssd_chunk_scan(x, dt, A, Bm, C, D, ent_p, Q)
            y_p = ssd_chunk_scan_plain(x, dt, A, Bm, C, D, ent_p, Q)
            y_tol, _ = ssd_scan_tol(y_p, fin_p)
            dy = (y_k.to(torch.float32) - y_p.to(torch.float32)).abs()
            fracs = {
                "chunk_state states": float((st_k - st_p).abs().max())
                / ssd_scan_tol(y_p, st_p)[1],
                "chunk_state decay": float((dc_k - dc_p).abs().max())
                / ssd_scan_tol(y_p, dc_p)[1],
                # exact: any difference fails
                "state_pass entering": 0.0 if torch.equal(ent_k, ent_p)
                else math.inf,
                "state_pass final": 0.0 if torch.equal(fin_k, fin_p)
                else math.inf,
                "chunk_scan y": float((dy / y_tol).max()),
            }
            err = float(dy.max())
            frac = max(fracs.values())
            for k, f in fracs.items():
                key = f"{dt_}".split(".")[-1] + " " + k
                by[key] = max(by.get(key, 0.0), f)
            cases += 1
            worst = max(worst, err)
            worst_frac = max(worst_frac, frac)
            if not frac <= 1.0:
                failures.append(dict(shape=list(shape), dtype=str(dt_),
                                     err=err, tol_frac=fracs))
    return {"cases": cases, "max_abs_err": worst, "failures": failures,
            "max_tol_frac": worst_frac, "max_tol_frac_by": by}


def summarize(result: Dict[str, object], limit: int = 5) -> List[str]:
    """Human-readable lines for a sweep result (first ``limit`` failures)."""
    lines = [f"cases={result['cases']} max_abs_err={result['max_abs_err']} "
             f"failures={len(result['failures'])}"]
    lines += [str(f) for f in result["failures"][:limit]]
    return lines
