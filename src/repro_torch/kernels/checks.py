"""Kernel-against-plain-version sweeps (no counterpart in ``repro``).

Each sweep feeds the same seeded inputs to a kernel's entry point and to its
plain PyTorch version on the same device and requires exact equality — the
integer paths leave no room for float drift.  On a CUDA device the entry
point launches the hand-written kernel; on the CPU it runs the plain version
itself (which only exercises the sweep).  ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py`` run these on the card.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.qconv_dw.ops import (DW_PACK_ALIGN,
                                              qconv_dw_int8_act,
                                              qconv_dw_int8_act_plain)
from repro_torch.kernels.qmatmul.ops import (qmatmul_int8_act,
                                             qmatmul_int8_act_plain)
from repro_torch.quant.pack import PACK_ALIGN, pack_rows

# (M, K, N) of every qgemm call of the slice's main path at batch 8:
# separable-cnn stem (im2col 3x3x1), pw0, pw1, fc; mnist-cnn conv0, conv1, fc
QGEMM_PATH_SHAPES = ((6272, 9, 8), (1568, 8, 16), (392, 16, 32), (8, 1568, 10),
                     (6272, 9, 16), (1568, 144, 32))
QGEMM_RAGGED = tuple(itertools.product((1, 7, 6272), (8, 9, 1568, 1100),
                                       (8, 10, 32, 130)))
# (B, H, W, C) of the depthwise inputs: separable-cnn dw0/dw1 at batch 8,
# then ragged ones (odd spatial sizes, C not a multiple of 8 or of 32)
QCONV_DW_SHAPES = ((8, 14, 14, 8), (8, 14, 14, 16), (1, 11, 10, 130),
                   (7, 9, 9, 8), (2, 28, 28, 32), (3, 5, 7, 10))
DW_STRIDES = ((1, 1), (2, 2), (1, 2))
DW_PADS = ("SAME", "VALID")

# weight working points: (bits, packed)
WEIGHT_VARIANTS = ((8, False), (4, False), (2, False), (4, True), (2, True))
# epilogues: int8 codes, decoded 16-bit fake-quant, plain float
EPILOGUES = ("code", "fq", "float")


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _act_qt(kind: str, frac: int) -> Optional[Tuple[int, int, int]]:
    if kind == "code":
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


def _variants() -> Iterator[Tuple[int, bool, str, bool, bool]]:
    for (bits, packed), epi, relu, bias in itertools.product(
            WEIGHT_VARIANTS, EPILOGUES, (False, True), (False, True)):
        yield bits, packed, epi, relu, bias


def _compare(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.dtype != want.dtype or got.shape != want.shape:
        return math.inf
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max()) \
        if got.numel() else 0.0


def qgemm_sweep(device, shapes: Optional[Sequence[Tuple[int, int, int]]] = None
                ) -> Dict[str, object]:
    """``qmatmul_int8_act`` against its plain version over bits {8,4,2} x
    packed x epilogue x ReLU x bias at ``shapes`` (default: the path's shapes
    plus the ragged product)."""
    shapes = list(shapes or (QGEMM_PATH_SHAPES + QGEMM_RAGGED))
    dev = torch.device(device)
    cases, worst, failures = 0, 0.0, []
    for si, (M, K, N) in enumerate(shapes):
        g = _gen(1000 + si)
        x = torch.randint(-128, 128, (M, K), generator=g,
                          dtype=torch.int8).to(dev)
        codes, s = _weights(g, K, N)
        b = (torch.randn((N,), generator=g) * 0.1).to(dev)
        codes, s = codes.to(dev), s.to(dev)
        xs = 2.0 ** -4
        packs = {bits: pack_rows(codes, bits, PACK_ALIGN) for bits in (4, 2)}
        for bits, packed, epi, relu, bias in _variants():
            w = packs[bits] if packed else codes
            common = dict(bits=bits, relu=relu, packed=packed)
            y0 = qmatmul_int8_act_plain(x, xs, w, s, b, act_qt=None,
                                        out_code=False, **common)
            aqt = _act_qt(epi, _frac_for(y0))
            args = (x, xs, w, s, b if bias else None)
            got = qmatmul_int8_act(*args, act_qt=aqt, out_code=epi == "code",
                                   **common)
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


def qconv_dw_sweep(device,
                   shapes: Optional[Sequence[Tuple[int, int, int, int]]] = None,
                   strides: Sequence[Tuple[int, int]] = DW_STRIDES,
                   pads: Sequence[str] = DW_PADS) -> Dict[str, object]:
    """``qconv_dw_int8_act`` against its plain version over bits {8,4,2} x
    packed x strides x SAME/VALID x epilogue x ReLU x bias."""
    shapes = list(shapes or QCONV_DW_SHAPES)
    dev = torch.device(device)
    cases, worst, failures = 0, 0.0, []
    for si, (B, H, W, C) in enumerate(shapes):
        g = _gen(2000 + si)
        x = torch.randint(-128, 128, (B, H, W, C), generator=g,
                          dtype=torch.int8).to(dev)
        codes, s = _weights(g, 9, C)
        b = (torch.randn((C,), generator=g) * 0.1).to(dev)
        codes, s = codes.to(dev), s.to(dev)
        xs = 2.0 ** -6
        packs = {bits: pack_rows(codes, bits, DW_PACK_ALIGN) for bits in (4, 2)}
        for st, pd in itertools.product(strides, pads):
            for bits, packed, epi, relu, bias in _variants():
                w = packs[bits] if packed else codes
                common = dict(kh=3, kw=3, strides=st, pads=pd, bits=bits,
                              relu=relu, packed=packed)
                y0 = qconv_dw_int8_act_plain(x, xs, w, s, b, act_qt=None,
                                             out_code=False, **common)
                aqt = _act_qt(epi, _frac_for(y0))
                args = (x, xs, w, s, b if bias else None)
                got = qconv_dw_int8_act(*args, act_qt=aqt,
                                        out_code=epi == "code", **common)
                want = qconv_dw_int8_act_plain(*args, act_qt=aqt,
                                               out_code=epi == "code",
                                               **common)
                err = _compare(got, want)
                cases += 1
                worst = max(worst, err)
                if err != 0.0 or not torch.equal(got, want):
                    failures.append(dict(B=B, H=H, W=W, C=C, strides=st,
                                         pads=pd, bits=bits, packed=packed,
                                         epilogue=epi, relu=relu, bias=bias,
                                         err=err))
    return {"cases": cases, "max_abs_err": worst, "failures": failures}


def summarize(result: Dict[str, object], limit: int = 5) -> List[str]:
    """Human-readable lines for a sweep result (first ``limit`` failures)."""
    lines = [f"cases={result['cases']} max_abs_err={result['max_abs_err']} "
             f"failures={len(result['failures'])}"]
    lines += [str(f) for f in result["failures"][:limit]]
    return lines
