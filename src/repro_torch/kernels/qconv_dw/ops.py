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
reshape copies.  The host chooses each block's channel tile and band of
output columns: :func:`dw_tiles` is the static rule, and
:func:`pick_blocks_dw` (the counterpart of the reference's, which tunes its
channel block) times the tiles around it on the card the first time a shape
is seen and caches the winner in process and on disk
(:mod:`repro_torch.kernels.autotune`).  In this package :func:`qconv_dw`
names the int8-mode launch wrapper.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import autotune
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
           "qconv_dw_int8_act_plain", "dw_tiles", "candidate_dw_tiles",
           "pick_blocks_dw", "DW_PACK_ALIGN", "ActQt"]


# -- the block's tiles ----------------------------------------------------------
# qconv_dw.cu's limits: a channel tile of whole 4-channel vectors (single
# channels where C % 4 != 0) up to MAX_CT, a band of up to MAX_OWB output
# columns, the tile's tap rows and input slab within SMEM_BUDGET
MAX_CT = 64
MAX_OWB = 64
SMEM_BUDGET = 48 * 1024


def _vec(C: int) -> int:
    return 4 if C % 4 == 0 else 1


def dw_smem_bytes(ct: int, owb: int, *, kh: int, kw: int, sw: int,
                  float_mode: bool) -> int:
    """The shared memory ``qconv_dw.cu`` stages a block in: the ``ct``
    channels' taps as 32-bit values (16-byte aligned), then kh input rows
    of the band's input columns x ``ct`` channels."""
    taps = (kh * kw * ct * 4 + 15) & ~15
    return taps + kh * ((owb - 1) * sw + kw) * ct * (4 if float_mode else 1)


def _dw_legal(tile: Tuple[int, int], C: int, *, kh: int, kw: int, sw: int,
              float_mode: bool) -> bool:
    ct, owb = tile
    vec = _vec(C)
    return (vec <= ct <= MAX_CT and ct % vec == 0 and 1 <= owb <= MAX_OWB
            and dw_smem_bytes(ct, owb, kh=kh, kw=kw, sw=sw,
                              float_mode=float_mode) <= SMEM_BUDGET)


def dw_tiles(C: int, OW: int, *, kh: int, kw: int, sw: int,
             float_mode: bool) -> Tuple[int, int]:
    """(ct, owb) of an untuned call: every channel (up to 64) and every
    output column (up to 64) of a row, the band halved, then the channel
    tile, until the block fits in shared memory."""
    vec = _vec(C)
    ct, owb = min(C, MAX_CT), min(OW, MAX_OWB)

    def over():
        return dw_smem_bytes(ct, owb, kh=kh, kw=kw, sw=sw,
                             float_mode=float_mode) > SMEM_BUDGET

    while over() and owb > 1:
        owb = (owb + 1) // 2
    while over() and ct > vec:
        ct = max((ct // 2) // vec * vec, vec)
    if over():
        raise ValueError(f"no qconv_dw tile fits {kh}x{kw} stride {sw} in "
                         f"{SMEM_BUDGET} B of shared memory")
    return ct, owb


def candidate_dw_tiles(C: int, OW: int, *, kh: int, kw: int, sw: int,
                       float_mode: bool) -> List[Tuple[int, int]]:
    """The tiles a sweep times, :func:`dw_tiles`' first: its channel tile
    halved up to twice (in whole channel vectors) times its band halved up
    to twice, each one ``qconv_dw.cu`` takes."""
    geo = dict(kh=kh, kw=kw, sw=sw, float_mode=float_mode)
    ct0, owb0 = dw_tiles(C, OW, **geo)
    vec = _vec(C)
    cts = [c for c in (ct0, ct0 // 2, ct0 // 4) if c >= vec and c % vec == 0]
    owbs = (owb0, -(-owb0 // 2), -(-owb0 // 4))
    out = [(ct0, owb0)] + [(c, o) for c in cts for o in owbs]
    return [t for t in dict.fromkeys(out) if _dw_legal(t, C, **geo)]


# the L1 dict: (B, H, W, C, OH, OW, kh, kw, sh, sw, bits, int8_act, packed,
# timed) -> (ct, owb); its disk half is repro_torch.kernels.autotune's file
# under "qconv_dw:" keys, 2-tuples
_TILE_CACHE: Dict[tuple, Tuple[int, int]] = {}
_SWEEP_LOCK = threading.Lock()
# each sweep's report, newest last (as qmatmul.ops.sweep_reports)
sweep_reports: deque = deque(maxlen=512)


def _disk_key_dw(key) -> str:
    B, H, W, C, OH, OW, kh, kw, sh, sw, bits, int8_act, packed, _t = key
    return (f"qconv_dw:{B}:{H}:{W}:{C}:{OH}x{OW}:{kh}x{kw}:{sh}x{sw}:{bits}:"
            f"{int(int8_act)}:{int(packed)}")


def _sweep_dw(key, cands: List[Tuple[int, int]], hpad: Tuple[int, int],
              wpad: Tuple[int, int]) -> Tuple[int, int]:
    """Time the candidate tiles ``cands`` (the static pick first) of
    ``key``'s call (its (top, bottom) and (left, right) pads ``hpad``,
    ``wpad``) on the card and return the pick (see
    :func:`repro_torch.kernels.autotune.choose`)."""
    B, H, W, C, OH, OW, kh, kw, sh, sw, bits, int8_act, packed, _t = key
    pt, pl = hpad[0], wpad[0]
    default = cands[0]
    g = torch.Generator().manual_seed(0)
    if int8_act:
        x = torch.randint(-128, 128, (B, H, W, C), generator=g,
                          dtype=torch.int8)
    else:
        x = torch.randn((B, H, W, C), generator=g)
    taps = kh * kw
    if packed:
        rows = -(-taps // DW_PACK_ALIGN) * DW_PACK_ALIGN // (8 // bits)
        w = torch.randint(0, 256, (rows, C), generator=g,
                          dtype=torch.uint8)
    else:
        rows = taps
        w = torch.randint(-127, 128, (taps, C), generator=g,
                          dtype=torch.int8)
    s = torch.rand((C,), generator=g) * 1e-2
    b = torch.randn((C,), generator=g) * 0.1
    out = torch.empty((B, OH, OW, C),
                      dtype=torch.int8 if int8_act else torch.float32)
    x, w, s, b, out = (t.to(autotune.SWEEP_DEVICE)
                       for t in (x, w, s, b, out))
    entry = "repro_qconv_dw_i8" if int8_act else "repro_qconv_dw_f32"
    aqt = (4, -128, 127) if int8_act else (10, -(2 ** 15), 2 ** 15 - 1)

    def launch(tile):
        return lambda: _launch(
            entry, x, w, s, b, out, kh=kh, kw=kw, sh=sh, sw=sw, pt=pt,
            pl=pl, bits=bits, packed=packed, kp_rows=rows, relu=True,
            act_qt=aqt, out_code=int8_act, tile=tile)

    times = autotune.time_candidates({t: launch(t) for t in cands})
    pick, spread = autotune.choose(times, default)
    pick_blocks_dw.sweeps += 1
    sweep_reports.append({
        "kernel": "qconv_dw" if int8_act else "qconv_dw_f32",
        "shape": [B, H, W, C], "window": [kh, kw], "strides": [sh, sw],
        "pads": [list(hpad), list(wpad)], "out": [OH, OW], "bits": bits,
        "packed": packed,
        "candidates": [{"tiles": list(t), "windows_ms": v, "best_ms": min(v)}
                       for t, v in times.items()],
        "static": list(default), "pick": list(pick), "spread_ms": spread})
    return pick


def pick_blocks_dw(B: int, H: int, W: int, C: int, *, kh: int, kw: int,
                   strides=(1, 1), pads="SAME", bits: int = 8,
                   int8_act: bool = True, packed: bool = False,
                   timed: bool = False) -> Tuple[int, int]:
    """(ct, owb) for a depthwise call at a working point (``int8_act``
    False: the float mode): the in-process dict, then (timed picks only)
    the disk cache, then a timing sweep on the card of
    :func:`candidate_dw_tiles`, written through to both (a call with one
    candidate takes it, untimed and not persisted).  ``timed=False``
    (what a call on the CPU gets) returns :func:`dw_tiles` and touches
    neither disk nor card.  Each channel's taps are summed in the same
    order whatever the tile, so every candidate gives the same result bit
    for bit in both modes.  Counts sweeps in ``pick_blocks_dw.sweeps``."""
    sh, sw = (int(v) for v in strides)
    OH, OW, hpad, wpad = out_spatial(H, W, kh, kw, (sh, sw),
                                     normalize_pads(pads))
    key = (B, H, W, C, OH, OW, kh, kw, sh, sw, bits, bool(int8_act),
           bool(packed), bool(timed))
    hit = _TILE_CACHE.get(key)
    if hit is not None:
        return hit
    geo = dict(kh=kh, kw=kw, sw=sw, float_mode=not int8_act)
    if not timed:
        tile = dw_tiles(C, OW, **geo)
        _TILE_CACHE[key] = tile
        return tile
    with _SWEEP_LOCK:
        hit = _TILE_CACHE.get(key)
        if hit is not None:
            return hit
        cands = candidate_dw_tiles(C, OW, **geo)
        dk = _disk_key_dw(key)
        disk = autotune.disk_cache().get(dk)
        if len(cands) == 1:
            tile = cands[0]
        elif disk is not None and tuple(disk) in cands:
            tile = tuple(disk)
        else:
            tile = _sweep_dw(key, cands, hpad, wpad)
            autotune.disk_put(dk, tile)
        _TILE_CACHE[key] = tile
        return tile


pick_blocks_dw.sweeps = 0


def _launch(entry: str, x: torch.Tensor, w: torch.Tensor,
            s_eff: torch.Tensor, bias: Optional[torch.Tensor],
            out: torch.Tensor, *, kh: int, kw: int, sh: int, sw: int,
            pt: int, pl: int, bits: int, packed: bool, kp_rows: int,
            relu: bool, act_qt: Optional[ActQt], out_code: bool,
            tile: Tuple[int, int]) -> None:
    """Launch the C entry point ``entry`` into ``out`` on the current
    stream; raises if the kernel refuses the call."""
    B, H, W, C = x.shape
    _, OH, OW, _ = out.shape
    frac, qmin, qmax = act_qt if act_qt is not None else (0, 0, 0)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), w.data_ptr(), s_eff.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            B, H, W, C, OH, OW, kh, kw, sh, sw, pt, pl, bits, int(packed),
            kp_rows, int(relu), int(act_qt is not None), int(out_code), qmin,
            qmax, tile[0], tile[1], 2.0 ** frac, 2.0 ** -frac, stream)
    check(rc, entry)


def _run(entry: str, x: torch.Tensor, w: torch.Tensor,
         s_eff: torch.Tensor, bias: Optional[torch.Tensor], *, kh: int,
         kw: int, strides: Tuple[int, int], pads, bits: int, packed: bool,
         relu: bool, act_qt: Optional[ActQt], out_code: bool, timed: bool,
         tile: Optional[Tuple[int, int]]) -> torch.Tensor:
    """Check the operands of either mode, allocate the output, choose the
    tile (``tile``, else :func:`pick_blocks_dw`) and launch ``entry``;
    returns the output (empty when there is no work)."""
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
    pads = normalize_pads(pads)
    oh, ow, (pt, _), (pl, _) = out_spatial(H, W, kh, kw, (sh, sw), pads)
    out = torch.empty((B, oh, ow, C),
                      dtype=torch.int8 if out_code else torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    if tile is None:
        tile = pick_blocks_dw(B, H, W, C, kh=kh, kw=kw, strides=(sh, sw),
                              pads=pads, bits=bits,
                              int8_act=x.dtype == torch.int8, packed=packed,
                              timed=timed)
    _launch(entry, x, w, s_eff, bias, out, kh=kh, kw=kw, sh=sh, sw=sw,
            pt=pt, pl=pl, bits=bits, packed=packed,
            kp_rows=rows if packed else taps, relu=relu, act_qt=act_qt,
            out_code=out_code, tile=tile)
    return out


def qconv_dw(x_codes: torch.Tensor, w: torch.Tensor, s_eff: torch.Tensor,
             bias: Optional[torch.Tensor] = None, *, kh: int, kw: int,
             strides: Tuple[int, int], pads, bits: int, packed: bool,
             relu: bool, act_qt: Optional[ActQt], out_code: bool,
             timed: bool = True,
             tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Launch ``csrc/qconv_dw.cu`` in its int8-activation mode on the
    current CUDA stream.

    x_codes (B, H, W, C) int8; w (kh*kw, C) int8 tap rows, or with
    ``packed`` the split-row (kp_rows, C) uint8 buffer with
    kp_rows * 8/bits >= kh*kw; s_eff (C,) f32 folded scale; bias (C,) f32 or
    None.  Returns (B, OH, OW, C) int8 codes when ``out_code``, else f32.
    The block's (ct, owb) are ``tile``, else :func:`pick_blocks_dw`
    (``timed``: the timed pick; otherwise :func:`dw_tiles`).  Counts
    launches in ``qconv_dw.launches``."""
    check_epilogue(act_qt, out_code)
    _expect(x_codes, "x_codes", torch.int8, 4, x_codes.device)
    out = _run("repro_qconv_dw_i8", x_codes, w, s_eff, bias, kh=kh, kw=kw,
               strides=strides, pads=pads, bits=bits, packed=packed,
               relu=relu, act_qt=act_qt, out_code=out_code, timed=timed,
               tile=tile)
    if out.numel():
        qconv_dw.launches += 1
    return out


qconv_dw.launches = 0


def qconv_dw_f32(x: torch.Tensor, w: torch.Tensor, s_eff: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, kh: int, kw: int,
                 strides: Tuple[int, int], pads, bits: int, packed: bool,
                 relu: bool, act_qt: Optional[ActQt], timed: bool = True,
                 tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Launch ``csrc/qconv_dw.cu`` in its float-activation mode on the
    current CUDA stream: x (B, H, W, C) f32, the weight operands as for
    :func:`qconv_dw`, s_eff (C,) the channel scale with the sub-byte step
    folded in; the tile as for :func:`qconv_dw`.  Returns (B, OH, OW, C)
    f32.  Counts launches in ``qconv_dw_f32.launches``."""
    _expect(x, "x", torch.float32, 4, x.device)
    out = _run("repro_qconv_dw_f32", x, w, s_eff, bias, kh=kh, kw=kw,
               strides=strides, pads=pads, bits=bits, packed=packed,
               relu=relu, act_qt=act_qt, out_code=False, timed=timed,
               tile=tile)
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
                      out_dtype: torch.dtype = torch.float32,
                      timed: bool = True) -> torch.Tensor:
    """Fully-integer direct depthwise conv: x_codes (B, H, W, C) int8
    activation codes, int32 window MACs, the producer's scalar power-of-two
    ``x_scale`` folded into the per-channel weight scale, and
    ``out_code=True`` emitting the consumer's int8 codes.  ``codes`` is
    (kh*kw, C) int8 or, with ``packed=True``, the split-row
    (align(kh*kw, 8)/r, C) uint8 buffer.  On the card the tile is the timed
    :func:`pick_blocks_dw`, or with ``timed=False`` :func:`dw_tiles`."""
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
                     act_qt=act_qt, out_code=out_code, timed=timed)
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
                   packed: bool = False, timed: bool = True) -> torch.Tensor:
    """Float-activation direct depthwise conv with the fused epilogue (the
    reference's ``qconv_dw``): x (B, H, W, C) float NHWC; ``codes`` (kh*kw,
    C) int8 master tap rows or, with ``packed=True``, the split-row
    (align(kh*kw, 8)/r, C) uint8 buffer; scale (C,) f32; bias (C,) or None;
    ``timed`` as for :func:`qconv_dw_int8_act`.  Returns (B, OH, OW, C) in
    x's dtype."""
    _check_packed(codes, kh * kw, bits, packed)
    pads = normalize_pads(pads)
    if x.device.type == "cuda":
        s_eff = fold_scale(scale, 1.0, bits, packed).contiguous()
        y = qconv_dw_f32(x.to(torch.float32).contiguous(), codes.contiguous(),
                         s_eff, _bias_f32(bias), kh=kh, kw=kw,
                         strides=strides, pads=pads, bits=bits, packed=packed,
                         relu=relu, act_qt=act_qt, timed=timed)
        return y.to(x.dtype)
    if x.device.type == "cpu":
        return qconv_dw_float_plain(
            x, codes, scale, bias, kh=kh, kw=kw, strides=strides, pads=pads,
            bits=bits, relu=relu, act_qt=act_qt, packed=packed,
            out_dtype=x.dtype)
    raise ValueError(f"no qconv_dw_float path for device {x.device}")
