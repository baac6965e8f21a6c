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
copies are made.  The host chooses the kernel's mapping and passes it to the
C entry point: :func:`pick_tiles` is the static rule, and :func:`pick_blocks`
(the counterpart of the reference's) times the mappings around it on the
card the first time a shape is seen and caches the winner in process and on
disk (:mod:`repro_torch.kernels.autotune`, ``REPRO_TORCH_AUTOTUNE_CACHE``).
Every CUDA call takes :func:`pick_blocks` unless it passes ``timed=False``
(the static rule) or its own ``tiles``.  In this package :func:`qgemm`
names the int8-mode launch wrapper.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels._build import check, load_kernels
from repro_torch.kernels.qmatmul.ref import (ActQt, fold_scale, qgemm_ref,
                                             qmatmul_int8_act_ref,
                                             qmatmul_ref)
from repro_torch.quant.pack import PACK_ALIGN, unpack_rows
from repro_torch.quant.ptq import derive_view

__all__ = ["qgemm", "qgemm_f32", "qgemm_float", "qgemm_float_plain",
           "qmatmul", "qmatmul_plain", "qmatmul_int8_act",
           "qmatmul_int8_act_plain", "scalar_scale",
           "pick_tiles", "pick_blocks", "candidate_tiles", "Tiles",
           "truncate_view_cuda", "ActQt"]

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


# -- the timed tile pick ---------------------------------------------------------
# qgemm.cu's launch limits, repeated on the host so that the candidates are
# exactly the mappings its `launch` accepts: tiled CTAs stage at least one k
# step of x and w in 48 KB (TILE_SMEM, 48-byte rows TI_PITCH in the int8
# mode), skinny clusters at least one 32-wide step of each of M rows in
# 96 KB (SK_SMEM, SK_WARPS partial sums)
TILED_BN = (8, 16, 32, 64)
SKINNY_BN = (8, 16, 32)
TILED_I8_BM = (16, 32, 64)
TILED_F32_BK = (8, 16, 32)
TILE_SMEM = 48 * 1024
TI_PITCH = 48
SK_SMEM = 96 * 1024
SK_WARPS = 8
# disk-tuple codes of the two mappings (a cache value holds positive ints)
MAPPING_CODES = {"tiled": 1, "skinny": 2}

# the L1 dict: (M, K, N, bits, int8_act, packed, timed) -> Tiles.  int8_act
# False is the float mode, so it also keys the float mode; ``timed`` keeps a
# CPU-side static pick from pinning the rule for later timed calls
_BLOCK_CACHE: Dict[Tuple[int, int, int, int, bool, bool, bool], Tiles] = {}
# one sweep at a time: threads serving one card must not time each other's
# launches
_SWEEP_LOCK = threading.Lock()
# each sweep's report (shape, every candidate's windows, the static pick,
# the pick, the spread), newest last
sweep_reports: deque = deque(maxlen=512)

# the disk half lives in repro_torch.kernels.autotune (one versioned file for
# every kernel family); these aliases keep the reference's module-level names
AUTOTUNE_CACHE_ENV = autotune.AUTOTUNE_CACHE_ENV
_disk_state = autotune._disk_state          # shared BY IDENTITY with autotune
autotune_cache_path = autotune.autotune_cache_path


def _disk_key(key) -> str:
    M, K, N, bits, int8_act, packed, _timed = key
    return f"qgemm:{M}:{K}:{N}:{bits}:{int(int8_act)}:{int(packed)}"


def _disk_cache() -> Dict[str, Tuple[int, ...]]:
    return autotune.disk_cache()


def _disk_put(key, tiles: Tiles) -> None:
    autotune.disk_put(_disk_key(key), encode_tiles(tiles))


def encode_tiles(t: Tiles) -> Tuple[int, ...]:
    """The cache's positive-int tuple of a mapping."""
    return (MAPPING_CODES[t.mapping], t.bm, t.bn, t.bk, t.splits)


def decode_tiles(v: Tuple[int, ...]) -> Optional[Tiles]:
    """The mapping a cache tuple encodes, or None for a tuple of another
    arity or mapping code."""
    names = {c: m for m, c in MAPPING_CODES.items()}
    if len(v) != 5 or v[0] not in names:
        return None
    return Tiles(names[v[0]], *v[1:])


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(t: Tiles, M: int, K: int, N: int, float_mode: bool) -> int:
    """The least shared memory ``qgemm.cu`` stages a call in with mapping
    ``t``: one k step (its chunk loop takes more steps only where they fit),
    counting the raw weight rows and the whole-K x block wherever the kernel
    may stage them.  ``launch`` refuses the mapping above its budget."""
    esz = 4 if float_mode else 1
    if t.mapping == "skinny":
        ldb = N if N <= t.bn else t.bn
        stage = M * (32 + 16 // esz) * esz + _align16(32 * ldb)
        red = (SK_WARPS + 1) * M * t.bn * 4
        return max(stage, red)
    raw_w = _align16(t.bk * N) if N <= t.bn else 0
    raw_a = _align16(t.bm * K * esz) if K <= t.bk else 0
    if float_mode:
        step = t.bm * (t.bk + 4) * 4 + t.bk * t.bn * 4
    else:
        step = (t.bm + t.bn) * TI_PITCH
    return step + raw_w + raw_a


def _legal(t: Tiles, M: int, K: int, N: int, float_mode: bool) -> bool:
    """Whether ``qgemm.cu``'s ``launch`` takes mapping ``t`` for the call."""
    if t.mapping == "skinny":
        ok = (M <= SKINNY_MAX_M and t.bn in SKINNY_BN and t.bk == 32
              and t.splits == SKINNY_CLUSTER)
        return ok and smem_bytes(t, M, K, N, float_mode) <= SK_SMEM
    if t.mapping != "tiled" or t.splits != 1 or t.bn not in TILED_BN:
        return False
    if float_mode:
        ok = t.bm == 512 // t.bn and t.bk in TILED_F32_BK
    else:
        ok = t.bm in TILED_I8_BM and t.bk == 32
    return ok and smem_bytes(t, M, K, N, float_mode) <= TILE_SMEM


def _near(sizes: Tuple[int, ...], v: int) -> Tuple[int, ...]:
    """``v`` and its neighbours in ``sizes``."""
    i = sizes.index(v)
    return sizes[max(i - 1, 0):i + 2]


def candidate_tiles(M: int, K: int, N: int,
                    float_mode: bool = False) -> List[Tiles]:
    """The mappings a sweep times, :func:`pick_tiles`' first: the tiled
    mapping at its BN and one step either side (int8: every BM of 16, 32,
    64; float: BM = 512 / BN and every k step of 8, 16, 32), and where
    M <= 64 the skinny mapping at its BN and one step either side.  Each
    is one that ``qgemm.cu`` takes; a static pick it would refuse raises."""
    default = pick_tiles(M, K, N, float_mode)
    if not _legal(default, M, K, N, float_mode):
        raise ValueError(f"pick_tiles gave {default} for M={M} K={K} N={N}, "
                         "which qgemm.cu refuses")
    out = [default]
    for bn in _near(TILED_BN, _fit(N, TILED_BN)):
        if float_mode:
            out += [Tiles("tiled", 512 // bn, bn, bk) for bk in TILED_F32_BK]
        else:
            out += [Tiles("tiled", bm, bn, 32) for bm in TILED_I8_BM]
    if M <= SKINNY_MAX_M:
        out += [Tiles("skinny", 16 * -(-M // 16), bn, 32, SKINNY_CLUSTER)
                for bn in _near(SKINNY_BN, _fit(N, SKINNY_BN))]
    return [t for t in dict.fromkeys(out) if _legal(t, M, K, N, float_mode)]


def _sweep_operands(M: int, K: int, N: int, bits: int, int8_act: bool,
                    packed: bool):
    """Operands of the real call's shapes, from a fixed seed, on the card:
    x, the weight (the split-row buffer when ``packed``), scale, bias and
    the output, with the path's epilogue (ReLU, requant; int8 codes out in
    the int8 mode)."""
    g = torch.Generator().manual_seed(0)
    dev = torch.device(autotune.SWEEP_DEVICE)
    if int8_act:
        x = torch.randint(-128, 128, (M, K), generator=g, dtype=torch.int8)
    else:
        x = torch.randn((M, K), generator=g)
    if packed:
        rows = -(-K // PACK_ALIGN) * PACK_ALIGN // (8 // bits)
        w = torch.randint(0, 256, (rows, N), generator=g, dtype=torch.uint8)
    else:
        w = torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8)
    s = torch.rand((N,), generator=g) * 1e-2
    b = torch.randn((N,), generator=g) * 0.1
    out = torch.empty((M, N), dtype=torch.int8 if int8_act else torch.float32)
    return [t.to(dev) for t in (x, w, s, b, out)]


def _sweep(key, cands: List[Tiles]) -> Tiles:
    """Time the candidates ``cands`` (the static pick first) of ``key``'s
    call on the card and return the pick (see
    :func:`repro_torch.kernels.autotune.choose`); its report goes to
    :data:`sweep_reports`."""
    M, K, N, bits, int8_act, packed, _timed = key
    float_mode = not int8_act
    default = cands[0]
    x, w, s, b, out = _sweep_operands(M, K, N, bits, int8_act, packed)
    entry = "repro_qgemm_f32" if float_mode else "repro_qgemm_i8"
    aqt = (10, -(2 ** 15), 2 ** 15 - 1) if float_mode else (4, -128, 127)

    def launch(t):
        return lambda: _launch(entry, x, w, None, s, b, out, bits=bits,
                               packed=packed, relu=True, act_qt=aqt,
                               out_code=int8_act, tiles=t)

    times = autotune.time_candidates({t: launch(t) for t in cands})
    pick, spread = autotune.choose(times, default)
    pick_blocks.sweeps += 1
    sweep_reports.append({
        "kernel": "qgemm_f32" if float_mode else "qgemm",
        "shape": [M, K, N], "bits": bits, "packed": packed,
        "candidates": [{"tiles": encode_tiles(t), "windows_ms": v,
                        "best_ms": min(v)} for t, v in times.items()],
        "static": encode_tiles(default), "pick": encode_tiles(pick),
        "spread_ms": spread})
    return pick


def pick_blocks(M: int, K: int, N: int, bits: int, *, int8_act: bool = True,
                packed: bool = False, timed: bool = False) -> Tiles:
    """The mapping ``csrc/qgemm.cu`` runs an (M, K, N) call with at a working
    point (``int8_act`` False: the float mode).

    Lookup order, as in the reference: the in-process dict, then (timed
    picks only) the disk cache, then a timing sweep on the card of
    :func:`candidate_tiles`, whose pick is written through to both (a call
    with one candidate takes it, untimed and not persisted).
    ``timed=False`` (what a call on the CPU gets) returns
    :func:`pick_tiles` and touches neither disk nor card.  A sweep keeps
    :func:`pick_tiles` unless a candidate's best window beats its best
    window by more than the spread the sweep measured.  In the int8 mode
    every mapping gives the same codes; in the float mode the skinny mapping
    sums K in another order than the tiled one, so a pick that switches
    mapping moves float outputs by rounding, within the float paths'
    tolerance.  A disk entry that is not a candidate of the call reads as a
    miss.  Counts sweeps in ``pick_blocks.sweeps``."""
    key = (M, K, N, bits, bool(int8_act), bool(packed), bool(timed))
    hit = _BLOCK_CACHE.get(key)
    if hit is not None:
        return hit
    if not timed:
        tiles = pick_tiles(M, K, N, float_mode=not int8_act)
        _BLOCK_CACHE[key] = tiles
        return tiles
    with _SWEEP_LOCK:
        hit = _BLOCK_CACHE.get(key)
        if hit is not None:
            return hit
        cands = candidate_tiles(M, K, N, not int8_act)
        disk = _disk_cache().get(_disk_key(key))
        tiles = None if disk is None else decode_tiles(disk)
        if len(cands) == 1:
            tiles = cands[0]
        elif tiles not in cands:
            tiles = _sweep(key, cands)
            _disk_put(key, tiles)
        _BLOCK_CACHE[key] = tiles
        return tiles


pick_blocks.sweeps = 0


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
            out_code: bool, tiles: Tiles) -> None:
    M, K = x.shape
    N = out.shape[1]
    frac, qmin, qmax = act_qt if act_qt is not None else (0, 0, 0)
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
          xs: Optional[torch.Tensor] = None, timed: bool = True,
          tiles: Optional[Tiles] = None) -> torch.Tensor:
    """Launch ``csrc/qgemm.cu`` in its int8-activation mode on the current
    CUDA stream.

    x_codes (M, K) int8; w (K, N) int8 master codes, or with ``packed`` the
    split-row (kp_rows, N) uint8 buffer with kp_rows * 8/bits >= K; s_eff (N,)
    f32 — the channel scale with the sub-byte step and, when ``xs`` is None,
    the scalar activation scale folded in; xs (M,) f32 per-row activation
    scale or None; bias (N,) f32 or None.  Returns (M, N) int8 codes when
    ``out_code``, else f32.  The mapping is ``tiles``, else
    :func:`pick_blocks` (``timed``: the timed pick; otherwise the static
    rule).  Counts launches in ``qgemm.launches``."""
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
    if tiles is None:
        tiles = pick_blocks(M, K, N, bits, int8_act=True, packed=packed,
                            timed=timed)
    _launch("repro_qgemm_i8", x_codes, w, xs, s_eff, bias, out, bits=bits,
            packed=packed, relu=relu, act_qt=act_qt, out_code=out_code,
            tiles=tiles)
    qgemm.launches += 1
    return out


qgemm.launches = 0


def qgemm_f32(x: torch.Tensor, w: torch.Tensor, s_eff: torch.Tensor,
              bias: Optional[torch.Tensor] = None, *, bits: int, packed: bool,
              relu: bool, act_qt: Optional[ActQt], timed: bool = True,
              tiles: Optional[Tiles] = None) -> torch.Tensor:
    """Launch ``csrc/qgemm.cu`` in its float-activation mode on the current
    CUDA stream: x (M, K) f32, the weight operands as for :func:`qgemm`,
    s_eff (N,) the channel scale with the sub-byte step folded in; the
    mapping as for :func:`qgemm`.  Returns (M, N) f32.  Counts launches in
    ``qgemm_f32.launches``."""
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
    if tiles is None:
        tiles = pick_blocks(M, K, N, bits, int8_act=False, packed=packed,
                            timed=timed)
    _launch("repro_qgemm_f32", x, w, None, s_eff, bias, out, bits=bits,
            packed=packed, relu=relu, act_qt=act_qt, out_code=False,
            tiles=tiles)
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
                     out_dtype: torch.dtype = torch.float32,
                     timed: bool = True) -> torch.Tensor:
    """Fully-integer Gemm: x_codes (..., K) int8 activation codes, int32 MACs,
    the fused epilogue re-quantizing straight to the consumer's code.

    ``x_scale`` is the producer FIFO's activation scale: a scalar (the writer
    path's power of two, folded into the per-channel weight scale) or a
    per-row tensor with one entry per row of ``x_codes`` (the reference's
    dynamic-range path, applied to the accumulator first).  ``codes`` is
    (K, N) int8 or, with ``packed=True``, the split-row (K'/r, N) uint8
    buffer.  ``out_code=True`` returns int8 codes (``act_qt`` required), else
    the decoded float in ``out_dtype``.  On the card the mapping is the
    timed :func:`pick_blocks`, or with ``timed=False`` the static rule."""
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
                  out_code=out_code, xs=rows, timed=timed)
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
                packed: bool = False, timed: bool = True) -> torch.Tensor:
    """Float-activation Gemm with the fused epilogue (the reference's
    ``qgemm``): x (..., K) float; ``codes`` (K, N) int8 master or, with
    ``packed=True``, the split-row (K'/r, N) uint8 buffer; scale (N,) f32;
    bias (N,) or None; ``act_qt`` the consumer's fixed-point activation
    quant; ``timed`` as for :func:`qmatmul_int8_act`.  Returns (..., N) in
    x's dtype."""
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
                      relu=relu, act_qt=act_qt, timed=timed).to(x.dtype)
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
            bits: int = 8, timed: bool = True) -> torch.Tensor:
    """Dequant matmul (the reference's ``qmatmul``): x (..., K) float;
    codes (K, N) int8 master; scale (N,) f32 -> (..., N) in x's dtype.

    Where ``min(M, K, N) >= 8`` the activations are rounded to bf16 (exact
    in f32) and a CUDA tensor launches ``csrc/qgemm.cu``'s f32 mode with the
    channel scale, no bias and no ReLU (the kernel sums x * code in f32 and
    scales once); a CPU tensor runs :func:`qmatmul_plain`.  Otherwise the
    oracle :func:`~repro_torch.kernels.qmatmul.ref.qmatmul_ref` runs on any
    device, with no bf16 rounding.  ``timed`` as for
    :func:`qmatmul_int8_act`.  Counts the kernel's launches in
    ``qmatmul.launches``."""
    x2, N, small = _qmatmul_operands(x, codes)
    if small or x2.device.type == "cpu":
        return qmatmul_plain(x, codes, scale, bits=bits)
    if x2.device.type != "cuda":
        raise ValueError(f"no qmatmul path for device {x2.device}")
    xb = x2.to(torch.bfloat16).to(torch.float32).contiguous()
    y = qgemm_f32(xb, codes.contiguous(),
                  scale.reshape(-1).to(torch.float32).contiguous(),
                  bits=bits, packed=False, relu=False, act_qt=None,
                  timed=timed)
    qmatmul.launches += 1
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


qmatmul.launches = 0
