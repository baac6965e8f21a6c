"""Public entry point of the streaming line-buffer convolution (counterpart
of ``repro.kernels.conv2d_stream.ops``).

``conv2d_stream(x, w, b)`` — SAME padding, stride 1 — dispatches on x's
device: a CUDA tensor launches the hand-written kernel
``csrc/conv2d_stream.cu`` through :func:`conv2d_stream_cuda`; a CPU tensor
runs the plain version
(:func:`~repro_torch.kernels.conv2d_stream.ref.conv2d_stream_plain`).  x and
w may each be f32 or bf16 (``compose_adaptive`` feeds bf16 weights, and a
bf16 or f32 stream); the output takes x's dtype, as the reference's does.

Like the reference, the convolution takes no strides and no pads: a graph
node that asks for other ones is refused by :func:`require_stream_window`
instead of being computed wrongly.

The kernel's mapping of a call — output rows, W tile and Cout tile per
block, the per-thread register tile, the window instance, the staging units
and the shared memory — is chosen on the host by :func:`stream_tiles`,
plain Python that runs (and is tested) anywhere.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels._build import check, load_kernels
from repro_torch.kernels.conv2d_stream.ref import (conv2d_stream_plain,
                                                   stream_pads)
from repro_torch.kernels.qconv_dw.ref import pad_amounts, normalize_pads

__all__ = ["conv2d_stream", "conv2d_stream_cuda", "require_stream_window",
           "stream_tiles", "StreamTiles", "SMEM_BYTES",
           "conv2d_stream_info"]

_FLOAT = (torch.float32, torch.bfloat16)
# the hard limits conv2d_stream.cu's entry point holds a mapping to (its
# SMEM_LIMIT and MAX_THREADS); the threads and shared memory of a mapping
# are worked out here only, by stream_tiles.  A block's shared memory on
# Hopper: 227 KB, as dynamic shared memory
SMEM_BYTES = 232448
SMS = 132                  # streaming multiprocessors of an H100 SXM
MAX_THREADS = 256          # a block's threads at most
FILL_THREADS = SMS * 256   # 8 warps on every SM
MIN_TW = 8                 # the narrowest W tile a row is cut to
MAX_TW = 32                # the widest W tile
MAX_CT = 64                # the widest Cout tile
MAX_ROWS = 8               # output rows per block at most
MIN_CHAIN = 32             # products a thread sums at least, once split
# window instances of the kernel: 1x1 and 3x3 at compile time, 0 generic
WINDOWS = {(1, 1): 1, (3, 3): 3}


class StreamTiles(NamedTuple):
    """The mapping ``conv2d_stream.cu`` runs for one call: one block per
    (image, ``rows`` output rows, ``tw`` output columns, ``ct`` output
    channels); each thread owns ``px`` pixels x ``co`` channels, and ``ks``
    threads share each such tile, each summing every ``ks``-th input channel
    (then adding their partial sums in a fixed order);
    ``window`` the compile-time window (1 or 3, 0 the generic one);
    ``ci_vec`` input channels per shared load of x; ``x_unit`` and
    ``w_unit`` elements per staging copy; ``threads`` a block;
    ``grid`` (blocks along images x row tiles x W tiles, along Cout tiles);
    ``smem_bytes`` the f32 filter slice, ``rows + kh - 1`` staged input
    rows of ``tw + kw - 1`` pixels and the ``ks - 1`` groups' partial
    sums."""
    rows: int
    tw: int
    ct: int
    px: int
    co: int
    ks: int
    window: int
    ci_vec: int
    x_unit: int
    w_unit: int
    threads: int
    grid: Tuple[int, int]
    smem_bytes: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem(kh: int, kw: int, cin: int, rows: int, tw: int, ct: int,
          px: int = 1, co: int = 4, ks: int = 1) -> int:
    group = _cdiv(rows * tw, px) * (ct // co)
    return 4 * cin * (kh * kw * ct + (rows + kh - 1) * (tw + kw - 1)) \
        + 4 * (ks - 1) * px * co * group


def _halve_ct(ct: int) -> int:
    """The next narrower Cout tile: halved to a multiple of 4, then from 4
    channels to 1 (one channel a thread)."""
    return 1 if ct <= 4 else max(4, 4 * _cdiv(ct // 2, 4))


def stream_tiles(B: int, H: int, W: int, Cin: int, Cout: int, kh: int,
                 kw: int, x_bytes: int = 4, w_bytes: int = 4) -> StreamTiles:
    """The kernel's mapping for x (B, H, W, Cin) of ``x_bytes`` per element
    and w (kh, kw, Cin, Cout) of ``w_bytes``.

    1. Tiles: Cout in balanced tiles of at most 64 channels (a multiple of
       4: each thread owns 4 channels), W in balanced tiles of at most 32
       columns.
    2. Pixels per thread: 4 where the call has 4x enough 4-channel items to
       put 8 warps on every SM, 2 where it has 2x, else 1 (or 2, where a
       block would exceed 256 threads; the generic window stops at 2).
    3. Shared memory: while the filter slice and the staged rows exceed 227
       KB, narrow the larger of the two: the Cout tile (down to one channel,
       then one channel a thread) or the W tile (down to 8 columns).  A call
       is refused only when one output channel's filter slice plus kh rows
       of an 8-pixel W tile do not fit.
    4. Blocks: while there are fewer blocks than SMs, narrow the Cout tile
       (to 4 channels), then the W tile (to 8 columns).
    5. Split: where the call still puts fewer than 8 warps on an SM, ks = 4
       or 2 thread groups share each output tile's kh*kw*Cin sum, as long
       as each keeps at least 32 products and the block 256 threads: a
       shorter chain of dependent fmas a thread.
    6. Rows per block: the most (up to 8) whose block stays within 256
       threads and 227 KB and keeps at least one block per SM, so the
       R + kh - 1 staged rows feed R output rows.
    """
    for name, v in (("B", B), ("H", H), ("W", W), ("Cin", Cin),
                    ("Cout", Cout), ("kh", kh), ("kw", kw)):
        if v < 1:
            raise ValueError(f"conv2d_stream needs {name} >= 1, got {v}")
    need = 4 * (kh * kw * Cin + kh * (min(W, MIN_TW) + kw - 1) * Cin)
    if need > SMEM_BYTES:
        raise ValueError(
            f"a {kh}x{kw} window over {Cin} input channels needs {need} B "
            f"of shared memory for one output channel's filter slice plus "
            f"{kh} rows of an {min(W, MIN_TW)}-pixel W tile, over the "
            f"{SMEM_BYTES}-byte limit of a block")
    nct = _cdiv(Cout, MAX_CT)
    ct = 4 * _cdiv(_cdiv(Cout, nct), 4)
    tw = _cdiv(W, _cdiv(W, MAX_TW))
    min_tw = min(W, MIN_TW)
    items = B * H * W * _cdiv(Cout, 4)
    # the generic window's instances stop at 2 pixels a thread (4 spill)
    max_px = 4 if (kh, kw) in WINDOWS else 2
    px = 4 if items >= 4 * FILL_THREADS else 2 if items >= 2 * FILL_THREADS \
        else 1
    px = min(px, max_px)

    def co_of(c: int) -> int:
        return 4 if c % 4 == 0 else 1

    def threads(rows: int, tw_: int, ct_: int, ks_: int = 1) -> int:
        p = px if co_of(ct_) == 4 else 1
        return 32 * _cdiv(ks_ * _cdiv(rows * tw_, p) * (ct_ // co_of(ct_)),
                          32)

    def blocks(rows: int, tw_: int, ct_: int) -> int:
        return B * _cdiv(H, rows) * _cdiv(W, tw_) * _cdiv(Cout, ct_)

    while _smem(kh, kw, Cin, 1, tw, ct) > SMEM_BYTES:
        filt = kh * kw * ct
        line = kh * (tw + kw - 1)
        if (filt >= line or tw <= min_tw) and ct > 1:
            ct = _halve_ct(ct)
        else:
            tw = max(min_tw, _cdiv(tw, 2))
    while blocks(1, tw, ct) < SMS:
        if ct > 4:
            ct = _halve_ct(ct)
        elif tw > min_tw:
            tw = max(min_tw, _cdiv(tw, 2))
        else:
            break
    # a 32-column tile of 64 channels needs 2 pixels a thread to fit 256
    while threads(1, tw, ct) > MAX_THREADS:
        px *= 2
    assert px <= max_px
    co = co_of(ct)
    if co == 1:
        px, window, ci_vec = 1, 0, 1
    else:
        window = WINDOWS.get((kh, kw), 0)
        ci_vec = 4 if Cin % 4 == 0 else 1
    ks = 1
    if co == 4 and blocks(1, tw, ct) * threads(1, tw, ct) < FILL_THREADS:
        for k in (4, 2):
            if kh * kw * Cin >= MIN_CHAIN * k and Cin >= k * ci_vec \
                    and threads(1, tw, ct, k) <= MAX_THREADS \
                    and _smem(kh, kw, Cin, 1, tw, ct, px, co, k) \
                    <= SMEM_BYTES:
                ks = k
                break
    assert ks == 1 or px == 1, "a split block runs one pixel a thread"
    rows = 1
    for r in range(2, min(H, MAX_ROWS) + 1):
        if threads(r, tw, ct, ks) > MAX_THREADS \
                or _smem(kh, kw, Cin, r, tw, ct, px, co, ks) > SMEM_BYTES \
                or blocks(r, tw, ct) < SMS:
            break
        rows = r
    if x_bytes == 4:
        x_unit = 4 if Cin % 4 == 0 else 1
    else:
        x_unit = 8 if Cin % 8 == 0 else 2 if Cin % 2 == 0 else 1
    w_unit = 4 if w_bytes == 4 and Cout % 4 == 0 and ct % 4 == 0 else 1
    return StreamTiles(rows, tw, ct, px, co, ks, window, ci_vec, x_unit,
                       w_unit, threads(rows, tw, ct, ks),
                       (B * _cdiv(H, rows) * _cdiv(W, tw), _cdiv(Cout, ct)),
                       _smem(kh, kw, Cin, rows, tw, ct, px, co, ks))


def require_stream_window(name: str, kh: int, kw: int, strides, pads) -> None:
    """Raise unless a Conv node's strides are 1 and its pads equal the
    kernel's SAME padding at its window size (a 1x1 VALID conv qualifies)."""
    if tuple(int(s) for s in strides) != (1, 1):
        raise ValueError(f"Conv {name!r}: the stream conv runs stride 1 only, "
                         f"got strides {tuple(strides)}")
    p = normalize_pads(pads)
    ph, pw = (p, p) if isinstance(p, str) else p
    got = (pad_amounts(1, kh, 1, ph)[1], pad_amounts(1, kw, 1, pw)[1])
    if got != stream_pads(kh, kw):
        raise ValueError(f"Conv {name!r}: pads {pads!r} at a {kh}x{kw} window "
                         f"are {got}, not the stream conv's SAME padding "
                         f"{stream_pads(kh, kw)}")


def conv2d_stream_cuda(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch ``csrc/conv2d_stream.cu`` on the current CUDA stream: x
    (B, H, W, Cin) and w (kh, kw, Cin, Cout) contiguous, each f32 or bf16; b
    (Cout,) f32 or None.  Returns (B, H, W, Cout) in x's dtype, on
    :func:`stream_tiles`' mapping.  Counts one launch per call in
    ``conv2d_stream_cuda.launches``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"conv2d_stream_cuda launches the CUDA kernel; got a "
                         f"{dev} tensor")
    for t, name, nd in ((x, "x", 4), (w, "w", 4)):
        if t.device != dev or t.dtype not in _FLOAT or t.ndim != nd \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-D f32 or bf16 "
                             f"tensor on {dev}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    B, H, W, Cin = x.shape
    kh, kw, wcin, cout = w.shape
    if wcin != Cin or Cin < 1:
        raise ValueError(f"weight takes {wcin} input channels, x has {Cin}")
    if b is not None and (b.device != dev or b.dtype != torch.float32
                          or tuple(b.shape) != (cout,)
                          or not b.is_contiguous()):
        raise ValueError(f"bias must be a contiguous f32 ({cout},) tensor on "
                         f"{dev}")
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    t = stream_tiles(B, H, W, Cin, cout, kh, kw, x.element_size(),
                     w.element_size())
    # the vector staging units assume 16-byte aligned bases (as PyTorch's
    # allocations are); a tensor that starts elsewhere is staged by element
    if x.data_ptr() % 16:
        t = t._replace(x_unit=1)
    if w.data_ptr() % 16:
        t = t._replace(w_unit=1)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_conv2d_stream(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), B, H, W, Cin, cout, kh, kw,
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            t.rows, t.tw, t.ct, t.px, t.co, t.ks, t.window, t.ci_vec,
            t.x_unit, t.w_unit, t.threads, t.smem_bytes, stream)
    check(rc, "conv2d_stream")
    conv2d_stream_cuda.launches += 1
    return out


conv2d_stream_cuda.launches = 0


def conv2d_stream(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, H, W, Cin); w (kh, kw, Cin, Cout); b (Cout,) or None — SAME
    padding, stride 1, output in x's dtype."""
    if x.device.type == "cuda":
        bias = None if b is None else \
            b.reshape(-1).to(torch.float32).contiguous()
        return conv2d_stream_cuda(x.contiguous(), w.contiguous(), bias)
    if x.device.type == "cpu":
        return conv2d_stream_plain(x, w, b)
    raise ValueError(f"no conv2d_stream path for device {x.device}")


def conv2d_stream_info(tiles: StreamTiles) -> dict:
    """The registers a thread of the kernel instance ``tiles`` runs takes,
    its dynamic shared memory and how many of its blocks one SM holds at
    once (the CUDA occupancy calculator).  Needs the card."""
    import ctypes
    lib = load_kernels()
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.repro_conv2d_stream_info(tiles.window, tiles.px, tiles.co,
                                      tiles.ci_vec, tiles.ks, tiles.threads,
                                      tiles.smem_bytes, ctypes.byref(regs),
                                      ctypes.byref(blocks))
    check(rc, "conv2d_stream_info")
    return {"registers": regs.value, "dynamic_smem_bytes": tiles.smem_bytes,
            "blocks_per_sm": blocks.value}
