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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import check, load_kernels
from repro_torch.kernels.conv2d_stream.ref import (conv2d_stream_plain,
                                                   stream_pads)
from repro_torch.kernels.qconv_dw.ref import pad_amounts, normalize_pads

__all__ = ["conv2d_stream", "conv2d_stream_cuda", "require_stream_window",
           "SMEM_BYTES"]

_FLOAT = (torch.float32, torch.bfloat16)
# the kernel's shared-memory budget (SMEM_BYTES in conv2d_stream.cu)
SMEM_BYTES = 48 * 1024


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
    (Cout,) f32 or None.  Returns (B, H, W, Cout) in x's dtype.  Counts
    launches in ``conv2d_stream_cuda.launches``."""
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
    if 4 * (kh * (W + kw - 1) * Cin + kh * kw * Cin) > SMEM_BYTES:
        raise ValueError(f"a {kh}x{kw} window over rows of {W}x{Cin} does "
                         f"not fit the kernel's {SMEM_BYTES}-byte line buffer")
    out = torch.empty((B, H, W, cout), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_conv2d_stream(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), B, H, W, Cin, cout, kh, kw,
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            stream)
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
