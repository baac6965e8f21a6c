"""Plain PyTorch versions of the streaming line-buffer convolution
(counterpart of ``repro.kernels.conv2d_stream.ref``).

:func:`conv2d_ref` is the reference's oracle (one f32 convolution, SAME,
stride 1); :func:`conv2d_stream_plain` is the specification the CUDA kernel
``csrc/conv2d_stream.cu`` is held to: the TPU kernel's ``kh*kw`` tap
matmuls, each (B*H*W, Cin) @ (Cin, Cout) in f32 and added to the f32
accumulator in tap order (dy-major, then dx), then the bias, then one cast
to x's dtype.  The kernel sums each tap's dot in its own order, so the two
agree to f32 rounding, not bit for bit.  Both run on any device with TF32
off (PyTorch's default for matmuls; set here for the convolution).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["conv2d_ref", "conv2d_stream_plain", "stream_pads"]


def stream_pads(kh: int, kw: int):
    """The kernel's padding ((top, bottom), (left, right)): ``k // 2`` before
    and the rest after, XLA's SAME for an odd window."""
    return (kh // 2, kh - 1 - kh // 2), (kw // 2, kw - 1 - kw // 2)


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               stride: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin) float; w (kh, kw, Cin, Cout) HWIO; b (Cout,).  One
    f32 convolution with XLA's SAME padding, NHWC in and out, cast to x's
    dtype — the reference's oracle, matching ``models.cnn.conv2d``."""
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
    kh, kw = int(w.shape[0]), int(w.shape[1])
    H, W = int(x.shape[1]), int(x.shape[2])
    pads = []
    for size, k in ((W, kw), (H, kh)):          # F.pad wants last dim first
        o = -(-size // stride)
        p = max((o - 1) * stride + k - size, 0)
        pads += [p // 2, p - p // 2]
    xc = F.pad(x.to(torch.float32).permute(0, 3, 1, 2), pads)
    y = F.conv2d(xc, w.to(torch.float32).permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1) + b.to(torch.float32)
    return y.to(x.dtype).contiguous()


def conv2d_stream_plain(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: x (B, H, W, Cin) and w
    (kh, kw, Cin, Cout), each f32 or bf16; b (Cout,) or None.  SAME padding
    (:func:`stream_pads`), stride 1; returns (B, H, W, Cout) in x's dtype."""
    B, H, W, Cin = x.shape
    kh, kw, _, cout = w.shape
    (pt, pb), (pl, pr) = stream_pads(kh, kw)
    xp = F.pad(x.to(torch.float32), (0, 0, pl, pr, pt, pb))
    wf = w.to(torch.float32)
    acc = torch.zeros((B * H * W, cout), dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            patch = xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, Cin)
            acc = acc + patch @ wf[dy, dx]
    if b is not None:
        acc = acc + b.reshape(1, -1).to(torch.float32)
    return acc.reshape(B, H, W, cout).to(x.dtype)
