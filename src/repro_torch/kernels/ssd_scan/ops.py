"""Public entry point of the SSD chunk scan (counterpart of
``repro.kernels.ssd_scan.ops``).

``ssd_chunked_kernel`` keeps the reference's contract (the model oracle's
signature and layouts) and dispatches on x's device: a CUDA tensor launches
the hand-written kernel ``csrc/ssd_scan.cu`` through :func:`ssd_scan_cuda`,
with no fallback; a CPU tensor runs the plain version
(:func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_plain`).  A warm
start (``init_state`` given) takes the same routes: the kernel loads the
initial state into shared memory where it would zero it, so the reference
wrapper's detour through the model oracle has no counterpart.

Unlike the reference's wrapper, no ``repeat``/``transpose`` copy is made:
the kernel reads the (B,S,H,P) and (B,S,G,N) layouts in place through their
strides (the model passes views into the fused conv output), and it masks a
ragged last chunk itself, where the reference's wrapper asserts
``S % chunk == 0``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, load_kernels
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_plain

__all__ = ["ssd_chunked_kernel", "ssd_scan_cuda"]

_FLOAT = (torch.float32, torch.bfloat16)


def _check_operand(t: torch.Tensor, name: str, shape, dtypes, dev) -> None:
    if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a {shape} tensor of "
                         f"{[str(d) for d in dtypes]} on {dev}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                  chunk: int, init_state: torch.Tensor = None):
    """Launch ``csrc/ssd_scan.cu`` on the current CUDA stream: x (B,S,H,P)
    f32 or bf16, dt (B,S,H) f32, A and D (H,) f32, Bm and C (B,S,G,N) in
    x's dtype — any strides, as long as the last dim of x, Bm and C is
    contiguous — and ``init_state`` (B,H,P,N) f32 or None for a zero start.
    Returns (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32).  Shapes
    the kernel does not take (chunk, P or N not a multiple of 4, tiles over
    the shared memory a block can have) come back from it as a CUDA error.
    Counts launches in ``ssd_scan_cuda.launches``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_cuda launches the CUDA kernel; got a "
                         f"{dev} tensor")
    if x.ndim != 4 or x.dtype not in _FLOAT:
        raise ValueError(f"x must be a 4-D f32 or bf16 tensor; got {x.dtype} "
                         f"{tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if Bm.ndim != 4:
        raise ValueError(f"Bm must be (B, S, G, N); got {tuple(Bm.shape)}")
    G, N = Bm.shape[2], Bm.shape[3]
    _check_operand(dt, "dt", (Bsz, S, H), (torch.float32,), dev)
    _check_operand(A, "A", (H,), (torch.float32,), dev)
    _check_operand(D, "D", (H,), (torch.float32,), dev)
    _check_operand(Bm, "Bm", (Bsz, S, G, N), (x.dtype,), dev)
    _check_operand(C, "C", (Bsz, S, G, N), (x.dtype,), dev)
    if init_state is not None:
        _check_operand(init_state, "init_state", (Bsz, H, P, N),
                       (torch.float32,), dev)
        init_state = init_state.contiguous()
    if x.stride(3) != 1:
        x = x.contiguous()
    if Bm.stride(3) != 1:
        Bm = Bm.contiguous()
    if C.stride(3) != 1:
        C = C.contiguous()
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    fin = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    if Bsz * H == 0:
        return y, fin
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), D.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), fin.data_ptr(),
            Bsz, S, H, P, G, N, chunk,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            Bm.stride(0), Bm.stride(1), Bm.stride(2),
            C.stride(0), C.stride(1), C.stride(2),
            int(x.dtype == torch.bfloat16), stream)
    check(rc, f"ssd_scan (B={Bsz}, S={S}, H={H}, P={P}, G={G}, N={N}, "
              f"chunk={chunk})")
    ssd_scan_cuda.launches += 1
    return y, fin


ssd_scan_cuda.launches = 0


def ssd_chunked_kernel(x, dt, A, Bm, C, D, chunk: int, init_state=None):
    """Same contract as ``ssd_chunked``: x (B,S,H,P), dt (B,S,H) f32, A
    (H,), Bm/C (B,S,G,N), D (H,), init_state (B,H,P,N) or None -> (y
    (B,S,H,P), state (B,H,P,N))."""
    if x.device.type == "cuda":
        return ssd_scan_cuda(
            x, dt.to(torch.float32), A.to(torch.float32), Bm.to(x.dtype),
            C.to(x.dtype), D.to(torch.float32), chunk,
            None if init_state is None else init_state.to(torch.float32))
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, dt, A, Bm, C, D, chunk, init_state)
    raise ValueError(f"no ssd_scan path for device {x.device}")
