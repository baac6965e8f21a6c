"""Public entry point of the SSD chunk scan (counterpart of
``repro.kernels.ssd_scan.ops``).

``ssd_chunked_kernel`` keeps the reference's contract (the model oracle's
signature and layouts) and dispatches on x's device: a CUDA tensor launches
the hand-written kernels ``csrc/ssd_scan.cu`` through :func:`ssd_scan_cuda`,
with no fallback; a CPU tensor runs the plain version
(:func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_plain`).  A warm
start (``init_state`` given) takes the same routes: the state-passing phase
starts from the initial state where it would start from zero, so the
reference wrapper's detour through the model oracle has no counterpart.
The kernels are forward only, as the reference's: under grad mode an input
that requires grad raises ``RuntimeError`` (training takes the oracle).

:func:`ssd_scan_cuda` runs the scan as three chunk-parallel phases on the
current stream: :func:`ssd_chunk_state_cuda` (each chunk's summary state
and decay, into a (B,H,nc,N,P) f32 scratch), :func:`ssd_state_pass_cuda`
(the recurrence over the chunks, in place) and :func:`ssd_chunk_scan_cuda`
(y from each chunk and the state entering it).  :func:`ssd_chunk_states`,
:func:`ssd_state_pass` and :func:`ssd_chunk_scan` dispatch each phase on the
device as ``ssd_chunked_kernel`` does.

Unlike the reference's wrapper, no ``repeat``/``transpose`` copy is made:
the kernels read the (B,S,H,P) and (B,S,G,N) layouts in place through their
strides (the model passes views into the fused conv output), and they mask
a ragged last chunk themselves, where the reference's wrapper asserts
``S % chunk == 0``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check, load_kernels
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_scan_plain,
                                              ssd_chunk_states_plain,
                                              ssd_chunked_plain,
                                              ssd_state_pass_plain)

__all__ = ["ssd_chunk_scan", "ssd_chunk_scan_cuda", "ssd_chunk_state_cuda",
           "ssd_chunk_states", "ssd_chunked_kernel", "ssd_scan_cuda",
           "ssd_state_pass", "ssd_state_pass_cuda"]

_FLOAT = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)


def _check_operand(t: torch.Tensor, name: str, shape, dtypes, dev) -> None:
    if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be a {shape} tensor of "
                         f"{[str(d) for d in dtypes]} on {dev}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _refuse_dtensor(what: str, ts) -> None:
    """The launches pass raw ``data_ptr()``s through ``ctypes``: a DTensor
    would hand over one rank's shard as if it were the whole tensor.  On a
    device mesh the model runs the scan on each rank's local shards
    (``ssm_block`` under ``repro_torch.sharding.shard_map``)."""
    if torch.distributed.is_available():
        from torch.distributed.tensor import DTensor
        if any(isinstance(t, DTensor) for t in ts):
            raise TypeError(
                f"{what}: got a DTensor; pass each rank's local shards (run "
                "the scan under local_map / repro_torch.sharding.shard_map)")


def _device_type(what: str, *ts) -> str:
    """The route of an entry point: ``cuda`` or ``cpu`` from the first
    tensor's device.  A DTensor among ``ts`` raises ``TypeError``."""
    _refuse_dtensor(what, ts)
    kind = ts[0].device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no ssd_scan path for device {ts[0].device}")
    return kind


def _on_cuda(what: str, *ts) -> torch.device:
    """The checks before a launch: no DTensor, the first tensor on a CUDA
    device (returned), no input that requires grad under grad mode."""
    if _device_type(what, *ts) != "cuda":
        raise ValueError(f"{what} launches the CUDA kernel; got a "
                         f"{ts[0].device} tensor")
    _refuse_grad(what, *ts)
    return ts[0].device


def _refuse_grad(what: str, *ts) -> None:
    """The kernels have no backward (nor has the reference's ``ssd_kernel``)
    and a ``ctypes`` launch is not recorded by autograd: with grad mode on,
    an input that requires grad would get no gradient and raise nothing, so
    refuse it.  Training takes the oracle (``ssm_block(use_kernel=False)``)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(
            f"{what}: the ssd_scan kernel has no backward; an input requires "
            "grad under grad mode. Differentiate through the oracle "
            "ssd_chunked (ssm_block(..., use_kernel=False)) instead")


def _inputs(x, dt, A, Bm, C=None, D=None):
    """Check the scan's inputs on x's CUDA device; returns them with the
    last dim of x, Bm and C contiguous, and (B, S, H, P, G, N)."""
    dev = x.device
    if x.ndim != 4 or x.dtype not in _FLOAT:
        raise ValueError(f"x must be a 4-D f32 or bf16 tensor; got {x.dtype} "
                         f"{tuple(x.shape)}")
    Bsz, S, H, P = x.shape
    if Bm.ndim != 4:
        raise ValueError(f"Bm must be (B, S, G, N); got {tuple(Bm.shape)}")
    G, N = Bm.shape[2], Bm.shape[3]
    _check_operand(dt, "dt", (Bsz, S, H), _F32, dev)
    _check_operand(A, "A", (H,), _F32, dev)
    _check_operand(Bm, "Bm", (Bsz, S, G, N), (x.dtype,), dev)
    if C is not None:
        _check_operand(C, "C", (Bsz, S, G, N), (x.dtype,), dev)
        C = C if C.stride(3) == 1 else C.contiguous()
    if D is not None:
        _check_operand(D, "D", (H,), _F32, dev)
        D = D.contiguous()
    x = x if x.stride(3) == 1 else x.contiguous()
    Bm = Bm if Bm.stride(3) == 1 else Bm.contiguous()
    return x, dt, A.contiguous(), Bm, C, D, (Bsz, S, H, P, G, N)


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def ssd_chunk_state_cuda(x, dt, A, Bm, chunk: int):
    """Phase 1 on the card: each chunk's summary state
    ``S_c = (B*w)^T x`` and decay ``exp(l_last)`` -> (states (B,H,nc,N,P)
    f32, decay (B,H,nc) f32), nc = ceil(S/chunk).  Operands as for
    :func:`ssd_scan_cuda`.  Counts launches in ``.launches``."""
    dev = _on_cuda("ssd_chunk_state_cuda", x, dt, A, Bm)
    x, dt, A, Bm, _, _, (Bsz, S, H, P, G, N) = _inputs(x, dt, A, Bm)
    nc = -(-S // chunk) if chunk > 0 else 0     # the kernel refuses chunk <= 0
    states = torch.empty((Bsz, H, nc, N, P), dtype=torch.float32, device=dev)
    decay = torch.empty((Bsz, H, nc), dtype=torch.float32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.repro_ssd_chunk_state(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            states.data_ptr(), decay.data_ptr(), Bsz, S, H, P, G, N, chunk,
            *_strides(x, dt, Bm), int(x.dtype == torch.bfloat16),
            _stream(dev))
    check(rc, f"ssd chunk_state (B={Bsz}, S={S}, H={H}, P={P}, G={G}, "
              f"N={N}, chunk={chunk})")
    ssd_chunk_state_cuda.launches += 1
    return states, decay


def ssd_state_pass_cuda(states, decay, init_state=None):
    """Phase 2 on the card: ``states`` (B,H,nc,N,P) f32 is overwritten IN
    PLACE, each chunk's summary by the state entering that chunk, starting
    from ``init_state`` (B,H,P,N) f32 or zero; returns the final state
    (B,H,P,N) f32.  ``decay`` is (B,H,nc) f32.  Counts launches in
    ``.launches``."""
    dev = _on_cuda("ssd_state_pass_cuda", states, decay, init_state)
    if states.ndim != 5 or not states.is_contiguous():
        raise ValueError("states must be a contiguous (B, H, nc, N, P) "
                         f"tensor; got {tuple(states.shape)}")
    Bsz, H, nc, N, P = states.shape
    _check_operand(states, "states", (Bsz, H, nc, N, P), _F32, dev)
    _check_operand(decay, "decay", (Bsz, H, nc), _F32, dev)
    decay = decay.contiguous()
    if init_state is not None:
        _check_operand(init_state, "init_state", (Bsz, H, P, N), _F32, dev)
        init_state = init_state.contiguous()
    fin = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.repro_ssd_state_pass(
            states.data_ptr(), decay.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            fin.data_ptr(), Bsz * H, nc, P, N, _stream(dev))
    check(rc, f"ssd state_pass (B*H={Bsz * H}, nc={nc}, P={P}, N={N})")
    ssd_state_pass_cuda.launches += 1
    return fin


def ssd_chunk_scan_cuda(x, dt, A, Bm, C, D, states, chunk: int):
    """Phase 3 on the card: y (B,S,H,P) in x's dtype from each chunk's
    inputs and ``states`` (B,H,nc,N,P) f32, the state entering each chunk
    (what :func:`ssd_state_pass_cuda` leaves).  Counts launches in
    ``.launches``."""
    dev = _on_cuda("ssd_chunk_scan_cuda", x, dt, A, Bm, C, D, states)
    x, dt, A, Bm, C, D, (Bsz, S, H, P, G, N) = _inputs(x, dt, A, Bm, C, D)
    nc = -(-S // chunk) if chunk > 0 else 0
    _check_operand(states, "states", (Bsz, H, nc, N, P), _F32, dev)
    states = states.contiguous()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    lib = load_kernels()
    with torch.cuda.device(dev):
        rc = lib.repro_ssd_chunk_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), D.data_ptr(), states.data_ptr(), y.data_ptr(),
            Bsz, S, H, P, G, N, chunk, *_strides(x, dt, Bm, C),
            int(x.dtype == torch.bfloat16), _stream(dev))
    check(rc, f"ssd chunk_scan (B={Bsz}, S={S}, H={H}, P={P}, G={G}, "
              f"N={N}, chunk={chunk})")
    ssd_chunk_scan_cuda.launches += 1
    return y


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                  chunk: int, init_state: torch.Tensor = None):
    """Launch ``csrc/ssd_scan.cu``'s three phases on the current CUDA
    stream: x (B,S,H,P) f32 or bf16, dt (B,S,H) f32, A and D (H,) f32, Bm
    and C (B,S,G,N) in x's dtype — any strides, as long as the last dim of
    x, Bm and C is contiguous — and ``init_state`` (B,H,P,N) f32 or None
    for a zero start.  Returns (y (B,S,H,P) in x's dtype, final state
    (B,H,P,N) f32).  The (B,H,nc,N,P) f32 scratch between the phases comes
    from the caching allocator.  Shapes the kernels do not take (chunk, P or
    N not a multiple of 4, a phase's tiles over the shared memory a block
    can have) come back from them as a CUDA error.  Counts one launch per
    call in ``ssd_scan_cuda.launches`` (each phase counts its own)."""
    _on_cuda("ssd_scan_cuda", x, dt, A, Bm, C, D, init_state)
    Bsz, S, H, P = x.shape
    if Bsz * H == 0:
        N = Bm.shape[3]
        return (torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device),
                torch.empty((Bsz, H, P, N), dtype=torch.float32,
                            device=x.device))
    states, decay = ssd_chunk_state_cuda(x, dt, A, Bm, chunk)
    fin = ssd_state_pass_cuda(states, decay, init_state)
    y = ssd_chunk_scan_cuda(x, dt, A, Bm, C, D, states, chunk)
    ssd_scan_cuda.launches += 1
    return y, fin


for _fn in (ssd_chunk_state_cuda, ssd_state_pass_cuda, ssd_chunk_scan_cuda,
            ssd_scan_cuda):
    _fn.launches = 0


def ssd_chunked_kernel(x, dt, A, Bm, C, D, chunk: int, init_state=None):
    """Same contract as ``ssd_chunked``: x (B,S,H,P), dt (B,S,H) f32, A
    (H,), Bm/C (B,S,G,N), D (H,), init_state (B,H,P,N) or None -> (y
    (B,S,H,P), state (B,H,P,N)).  Forward only, on every device: with grad
    mode on, an input that requires grad raises ``RuntimeError``; a DTensor
    raises ``TypeError``."""
    kind = _device_type("ssd_chunked_kernel", x, dt, A, Bm, C, D,
                        init_state)
    _refuse_grad("ssd_chunked_kernel", x, dt, A, Bm, C, D, init_state)
    if kind == "cuda":
        return ssd_scan_cuda(
            x, dt.to(torch.float32), A.to(torch.float32), Bm.to(x.dtype),
            C.to(x.dtype), D.to(torch.float32), chunk,
            None if init_state is None else init_state.to(torch.float32))
    return ssd_chunked_plain(x, dt, A, Bm, C, D, chunk, init_state)


def ssd_chunk_states(x, dt, A, Bm, chunk: int):
    """Phase 1 on x's device (the kernel on CUDA, the plain version on the
    CPU) -> (states (B,H,nc,N,P) f32, decay (B,H,nc) f32)."""
    fn = (ssd_chunk_state_cuda if _device_type("ssd_chunk_states", x, dt, A,
                                               Bm) == "cuda"
          else ssd_chunk_states_plain)
    return fn(x, dt, A, Bm, chunk)


def ssd_state_pass(states, decay, init_state=None):
    """Phase 2 on the states' device -> (entering states (B,H,nc,N,P),
    final state (B,H,P,N)).  On the card the kernel overwrites ``states``
    with the entering states and the same tensor is returned."""
    if _device_type("ssd_state_pass", states, decay, init_state) == "cuda":
        return states, ssd_state_pass_cuda(states, decay, init_state)
    return ssd_state_pass_plain(states, decay, init_state)


def ssd_chunk_scan(x, dt, A, Bm, C, D, states, chunk: int):
    """Phase 3 on x's device -> y (B,S,H,P) in x's dtype."""
    fn = (ssd_chunk_scan_cuda if _device_type("ssd_chunk_scan", x, dt, A, Bm,
                                              C, D, states) == "cuda"
          else ssd_chunk_scan_plain)
    return fn(x, dt, A, Bm, C, D, states, chunk)


def ssd_scan_phase_info(chunk: int, P: int, N: int, bf16: bool) -> dict:
    """Per phase of the kernel (``chunk_state``, ``state_pass``,
    ``chunk_scan``) at this shape and x dtype: the dynamic shared memory a
    block takes and how many blocks of it one SM holds at once (the CUDA
    occupancy calculator).  Needs the card."""
    import ctypes
    lib = load_kernels()
    out = {}
    for phase, name in ((1, "chunk_state"), (2, "state_pass"),
                        (3, "chunk_scan")):
        smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.repro_ssd_scan_info(phase, chunk, P, N, int(bf16),
                                     ctypes.byref(smem), ctypes.byref(blocks))
        check(rc, f"ssd_scan_info phase {phase}")
        out[name] = {"dynamic_smem_bytes": smem.value,
                     "blocks_per_sm": blocks.value}
    return out
