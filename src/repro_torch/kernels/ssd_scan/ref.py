"""Plain PyTorch version of the SSD chunk-scan kernel (counterpart of
``repro.kernels.ssd_scan.ref``).

:func:`ssd_chunked_plain` is the specification the CUDA kernels
``csrc/ssd_scan.cu`` are held to: the oracle's algorithm with every step in
f32 (f64 for f64 inputs), as the TPU kernel ``ssd_kernel`` computes it —
unlike the model oracle, whose intra-chunk math follows
``perf.FLAGS.ssd_bf16_intra`` — including the oracle's rule for a ragged
length (zero-padding to a chunk multiple, exact since dt=0 rows change
nothing).  The kernels sum each dot in their own order, so the two agree to
f32 rounding, not bit for bit.  ``ssd_ref`` is the model oracle, as in the
reference.

The kernel runs in three phases, and each has its plain version here, the
same math as the matching lines of ``models.ssm._ssd_scan``:
:func:`ssd_chunk_states_plain` (the chunk summaries ``S_c`` and decays),
:func:`ssd_state_pass_plain` (the recurrence over the chunks) and
:func:`ssd_chunk_scan_plain` (``y_intra + y_inter + D x``).  Composed, they
give :func:`ssd_chunked_plain`'s result bit for bit.  The chunk states are
laid out (B,H,nc,N,P), as the kernels keep them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.ssm import _ssd_scan
from repro_torch.models.ssm import ssd_chunked as ssd_ref  # noqa: F401

__all__ = ["ssd_chunk_scan_plain", "ssd_chunk_states_plain",
           "ssd_chunked_plain", "ssd_ref", "ssd_state_pass_plain"]


def ssd_chunked_plain(x, dt, A, Bm, C, D, chunk: int, init_state=None):
    """x (B,S,H,P); dt (B,S,H) f32; A, D (H,); Bm/C (B,S,G,N) ->
    (y (B,S,H,P) in x's dtype, final state (B,H,P,N) f32)."""
    return _ssd_scan(x, dt, A, Bm, C, D, chunk, init_state, intra_bf16=False)


def _chunks(x, dt, A, mats, chunk: int):
    """``_ssd_scan``'s set-up: zero-pad to a chunk multiple, cut into
    chunks, repeat each group's B/C over its heads, and the cumulative
    log-decay.  Returns (xc (B,nc,Q,H,P), dtc, [each of ``mats`` as
    (B,nc,Q,H,N)], ld (B,nc,Q,H), working dtype)."""
    Bsz, S, H, Pd = x.shape
    wd = torch.float64 if x.dtype == torch.float64 else torch.float32
    if S % chunk != 0:
        pad = chunk - S % chunk

        def zf(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))

        x, dt, mats = zf(x), zf(dt), [zf(m) for m in mats]
        S = S + pad
    nc = S // chunk
    xc = x.reshape(Bsz, nc, chunk, H, Pd)
    dtc = dt.to(wd).reshape(Bsz, nc, chunk, H)
    mc = []
    for m in mats:
        G, N = m.shape[2], m.shape[3]
        mc.append(m.reshape(Bsz, nc, chunk, G, N).repeat_interleave(
            H // G, dim=3))
    dA = dtc * A.to(wd)[None, None, None, :]                         # <= 0
    ld = torch.cumsum(dA, dim=2)                                     # (B,nc,Q,H)
    return xc, dtc, mc, ld, wd


def ssd_chunk_states_plain(x, dt, A, Bm, chunk: int):
    """Phase 1: each chunk's summary ``S_c = sum_j exp(l_last - l_j) dt_j
    B_j x_j^T`` and decay ``exp(l_last)`` -> (states (B,H,nc,N,P), decay
    (B,H,nc)), f32 (f64 for f64 x)."""
    xc, dtc, (Bc,), ld, wd = _chunks(x, dt, A, [Bm], chunk)
    l_last = ld[:, :, -1:, :]
    w_j = torch.exp(l_last - ld) * dtc                               # (B,nc,Q,H)
    S_c = torch.einsum("bcqhn,bcqhp->bchnp", w_j[..., None] * Bc.to(wd),
                       xc.to(wd))
    chunk_decay = torch.exp(l_last[:, :, 0, :])                      # (B,nc,H)
    return (S_c.transpose(1, 2).contiguous(),
            chunk_decay.transpose(1, 2).contiguous())


def ssd_state_pass_plain(states, decay, init_state=None):
    """Phase 2: the recurrence ``s <- s * decay_c + S_c`` over the chunks in
    order from ``init_state`` (B,H,P,N) or zero -> (the state entering each
    chunk (B,H,nc,N,P), the final state (B,H,P,N))."""
    Bsz, H, nc, N, Pd = states.shape
    s = (torch.zeros((Bsz, H, N, Pd), dtype=states.dtype,
                     device=states.device)
         if init_state is None
         else init_state.transpose(2, 3).to(states.dtype))           # (B,H,N,P)
    prefix = []
    for c in range(nc):
        prefix.append(s)
        s = s * decay[:, :, c, None, None] + states[:, :, c]
    entering = (torch.stack(prefix, dim=2) if prefix
                else torch.empty_like(states))
    return entering, s.transpose(2, 3)


def ssd_chunk_scan_plain(x, dt, A, Bm, C, D, states, chunk: int):
    """Phase 3: ``y = y_intra + y_inter + D x`` from each chunk's inputs
    and ``states`` (B,H,nc,N,P), the state entering each chunk -> y
    (B,S,H,P) in x's dtype."""
    Bsz, S, H, Pd = x.shape
    xc, dtc, (Bc, Cc), ld, wd = _chunks(x, dt, A, [Bm, C], chunk)

    # intra-chunk: att[i,j] = (C_i . B_j) * exp(l_i - l_j) * dt_j,  j <= i
    li = ld[:, :, :, None, :]
    lj = ld[:, :, None, :, :]
    decay = torch.exp(torch.clamp_max(li - lj, 0.0)).to(wd)
    cb = torch.einsum("bcqhn,bckhn->bcqkh", Cc.to(wd), Bc.to(wd))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    att = cb * decay * dtc[:, :, None, :, :].to(wd)
    att = torch.where(causal[None, None, :, :, None], att,
                      torch.zeros((), dtype=wd, device=x.device))
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att, xc.to(wd)).to(wd)

    # inter-chunk contribution: y_i += C_i . (exp(l_i) * state_entering)
    s_prefix = states.transpose(1, 2).contiguous()                   # (B,nc,H,N,P)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Cc.to(wd) * torch.exp(ld)[..., None], s_prefix)

    y = (y_intra + y_inter).reshape(Bsz, -1, H, Pd)[:, :S]
    y = y + x.to(wd) * D.to(wd)[None, None, :, None]
    return y.to(x.dtype)
