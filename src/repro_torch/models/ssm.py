"""Mamba-2 SSD (state-space duality) block: chunked prefill + O(1) decode
(counterpart of ``repro.models.ssm``).

Chunked SSD (arXiv:2405.21060): within chunks of length Q the output is a
masked attention-like quadratic form; across chunks an (H, P, N) state is
carried by a linear recurrence.  :func:`ssd_chunked` is the plain oracle the
models use off the card; on a CUDA tensor :func:`ssm_block` runs the scan
through the hand-written kernel (``repro_torch.kernels.ssd_scan``).

The reference's mesh layout pins (``_constrain_inner``,
``FLAGS.ssd_constraint``) have no counterpart on one card.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import perf
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.common import rmsnorm


class SSMLayerParams(NamedTuple):
    w_z: torch.Tensor      # (d, d_inner) — gate projection
    w_x: torch.Tensor      # (d, d_inner) — value projection
    w_bc: torch.Tensor     # (d, 2*G*N)   — B/C projection
    w_dt: torch.Tensor     # (d, H)       — dt projection
    conv: torch.Tensor     # (K, conv_dim)
    A_log: torch.Tensor    # (H,) f32
    D: torch.Tensor        # (H,)
    dt_bias: torch.Tensor  # (H,) f32
    norm_w: torch.Tensor   # (d_inner,)
    w_out: torch.Tensor    # (d_inner, d)


class SSMState(NamedTuple):
    ssd: torch.Tensor      # (B, H, P, N) f32
    conv: torch.Tensor     # (B, K-1, conv_dim)


def _project_in(x: torch.Tensor, p: SSMLayerParams):
    """Separate z/x/BC/dt projections."""
    z = torch.matmul(x, p.w_z)
    xv = torch.matmul(x, p.w_x)
    bc = torch.matmul(x, p.w_bc)
    dt = torch.matmul(x, p.w_dt)
    return z, torch.cat([xv, bc], dim=-1), dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv via K shifted adds.  xbc: (B, S, C); w: (K, C);
    state: (B, K-1, C) previous inputs.  Returns (y, new_state)."""
    K = w.shape[0]
    S = xbc.shape[1]
    if state is None:
        pad = torch.zeros((xbc.shape[0], K - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                  # (B, S+K-1, C)
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :]
    return F.silu(y.to(torch.float32)).to(xbc.dtype), new_state


def _ssd_scan(x, dt, A, Bm, C, D, chunk: int, init_state, intra_bf16: bool):
    """The chunked scan: the oracle's algorithm.  Math in f32 (f64 for f64
    inputs); the intra-chunk part in bf16 when ``intra_bf16`` and x is
    bf16.  Ragged S is zero-padded to a chunk multiple: dt=0 rows neither
    update the state nor decay it, so the padding is exact."""
    Bsz, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    S0 = S
    wd = torch.float64 if x.dtype == torch.float64 else torch.float32
    if S % chunk != 0:
        pad = chunk - S % chunk

        def zf(a):
            return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))

        x, dt, Bm, C = zf(x), zf(dt), zf(Bm), zf(C)
        S = S + pad
    nc = S // chunk
    rep = H // G

    xc = x.reshape(Bsz, nc, chunk, H, Pd)
    dtc = dt.to(wd).reshape(Bsz, nc, chunk, H)
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    Cc = C.reshape(Bsz, nc, chunk, G, N).repeat_interleave(rep, dim=3)

    dA = dtc * A.to(wd)[None, None, None, :]                         # <= 0
    ld = torch.cumsum(dA, dim=2)                                     # (B,nc,Q,H)
    l_last = ld[:, :, -1:, :]

    # intra-chunk: att[i,j] = (C_i . B_j) * exp(l_i - l_j) * dt_j,  j <= i
    idt = torch.bfloat16 if (intra_bf16 and x.dtype == torch.bfloat16) else wd
    li = ld[:, :, :, None, :]
    lj = ld[:, :, None, :, :]
    decay = torch.exp(torch.clamp_max(li - lj, 0.0)).to(idt)
    cb = torch.einsum("bcqhn,bckhn->bcqkh", Cc.to(idt), Bc.to(idt))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    att = cb * decay * dtc[:, :, None, :, :].to(idt)
    att = torch.where(causal[None, None, :, :, None], att,
                      torch.zeros((), dtype=idt, device=x.device))
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", att, xc.to(idt)).to(wd)

    # chunk summaries: S_c = sum_j exp(l_last - l_j) dt_j B_j x_j^T
    w_j = torch.exp(l_last - ld) * dtc                               # (B,nc,Q,H)
    S_c = torch.einsum("bcqhn,bcqhp->bchnp", w_j[..., None] * Bc.to(wd),
                       xc.to(wd))

    # inter-chunk recurrence over the chunks, in order
    chunk_decay = torch.exp(l_last[:, :, 0, :])                      # (B,nc,H)
    s = (torch.zeros((Bsz, H, N, Pd), dtype=wd, device=x.device)
         if init_state is None
         else init_state.transpose(2, 3).to(wd))                     # (B,H,N,P)
    prefix = []
    for c in range(nc):
        prefix.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
    s_prefix = torch.stack(prefix, dim=1)                            # (B,nc,H,N,P)

    # inter-chunk contribution: y_i += C_i . (exp(l_i) * state_prefix)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           Cc.to(wd) * torch.exp(ld)[..., None], s_prefix)

    y = (y_intra + y_inter).reshape(Bsz, S, H, Pd)
    y = y + x.to(wd) * D.to(wd)[None, None, :, None]
    return y[:, :S0].to(x.dtype), s.transpose(2, 3)                  # (B,H,P,N)


def ssd_chunked(x, dt, A, Bm, C, D, chunk: int, init_state=None):
    """Chunked SSD scan (plain oracle; the intra-chunk math follows
    ``perf.FLAGS.ssd_bf16_intra``).

    x: (B, S, H, P); dt: (B, S, H) f32 (post-softplus); A: (H,) f32
    (negative); Bm/C: (B, S, G, N); D: (H,).  Returns (y (B,S,H,P),
    final_state (B,H,P,N) f32)."""
    return _ssd_scan(x, dt, A, Bm, C, D, chunk, init_state,
                     perf.FLAGS.ssd_bf16_intra)


def ssd_decode_step(x, dt, A, Bm, C, D, state):
    """One-token SSD update.  x: (B,H,P); dt: (B,H); Bm/C: (B,G,N);
    state: (B,H,P,N) f32.  Returns (y (B,H,P), new_state)."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    Bx = Bm.repeat_interleave(rep, dim=1).to(torch.float32)          # (B,H,N)
    Cx = C.repeat_interleave(rep, dim=1).to(torch.float32)
    dA = torch.exp(dt * A[None, :])                                  # (B,H)
    upd = (dt[:, :, None] * x.to(torch.float32))[..., None] * Bx[:, :, None, :]
    new_state = state * dA[:, :, None, None] + upd                   # (B,H,P,N)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cx)
    y = y + x.to(torch.float32) * D[None, :, None]
    return y.to(x.dtype), new_state


def ssm_block(x: torch.Tensor, p: SSMLayerParams, cfg: ModelConfig,
              state: Optional[SSMState] = None,
              use_kernel: Optional[bool] = None):
    """Full-sequence SSM mixer.  x: (B, S, d) -> (y (B,S,d), final SSMState).

    ``use_kernel=None`` (the default) means auto: the scan goes through the
    hand-written kernel for a CUDA tensor and through the oracle
    :func:`ssd_chunked` elsewhere (the rule of the reference's ``qjax``
    writer).  ``True`` takes the kernel's entry point on any device (on the
    CPU that is the kernel's plain version), ``False`` the oracle."""
    s = cfg.ssm
    B, S, _ = x.shape
    H, Pd = cfg.n_ssm_heads, s.d_head
    z, xbc, dt = _project_in(x, p)
    xbc, conv_state = _causal_conv(xbc, p.conv,
                                   None if state is None else state.conv)
    xi, BC = xbc[..., :cfg.d_inner], xbc[..., cfg.d_inner:]
    gn = s.n_groups * s.d_state
    Bm = BC[..., :gn].reshape(B, S, s.n_groups, s.d_state)
    Cm = BC[..., gn:].reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    A = -torch.exp(p.A_log)
    xh = xi.reshape(B, S, H, Pd)
    if use_kernel is None:
        use_kernel = x.is_cuda
    init = None if state is None else state.ssd
    if use_kernel:
        from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
        y, ssd_state = ssd_chunked_kernel(xh, dt, A, Bm, Cm, p.D, s.chunk,
                                          init)
    else:
        y, ssd_state = ssd_chunked(xh, dt, A, Bm, Cm, p.D, s.chunk, init)
    y = y.reshape(B, S, cfg.d_inner)
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p.norm_w)
    out = torch.matmul(y, p.w_out)
    return out, SSMState(ssd=ssd_state, conv=conv_state)


def ssm_decode(x: torch.Tensor, p: SSMLayerParams, cfg: ModelConfig,
               state: SSMState):
    """One-token SSM step.  x: (B, 1, d) -> (y (B,1,d), new state)."""
    s = cfg.ssm
    B = x.shape[0]
    H, Pd = cfg.n_ssm_heads, s.d_head
    z, xbc, dt = _project_in(x[:, 0], p)
    xp = torch.cat([state.conv.to(xbc.dtype), xbc[:, None, :]], dim=1)
    y = sum(xp[:, i, :] * p.conv[i] for i in range(p.conv.shape[0]))
    xbc = F.silu(y.to(torch.float32)).to(xbc.dtype)
    conv_state = xp[:, 1:, :]
    xi, BC = xbc[..., :cfg.d_inner], xbc[..., cfg.d_inner:]
    gn = s.n_groups * s.d_state
    Bm = BC[..., :gn].reshape(B, s.n_groups, s.d_state)
    Cm = BC[..., gn:].reshape(B, s.n_groups, s.d_state)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    A = -torch.exp(p.A_log)
    yh, ssd_state = ssd_decode_step(xi.reshape(B, H, Pd), dt, A, Bm, Cm, p.D,
                                    state.ssd)
    yh = yh.reshape(B, cfg.d_inner)
    yh = rmsnorm(yh * F.silu(z.to(torch.float32)).to(yh.dtype), p.norm_w)
    out = torch.matmul(yh, p.w_out)
    return out[:, None, :], SSMState(ssd=ssd_state, conv=conv_state)


def init_ssm_state(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device: DeviceLike = None) -> SSMState:
    s = cfg.ssm
    H, Pd = cfg.n_ssm_heads, s.d_head
    conv_dim = cfg.d_inner + 2 * s.n_groups * s.d_state
    return SSMState(
        ssd=torch.zeros((batch, H, Pd, s.d_state), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                         device=device),
    )
