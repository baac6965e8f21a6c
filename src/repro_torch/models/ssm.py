"""Mamba-2 SSD (state-space duality) block: chunked prefill + O(1) decode
(counterpart of ``repro.models.ssm``).

Chunked SSD (arXiv:2405.21060): within chunks of length Q the output is a
masked attention-like quadratic form; across chunks an (H, P, N) state is
carried by a linear recurrence.  :func:`ssd_chunked` is the plain oracle the
models use off the card; on a CUDA tensor :func:`ssm_block` runs the scan
through the hand-written kernel (``repro_torch.kernels.ssd_scan``).

On a device mesh (``mesh=``, DTensor activations and parameters) the
inner activations and the SSD heads are pinned to model-sharded layouts
(``_constrain_inner`` and the head pins, ``FLAGS.ssd_constraint``), the
depthwise conv runs on each rank's own channels, the x part apart from
the B/C part (:func:`_conv_channels`), and the scan runs on each rank's
local heads and batch rows under :func:`repro_torch.sharding.shard_map`
(``local_map``): the scan kernel's ``ctypes`` launches never see a
DTensor.  Where the model axis does not divide the SSD heads,
:func:`ssm_block` pads them with zero heads to a multiple of it
(:func:`ssd_heads`, :func:`_pad_heads`), as the reference pads uneven
head counts on 'model': every rank then holds the same number of whole
heads.  The one-token decode pads nothing there: :func:`ssm_decode`
updates each rank's own channels of the flat (B, d_inner, N) state, as
the decode state stores it (:func:`decodes_flat`,
:func:`_decode_on_channels`), so the state is never gathered.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import perf
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models.common import rmsnorm
from repro_torch.sharding import (P, axis_names, batch_axes, constrain,
                                  dp_size, heads_view, holds, padded_heads,
                                  pin, pin_residual, shard_map, store,
                                  tp_size)
from repro_torch.sharding import zero_pad as _zero_pad


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
    ssd: torch.Tensor      # (B, H, P, N) f32; flat (B, H*P, N) through
    #                        ssm_decode where decodes_flat (a mesh whose
    #                        model axis does not divide the heads)
    conv: torch.Tensor     # (B, K-1, conv_dim)


def _project_in(x: torch.Tensor, p: SSMLayerParams):
    """Separate z/x/BC/dt projections, each on its weight's layout."""
    return (torch.matmul(x, p.w_z), torch.matmul(x, p.w_x),
            torch.matmul(x, p.w_bc), torch.matmul(x, p.w_dt))


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


def _conv_on_shards(mesh, u, w, state, feat):
    """The output of :func:`_causal_conv` on each rank's own channels and
    batch rows: u (B, S, C) and state (B, K-1, C) with C over ``feat``
    (``"model"`` or None: whole on each model rank), the batch over the
    data axes where they divide it."""
    bspec = batch_axes(mesh) if u.shape[0] % dp_size(mesh) == 0 else None
    act = P(bspec, None, feat)
    return shard_map(lambda u, w, s: _causal_conv(u, w, s)[0], mesh,
                     (act, P(None, feat), None if state is None else act),
                     act)(u, w, state)


def _conv_state(u, state, K: int):
    """The conv's new state, the last K-1 inputs of [state; u]: u (B, S,
    C); state (B, K-1, C) or None (zeros)."""
    u = u[:, -(K - 1):, :]
    prev = (torch.zeros((u.shape[0], K - 1, u.shape[2]), dtype=u.dtype,
                        device=u.device)
            if state is None else state.to(u.dtype))
    return torch.cat([prev, u], dim=1)[:, -(K - 1):, :]


def _conv_channels(xv, bc, w, state, cfg: ModelConfig, mesh):
    """:func:`_causal_conv` of the x channels ``xv`` (B, S, d_inner, or
    Hp * d_head with zero heads padded after the real ones) and the B/C
    channels ``bc`` (B, S, 2*G*N) with the (K, conv_dim) weight ``w``.
    ``state``: (B, K-1, conv_dim) or None.  Returns (x part, B/C part, new
    state (B, K-1, conv_dim)).  Without a mesh, one conv over their
    concatenation.  On a mesh the two parts run apart, each with its
    columns of ``w`` (the conv is per channel, so the numbers are the
    same), and no (B, S, .) activation is gathered for the conv:

    * x on whole heads that divide the model axis (mamba2; hymba's
      prefill, its heads padded): the x channels stay on the model-sharded
      layout of ``w_x``'s product, through the conv to the scan.  The
      weight's shards (conv_dim / tp columns a rank) cross d_inner, so the
      (K, conv_dim) weight is gathered (a few KB) and ``shard_map`` cuts
      its x columns, zero-padded to ``xv``'s width, to the x part's
      layout.  The B/C channels (2*G*N, small) are whole on each model
      rank, as :func:`_scan_on_shards` takes them.
    * Heads that do not divide it (hymba's one-token decode at model 16):
      the weight's shards cross d_inner and the heads, so x and B/C are
      made whole first and the conv runs on the weight's own shards, its
      output made whole after; the weight never moves.  The decode's
      flat route (:func:`_decode_on_channels`) then cuts the whole x to
      the state's channel shards without moving it.

    The new state is rejoined from the inputs' last K-1 steps (the real
    x channels), whole over 'model' as ``decode_state_sharding`` lays it
    out."""
    di, K = cfg.d_inner, w.shape[0]
    if mesh is None:
        y, new_state = _causal_conv(torch.cat([xv, bc], dim=-1), w, state)
        return y[..., :di], y[..., di:], new_state
    sx, sbc = (None, None) if state is None else (state[..., :di],
                                                  state[..., di:])
    tp = tp_size(mesh)
    bspec = batch_axes(mesh) if xv.shape[0] % dp_size(mesh) == 0 else None
    whole = P(bspec, None, None)
    bc = constrain(bc, mesh, whole)
    pad = xv.shape[-1] - di
    if (xv.shape[-1] // cfg.ssm.d_head) % tp == 0:
        w = constrain(w, mesh, P(None, None))
        wx = w[:, :di]
        if pad:
            wx = _zero_pad(wx, -1, pad, mesh)
            sx = None if sx is None else _zero_pad(sx, -1, pad, mesh)
        yx = _conv_on_shards(mesh, xv, wx, sx, "model")
        ybc = _conv_on_shards(mesh, bc, w[:, di:], sbc, None)
        u = torch.cat([constrain(xv[:, -(K - 1):], mesh, whole)[..., :di],
                       bc[:, -(K - 1):]], dim=-1)
    else:
        u = torch.cat([constrain(xv, mesh, whole), bc], dim=-1)
        feat = "model" if w.shape[1] % tp == 0 else None
        y = constrain(_conv_on_shards(mesh, u, w, state, feat), mesh, whole)
        yx, ybc = y[..., :di], y[..., di:]
    return yx, ybc, _conv_state(u, state, K)


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


def _decay_add(state, dA, upd, inplace: bool):
    """``state * dA + upd``; ``inplace``: the same two ops written into
    ``state`` (the same numbers bit for bit, no new state tensor)."""
    if inplace:
        return state.mul_(dA).add_(upd)
    return state * dA + upd


def ssd_decode_step(x, dt, A, Bm, C, D, state, inplace: bool = False):
    """One-token SSD update.  x: (B,H,P); dt: (B,H); Bm/C: (B,G,N);
    state: (B,H,P,N) f32.  Returns (y (B,H,P), new_state): a new tensor,
    as the reference's; ``inplace`` (the decode routes of
    :func:`ssm_decode`) writes it into ``state`` and returns that."""
    H = x.shape[1]
    rep = H // Bm.shape[1]
    Bx = Bm.repeat_interleave(rep, dim=1).to(torch.float32)          # (B,H,N)
    Cx = C.repeat_interleave(rep, dim=1).to(torch.float32)
    dA = torch.exp(dt * A[None, :])                                  # (B,H)
    upd = (dt[:, :, None] * x.to(torch.float32))[..., None] * Bx[:, :, None, :]
    new_state = _decay_add(state, dA[:, :, None, None], upd,
                           inplace)                                  # (B,H,P,N)
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cx)
    y = y + x.to(torch.float32) * D[None, :, None]
    return y.to(x.dtype), new_state


def ssd_decode_channels(x, dt, A, Bm, C, D, state, inplace: bool = False):
    """:func:`ssd_decode_step` on flat channels, channel c = h * P + p of
    head h: x, dt (B, C); A, D (C,) (dt, A and D of each channel's head);
    Bm/C (B, N), shared by every channel (one group), or (B, C, N), each
    channel's group's; state (B, C, N) f32.  The same operations in the
    same order, channel by channel, so any run of channels updates on its
    own: the new state equals ``ssd_decode_step``'s bit for bit, y within
    the rounding of the sum over N.  Returns (y (B, C), new_state);
    ``inplace`` as :func:`ssd_decode_step`'s."""
    one = Bm.ndim == 2
    Bx = (Bm[:, None, :] if one else Bm).to(torch.float32)          # (B,C,N)
    Cx = C.to(torch.float32)
    dA = torch.exp(dt * A[None, :])                                  # (B,C)
    upd = (dt * x.to(torch.float32))[..., None] * Bx
    new_state = _decay_add(state, dA[..., None], upd, inplace)       # (B,C,N)
    y = torch.einsum("bcn,bn->bc" if one else "bcn,bcn->bc", new_state, Cx)
    y = y + x.to(torch.float32) * D[None, :]
    return y.to(x.dtype), new_state


def _constrain_inner(t, mesh):
    """(B, S, d_inner-like) -> last dim over 'model' (divisible by design),
    the cotangent too, as the reference's constraint holds its transpose."""
    if mesh is None or not perf.FLAGS.ssd_constraint:
        return t
    bspec = batch_axes(mesh) if t.shape[0] % 2 == 0 else None
    spec = P(bspec, None, "model") if t.shape[-1] % tp_size(mesh) == 0 \
        else P(bspec, None, None)
    return pin(t, mesh, spec)


def ssd_heads(n_heads: int, tp: int) -> int:
    """The SSD heads the scan runs on over ``tp`` model ranks
    (:func:`repro_torch.sharding.padded_heads`)."""
    return padded_heads(n_heads, tp)


def _pad_heads(p: SSMLayerParams, cfg: ModelConfig, Hp: int,
               mesh) -> SSMLayerParams:
    """``p`` with ``Hp - H`` zero heads after the ``H`` real ones in every
    head-indexed leaf but the conv (which :func:`_conv_channels` pads where
    its weight lies whole): the columns of ``w_z``, ``w_x`` and ``w_dt``,
    ``A_log``, ``D``, ``dt_bias``, ``norm_w`` and the rows of ``w_out``,
    each on even, head-aligned model shards.  The leaves are padded inside
    the forward from their stored layouts (a few MB a layer move where a
    (B, S, d_inner) activation would), so gradients reach them through the
    pad.  A padded head sees x = 0 and D = 0: its output and its state are
    zero, and it adds zeros to the out-projection's partial sums."""
    n = Hp - cfg.n_ssm_heads
    nc = n * cfg.ssm.d_head
    cols, rows, heads = P(None, "model"), P("model", None), P("model")
    return p._replace(
        w_z=_zero_pad(p.w_z, -1, nc, mesh, cols),
        w_x=_zero_pad(p.w_x, -1, nc, mesh, cols),
        w_dt=_zero_pad(p.w_dt, -1, n, mesh, cols),
        A_log=_zero_pad(p.A_log, 0, n, mesh, heads),
        D=_zero_pad(p.D, 0, n, mesh, heads),
        dt_bias=_zero_pad(p.dt_bias, 0, n, mesh, heads),
        norm_w=_zero_pad(p.norm_w, 0, nc, mesh, heads),
        w_out=_zero_pad(p.w_out, 0, nc, mesh, rows))


def _scan_on_shards(scan, mesh, xh, dt, A, Bm, C, D, chunk, init,
                    n_heads: int):
    """``scan`` on each rank's local heads and batch rows (the reference's
    Pallas call under ``jit`` on a mesh): x/dt/init sharded on heads over
    'model' and on the batch over the data axes when they divide it, A/D on
    heads, Bm/C (one group in every config) whole on each model rank.
    The model axis divides the heads (padded by :func:`ssd_heads` where
    the model's do not divide it); the scan is per head, so each head's
    values are those of the one-device scan.  The final state keeps the
    ``n_heads`` real heads, split over 'model' as ``torch.chunk`` splits
    them: each rank drops its padded heads' (zero) states."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    bspec = batch_axes(mesh) if Bsz % dp_size(mesh) == 0 else None
    heads = P(bspec, None, "model", None)
    state = P(bspec, "model", None, None)
    local = H // tp_size(mesh)
    keep = min(local, max(0, n_heads - mesh.get_local_rank("model") * local))

    def body(x, dt, A, Bm, C, D, init):
        y, st = scan(x, dt, A, Bm, C, D, chunk, init)
        return y, st[:, :keep]

    fn = shard_map(body, mesh,
                   (heads, P(bspec, None, "model"), P("model"),
                    P(bspec, None, None, None), P(bspec, None, None, None),
                    P("model"), None if init is None else state),
                   [heads, state],
                   out_shapes=[None, (Bsz, n_heads, Pd, N)])
    return fn(xh, dt, A, Bm, C, D, init)


def ssm_block(x: torch.Tensor, p: SSMLayerParams, cfg: ModelConfig,
              state: Optional[SSMState] = None,
              use_kernel: Optional[bool] = None, mesh=None):
    """Full-sequence SSM mixer.  x: (B, S, d) -> (y (B,S,d), final SSMState).

    ``use_kernel=None`` (the default) means auto: the scan goes through the
    hand-written kernel for a CUDA tensor and through the oracle
    :func:`ssd_chunked` elsewhere (the rule of the reference's ``qjax``
    writer).  ``True`` takes the kernel's entry point on any device (on the
    CPU that is the kernel's plain version), ``False`` the oracle.
    ``mesh``: the device mesh x and p lie on as DTensors; the scan then
    runs on each rank's local shards, on :func:`ssd_heads` heads (the
    real ones and, where the model axis does not divide them, zero heads
    padded after them, :func:`_pad_heads`).  The final state holds the
    real heads."""
    s = cfg.ssm
    B, S, _ = x.shape
    H, Pd = cfg.n_ssm_heads, s.d_head
    Hp = H if mesh is None else ssd_heads(H, tp_size(mesh))
    if Hp != H:
        p = _pad_heads(p, cfg, Hp, mesh)
    z, xv, bc, dt = _project_in(x, p)
    xi, BC, conv_state = _conv_channels(
        xv, bc, p.conv, None if state is None else state.conv, cfg, mesh)
    z = _constrain_inner(z, mesh)
    xi = _constrain_inner(xi, mesh)
    gn = s.n_groups * s.d_state
    Bm = BC[..., :gn].reshape(B, S, s.n_groups, s.d_state)
    Cm = BC[..., gn:].reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    A = -torch.exp(p.A_log)
    xh = xi.reshape(B, S, Hp, Pd)       # whole heads on each model rank
    if mesh is not None and perf.FLAGS.ssd_constraint:
        # pin the SSD head layout so the chunked scan is never resharded or
        # partial-summed across ranks
        bspec = batch_axes(mesh) if B % 2 == 0 else None
        xh = constrain(xh, mesh, P(bspec, None, "model", None))
        dt = constrain(dt, mesh, P(bspec, None, "model"))
    if use_kernel is None:
        use_kernel = x.is_cuda
    init = None if state is None else state.ssd
    if init is not None and Hp != H:
        init = _zero_pad(init, 1, Hp - H, mesh)
    if use_kernel:
        from repro_torch.kernels.ssd_scan.ops import ssd_chunked_kernel
        scan = ssd_chunked_kernel
    else:
        scan = ssd_chunked
    if mesh is not None:
        y, ssd_state = _scan_on_shards(scan, mesh, xh, dt, A, Bm, Cm, p.D,
                                       s.chunk, init, H)
    else:
        y, ssd_state = scan(xh, dt, A, Bm, Cm, p.D, s.chunk, init)
    y = y.reshape(B, S, Hp * Pd)
    # the mean over the d_inner real channels (the padded ones are zeros)
    y = rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p.norm_w,
                n=None if Hp == H else cfg.d_inner)
    out = torch.matmul(y, p.w_out)
    if Hp != H and cfg.d_inner % tp_size(mesh):
        # w_out's rule leaves it whole here, so its product is whole too:
        # the padded rows' partial sums are reduced here, where DTensor
        # could split the batch rows unevenly over 'model'
        out = pin_residual(out, mesh)
    return out, SSMState(ssd=ssd_state, conv=conv_state)


def _decode_on_shards(mesh, xh, dt, A, Bm, C, D, state):
    """``ssd_decode_step`` on each rank's local heads and batch rows, as
    :func:`_scan_on_shards` runs the scan (the model axis divides the
    heads).  The new state is written into ``state`` (in place where it
    lies on the update's layout, else :func:`store`d), which is
    returned."""
    bspec = batch_axes(mesh) if xh.shape[0] % dp_size(mesh) == 0 else None
    heads = P(bspec, "model", None)
    st = P(bspec, "model", None, None)
    inplace = holds(state, mesh, st)
    fn = shard_map(functools.partial(ssd_decode_step, inplace=inplace), mesh,
                   (heads, P(bspec, "model"), P("model"),
                    P(bspec, None, None), P(bspec, None, None), P("model"),
                    st),
                   [heads, st])
    y, new = fn(xh, dt, A, Bm, C, D, state)
    return y, (state if inplace else store(state, new))


def decodes_flat(cfg: ModelConfig, mesh) -> bool:
    """Whether :func:`ssm_decode` runs on flat channels
    (:func:`_decode_on_channels`): on a mesh whose model axis does not
    divide the SSD heads (hymba's 50 at model 16), where a head view of a
    channel-sharded state or output would gather it over 'model'."""
    return mesh is not None and cfg.n_ssm_heads % tp_size(mesh) != 0


def _spread(t, dim: int, n: int):
    """``t.repeat_interleave(n, dim)`` as an expand and a flatten (views,
    which DTensor runs on a tensor replicated over 'model' in place)."""
    t = t.unsqueeze(dim + 1)
    shape = list(t.shape)
    shape[dim + 1] = n
    return t.expand(shape).flatten(dim, dim + 1)


def _decode_on_channels(mesh, x, dt, A, Bm, C, D, state, d_head: int):
    """:func:`ssd_decode_channels` on each rank's own flat channels and
    batch rows.  x (B, C), the per-head dt (B, H), A and D (H,), and Bm/C
    (B, G, N) come whole over 'model' (the decode's conv output is whole);
    dt, A and D are spread over their heads' channels and Bm/C, for G > 1,
    over their groups' channels, then cut to the state's channel shards,
    which moves nothing.  The flat state (B, C, N) stays on its own
    layout: its channels over 'model' (``launch.specs.decode_state_sharding``
    where 'model' divides C; ``runtime.serve.decode_state_shardings``
    always, unevenly as ``torch.chunk`` splits them where it does not) or
    whole; the batch over the data axes where they divide it.  So neither
    the state nor y is gathered; the new state is written into ``state``
    as :func:`_decode_on_shards` writes it.  Raises ValueError on a state whose
    channels lie otherwise over 'model' (a shard the route would have to
    gather)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    Bsz, Cn = x.shape
    N = state.shape[-1]
    got = (state.placements[axis_names(mesh).index("model")]
           if isinstance(state, DTensor) else Replicate())
    if got not in (Shard(1), Replicate()):
        raise ValueError(f"flat SSD decode: a state of {Cn} channels laid "
                         f"out {got} over 'model' cannot update on its own "
                         f"shards")
    feat = "model" if got == Shard(1) else None
    bspec = batch_axes(mesh) if Bsz % dp_size(mesh) == 0 else None
    ch, st = P(bspec, feat), P(bspec, feat, None)
    G = Bm.shape[1]
    if G == 1:
        Bm, C, bc = Bm[:, 0], C[:, 0], P(bspec, None)
    else:
        Bm, C, bc = _spread(Bm, 1, Cn // G), _spread(C, 1, Cn // G), st
    inplace = holds(state, mesh, st)
    fn = shard_map(functools.partial(ssd_decode_channels, inplace=inplace),
                   mesh, (ch, ch, P(feat), bc, bc, P(feat), st), [ch, st],
                   out_shapes=[(Bsz, Cn), (Bsz, Cn, N)])
    y, new = fn(x, _spread(dt, 1, d_head), _spread(A, 0, d_head), Bm, C,
                _spread(D, 0, d_head), state)
    return y, (state if inplace else store(state, new))


def ssm_decode(x: torch.Tensor, p: SSMLayerParams, cfg: ModelConfig,
               state: SSMState, mesh=None):
    """One-token SSM step.  x: (B, 1, d) -> (y (B,1,d), new state).  On a
    mesh the per-head update runs on each rank's local heads; where the
    model axis does not divide the heads (:func:`decodes_flat`) on each
    rank's own flat channels, the SSD state taken and returned flat, (B,
    d_inner, N), as the decode state stores it, and y left on its channel
    shards through the gate, the norm and the out-projection.  The new
    SSD and conv states are written into ``state``'s tensors (the SSD
    state updated in place where the update gets its own storage), and
    the returned state holds them: a decode step's state is its own
    (``transformer.decode_step`` copies one it does not donate)."""
    s = cfg.ssm
    B = x.shape[0]
    H, Pd = cfg.n_ssm_heads, s.d_head
    z, xv, bc, dt = _project_in(x[:, 0], p)
    xi, BC, conv_state = _conv_channels(xv[:, None], bc[:, None], p.conv,
                                        state.conv, cfg, mesh)
    xi, BC = xi[:, 0], BC[:, 0]
    gn = s.n_groups * s.d_state
    Bm = BC[..., :gn].reshape(B, s.n_groups, s.d_state)
    Cm = BC[..., gn:].reshape(B, s.n_groups, s.d_state)
    flat = decodes_flat(cfg, mesh)
    if flat:
        # whole over 'model' before the softplus: past the first layer the
        # product is a partial sum, which DTensor would reduce-scatter onto
        # uneven head shards
        dt = constrain(dt, mesh, P(batch_axes(mesh) if B % dp_size(mesh) == 0
                                   else None, None))
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    A = -torch.exp(p.A_log)
    if flat:
        yh, ssd_state = _decode_on_channels(mesh, xi, dt, A, Bm, Cm, p.D,
                                            state.ssd, Pd)
    else:
        xh = heads_view(xi, (B, H, Pd), H, mesh)
        if mesh is None:
            yh, ssd_state = ssd_decode_step(xh, dt, A, Bm, Cm, p.D,
                                            state.ssd, inplace=True)
        else:
            yh, ssd_state = _decode_on_shards(mesh, xh, dt, A, Bm, Cm, p.D,
                                              state.ssd)
        yh = heads_view(yh, (B, cfg.d_inner), H, mesh)
    conv_state = store(state.conv, conv_state)
    # on channel shards the mean is a sum over them (even where torch.chunk
    # splits them unevenly) divided by d_inner
    yh = rmsnorm(yh * F.silu(z.to(torch.float32)).to(yh.dtype), p.norm_w,
                 n=cfg.d_inner if flat else None)
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
