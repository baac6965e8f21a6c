"""Attention: GQA with RoPE, sliding-window support, chunked prefill, KV-cache
decode (counterpart of ``repro.models.attention``).

Prefill attention is computed in query chunks so the (B, H, S, S) score
tensor is never materialized; per-row softmax stays exact because each
chunk row sees all keys (or, banded, all keys its window can reach).  The
reference's ``lax.scan`` over chunks becomes a Python loop.

The reference computes attention in plain ``jnp`` with no Pallas kernel, so
the port follows it step by step in plain PyTorch: the scores are an f32
product of the upcast operands (the reference's einsum with
``preferred_element_type=f32``), cast to the score dtype and scaled there,
masked with that dtype's lowest value, and the softmax runs in the score
dtype as ``jax.nn.softmax`` writes it.  ``F.scaled_dot_product_attention``
would round bf16 at other places; it is a yardstick only.

Perf knobs (``repro_torch.perf.FLAGS``, read at call time):
  * grouped GQA (scores per kv-head group, the repeated kv tensor is never
    materialized);
  * banded SWA prefill (only the in-window key band is computed per q
    chunk);
  * bf16 score tensors when the activations are bf16.
On a device mesh (``mesh=``, DTensor activations and parameters) the
projections follow DTensor's sharding propagation from the parameters, as
the reference's follow GSPMD's; q/k/v are pinned where the q heads neither
divide nor fit under the model axis (``FLAGS.attn_head_constraint``, the
reference's ``_constrain_heads``), and the attention core (scores, mask,
softmax, values, the cache update) runs under
:func:`repro_torch.sharding.shard_map` on each rank's whole kv-head groups
and batch rows, so the d_head contraction is never split.  DTensor cannot
cut a head dim the model axis does not divide the way JAX pads it.  Where
the reference pins such q heads, :func:`attention` pads them with zero
heads to a multiple of the model axis (:func:`q_heads`,
:func:`_pad_q_heads`) and runs the core on each rank's own q heads, each
with its kv head (:func:`_on_q_shards`); the kv heads of that route (and
elsewhere a flat projection that would split inside a head, as in the
one-token decode) are replicated over 'model'.  Where the model axis
divides the q heads and is a multiple of the kv heads
(:func:`_on_own_q_heads`: 32 q and 8 kv heads on model 16, r = tp / Hkv =
2), nothing pads: each rank scores its own q heads, as GSPMD keeps them on
their shards, against the one kv head that the r model ranks of its group
hold, k and v gathered over those r ranks only and k rotated after that
gather (:func:`_on_kv_head_group`).  Where the model axis is a multiple of
the heads (whisper-base's 8 on model 16, r = 2 ranks a head;
:func:`row_exchange`), q, k and v stay on their own flat shards and an
all-to-all over the head's r ranks trades batch rows for head dims, so each
rank scores one whole head for 1/r of its rows (:func:`_on_head_rows`);
where r does not divide the local batch (1 row a data rank), the
all-to-all trades query positions instead and k and v are gathered one
head wide over the same r ranks, so each rank scores its head whole for
1/r of the queries (:func:`query_exchange`, :func:`_on_head_queries`).
The reference there splits d_head over the head's ranks and all-reduces the
f32 scores; trading rows or queries keeps each head's dot products whole on
one rank, the one-device math for every row.  The head-group exchanges are
autograd-recorded collectives over process groups of r ranks
(:func:`_head_group`, ``sharding.group_all_to_all``,
``sharding.group_gather``).  Any other head count runs the core on the
kv-head groups (:func:`_on_kv_groups`).

A decode cache whose slots are sharded over the data axes
(``launch.specs.decode_state_sharding`` for a batch they do not divide)
is attended on each rank's own slots, the softmax completed by
all-reduces (:func:`_decode_on_seq_shards`), as
GSPMD partitions the reference's decode over such a cache; one whose flat
kv dim the model axis splits inside each kv head is attended on each
rank's own dims of its head, the scores summed over the head's ranks
(:func:`_decode_on_split_heads`), and on its own dims of its own slots
where the cache is sharded both ways (mixtral-8x7b's and
h2o-danube-3-4b's long_500k): the scores summed over the head's ranks,
the softmax and the value product completed over the data axes.  Where
the q heads lie whole on every model rank instead (neither the local
batch nor the queries split over the head's ranks), a step that autograd
records takes ``wo`` whole over 'model' for the out-projection: the
residual's held cotangent then comes back whole, where against ``wo``'s
row shards it would be cut inside a head.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import perf
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_rope, rope_angles
from repro_torch.sharding import (P, axis_names, batch_axes, batch_entry,
                                  constrain, dp_size, group_all_to_all,
                                  group_gather, heads_view, mesh_shape,
                                  padded_heads, pin_residual, shard_map,
                                  tp_size, zero_pad)

Q_CHUNK = 1024  # query-block size for chunked attention
PAD_POS = -10 ** 9     # position of the keys padded in front of a band
EMPTY_POS = 10 ** 9    # position of a cache slot not written yet


class LayerAttnParams(NamedTuple):
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None


def _constrain_heads(x, mesh, batch_sharded: bool = True):
    """x: (B, S, H, Dh) -> head-sharded over 'model' where it divides H;
    otherwise replicated there (JAX pads the uneven heads, DTensor cannot
    split them in the attention that follows)."""
    dp = batch_axes(mesh) if batch_sharded and x.shape[0] % 2 == 0 else None
    heads = "model" if x.shape[2] % tp_size(mesh) == 0 else None
    return constrain(x, mesh, P(dp, None, heads, None))


def _pins_heads(cfg: ModelConfig, mesh) -> bool:
    """The reference's gate for pinning q/k/v head-sharded: on a mesh,
    with ``FLAGS.attn_head_constraint``, where the q heads neither divide
    nor fit under the model axis (divisible counts propagate fine, and H <
    tp would leave more slots than heads)."""
    if mesh is None or not perf.FLAGS.attn_head_constraint:
        return False
    tp = tp_size(mesh)
    return cfg.n_heads % tp != 0 and cfg.n_heads > tp


def q_heads(cfg: ModelConfig, mesh=None) -> int:
    """The q heads :func:`attention` runs on: where the reference pins
    them (:func:`_pins_heads`) and GSPMD pads the uneven ones, the q heads
    padded with zero heads to a multiple of the model axis
    (:func:`repro_torch.sharding.padded_heads`: hymba's and granite's 25
    and 24 heads to 32 at model 16, 2 a rank); else ``cfg.n_heads``."""
    if _pins_heads(cfg, mesh):
        return padded_heads(cfg.n_heads, tp_size(mesh))
    return cfg.n_heads


def _on_own_q_heads(cfg: ModelConfig, mesh) -> bool:
    """Whether :func:`attention` runs the core unpadded on each rank's own
    q heads against the kv head that the r = tp / Hkv model ranks of its
    group hold (:func:`_on_kv_head_group`): on a mesh whose model axis
    divides the q heads and is a multiple of the kv heads, more than one
    rank a kv head (mixtral-8x7b's and h2o-danube-3-4b's 32 q and 8 kv
    heads on model 16, r = 2).  Whole kv heads cannot be split over
    'model', so :func:`_on_kv_groups` would score every head on every
    model rank; whole q heads can, each rank scoring its own H / tp, all
    of one kv head."""
    if mesh is None:
        return False
    tp, Hkv = tp_size(mesh), cfg.n_kv_heads
    return cfg.n_heads % tp == 0 and Hkv < tp and tp % Hkv == 0


def _pad_q_heads(p: LayerAttnParams, cfg: ModelConfig, Hp: int,
                 mesh) -> LayerAttnParams:
    """``p`` with ``Hp - H`` zero q heads after the ``H`` real ones: zero
    columns of ``wq`` (and ``bq``) and zero rows of ``wo``, each on even,
    head-aligned model shards.  The leaves are padded inside the forward
    from their stored layouts (a few MB a layer), so gradients reach them
    through the pad.  A padded head's q is zero, so its softmax is uniform
    and its output nonzero; but that output meets ``wo``'s zero rows, so
    it adds exact zeros to the out-projection's partial sums, and its
    gradient into k and v is exactly zero."""
    n = (Hp - cfg.n_heads) * cfg.head_dim
    return p._replace(
        wq=zero_pad(p.wq, -1, n, mesh, P(None, "model")),
        bq=None if p.bq is None else zero_pad(p.bq, 0, n, mesh, P("model")),
        wo=zero_pad(p.wo, 0, n, mesh, P("model", None)))


def _head_ranks(cfg: ModelConfig, mesh) -> int:
    """r = tp / H where the model axis splits each whole q head over r
    ranks: on a mesh whose model axis is a multiple of the q heads, H < tp,
    with as many kv heads as q heads and no RoPE; else 0."""
    if mesh is None:
        return 0
    tp, H = tp_size(mesh), cfg.n_heads
    if H >= tp or tp % H or cfg.n_kv_heads != H or cfg.rope_theta > 0:
        return 0
    return tp // H


def _local_batch(mesh, batch: int) -> int:
    """The rows a data rank holds: B / dp where the data axes divide the
    batch, else B."""
    dp = dp_size(mesh)
    return batch // dp if batch % dp == 0 else batch


def row_exchange(cfg: ModelConfig, mesh, batch: int) -> int:
    """r = tp / H where :func:`attention` scores each q head on the r model
    ranks that hold its dims by trading batch rows for head dims
    (:func:`_on_head_rows`), else 0: where the model axis splits the heads
    (:func:`_head_ranks`) and r divides the local batch
    (:func:`_local_batch`): whisper-base's 8 heads on model 16, r = 2."""
    r = _head_ranks(cfg, mesh)
    return r if r and _local_batch(mesh, batch) % r == 0 else 0


def query_exchange(cfg: ModelConfig, mesh, batch: int, seq: int) -> int:
    """r = tp / H where :func:`attention` scores each q head on the r model
    ranks that hold its dims by trading query positions for head dims
    (:func:`_on_head_queries`), else 0: where the model axis splits the
    heads (:func:`_head_ranks`) but r does not divide the local batch, so
    :func:`row_exchange` cannot apply, and r divides the ``seq`` query
    positions: whisper-base's prefill_32k on 2x16x16, 1 row a data rank,
    r = 2."""
    r = _head_ranks(cfg, mesh)
    if not r or _local_batch(mesh, batch) % r == 0:
        return 0
    return r if seq % r == 0 else 0


def _proj_flat(x: torch.Tensor, p: LayerAttnParams):
    """The flat projections q (B, S, Hq*Dh), k and v (B, S, Hkv*Dh), with
    their biases; on a mesh each on its model shards of the weights'
    columns."""
    q = torch.matmul(x, p.wq)
    k = torch.matmul(x, p.wk)
    v = torch.matmul(x, p.wv)
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return q, k, v


def _proj_qkv(x: torch.Tensor, p: LayerAttnParams, cfg: ModelConfig,
              mesh=None):
    """q (B, S, Hq, Dh), k and v (B, S, Hkv, Dh): Hq is ``cfg.n_heads``, or
    the padded count when ``p`` holds :func:`_pad_q_heads`' weights."""
    B, S, _ = x.shape
    q, k, v = _proj_flat(x, p)
    Hq = q.shape[-1] // cfg.head_dim
    q = heads_view(q, (B, S, Hq, cfg.head_dim), Hq, mesh)
    k = heads_view(k, (B, S, cfg.n_kv_heads, cfg.head_dim), cfg.n_kv_heads,
                   mesh)
    v = heads_view(v, (B, S, cfg.n_kv_heads, cfg.head_dim), cfg.n_kv_heads,
                   mesh)
    # The decision follows the q-head count and applies to k/v too: padded
    # q heads lie on even head shards, k/v heads the model axis does not
    # divide stay whole over it.
    if _pins_heads(cfg, mesh):
        q = _constrain_heads(q, mesh)
        k = _constrain_heads(k, mesh)
        v = _constrain_heads(v, mesh)
    return q, k, v


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, Dh) -> (B, S, H, Dh) by group repetition."""
    rep = n_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: Optional[int],
          causal: bool) -> torch.Tensor:
    """qpos: (Q,), kpos: (K,) -> bool (Q, K) of *allowed* links."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _softmax(s: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim, step by step in s's dtype."""
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _sdpa_chunk(q, k, v, qpos, kpos, window, causal, scale, grouped: bool,
                softmax=_softmax):
    """q: (B, Qc, H, Dh); k/v: (B, S, Hkv, Dh) -> (B, Qc, H, Dh).

    grouped=True computes scores per kv group without repeating k/v.
    ``softmax`` normalises the masked scores over their last dim."""
    B, Qc, H, Dh = q.shape
    Hkv = k.shape[2]
    m = _mask(qpos, kpos, window, causal)
    sdt = torch.bfloat16 if (perf.FLAGS.attn_bf16_scores
                             and q.dtype == torch.bfloat16) else torch.float32
    neg = torch.finfo(sdt).min
    scale_t = torch.tensor(scale, dtype=sdt, device=q.device)
    if grouped and Hkv != H:
        G = H // Hkv
        qg = q.reshape(B, Qc, Hkv, G, Dh)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()
                         ).to(sdt) * scale_t
        s = s.masked_fill(~m, neg)
        prob = softmax(s).to(v.dtype)
        o = torch.einsum("bhgqk,bkhd->bqhgd", prob, v)
        return o.reshape(B, Qc, H, Dh)
    kx = _expand_kv(k, H)
    vx = _expand_kv(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()).to(sdt) \
        * scale_t
    s = s.masked_fill(~m, neg)
    prob = softmax(s).to(vx.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", prob, vx)


def prefill_route(cfg: ModelConfig, S: int, causal: bool = True,
                  cross: bool = False) -> str:
    """Which schedule :func:`attention` runs for S queries: ``"unchunked"``
    (S <= Q_CHUNK or ragged), ``"banded"`` (SWA, ``FLAGS.swa_banded``, the
    window a multiple of Q_CHUNK, no cross-attention) or ``"chunked"``."""
    qc, win = Q_CHUNK, cfg.sliding_window
    if S <= qc or S % qc != 0:
        return "unchunked"
    if (perf.FLAGS.swa_banded and win is not None and causal and not cross
            and win % qc == 0):
        return "banded"
    return "chunked"


def attend(q, k, v, positions, kpos, cfg: ModelConfig, causal: bool = True,
           cross: bool = False, q0: int = 0) -> torch.Tensor:
    """Scores, mask, softmax and the value product for the whole sequence:
    q (B,S,H,Dh), k/v (B,Sk,Hkv,Dh) after RoPE -> (B,S,H,Dh), on the
    schedule :func:`prefill_route` picks.  ``positions`` are q's own; q's
    first query is key ``q0`` (a rank's share of the queries,
    :func:`_on_head_queries`), where the band starts."""
    S = q.shape[1]
    scale = cfg.head_dim ** -0.5
    grouped = perf.FLAGS.gqa_grouped
    win = cfg.sliding_window
    qc = Q_CHUNK
    route = prefill_route(cfg, S, causal, cross)
    if route == "unchunked":
        return _sdpa_chunk(q, k, v, positions, kpos, win, causal, scale,
                           grouped)
    outs = []
    if route == "banded":
        # per q chunk only keys in [chunk_start - window, chunk_end) can
        # attend: pad keys in front so every chunk slices a fixed-size band
        band = win + qc
        pad = band - qc
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
        kpos_p = torch.nn.functional.pad(kpos, (pad, 0), value=PAD_POS)
        for start in range(0, S, qc):     # band ends at chunk end
            kb = slice(q0 + start, q0 + start + band)
            outs.append(_sdpa_chunk(
                q[:, start:start + qc], kp[:, kb], vp[:, kb],
                positions[start:start + qc], kpos_p[kb], win, causal, scale,
                grouped))
    else:
        for start in range(0, S, qc):
            sl = slice(start, start + qc)
            outs.append(_sdpa_chunk(q[:, sl], k, v, positions[sl], kpos, win,
                                    causal, scale, grouped))
    return torch.cat(outs, dim=1)


def _group_specs(mesh, B: int, Hkv: int, batch: bool = True):
    """(q spec (B,S,Hkv,G,Dh), k/v spec (B,S,Hkv,Dh)): whole kv-head groups
    over 'model' where they divide it, and the batch as
    :func:`~repro_torch.sharding.batch_entry` lays it out (whole if
    ``batch`` is False)."""
    bspec = batch_entry(B, mesh) if batch else None
    hspec = "model" if Hkv % tp_size(mesh) == 0 else None
    return P(bspec, None, hspec, None, None), P(bspec, None, hspec, None)


def _on_kv_groups(core, mesh, q, k, v, *extra, extra_specs=(),
                  batch: bool = True):
    """``core(q, k, v, *extra)`` -> out (B,S,H,Dh) on each rank's local
    kv-head groups: q (B,S,H,Dh), k/v (B,S,Hkv,Dh); the batch over the data
    axes unless ``batch`` is False."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qspec, kvspec = _group_specs(mesh, B, Hkv, batch)
    # q sharded on H in whole groups, so its (Hkv, G) view keeps the shards
    q5 = constrain(q, mesh, P(qspec[0], None, qspec[2], None)).reshape(
        B, S, Hkv, G, Dh)

    def body(q5, k, v, *rest):
        b, s, hl = q5.shape[:3]
        out = core(q5.reshape(b, s, hl * G, Dh), k, v, *rest)
        return out.reshape(b, s, hl, G, Dh)

    return shard_map(body, mesh, (qspec, kvspec, kvspec) + tuple(extra_specs),
                     qspec)(q5, k, v, *extra).reshape(B, S, H, Dh)


def _on_q_shards(core, mesh, q, k, v, n_heads: int):
    """``core(q, k, v)`` -> out (B,S,Hp,Dh) on each rank's own q heads: q
    (B,S,Hp,Dh) on even head shards over 'model' (padded by
    :func:`q_heads`), k/v (B,Sk,Hkv,Dh) whole over it; the batch
    over the data axes where they divide it.  For each of its Hp / tp q
    heads, by global index j, a rank takes kv head ``min(j // G, Hkv - 1)``
    (G = n_heads / Hkv; a padded head takes the last), so its heads may
    belong to two kv groups, and ``core`` runs with as many kv heads as q
    heads (the per-head path of :func:`_sdpa_chunk`): no rank scores more
    than Hp / tp q heads, and k and v are not repeated whole."""
    B, Hp, Hkv = q.shape[0], q.shape[2], k.shape[2]
    local = Hp // tp_size(mesh)
    bspec = batch_axes(mesh) if B % dp_size(mesh) == 0 else None
    qspec, kvspec = P(bspec, None, "model", None), P(bspec, None, None, None)

    def body(q, k, v):
        kv = _kv_heads_of(mesh.get_local_rank("model"), local, n_heads, Hkv)
        return core(q, k[:, :, kv], v[:, :, kv])

    return shard_map(body, mesh, (qspec, kvspec, kvspec), qspec)(q, k, v)


def _flat_spec(mesh, batch: int) -> P:
    """A flat (B, S, n*Dh) projection on its own model shards, the batch
    over the data axes where they divide it."""
    return P(batch_axes(mesh) if batch % dp_size(mesh) == 0 else None, None,
             "model")


def _on_head_rows(core, mesh, q, k, v, r: int):
    """``core(q, k, v)`` on whole heads, each scored by one of the r model
    ranks that hold its dims (:func:`row_exchange`): q (B,S,H*Dh) and k/v
    (B,Sk,H*Dh) flat on their own model shards, so model rank m holds dims
    [(m % r) * Dh/r, +Dh/r) of head m // r.  Inside the body an all-to-all
    over the head's r ranks (:func:`_head_group`) trades batch rows for
    head dims: each rank takes its head whole, (B_l / r, S, 1, Dh), for its
    own 1/r of the local batch rows, ``core`` scores it, and a second
    all-to-all returns the output to (B_l, S, Dh/r) on the rank's own dims,
    which are ``wo``'s row shard.  Per row the math is the one-device
    core's; nothing is gathered."""
    spec = _flat_spec(mesh, q.shape[0])
    part = _head_group(mesh, r)

    def body(q, k, v):
        q, k, v = (group_all_to_all(t, part, 0, -1).unsqueeze(2)
                   for t in (q, k, v))
        return group_all_to_all(core(q, k, v).squeeze(2), part, -1, 0)

    return shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)


def _on_head_queries(core, mesh, q, k, v, r: int):
    """``core(q, k, v, q0)`` on whole heads, each scored by the r model
    ranks that hold its dims for 1/r of the query positions each
    (:func:`query_exchange`): q (B,S,H*Dh) and k/v (B,Sk,H*Dh) flat on
    their own model shards, as :func:`_on_head_rows` takes them.  Inside
    the body an all-to-all over the head's r ranks (:func:`_head_group`)
    trades query positions for head dims, so group rank j takes its head
    whole, (B_l, S/r, 1, Dh), for queries [q0, q0 + S/r), q0 = j * S/r;
    k and v are gathered whole for the head over the same ranks, (B_l,
    Sk, 1, Dh); ``core`` scores the rank's queries against every key, the
    causal mask and any band offset by q0; a second all-to-all returns
    the output to (B_l, S, Dh/r) on the rank's own dims, which are
    ``wo``'s row shard.  Per query row the math is the one-device core's.
    Raises where S or a head's dims do not split evenly over r ranks."""
    S, width = q.shape[1], q.shape[2]
    if S % r or width % tp_size(mesh):
        raise ValueError(f"query exchange over {r} ranks: {S} queries or "
                         f"{width} q dims over {tp_size(mesh)} model ranks "
                         f"do not split evenly")
    spec = _flat_spec(mesh, q.shape[0])
    part = _head_group(mesh, r)
    n = S // r

    def body(q, k, v):
        k, v = (group_gather(t, part, -1).unsqueeze(2) for t in (k, v))
        q = group_all_to_all(q, part, 1, -1).unsqueeze(2)
        q0 = (mesh.get_local_rank("model") % r) * n
        return group_all_to_all(core(q, k, v, q0).squeeze(2), part, -1, 1)

    return shard_map(body, mesh, (spec, spec, spec), spec)(q, k, v)


def _on_kv_head_group(core, mesh, q, k, v, r: int, rope=None):
    """``core(q, k, v)`` -> (out (B,S,H,Dh), k after RoPE) on each rank's own
    q heads, against the kv head that the r model ranks of its group hold
    (:func:`_on_own_q_heads`): q (B,S,H,Dh) on whole-head shards over 'model'
    (after RoPE), k/v (B,S,Hkv*Dh) flat on their own model shards (before
    RoPE).  k and v are gathered over the group's r ranks only
    (:func:`_head_group`), to the one kv head (B_l, S, 1, Dh); RoPE
    (``rope``: cos and sin, or None) rotates k there, since it pairs dims i
    and i + Dh/2 that lie on different ranks of the group.  The rotated k
    comes back on the rank's own flat shard, as the decode cache splits it
    inside its kv heads (:func:`_split_in_head`)."""
    Dh = q.shape[3]
    flat = _flat_spec(mesh, q.shape[0])
    qspec = P(flat[0], None, "model", None)
    part = _head_group(mesh, r)
    dl = Dh // r

    def body(q, k, v):
        kh, vh = (group_gather(t, part, -1).unflatten(-1, (1, Dh))
                  for t in (k, v))
        if rope is not None:
            kh = apply_rope(kh, *rope)
        d0 = (mesh.get_local_rank("model") % r) * dl
        return core(q, kh, vh), kh[..., d0:d0 + dl].flatten(2)

    return shard_map(body, mesh, (qspec, flat, flat), [qspec, flat])(q, k, v)


def _kv_heads_of(rank: int, local: int, n_heads: int, n_kv: int) -> list:
    """The kv head of each of model rank ``rank``'s ``local`` q heads
    (global indices ``rank * local`` on): ``min(j // G, n_kv - 1)``."""
    G = n_heads // n_kv
    return [min(j // G, n_kv - 1)
            for j in range(rank * local, (rank + 1) * local)]


def attention(x: torch.Tensor, p: LayerAttnParams, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None, causal: bool = True,
              kv_override=None, mesh=None):
    """Full-sequence attention (prefill / encoder).

    kv_override: (k, v, kpos) for cross-attention (q from x, k and v
    precomputed flat, (B,Sk,Hkv*Dh), on their own model shards on a mesh).
    Returns (out (B,S,d), k, v) — k/v (B,S,Hkv*Dh) returned for cache
    population at prefill (after RoPE), flat as the decode cache holds
    them and, on a mesh, on their own model shards wherever the route
    keeps them so.  ``mesh``: the device mesh x and p lie on as DTensors.

    The core (scores, mask, softmax, values) runs on the whole tensors
    without a mesh; on a mesh on the first of five routes that applies:

    1. :func:`_on_head_rows` where the model axis is a multiple of the q
       heads, with as many kv heads and no RoPE, and r = tp / H divides
       the local batch (:func:`row_exchange`): each head scored whole on
       one of its r ranks for 1/r of the rows (whisper-base on 16x16).
    2. :func:`_on_head_queries` where the same heads meet a local batch r
       does not divide and r divides the S queries
       (:func:`query_exchange`): each head scored whole on one of its r
       ranks for 1/r of the query positions (whisper-base's prefill_32k
       on 2x16x16, 1 row a data rank).
    3. :func:`_on_kv_head_group` where the model axis divides the q heads
       and is a multiple of the kv heads (:func:`_on_own_q_heads`, not
       cross-attention): each rank's own q heads against the one kv head
       its group gathers (mixtral-8x7b, h2o-danube-3-4b).
    4. :func:`_on_q_shards` where the pins pad the q heads
       (:func:`q_heads`): each rank's own padded q heads (hymba-1.5b,
       granite-moe-3b-a800m).
    5. :func:`_on_kv_groups` otherwise: whole kv-head groups over 'model'
       where they divide it, else every head on every model rank (routes
       1-2's heads at an odd S and a local batch r does not divide).
       Routes 4 and 5 take q, k and v in heads views (:func:`_proj_qkv`).
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    cross = kv_override is not None
    kpos = kv_override[2] if cross else positions
    rope = (rope_angles(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.rope_theta > 0 and not cross else None)

    def core(q, k, v, q0: int = 0):
        return attend(q, k, v, positions[q0:q0 + q.shape[1]], kpos, cfg,
                      causal, cross, q0=q0)

    r, rq = row_exchange(cfg, mesh, B), query_exchange(cfg, mesh, B, S)
    if r or rq:
        q, k, v = _proj_flat(x, p)
        if cross:
            k, v = kv_override[:2]
        out = (_on_head_rows(core, mesh, q, k, v, r) if r else
               _on_head_queries(core, mesh, q, k, v, rq))
        return torch.matmul(out, p.wo), k, v
    if not cross and _on_own_q_heads(cfg, mesh):
        q, k, v = _proj_flat(x, p)
        q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)  # whole-head shards
        if rope is not None:
            q = apply_rope(q, *rope)
        out, k = _on_kv_head_group(core, mesh, q, k, v,
                                   tp_size(mesh) // cfg.n_kv_heads, rope)
        return torch.matmul(out.reshape(B, S, cfg.q_dim), p.wo), k, v
    Hq = q_heads(cfg, mesh)
    if Hq != cfg.n_heads:
        p = _pad_q_heads(p, cfg, Hq, mesh)
    q, k, v = _proj_qkv(x, p, cfg, mesh)
    if cross:
        Hkv, Sk = cfg.n_kv_heads, kv_override[0].shape[1]
        k, v = (heads_view(t, (B, Sk, Hkv, cfg.head_dim), Hkv, mesh)
                for t in kv_override[:2])
    elif rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)

    if mesh is None:
        out = core(q, k, v)
    elif Hq != cfg.n_heads:
        out = _on_q_shards(core, mesh, q, k, v, cfg.n_heads)
    else:
        out = _on_kv_groups(core, mesh, q, k, v)
    wo = p.wo
    if mesh is not None and Hq % tp_size(mesh) and out.requires_grad:
        # heads whole on every model rank (neither the local batch nor S
        # splits over the r ranks of a head): against wo's row shards the
        # held residual cotangent would come back cut inside a head, which
        # the heads view's backward cannot take.  wo whole
        # (0.5 MB a layer at whisper-base's width) keeps it whole; a
        # forward without autograd keeps the row shards.
        wo = constrain(wo, mesh, P(None, None))
    out = torch.matmul(out.reshape(B, S, Hq * cfg.head_dim), wo)
    if Hq != cfg.n_heads and cfg.q_dim % tp_size(mesh):
        # wo's rule leaves it whole here, so its product is whole too: the
        # padded rows' partial sums are reduced here, where DTensor could
        # split the batch rows unevenly over 'model'
        out = pin_residual(out, mesh)
    return out, k.flatten(2), v.flatten(2)


def cache_size(cfg: ModelConfig, seq_len: int) -> int:
    """Allocated cache length: SWA archs keep a ring buffer of window size."""
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def _slot(cfg: ModelConfig, index: int, smax: int) -> int:
    """The cache slot a decode step at ``index`` writes: the ring's for
    SWA; the reference's dynamic_update_slice clamps a start past the
    end."""
    slot = index % smax if cfg.sliding_window is not None else index
    return min(slot, smax - 1)


def _write_slot(cache, new, slot: int) -> None:
    """``new`` (B, 1, Hkv, Dh) written into slot ``slot`` of the (B, Smax,
    Hkv*Dh) ``cache`` in place.  A DTensor cache takes it on its own
    shards: ``new`` cut to the cache's layout of one slot, and each rank
    writes its own columns of its own rows where its shard holds the slot.
    The cache never moves, so a decode core that gathers it afterwards
    reads the new slot too.  Raises ValueError where the mesh dims that
    shard the slots do not split them evenly."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    new = new.reshape(new.shape[0], 1, -1)
    with torch.no_grad():
        if not isinstance(cache, DTensor):
            cache[:, slot:slot + 1] = new.to(cache.dtype)
            return
        mesh = cache.device_mesh
        # the rank's slot shard, the mesh dims that shard the slots major
        # first
        coord, shard, n = mesh.get_coordinate(), 0, 1
        for d, p in enumerate(cache.placements):
            if p == Shard(1):
                shard, n = shard * mesh.size(d) + coord[d], n * mesh.size(d)
        if cache.shape[1] % n:
            raise ValueError(f"decode cache: {cache.shape[1]} slots over "
                             f"{n} ranks do not split evenly")
        pl = tuple(Replicate() if p == Shard(1) else p
                   for p in cache.placements)
        if tuple(new.placements) != pl:
            new = new.redistribute(mesh, pl)
        local = cache.to_local()
        at = slot - shard * local.shape[1]
        if 0 <= at < local.shape[1]:
            local[:, at:at + 1] = new.to_local().to(local.dtype)


def decode_attention(x: torch.Tensor, p: LayerAttnParams, cfg: ModelConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, index: int,
                     *, kv_override=None, mesh=None, donate: bool = False):
    """Single-token decode.  x: (B, 1, d); cache_k/v: (B, Smax, Hkv*Dh)
    *flattened* on the kv dim; index: host int, the tokens already in the
    cache.

    RoPE is applied at insertion, so SWA ring buffers need no re-rotation.
    The new k/v are written into the slot (on a mesh into the caches'
    stored shards, :func:`_write_slot`) before any core reads the caches.
    Returns (out, new_cache_k, new_cache_v): copies of the caches passed
    in, which are left as they were; with ``donate`` (the reference's
    ``donate_argnums``) the caches passed in, written in place."""
    B = x.shape[0]
    q, k, v = _proj_qkv(x, p, cfg, mesh)
    scale = cfg.head_dim ** -0.5
    dev = x.device
    if kv_override is not None:
        ko, vo, _ = kv_override

        def cross(q, ko, vo):
            return _sdpa_chunk(q, ko.to(q.dtype), vo.to(q.dtype),
                               torch.zeros(1, dtype=torch.long, device=dev),
                               torch.zeros(ko.shape[1], dtype=torch.long,
                                           device=dev),
                               None, False, scale, perf.FLAGS.gqa_grouped)

        out = (cross(q, ko, vo) if mesh is None
               else _on_kv_groups(cross, mesh, q, ko, vo))
        out = out.reshape(B, 1, cfg.q_dim)
        return torch.matmul(out, p.wo), cache_k, cache_v

    if cfg.rope_theta > 0:
        cos, sin = rope_angles(torch.tensor([index], device=dev),
                               cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if not donate:
        cache_k, cache_v = cache_k.clone(), cache_v.clone()
    slot = _slot(cfg, index, cache_k.shape[1])
    _write_slot(cache_k, k, slot)
    _write_slot(cache_v, v, slot)

    def core(q, k, v, cache_k, cache_v, first: int = 0, smax=None,
             softmax=_softmax):
        """Attend over the written slots (batch and head counts from the
        tensors: on a mesh, the local shards).  ``cache_k``/``cache_v``
        hold the slots from ``first`` on of a cache of ``smax`` slots (all
        of them by default), and ``softmax`` completes the softmax over the
        slots the other shards hold."""
        Bl, Hkv, Dh = k.shape[0], k.shape[2], k.shape[3]
        held = cache_k.shape[1]
        smax = held if smax is None else smax
        kc = cache_k.reshape(Bl, held, Hkv, Dh).to(q.dtype)
        vc = cache_v.reshape(Bl, held, Hkv, Dh).to(q.dtype)
        valid = torch.arange(first, first + held, device=dev) <= min(
            index, smax - 1)
        kpos = torch.where(valid, 0, EMPTY_POS)  # unwritten slots fail causality
        return _sdpa_chunk(q, kc, vc,
                           torch.zeros(1, dtype=torch.long, device=dev),
                           kpos, None, True, scale, perf.FLAGS.gqa_grouped,
                           softmax)

    # On a mesh: a cache whose flat kv dim splits inside a kv head (8 kv
    # heads over model 16: mixtral, granite, h2o-danube3, whisper's
    # decoder) is attended on each rank's own dims of its head, and where
    # its slots are sharded over the data axes too (batch 1, long_500k) on
    # its own dims of its own slots; one whose slots alone are sharded so
    # on each rank's own slots (hymba's 5 kv heads over 16, whose shards
    # cross head boundaries); else (kv heads that divide the model axis)
    # on whole kv-head groups, whose body may read a gathered copy.
    if mesh is None:
        out = core(q, k, v, cache_k, cache_v)
    elif _split_in_head(cache_k, mesh, k.shape[2]):
        out = _decode_on_split_heads(mesh, q, k, v, cache_k, cache_v, index,
                                     scale)
    elif _seq_sharded(cache_k, mesh):
        out = _decode_on_seq_shards(core, mesh, q, k, v, cache_k, cache_v)
    else:
        _, kvspec = _group_specs(mesh, B, k.shape[2])
        # the caches read on their stored layout (``decode_state_sharding``
        # shards a batch the data axes divide, one data rank too)
        cspec = P(batch_axes(mesh) if B % dp_size(mesh) == 0 else None, None,
                  kvspec[2])
        out = _on_kv_groups(core, mesh, q, k, v, cache_k, cache_v,
                            extra_specs=(cspec, cspec))
    out = out.reshape(B, 1, cfg.q_dim)
    return torch.matmul(out, p.wo), cache_k, cache_v


def _seq_sharded(cache, mesh) -> bool:
    """Whether a (B, Smax, Hkv*Dh) cache's slots are sharded evenly over
    the data axes (``launch.specs.decode_state_sharding`` for a batch the
    data axes do not divide)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(cache, DTensor) or cache.shape[1] % dp_size(mesh):
        return False
    names = axis_names(mesh)
    return all(cache.placements[names.index(a)] == Shard(1)
               for a in batch_axes(mesh))


def _data_all_reduce(mesh, t, op: str):
    """``t`` all-reduced with ``op`` over each data axis of ``mesh`` in
    turn (inside a :func:`shard_map` body); on one data rank, ``t``."""
    from torch.distributed import _functional_collectives as funcol
    names = axis_names(mesh)
    for a in batch_axes(mesh):
        t = funcol.all_reduce(t, op, (mesh, names.index(a)))
    return funcol.wait_tensor(t)


def _data_rank(mesh) -> int:
    """This rank's index over the data axes, the outer axis first: the
    slot shard it holds of a cache sharded over them."""
    rank = 0
    for a in batch_axes(mesh):
        rank = rank * mesh_shape(mesh)[a] + mesh.get_local_rank(a)
    return rank


def _data_softmax(mesh):
    """The softmax over scores whose last dim the data axes shard: the
    max and the sum all-reduced over them (:func:`_data_all_reduce`), each
    step as :func:`_softmax` runs it.  A rank whose scores are all masked
    adds exactly 0 to the sum, as to the value product."""
    def softmax(s):
        e = torch.exp(s - _data_all_reduce(mesh, s.amax(dim=-1, keepdim=True),
                                           "max"))
        return e / _data_all_reduce(mesh, e.sum(dim=-1, keepdim=True), "sum")
    return softmax


def _decode_on_seq_shards(core, mesh, q, k, v, cache_k, cache_v):
    """The decode ``core`` on each rank's own cache slots, the batch
    replicated over the data axes: each rank scores its slots, and
    all-reduces over the data axes of the scores' max (B, H), the
    softmax's sum (B, H) and the output (B, H, Dh) complete the softmax and
    the value product; the cache is never gathered.  On one data rank each
    all-reduce returns its input, so the result is the one-device core's,
    bit for bit.  A cache that is also split inside its kv heads takes
    :func:`_decode_on_split_heads`."""
    smax = cache_k.shape[1]
    softmax = _data_softmax(mesh)

    def body(q, k, v, cache_k, cache_v):
        out = core(q, k, v, cache_k, cache_v,
                   _data_rank(mesh) * cache_k.shape[1], smax, softmax)
        return _data_all_reduce(mesh, out, "sum")

    _, kvspec = _group_specs(mesh, q.shape[0], k.shape[2], batch=False)
    cspec = P(None, batch_axes(mesh), kvspec[2])
    return _on_kv_groups(body, mesh, q, k, v, cache_k, cache_v,
                         extra_specs=(cspec, cspec), batch=False)


def _split_in_head(cache, mesh, n_kv: int) -> bool:
    """Whether a (B, Smax, Hkv*Dh) cache's flat kv dim is sharded over
    'model' inside its kv heads: the model axis does not divide the kv
    heads but they divide it, so each kv head lies on tp / Hkv consecutive
    model ranks (``launch.specs.decode_state_sharding``'s layout for 8 kv
    heads on model 16)."""
    from torch.distributed.tensor import DTensor, Shard
    tp = tp_size(mesh)
    if not isinstance(cache, DTensor) or n_kv % tp == 0 or tp % n_kv:
        return False
    return cache.placements[axis_names(mesh).index("model")] == Shard(2)


def _head_group(mesh, r: int):
    """The process group of the ``r`` consecutive model ranks that hold
    this rank's kv head.  Every rank creates every such group, in the same
    order, when they all reach their first head-group attention or
    split-head decode on ``mesh``; the groups are kept on the mesh.  The
    mesh's rank layout is host bookkeeping, read outside any tensor mode
    (the dry-run's fake one)."""
    groups = mesh.__dict__.setdefault("_repro_kv_head_groups", {})
    if r not in groups:
        import torch.distributed as dist
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes():
            ranks = mesh.mesh.reshape(-1, r).tolist()
        groups[r] = dist.new_subgroups_by_enumeration(ranks)[0]
    return groups[r]


def _slots_on_data(cache, mesh) -> bool:
    """Whether a (B, Smax, Hkv*Dh) cache's slots are sharded over any of
    the data axes, evenly or not (:func:`_seq_sharded` asks for all of
    them, evenly)."""
    from torch.distributed.tensor import DTensor, Shard
    names = axis_names(mesh)
    return isinstance(cache, DTensor) and any(
        cache.placements[names.index(a)] == Shard(1)
        for a in batch_axes(mesh))


def _decode_on_split_heads(mesh, q, k, v, cache_k, cache_v, index: int,
                           scale: float):
    """The decode core on a cache whose kv heads are each split over r =
    tp / Hkv consecutive model ranks (:func:`_split_in_head`), on the
    cache's own shards: model rank m holds dims [(m % r) * Dh/r, +Dh/r) of
    kv head m // r, the new slot written (:func:`_write_slot`).  Each rank
    scores its dims of the q heads of its head's group against its cache
    dims, and an all-reduce over the r ranks of the head
    (:func:`_head_group`) completes the (B, G, Smax) f32 scores; then the
    scale, the mask and the softmax as :func:`_sdpa_chunk` runs them, and
    each rank's dims of the value product.  The (B, H, Dh) output is made whole from the parts; the
    cache is never gathered.  The scores are summed in another order than
    the one-device dot, so they match it within float tolerance.

    Where the cache's slots are sharded over the data axes too
    (:func:`_seq_sharded`: batch 1, long_500k; the batch replicated over
    them), data rank j holds slots [j * held, +held) of those dims: each
    rank scores its own (held, Dh/r) block, and the softmax and the value
    product are completed over the data axes as
    :func:`_decode_on_seq_shards` completes them (all-reduces of the max,
    the sum and the (B, G, Dh/r) partial output).  Raises where the slots
    do not split evenly over the data ranks or a head's dims over its r
    ranks."""
    from torch.distributed import _functional_collectives as funcol
    B, _, H, Dh = q.shape
    Hkv = k.shape[2]
    tp = tp_size(mesh)
    r, G = tp // Hkv, H // Hkv
    dl = Dh // r
    smax = cache_k.shape[1]
    seq = _slots_on_data(cache_k, mesh)
    if Dh % r or (seq and not _seq_sharded(cache_k, mesh)):
        raise ValueError(f"split-head decode: {Dh} head dims over {r} model "
                         f"ranks or {smax} slots over {dp_size(mesh)} data "
                         f"ranks do not split evenly")
    part = _head_group(mesh, r)
    sdt = torch.bfloat16 if (perf.FLAGS.attn_bf16_scores
                             and q.dtype == torch.bfloat16) else torch.float32
    softmax = _data_softmax(mesh) if seq else _softmax

    def body(q, k, v, cache_k, cache_v):
        m = mesh.get_local_rank("model")
        h, d0 = m // r, (m % r) * dl
        held = cache_k.shape[1]
        first = _data_rank(mesh) * held if seq else 0
        qh = q[:, 0, h * G:(h + 1) * G, d0:d0 + dl]          # (Bl, G, dl)
        s = torch.einsum("bgd,bkd->bgk", qh.float(),
                         cache_k.to(q.dtype).float())
        s = funcol.wait_tensor(funcol.all_reduce(s, "sum", part))
        s = s.to(sdt) * torch.tensor(scale, dtype=sdt, device=q.device)
        valid = torch.arange(first, first + held, device=q.device) <= min(
            index, smax - 1)
        s = s.masked_fill(~valid, torch.finfo(sdt).min)
        prob = softmax(s).to(v.dtype)
        o = torch.einsum("bgk,bkd->bgd", prob, cache_v.to(q.dtype))
        if seq:
            o = _data_all_reduce(mesh, o, "sum")
        return o[:, None]                                   # (Bl, 1, G, dl)

    bspec = batch_axes(mesh) if B % dp_size(mesh) == 0 and not seq else None
    whole = P(bspec, None, None, None)
    cspec = P(bspec, batch_axes(mesh) if seq else None, "model")
    o = shard_map(body, mesh, (whole, whole, whole, cspec, cspec),
                  P(bspec, "model", None, None))(q, k, v, cache_k, cache_v)
    # (B, tp, G, dl), model rank m = h * r + part -> (B, 1, H, Dh)
    o = constrain(o, mesh, whole).reshape(B, Hkv, r, G, dl)
    return o.transpose(2, 3).reshape(B, 1, H, Dh)
