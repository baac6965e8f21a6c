"""Attention's q, k and v exchanged only among the model ranks that hold a
head, against ``mesh=None`` and the reference.

Two routes of ``attention.attention`` on a mesh whose model axis splits a
head over r consecutive model ranks (``attention._head_group``):

* ``attention.row_exchange`` (whisper-base's 8 heads on model 16, r = 2):
  q, k and v stay on their own flat model shards, and an all-to-all over
  the head's r ranks trades batch rows for head dims, so each rank scores
  its head whole for 1/r of its rows (``attention._on_head_rows``); a
  second all-to-all returns the output to the rank's own dims, ``wo``'s
  row shard.  The cross-attention takes ``encdec._cross_kv``'s flat k
  and v the same way.
* ``attention._on_own_q_heads`` (mixtral's and h2o-danube-3's 8 kv heads
  on model 16, r = 2): k and v are gathered over the r ranks of the kv head
  that the rank's own q heads belong to, one kv head wide, k rotated
  there (``attention._on_kv_head_group``); k comes back on its own flat
  shards, after RoPE, the layout the decode cache splits inside its kv
  heads (``launch.specs.decode_state_sharding``).

On 2x4 gloo ranks (the helpers of ``test_torch_distributed.py``, r = 2):
whisper-base's smoke config cut to 2 heads (f32, B = 4, 2 rows a data
rank) runs its encoder, decoder self-attention and cross-attention in a
prefill and one train step, every core on one head of 1 row; the logits,
the four caches, the loss and every gradient within 1e-5 of
``mesh=None``'s max |value|, ``mesh=None``'s logits within 1e-5 of the
reference's max |logit| (weights by ``params_from_jax``), a one-rank mesh
bit for bit.  One attention layer of 8 q heads and 2 kv heads with RoPE
and q/k/v biases at B = 2, S = 32, with query chunks of 8 in both packages
(``LAYER_CHUNK``), on the chunked route and (window 16) the banded one:
the output, k, v and the gradients of x and every
weight, then six decode steps on a cache made from the prefill's own k/v
shards (no gather; a ring of the last 16 positions for the window), the
outputs and caches, within 1e-5 of ``mesh=None``'s, whose prefill and
decode outputs are within 1e-5 of the reference's.  Each gather is one
kv head over 2 ranks.  Which route each arch takes on model 16 is held
without ranks.
"""
import dataclasses
import functools
import inspect
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro.models.params import init_params as j_init
from repro.runtime import model_api as j_api

from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention
from repro_torch.models.params import params_from_jax

from test_torch_attn_head_padding import _close, _full
from test_torch_distributed import _run_ranks

ENC_B, ENC_S = 4, 16
LAYER_CASES = (("chunked", None), ("banded", 16))
# query chunks of 8, so S = 32 takes the chunked and banded routes
LAYER_B, LAYER_S, LAYER_CHUNK, STEPS = 2, 32, 8, 6


def _whisper_cfg(get):
    """whisper-base's f32 smoke config with 2 heads (2 model ranks a head
    on model 4)."""
    import dataclasses
    return dataclasses.replace(get("whisper-base").smoke(), dtype="float32",
                               n_heads=2, n_kv_heads=2)


@functools.lru_cache(maxsize=None)
def _whisper_inputs(seed: int = 0):
    """(port config, port params carried from the reference's, tokens,
    labels, frames, the reference's f32 logits)."""
    jc, tc = _whisper_cfg(j_get_config), _whisper_cfg(get_config)
    jp = j_init(jc, jax.random.PRNGKey(seed), max_seq=ENC_S)
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc,
                             "cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jc.vocab, (ENC_B, ENC_S)).astype(np.int32)
    frames = rng.standard_normal((ENC_B, jc.enc_seq, jc.d_model)).astype(
        np.float32)
    want, _ = j_api.forward_logits(jp, {"tokens": toks,
                                        "frames": jnp.asarray(frames)}, jc)
    return (tc, params, torch.from_numpy(toks).long(),
            torch.from_numpy(np.roll(toks, -1, 1)).long(),
            torch.from_numpy(frames), torch.from_numpy(np.array(want)))


def _run_encdec(params, toks, labels, frames, cfg, mesh=None):
    """-> (prefill logits, its caches k, v, cross k, cross v, the train
    step's loss, the gradients), the inputs placed on ``mesh`` if given.
    Self-contained: the rank processes run its source."""
    import torch
    from repro_torch.models import encdec
    from repro_torch.runtime.train import _grads_of
    from repro_torch.sharding import (batch_spec, mesh_scope, param_sharding,
                                      place, place_tree)
    batch = {"tokens": toks, "labels": labels, "frames": frames}
    if mesh is not None:
        params = place_tree(params, param_sharding(params, mesh))
        batch = {k: place(v, mesh,
                          batch_spec(mesh, *(None,) * (v.ndim - 1)))
                 for k, v in batch.items()}
    with torch.no_grad(), mesh_scope(mesh):
        logits, _, caches = encdec.forward(
            params, batch["tokens"], batch["frames"], cfg, mesh=mesh,
            collect_cache=True)
    with mesh_scope(mesh):
        metrics, grads = _grads_of(params, batch, cfg, remat=False,
                                   mesh=mesh)
    return (logits, *caches, metrics["loss"], grads)


def _layer_setup(window, seed: int = 0):
    """(cfg, weights (wq, wk, wv, wo, bq, bk, bv), x, the output's
    cotangent, the decode steps' inputs) of one f32 attention layer:
    qwen's smoke layer (RoPE, q/k/v biases) with 8 q heads and 2 kv
    heads."""
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                              dtype="float32", n_heads=8, n_kv_heads=2,
                              sliding_window=window)
    rng = np.random.default_rng(seed)
    d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    w = tuple(torch.from_numpy((0.2 * rng.standard_normal(s)).astype(
        np.float32)) for s in ((d, qd), (d, kd), (d, kd), (qd, d), (qd,),
                               (kd,), (kd,)))
    x, dout = (torch.from_numpy(rng.standard_normal(
        (LAYER_B, LAYER_S, d)).astype(np.float32)) for _ in range(2))
    xs = torch.from_numpy(rng.standard_normal(
        (STEPS, LAYER_B, 1, d)).astype(np.float32))
    return cfg, w, x, dout, xs


def _hand_off(t, window, steps: int):
    """A prefill's k or v, the port's flat (B, S, Hkv*Dh) (on a mesh on its
    own model shards) or the reference's (B, S, Hkv, Dh), as a decode
    cache (B, slots, Hkv*Dh): the last ``window`` positions where there is
    a window (the ring, S a multiple of it, so position p lies in slot p %
    window), else S + ``steps`` slots.  A DTensor is handed off on each rank's own
    shard: nothing is gathered."""
    import torch
    from torch.distributed.tensor import DTensor

    def cache(local):
        local = local.flatten(2)
        if window:
            return local[:, -window:].clone()
        return torch.nn.functional.pad(local, (0, 0, 0, steps))

    if isinstance(t, DTensor):
        return DTensor.from_local(cache(t.to_local()), t.device_mesh,
                                  t.placements, run_check=False)
    return cache(t)


def _layer(cfg, w, x, dout, xs, mesh=None):
    """One ``attention`` layer, then six ``decode_attention`` steps on the
    cache its k/v make (:func:`_hand_off`) -> (out, k, v, grads of x and
    the weights, the decode outputs, the last caches k and v); on a mesh x
    over the data axes and the weights by the sharding rules.
    Self-contained: the rank processes run its source."""
    import torch
    from repro_torch.models import attention
    from repro_torch.sharding import P, mesh_scope, param_spec, place
    names = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
    S = x.shape[1]
    args, steps = [x] + list(w), list(xs)
    if mesh is not None:
        args = [place(x, mesh, P("data", None, None))] + [
            place(t, mesh, param_spec("attn/" + n, t.shape, mesh,
                                      stacked=False))
            for n, t in zip(names, w)]
        steps = [place(t, mesh, P("data", None, None)) for t in steps]
    args = [t.detach().requires_grad_() for t in args]
    with mesh_scope(mesh):
        p = attention.LayerAttnParams(*args[1:])
        out, k, v = attention.attention(args[0], p, cfg, mesh=mesh)
        g = dout if mesh is None else place(dout, mesh,
                                            P("data", None, None))
        grads = torch.autograd.grad((out * g).sum(), args)
        k, v = k.detach(), v.detach()
        with torch.no_grad():
            p = attention.LayerAttnParams(*(a.detach() for a in args[1:]))
            ck, cv = (_hand_off(t, cfg.sliding_window, len(steps))
                      for t in (k, v))
            outs = []
            for t, xt in enumerate(steps):
                o, ck, cv = attention.decode_attention(xt, p, cfg, ck, cv,
                                                       S + t, mesh=mesh)
                outs.append(o)
    return out.detach(), k, v, grads, outs, ck, cv


def _reference_layer(cfg, w, x, xs):
    """The reference's prefill output and six decode outputs of
    :func:`_layer`'s layer, on the same hand-off."""
    jcfg = dataclasses.replace(j_get_config("qwen1.5-0.5b").smoke(),
                               dtype="float32", n_heads=8, n_kv_heads=2,
                               sliding_window=cfg.sliding_window)
    p = j_attention.LayerAttnParams(*(jnp.asarray(t.numpy()) for t in w))
    out, k, v = j_attention.attention(jnp.asarray(x.numpy()), p, jcfg)
    ck, cv = (jnp.asarray(_hand_off(torch.from_numpy(np.array(t)),
                                    cfg.sliding_window, STEPS).numpy())
              for t in (k, v))
    outs = []
    for t in range(STEPS):
        o, ck, cv = j_attention.decode_attention(
            jnp.asarray(xs[t].numpy()), p, jcfg, ck, cv,
            jnp.int32(x.shape[1] + t))
        outs.append(torch.from_numpy(np.array(o)))
    return torch.from_numpy(np.array(out)), outs


# -- 2x4 gloo ranks ---------------------------------------------------------------

RANK_BODY = """
from torch.distributed.tensor import Shard
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import attention
calls, heads, gathers = [], [], []
rows, attend, gather = attention._on_head_rows, attention.attend, \\
    attention.group_gather


def counted_rows(*a, **k):
    calls.append("rows")
    return rows(*a, **k)


def counted_attend(q, *a, **k):
    heads.append((q.shape[0], q.shape[2]))
    return attend(q, *a, **k)


def counted_gather(t, group, dim):
    out = gather(t, group, dim)
    gathers.append((dist.get_world_size(group), out.shape[-1]))
    return out


attention._on_head_rows = counted_rows
attention.attend, attention.group_gather = counted_attend, counted_gather
mesh = compat_make_mesh((2, 4), ("data", "model"))
d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
c = d["whisper"]
cfg = _whisper_cfg(get_config)
got = _run_encdec(*c["args"], cfg, mesh)
# the encoder's layers and the decoder's self- and cross-attention, in the
# prefill and the train step; each core one head of 1 row (2 a data rank)
assert calls == ["rows"] * 2 * (cfg.enc_layers + 2 * cfg.n_layers), calls
assert set(heads) == {(1, 1)}, heads
assert not gathers, gathers
for i, what in enumerate(("prefill", "k", "v", "cross k", "cross v",
                          "loss")):
    _close(got[i], c["want"][i], ("whisper", what))
for k, w in c["want"][6].items():
    _close(got[6][k], w, ("whisper", k))
if RANK == 0:
    print("OK whisper")
attention.Q_CHUNK = LAYER_CHUNK
for c in d["layers"]:
    cfg = _layer_cfg(c["window"])
    n = len(gathers)
    got = _layer(cfg, *c["args"], mesh)
    # k and v, each gathered one kv head wide over its 2 ranks, in the
    # forward; the prefill's k/v on their own flat shards
    assert gathers[n:] == [(2, cfg.head_dim)] * 2, gathers[n:]
    for t in got[1:3]:
        assert tuple(t.placements) == (Shard(0), Shard(2)), t.placements
    for i, what in enumerate(("out", "k", "v")):
        _close(got[i], c["want"][i], (c["window"], what))
    for i, (g, w) in enumerate(zip(got[3], c["want"][3])):
        _close(g, w, (c["window"], "grad", i))
    for t, (g, w) in enumerate(zip(got[4], c["want"][4])):
        _close(g, w, (c["window"], "decode", t))
    for i, what in ((5, "cache k"), (6, "cache v")):
        _close(got[i], c["want"][i], (c["window"], what))
    if RANK == 0:
        print("OK layer", c["window"])
"""


def _layer_cfg(window):
    """:func:`_layer_setup`'s config, without its draws."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                               dtype="float32", n_heads=8, n_kv_heads=2,
                               sliding_window=window)


@pytest.fixture(scope="module")
def ranks_2x4(tmp_path_factory):
    """Rank 0's log of one run on 2x4 gloo ranks of the whisper smoke
    config and the layer on both routes, against ``mesh=None``'s results
    made here."""
    cfg, params, toks, labels, frames, _ = _whisper_inputs()
    args = (params, toks, labels, frames)
    whisper = {"args": args, "want": _run_encdec(*args, cfg)}
    layers = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "Q_CHUNK", LAYER_CHUNK)
        for _, window in LAYER_CASES:
            cfg, *args = _layer_setup(window)
            layers.append({"window": window, "args": args,
                           "want": _layer(cfg, *args)})
    tmp = tmp_path_factory.mktemp("head_groups_2x4")
    torch.save({"whisper": whisper, "layers": layers}, tmp / "in.pt")
    helpers = ("from repro_torch.configs import get_config\n"
               f"LAYER_CHUNK = {LAYER_CHUNK}\n") + "".join(
        textwrap.dedent(inspect.getsource(f)) + "\n"
        for f in (_whisper_cfg, _run_encdec, _layer_cfg, _hand_off, _layer,
                  _full, _close))
    return _run_ranks(tmp, 8, helpers + RANK_BODY)


MESH_2X4 = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))


def test_whisper_heads_on_rows_match_one_device(ranks_2x4):
    """whisper-base's smoke config with 2 heads on 2x4 ranks (2 model ranks
    a head, 2 rows a data rank): every attention core of the encoder and
    the decoder's self- and cross-attention, in the prefill and the train
    step, scores one head of one row; nothing is gathered in a head group;
    the prefill's logits and caches, the loss and every gradient within
    1e-5 of ``mesh=None``'s max |value|; ``mesh=None``'s logits within
    1e-5 of the reference's max |logit|."""
    cfg, params, toks, labels, frames, ref = _whisper_inputs()
    assert attention.row_exchange(cfg, MESH_2X4, ENC_B) == 2
    assert not attention._on_own_q_heads(cfg, MESH_2X4)
    _close(_run_encdec(params, toks, labels, frames, cfg)[0], ref,
           "reference")
    assert "OK whisper\n" in ranks_2x4


@pytest.fixture
def small_chunks(monkeypatch):
    """Query chunks of ``LAYER_CHUNK`` in both packages."""
    monkeypatch.setattr(j_attention, "Q_CHUNK", LAYER_CHUNK)
    monkeypatch.setattr(attention, "Q_CHUNK", LAYER_CHUNK)


@pytest.mark.parametrize("route,window", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_kv_head_group_layer_and_decode_on_2x4_ranks(ranks_2x4, small_chunks,
                                                     route, window):
    """One layer of 8 q heads and 2 kv heads (RoPE, biases) at (2, 32) in
    query chunks of 8, on the chunked route and (window 16) the banded
    one: k and v each gathered one kv head wide over its 2 model ranks;
    the output, k, v
    (on their own flat shards) and every gradient, and six decode steps on
    the cache the prefill's shards make, outputs and caches, within 1e-5
    of ``mesh=None``'s max |value|; ``mesh=None``'s prefill and decode
    outputs within 1e-5 of the reference's."""
    cfg, w, x, dout, xs = _layer_setup(window)
    assert attention.prefill_route(cfg, LAYER_S) == route
    assert attention._on_own_q_heads(cfg, MESH_2X4)
    assert not attention.row_exchange(cfg, MESH_2X4, LAYER_B)
    got = _layer(cfg, w, x, dout, xs)
    out, outs = _reference_layer(cfg, w, x, xs)
    _close(got[0], out, "reference prefill")
    for t, (g, want) in enumerate(zip(got[4], outs)):
        _close(g, want, ("reference decode", t))
    assert f"OK layer {window}\n" in ranks_2x4


# -- one rank: bit for bit ---------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_whisper_one_rank_is_bit_for_bit(one_rank_mesh):
    """At (1, 1) no head is split: whisper's prefill, its four caches, the
    loss and every gradient equal ``mesh=None``'s bit for bit."""
    cfg, params, toks, labels, frames, _ = _whisper_inputs()
    assert not attention.row_exchange(cfg, one_rank_mesh, ENC_B)
    want = _run_encdec(params, toks, labels, frames, cfg)
    got = _run_encdec(params, toks, labels, frames, cfg, one_rank_mesh)
    for i in range(6):
        assert torch.equal(_full(got[i]), want[i]), i
    for k, w in want[6].items():
        assert torch.equal(_full(got[6][k]), w), k


# -- the route each arch takes -----------------------------------------------------

# on model 16: each head scored on rows (whisper-base's 8 heads), k/v
# gathered over a kv head's group (32 q and 8 kv heads), q heads padded
ROW_ARCHS = ("whisper-base",)
KV_GROUP_ARCHS = ("mixtral-8x7b", "h2o-danube-3-4b")
PADDED_ARCHS = ("hymba-1.5b", "granite-moe-3b-a800m")
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_head_group_route_on_model_16(arch, mesh_name):
    """At train_4k's batch on each production mesh, whisper-base trades
    rows over the 2 model ranks of each head, mixtral-8x7b and
    h2o-danube-3-4b gather k/v over the 2 ranks of each kv head, hymba's
    and granite's q heads pad, and no other arch takes any of these;
    without a mesh and on one rank none does."""
    cfg = get_config(arch)
    shape = MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape=shape, axis_names=tuple(shape))
    one = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                axis_names=("data", "model"))
    B = get_shape("train_4k").global_batch
    assert attention.row_exchange(cfg, mesh, B) == (
        2 if arch in ROW_ARCHS else 0)
    assert attention._on_own_q_heads(cfg, mesh) == (arch in KV_GROUP_ARCHS)
    assert (attention.q_heads(cfg, mesh) != cfg.n_heads) == (
        arch in PADDED_ARCHS)
    for m in (one, None):
        assert not attention.row_exchange(cfg, m, B)
        assert not attention._on_own_q_heads(cfg, m)


@pytest.mark.parametrize("mesh_name,route", [("16x16", 2), ("2x16x16", 0)])
def test_whisper_prefill_rows_on_each_mesh(mesh_name, route):
    """whisper-base's prefill_32k: 2 rows a data rank on 16x16, which the
    2 ranks of a head split; 1 on 2x16x16, which they cannot, so they
    split its query positions instead (``attention.query_exchange``)."""
    shape = MESHES[mesh_name]
    mesh = types.SimpleNamespace(shape=shape, axis_names=tuple(shape))
    prefill = get_shape("prefill_32k")
    cfg, B = get_config("whisper-base"), prefill.global_batch
    assert attention.row_exchange(cfg, mesh, B) == route
    assert attention.query_exchange(cfg, mesh, B, prefill.seq_len) == (
        0 if route else 2)
