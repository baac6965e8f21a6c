"""Attention's core on each rank's own q heads: q heads padded over 'model'
where the reference pins them, and unpadded where the model axis divides
the q heads but not the kv heads; against ``mesh=None``, the reference and
the reference's dry-run.

Where the q heads neither divide nor fit under the model axis (hymba's 25
and granite's 24 on model 16), the reference pins q, k and v head-sharded
and GSPMD pads the uneven heads.  ``attention.attention`` pads the q heads
alone with zero heads to a multiple of the model axis
(``attention.q_heads``, ``attention._pad_q_heads``: zero columns of
``wq`` and ``bq``, zero rows of ``wo``, inside the forward), keeps k and v
whole over 'model', and runs the core on each rank's own q heads, each
with its kv head (``attention._on_q_shards``).  Where the model axis
divides the q heads but not the kv heads (mixtral's and h2o-danube-3's 32
q and 8 kv heads on model 16, ``attention._on_own_q_heads``), nothing
pads and the core runs on the same route: rank m scores q heads 2m and
2m + 1, both against kv head m // 2.

On 2x4 gloo ranks (the helpers of ``test_torch_distributed.py``) three
small f32 configs take that route: hymba's smoke config with 10 q heads
and 2 kv heads (groups of 5, padded to 12, so rank 1 holds heads of both
groups) 80 wide (its 10 SSD heads pad too), qwen's with 6 q heads and 2
kv heads (groups of 3, padded to 8) and its q/k/v biases, and qwen's with
8 q heads and 2 kv heads (2 a rank, unpadded).  The last gathers k and v
only over the 2 model ranks that hold its kv head
(``attention._on_kv_head_group``), each gather one kv head wide, and
returns its prefill caches on their own flat shards.  qwen's with 2 q and
2 kv heads takes whisper-base's route on model 16 (r = 2 model ranks a
head): at B = 4 (2 rows a data rank, which r divides) each head is scored
whole by one rank for half of the rank's rows
(``attention._on_head_rows``, one q head in every core), and at B = 2 (1
row a data rank) the heads stay whole on every model rank, the core on
the kv-head groups, with ``wo`` taken whole over 'model' in the train
step, where the held residual cotangent would otherwise come back cut
inside a head.  The prefill logits and
caches, six decode steps, the loss and every gradient are within 1e-5 of
``mesh=None``'s max |value|, the prefill within 1e-5 of the reference's
max |logit| (the LM tests' f32 tolerance), the weights carried over by
``params_from_jax``.  The smoke sequences take the unchunked route; one
attention layer of 10 q heads and 2 kv heads at B = 2, S = 2048 takes the
chunked route and, with a window of 1024, the banded one, its output and
gradients within 1e-5 of ``mesh=None``'s.  On a one-rank mesh nothing
pads nor leaves the kv-head groups, and the configs' results are
``mesh=None``'s bit for bit.

The dry-run: hymba-1.5b train_4k cut to 2 layers on a fake (16, 16) mesh
scores 2 q heads in every attention core on the traced rank, gathers no
q activation in ``models/attention.py``, peaks under 30 GB a rank and
all-gathers at most the reference's bytes a rank.
"""
import dataclasses
import functools
import inspect
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.models.params import init_params as j_init
from repro.runtime import model_api as j_api

from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention
from repro_torch.models.params import params_from_jax
from repro_torch.sharding import padded_heads

from test_torch_distributed import REPO, _run_ranks

# (case, arch, q heads, kv heads, d_model or None for the smoke config's,
# batch): q heads padded over model 4, and q heads model 4 divides but kv
# heads not
CASES = (("hymba-10-2", "hymba-1.5b", 10, 2, 80, 2),
         ("qwen-6-2", "qwen1.5-0.5b", 6, 2, None, 2))
OWN_CASES = (("qwen-8-2", "qwen1.5-0.5b", 8, 2, None, 2),)
# 2 q heads on model 4 (whisper-base's 8 on model 16), 2 model ranks a
# head: each head scored whole on one rank for half of its rows where they
# divide the rows (B = 4, without RoPE and q/k/v biases, as
# whisper-base), else whole on
# every model rank, the core on the kv-head groups, ``wo`` taken whole in
# the train step (B = 2, with qwen's RoPE)
WHOLE_CASES = (("qwen-2-2", "qwen1.5-0.5b", 2, 2, None, 4),
               ("qwen-2-2-b2", "qwen1.5-0.5b", 2, 2, None, 2))
# the attention route each case of the 2x4 run takes
ROUTES = {"hymba-10-2": "_on_q_shards", "qwen-6-2": "_on_q_shards",
          "qwen-8-2": "_on_kv_head_group", "qwen-2-2": "_on_head_rows",
          "qwen-2-2-b2": "_on_kv_groups"}
# the cases run as whisper-base's attention: without RoPE (rope_theta 0)
# and q/k/v biases
NO_ROPE = ("qwen-2-2",)
LAYER_CASES = (("chunked", None), ("banded", 1024))
S = 64
LAYER_B, LAYER_S = 2, 2048
DRY_LAYERS = 2


def _cfg(get, arch: str, n_heads: int, n_kv: int, d_model,
         rope: bool = True):
    """The f32 smoke config with ``n_heads`` q heads and ``n_kv`` kv heads
    (head dim 16), ``d_model`` wide if given, without RoPE and q/k/v biases
    unless ``rope`` (whisper-base's attention: without RoPE, k's bias
    would only shift each row's scores, and its gradient is zero)."""
    import dataclasses
    c = dataclasses.replace(get(arch).smoke(), dtype="float32",
                            n_heads=n_heads, n_kv_heads=n_kv)
    if d_model is not None:
        c = dataclasses.replace(c, d_model=d_model)
    if not rope:
        c = dataclasses.replace(c, rope_theta=0.0, qkv_bias=False)
    return c


@functools.lru_cache(maxsize=None)
def _inputs(arch, n_heads, n_kv, d_model, B, rope: bool = True,
            seed: int = 0):
    """(port config, port params carried from the reference's, tokens,
    labels, the reference's f32 logits), made once a case."""
    jc = _cfg(j_get_config, arch, n_heads, n_kv, d_model, rope)
    tc = _cfg(get_config, arch, n_heads, n_kv, d_model, rope)
    jp = j_init(jc, jax.random.PRNGKey(seed), max_seq=S)
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc,
                             "cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    want, _ = j_api.forward_logits(jp, {"tokens": toks}, jc)
    return (tc, params, torch.from_numpy(toks).long(),
            torch.from_numpy(np.roll(toks, -1, 1)).long(),
            torch.from_numpy(np.array(want)))


def _run(params, toks, labels, cfg, mesh=None):
    """-> (prefill logits, prefill caches k and v, the decode steps'
    logits, the last decode state, the loss, the gradients), the inputs
    placed on ``mesh`` if given.  Self-contained: the rank processes run
    its source."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.runtime import model_api, serve
    from repro_torch.runtime.train import _grads_of
    from repro_torch.sharding import (batch_spec, mesh_scope, param_sharding,
                                      place, place_tree)
    B, SMAX, STEPS = toks.shape[0], 16, 6
    batch = {"tokens": toks, "labels": labels}
    if mesh is not None:
        params = place_tree(params, param_sharding(params, mesh))
        batch = {k: place(v, mesh, batch_spec(mesh, None))
                 for k, v in batch.items()}
    with torch.no_grad(), mesh_scope(mesh):
        logits, _, (ck, cv, _) = transformer.forward(
            params, batch["tokens"], cfg, mesh=mesh, collect_cache=True)
        state = model_api.init_decode_state(params, {}, cfg, B, SMAX,
                                            torch.float32)
        if mesh is not None:
            state = place_tree(state, serve.decode_state_shardings(
                cfg, state, mesh))
        steps = []
        for t in range(STEPS):
            out, state = model_api.decode_step(
                params, batch["tokens"][:, t:t + 1], state, cfg, mesh=mesh)
            steps.append(out)
    with mesh_scope(mesh):
        metrics, grads = _grads_of(params, batch, cfg, remat=False,
                                   mesh=mesh)
    return logits, ck, cv, steps, state, metrics["loss"], grads


def _layer_setup(window, seed: int = 0):
    """(cfg, weights (wq, wk, wv, wo, bq, bk, bv), x, the output's
    cotangent) of one f32 attention layer: qwen's smoke layer with 10 q
    heads, 2 kv heads and its biases."""
    cfg = dataclasses.replace(_cfg(get_config, "qwen1.5-0.5b", 10, 2, None),
                              sliding_window=window)
    rng = np.random.default_rng(seed)
    d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    w = tuple(torch.from_numpy((0.2 * rng.standard_normal(s)).astype(
        np.float32)) for s in ((d, qd), (d, kd), (d, kd), (qd, d), (qd,),
                               (kd,), (kd,)))
    x, dout = (torch.from_numpy(rng.standard_normal(
        (LAYER_B, LAYER_S, d)).astype(np.float32)) for _ in range(2))
    return cfg, w, x, dout


def _layer(cfg, w, x, dout, mesh=None):
    """One ``attention`` layer -> (out, k, v, grads of x and the weights);
    on a mesh x over the data axes and the weights by the sharding rules.
    Self-contained: the rank processes run its source."""
    import torch
    from repro_torch.models import attention
    from repro_torch.sharding import P, mesh_scope, param_spec, place
    names = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
    args = [x] + list(w)
    if mesh is not None:
        args = [place(x, mesh, P("data", None, None))] + [
            place(t, mesh, param_spec("attn/" + n, t.shape, mesh,
                                      stacked=False))
            for n, t in zip(names, w)]
    args = [t.detach().requires_grad_() for t in args]
    with mesh_scope(mesh):
        p = attention.LayerAttnParams(*args[1:])
        out, k, v = attention.attention(args[0], p, cfg, mesh=mesh)
        g = dout if mesh is None else place(dout, mesh,
                                            P("data", None, None))
        grads = torch.autograd.grad((out * g).sum(), args)
    return out.detach(), k.detach(), v.detach(), grads


def _full(t):
    """A DTensor's global value; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _close(got, want, what):
    """|got - want| within 1e-5 of max |want|."""
    got = _full(got)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()) + 1e-12, (what, err)


# -- 2x4 gloo ranks ---------------------------------------------------------------

RANK_BODY = """
import dataclasses
from repro_torch.configs import get_config
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import attention
calls, heads, gathers = [], [], []


def counting(name):
    route = getattr(attention, name)

    def counted(*a, **k):
        calls.append(name)
        return route(*a, **k)
    return counted


for name in ("_on_q_shards", "_on_kv_head_group", "_on_head_rows",
             "_on_kv_groups"):
    setattr(attention, name, counting(name))
attend, gather = attention.attend, attention.group_gather


def counted_attend(q, *a, **k):
    heads.append(q.shape[2])
    return attend(q, *a, **k)


def counted_gather(t, group, dim):
    out = gather(t, group, dim)
    gathers.append((dist.get_world_size(group), out.shape[-1]))
    return out


attention.attend, attention.group_gather = counted_attend, counted_gather
mesh = compat_make_mesh((2, 4), ("data", "model"))
d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
for case, c in d["models"].items():
    cfg = _cfg(get_config, *c["cfg"])
    n, nh, ng = len(calls), len(heads), len(gathers)
    got = _run(c["params"], c["toks"], c["labels"], cfg, mesh)
    # each layer's prefill and its train step's forward on the case's
    # route (the decode steps' cores on split heads)
    assert calls[n:] == [c["route"]] * (2 * cfg.n_layers), calls[n:]
    if c["route"] == "_on_head_rows":      # one whole head a core
        assert set(heads[nh:]) == {1}, heads[nh:]
    if c["route"] == "_on_kv_head_group":  # one kv head, over its 2 ranks
        assert gathers[ng:] and set(gathers[ng:]) == {(2, cfg.head_dim)}, \
            gathers[ng:]
    else:
        assert len(gathers) == ng, gathers[ng:]
    want = c["want"]
    for i, what in enumerate(("prefill", "cache k", "cache v")):
        _close(got[i], want[i], (case, what))
    for t, (g, w) in enumerate(zip(got[3], want[3])):
        _close(g, w, (case, "decode", t))
    for f in ("cache_k", "cache_v", "ssm_ssd", "ssm_conv"):
        if getattr(want[4], f) is not None:
            _close(getattr(got[4], f), getattr(want[4], f), (case, f))
    _close(got[5], want[5], (case, "loss"))
    for k, w in want[6].items():
        _close(got[6][k], w, (case, k))
    if RANK == 0:
        print("OK", case)
for c in d["layers"]:
    cfg = dataclasses.replace(_cfg(get_config, "qwen1.5-0.5b", 10, 2, None),
                              sliding_window=c["window"])
    n = len(calls)
    got = _layer(cfg, c["w"], c["x"], c["dout"], mesh)
    assert calls[n:] == ["_on_q_shards"], calls[n:]
    for i, what in enumerate(("out", "k", "v")):
        _close(got[i], c["want"][i], (c["window"], what))
    for i, (g, w) in enumerate(zip(got[3], c["want"][3])):
        _close(g, w, (c["window"], "grad", i))
if RANK == 0:
    print("OK layers")
"""


@pytest.fixture(scope="module")
def ranks_2x4(tmp_path_factory):
    """Rank 0's log of one run on 2x4 gloo ranks of every 2x4 check below:
    each of :data:`CASES`, :data:`OWN_CASES` and :data:`WHOLE_CASES`
    (prefill, caches, decode,
    loss and gradients) and the layer on both routes, against
    ``mesh=None``'s results made here.  One run, so the ranks start
    once."""
    models = {}
    for case, arch, n_heads, n_kv, d_model, batch in (CASES + OWN_CASES
                                                      + WHOLE_CASES):
        rope = case not in NO_ROPE
        cfg, params, toks, labels, _ = _inputs(arch, n_heads, n_kv, d_model,
                                               batch, rope)
        models[case] = {"cfg": (arch, n_heads, n_kv, d_model, rope),
                        "route": ROUTES[case],
                        "params": params, "toks": toks, "labels": labels,
                        "want": _run(params, toks, labels, cfg)}
    layers = []
    for _, window in LAYER_CASES:
        cfg, w, x, dout = _layer_setup(window)
        layers.append({"window": window, "w": w, "x": x, "dout": dout,
                       "want": _layer(cfg, w, x, dout)})
    tmp = tmp_path_factory.mktemp("ranks_2x4")
    torch.save({"models": models, "layers": layers}, tmp / "in.pt")
    helpers = "".join(textwrap.dedent(inspect.getsource(f)) + "\n"
                      for f in (_cfg, _run, _layer, _full, _close))
    return _run_ranks(tmp, 8, helpers + RANK_BODY)


@pytest.mark.parametrize("case,arch,n_heads,n_kv,d_model,batch", CASES,
                         ids=[c[0] for c in CASES])
def test_padded_q_heads_on_2x4_ranks_match_one_device(ranks_2x4, case, arch,
                                                      n_heads, n_kv, d_model,
                                                      batch):
    """The mesh prefill's logits and caches, six decode steps, the train
    step's loss and every gradient within 1e-5 of ``mesh=None``'s max
    |value|, every attention core of the prefill and the train step on
    the rank's own q heads (q padded over model 4); ``mesh=None``'s
    prefill within 1e-5 of the reference's max |logit|."""
    cfg, params, toks, labels, ref = _inputs(arch, n_heads, n_kv, d_model,
                                             batch)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))
    assert attention.q_heads(cfg, mesh) == padded_heads(n_heads, 4) > n_heads
    _close(_run(params, toks, labels, cfg)[0], ref, "reference")
    assert f"OK {case}\n" in ranks_2x4


@pytest.mark.parametrize("case,arch,n_heads,n_kv,d_model,batch", OWN_CASES,
                         ids=[c[0] for c in OWN_CASES])
def test_own_q_heads_on_2x4_ranks_match_one_device(ranks_2x4, case, arch,
                                                   n_heads, n_kv, d_model,
                                                   batch):
    """8 q heads and 2 kv heads on model 4: nothing pads, and every
    attention core of the prefill and the train step runs on the rank's
    own 2 q heads, against the one kv head gathered over the 2 model ranks
    that hold it; the mesh prefill's logits and caches, six decode steps,
    the train step's loss and every gradient within 1e-5 of
    ``mesh=None``'s max |value|; ``mesh=None``'s prefill within 1e-5 of
    the reference's max |logit|."""
    cfg, params, toks, labels, ref = _inputs(arch, n_heads, n_kv, d_model,
                                             batch)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))
    assert attention.q_heads(cfg, mesh) == n_heads
    assert attention._on_own_q_heads(cfg, mesh)
    _close(_run(params, toks, labels, cfg)[0], ref, "reference")
    assert f"OK {case}\n" in ranks_2x4


@pytest.mark.parametrize("case,arch,n_heads,n_kv,d_model,batch", WHOLE_CASES,
                         ids=[c[0] for c in WHOLE_CASES])
def test_whole_q_heads_on_2x4_ranks_match_one_device(ranks_2x4, case, arch,
                                                     n_heads, n_kv, d_model,
                                                     batch):
    """2 q heads and 2 kv heads on model 4, 2 model ranks a head (the
    route of whisper-base's 8 heads on model 16): nothing pads.  At B = 4
    each core scores one head whole for half of the rank's rows, q, k and
    v traded over the head's 2 ranks; at B = 2 the heads stay whole on
    every model rank, the core runs on the kv-head groups, and the train
    step takes ``wo`` whole over 'model' under the held residual
    cotangent.  The mesh prefill's logits and caches, six decode steps,
    the train step's loss and every gradient within 1e-5 of
    ``mesh=None``'s max |value|; ``mesh=None``'s prefill within 1e-5 of
    the reference's max |logit|."""
    cfg, params, toks, labels, ref = _inputs(arch, n_heads, n_kv, d_model,
                                             batch, case not in NO_ROPE)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))
    assert attention.q_heads(cfg, mesh) == n_heads
    assert not attention._on_own_q_heads(cfg, mesh)
    assert attention.row_exchange(cfg, mesh, batch) == (2 if batch == 4
                                                        else 0)
    _close(_run(params, toks, labels, cfg)[0], ref, "reference")
    assert f"OK {case}\n" in ranks_2x4


@pytest.mark.parametrize("route,window", LAYER_CASES,
                         ids=[c[0] for c in LAYER_CASES])
def test_padded_q_heads_layer_on_2x4_ranks(ranks_2x4, route, window):
    """One attention layer of 10 q heads and 2 kv heads at (2, 2048), on
    the chunked route and (window 1024) the banded one: the output, k, v
    and the gradients of x and every weight within 1e-5 of ``mesh=None``'s
    max |value|, the core on the rank's own q heads."""
    cfg = _layer_setup(window)[0]
    assert attention.prefill_route(cfg, LAYER_S) == route
    assert "OK layers" in ranks_2x4


# -- one rank: bit for bit ---------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("case,arch,n_heads,n_kv,d_model,batch",
                         CASES + OWN_CASES + WHOLE_CASES,
                         ids=[c[0] for c in CASES + OWN_CASES + WHOLE_CASES])
def test_one_rank_is_bit_for_bit(one_rank_mesh, case, arch, n_heads, n_kv,
                                 d_model, batch):
    """At (1, 1) no q head pads nor leaves its kv-head group: the prefill,
    its caches, the decode steps and state, the loss and every gradient
    equal ``mesh=None``'s bit for bit."""
    cfg, params, toks, labels, _ = _inputs(arch, n_heads, n_kv, d_model,
                                           batch, case not in NO_ROPE)
    assert attention.q_heads(cfg, one_rank_mesh) == n_heads
    assert not attention._on_own_q_heads(cfg, one_rank_mesh)
    assert not attention.row_exchange(cfg, one_rank_mesh, batch)
    want = _run(params, toks, labels, cfg)
    got = _run(params, toks, labels, cfg, one_rank_mesh)
    for i in range(3):
        assert torch.equal(_full(got[i]), want[i]), i
    for g, w in zip(got[3], want[3]):
        assert torch.equal(_full(g), w)
    for g, w in zip(got[4][:-1], want[4][:-1]):
        if w is not None:
            assert torch.equal(_full(g), w)
    assert torch.equal(_full(got[5]), want[5])
    for k, w in want[6].items():
        assert torch.equal(_full(got[6][k]), w), k


# -- the padding alone -------------------------------------------------------------

# (q heads, kv heads, model ranks) where the reference's gate applies
PAD_CASES = [(h, kv, tp) for h, kv in ((6, 2), (10, 2), (24, 8), (25, 5))
             for tp in (4, 16) if h % tp and h > tp]


@pytest.mark.parametrize("n_heads,n_kv,tp", PAD_CASES)
def test_padded_heads_meet_their_kv_heads(n_heads, n_kv, tp):
    """Every model rank holds Hp / tp whole q heads; on each rank's heads,
    with the kv heads ``_on_q_shards`` gives them, the real heads' outputs
    are those of the one-device core within 1e-6 of their max; a padded
    head's q, ``wq``/``bq`` columns and ``wo`` rows are zero, so its share
    of the out-projection is exactly zero and the out-projection is the
    unpadded one's within 1e-6."""
    Hp = padded_heads(n_heads, tp)
    mesh = types.SimpleNamespace(shape={"data": 1, "model": tp},
                                 axis_names=("data", "model"))
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").smoke(),
                              dtype="float32", n_heads=n_heads,
                              n_kv_heads=n_kv, d_head=8)
    assert attention.q_heads(cfg, mesh) == Hp
    local = Hp // tp
    assert Hp % tp == 0 and local >= 1 and 0 < Hp - n_heads < tp
    g = torch.Generator().manual_seed(n_heads * tp)
    Dh, d, Sq = cfg.head_dim, cfg.d_model, 12
    p = attention.LayerAttnParams(*(0.3 * torch.randn(*s, generator=g)
                                    for s in ((d, cfg.q_dim), (d, cfg.kv_dim),
                                              (d, cfg.kv_dim), (cfg.q_dim, d),
                                              (cfg.q_dim,), (cfg.kv_dim,),
                                              (cfg.kv_dim,))))
    pp = attention._pad_q_heads(p, cfg, Hp, None)
    n = (Hp - n_heads) * Dh
    assert torch.equal(pp.wq[:, :cfg.q_dim], p.wq) and not pp.wq[:, -n:].any()
    assert torch.equal(pp.bq[:cfg.q_dim], p.bq) and not pp.bq[-n:].any()
    assert torch.equal(pp.wo[:cfg.q_dim], p.wo) and not pp.wo[-n:].any()
    x = torch.randn(2, Sq, d, generator=g)
    q, k, v = attention._proj_qkv(x, pp, cfg)
    assert q.shape[2] == Hp and not q[:, :, n_heads:].any()
    pos = torch.arange(Sq)
    want = attention.attend(q[:, :, :n_heads], k, v, pos, pos, cfg)
    outs = []
    for rank in range(tp):
        kv = attention._kv_heads_of(rank, local, n_heads, n_kv)
        heads = range(rank * local, (rank + 1) * local)
        for j, h in zip(heads, kv):
            assert h == (j * n_kv // n_heads if j < n_heads else n_kv - 1)
        outs.append(attention.attend(q[:, :, heads.start:heads.stop],
                                     k[:, :, kv], v[:, :, kv], pos, pos,
                                     cfg))
    got = torch.cat(outs, dim=2)
    tol = 1e-6 * float(want.abs().max())
    assert float((got[:, :, :n_heads] - want).abs().max()) <= tol
    flat = got.reshape(2, Sq, Hp * Dh)
    assert not (flat[..., -n:] @ pp.wo[-n:]).any()
    base = want.reshape(2, Sq, cfg.q_dim) @ p.wo
    assert float((flat @ pp.wo - base).abs().max()) <= \
        1e-6 * float(base.abs().max())


# -- the unpadded route's heads ----------------------------------------------------

def test_kv_heads_of_eight_kv_heads_on_model_16():
    """32 q heads and 8 kv heads on model 16 (mixtral, h2o-danube-3): rank
    m holds q heads 2m and 2m + 1, both of kv head m // 2."""
    for m in range(16):
        assert attention._kv_heads_of(m, 2, 32, 8) == [m // 2] * 2, m


# the archs whose attention runs unpadded on each rank's own q heads on
# model 16
OWN_Q_ARCHS = ("mixtral-8x7b", "h2o-danube-3-4b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_own_q_heads_route_on_model_16(arch):
    """On model 16 the unpadded own-q-heads route takes mixtral-8x7b and
    h2o-danube-3-4b (32 q heads, 8 kv heads) and no other arch: heads the
    axis divides, whisper's 8 q heads and the padded 25 and 24 stay off
    it; on one rank and without a mesh no arch takes it."""
    cfg = get_config(arch)
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16},
                                 axis_names=("data", "model"))
    one = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                axis_names=("data", "model"))
    assert attention._on_own_q_heads(cfg, mesh) == (arch in OWN_Q_ARCHS)
    assert not attention._on_own_q_heads(cfg, one)
    assert not attention._on_own_q_heads(cfg, None)
    if arch in OWN_Q_ARCHS:
        assert attention.q_heads(cfg, mesh) == cfg.n_heads == 32


# -- the dry-run against the reference's -----------------------------------------

@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's hymba-1.5b train_4k cut to 2 layers, compiled in a
    subprocess started when the module's first test asks for it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "dryrun_parity.py"),
         "--reference-only", "--layers", str(DRY_LAYERS),
         "--cell=hymba-1.5b:train_4k"],
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    result = {}

    def get():
        if not result:
            out, err = proc.communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.startswith("REF ")]
            assert proc.returncode == 0 and lines, err[-4000:]
            result.update(json.loads(lines[-1][4:])["hymba-1.5b"])
        return result

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_hymba_train_scores_two_q_heads_a_rank(reference_dryrun,
                                               monkeypatch):
    """hymba-1.5b train_4k at 2 layers on a fake (16, 16) mesh: its 25 q
    heads padded to 32, every attention core on the traced rank scores 2
    q heads; no all-gather site in ``models/attention.py`` moves (per
    call) as much as a rank's (B_l, S, H * Dh) bf16 q activation; the
    peak a rank is under 30 GB; the all-gather wire bytes a rank are at
    most the reference's."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=DRY_LAYERS)
    shape = get_shape("train_4k")
    assert padded_heads(cfg.n_heads, 16) == 32
    heads = []
    attend = attention.attend

    def counted(q, *args, **kwargs):
        heads.append(q.shape[2])
        return attend(q, *args, **kwargs)

    monkeypatch.setattr(attention, "attend", counted)
    traced = D.trace_cell(cfg, shape, (16, 16), n_sites=None)
    # each layer's forward, and again in its backward (remat)
    assert heads == [2] * (2 * DRY_LAYERS), heads
    q_shard = (shape.global_batch // 16 * shape.seq_len * cfg.q_dim * 2)
    sites = [s for s in traced["sites"] if s["op"] == "all-gather"
             and "models/attention.py" in s["site"]]
    for s in sites:
        assert s["wire_bytes"] / s["count"] < q_shard, s
    peak = traced["memory"]["peak_bytes"]
    assert peak < 30e9, peak
    got = traced["collective"].bytes_by_op.get("all-gather", 0.0)
    ref = reference_dryrun()["all_gather"]
    assert got <= ref, (got, ref)
