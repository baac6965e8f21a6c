"""Attention's query positions split over the model ranks that hold a head,
where the local batch is one row, against ``mesh=None`` and the reference.

Where the model axis splits each whole head over r ranks (as many kv heads
as q heads, no RoPE: whisper-base's 8 heads on model 16, r = 2) and the
local batch is a row count r does not divide (whisper-base's prefill_32k on
2x16x16: 1 row a data rank), ``attention.row_exchange`` cannot trade rows.
``attention.query_exchange`` picks ``attention._on_head_queries`` instead:
an all-to-all over the head's r ranks trades query positions for head
dims, k and v are gathered one head wide over the same ranks, each rank
scores its head whole for 1/r of the queries (the causal mask and any band
offset by its first query), and a second all-to-all hands the output back
on ``wo``'s row shard.

On 2x4 gloo ranks (the helpers of ``test_torch_distributed.py``, r = 2):
whisper-base's f32 smoke config cut to 2 heads at B = 2, one row a data
rank, runs its encoder, its causal decoder self-attention and its
cross-attention in a prefill and one train step, every core on one head of
one row and half of the queries; the logits, the four caches, the loss and
every gradient within 1e-5 of ``mesh=None``'s max |value|, ``mesh=None``'s
logits within 1e-5 of the reference's.  One causal attention layer of the
same heads at S = 32 in query chunks of 8 in both packages, on the chunked
route and (window 16) the banded one, each rank's 16 queries offset by its
first: the output, k, v and the gradients of x and the weights within 1e-5
of ``mesh=None``'s, which is within 1e-5 of the reference's.  On one rank,
the route forced with r = 1 (a one-head config, whose trades are
identities) equals ``mesh=None`` bit for bit.  Which route each (arch,
shape, mesh) of the reference's sweep takes is held without ranks.
"""
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

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import shapes_for
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention
from repro_torch.models.params import params_from_jax

from test_torch_attn_head_padding import _close, _full
from test_torch_distributed import _run_ranks
from test_torch_head_groups import MESHES, _run_encdec

# 1 row a data rank on 2x4; whisper's smoke enc_seq is 16
B, DEC_S = 2, 16
LAYER_CASES = (("chunked", None), ("banded", 16))
# query chunks of 8, so each rank's 16 of S = 32 queries take the chunked
# and banded routes
LAYER_S, LAYER_CHUNK = 32, 8


def _cfg(get, heads: int = 2, window=None):
    """whisper-base's f32 smoke config with ``heads`` heads (2 model ranks
    a head on model 4 at 2) and an optional sliding window."""
    import dataclasses
    return dataclasses.replace(get("whisper-base").smoke(), dtype="float32",
                               n_heads=heads, n_kv_heads=heads,
                               sliding_window=window)


@functools.lru_cache(maxsize=None)
def _inputs(heads: int = 2, seed: int = 0):
    """(port config, port params carried from the reference's, tokens,
    labels, frames, the reference's f32 logits)."""
    jc, tc = _cfg(j_get_config, heads), _cfg(get_config, heads)
    jp = j_init(jc, jax.random.PRNGKey(seed), max_seq=DEC_S)
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, tc,
                             "cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jc.vocab, (B, DEC_S)).astype(np.int32)
    frames = rng.standard_normal((B, jc.enc_seq, jc.d_model)).astype(
        np.float32)
    want, _ = j_api.forward_logits(jp, {"tokens": toks,
                                        "frames": jnp.asarray(frames)}, jc)
    return (tc, params, torch.from_numpy(toks).long(),
            torch.from_numpy(np.roll(toks, -1, 1)).long(),
            torch.from_numpy(frames), torch.from_numpy(np.array(want)))


def _layer_setup(window, seed: int = 0):
    """(weights (wq, wk, wv, wo), x, the output's cotangent) of one f32
    causal attention layer of :func:`_cfg`'s 2 heads at (B, LAYER_S)."""
    cfg = _cfg(get_config, window=window)
    rng = np.random.default_rng(seed)
    d, qd = cfg.d_model, cfg.q_dim
    w = tuple(torch.from_numpy((0.2 * rng.standard_normal(s)).astype(
        np.float32)) for s in ((d, qd), (d, qd), (d, qd), (qd, d)))
    x, dout = (torch.from_numpy(rng.standard_normal(
        (B, LAYER_S, d)).astype(np.float32)) for _ in range(2))
    return w, x, dout


def _layer(cfg, w, x, dout, mesh=None):
    """One causal ``attention`` layer -> (out, k, v, grads of x and the
    weights); on a mesh x over the data axes and the weights by the
    sharding rules.  Self-contained: the rank processes run its source."""
    import torch
    from repro_torch.models import attention
    from repro_torch.sharding import P, mesh_scope, param_spec, place
    names = ("wq", "wk", "wv", "wo")
    args = [x] + list(w)
    if mesh is not None:
        args = [place(x, mesh, P("data", None, None))] + [
            place(t, mesh, param_spec("attn/" + n, t.shape, mesh,
                                      stacked=False))
            for n, t in zip(names, w)]
    args = [t.detach().requires_grad_() for t in args]
    with mesh_scope(mesh):
        out, k, v = attention.attention(
            args[0], attention.LayerAttnParams(*args[1:]), cfg, mesh=mesh)
        g = dout if mesh is None else place(dout, mesh,
                                            P("data", None, None))
        grads = torch.autograd.grad((out * g).sum(), args)
    return out.detach(), k.detach(), v.detach(), grads


# -- 2x4 gloo ranks ---------------------------------------------------------------

RANK_BODY = """
from torch.distributed.tensor import Shard
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import attention
calls, cores, gathers = [], [], []
queries, groups, attend, gather = attention._on_head_queries, \\
    attention._on_kv_groups, attention.attend, attention.group_gather


def counted_queries(*a, **k):
    calls.append("queries")
    return queries(*a, **k)


def counted_groups(*a, **k):
    calls.append("kv groups")
    return groups(*a, **k)


def counted_attend(q, *a, q0=0, **k):
    cores.append((q.shape[0], q.shape[2], q.shape[1], q0))
    return attend(q, *a, q0=q0, **k)


def counted_gather(t, group, dim):
    out = gather(t, group, dim)
    gathers.append((dist.get_world_size(group), out.shape[-1]))
    return out


attention._on_head_queries = counted_queries
attention._on_kv_groups = counted_groups
attention.attend, attention.group_gather = counted_attend, counted_gather
mesh = compat_make_mesh((2, 4), ("data", "model"))
part = mesh.get_local_rank("model") % 2
d = torch.load(os.path.join(DATA, "in.pt"), weights_only=False)
c = d["whisper"]
cfg = _cfg(get_config)
got = _run_encdec(*c["args"], cfg, mesh)
# the encoder's layers and the decoder's self- and cross-attention, in the
# prefill and the train step: each core one head of the rank's 1 row, for
# its half of the 16 queries; k and v gathered one head wide over 2 ranks
n = 2 * (cfg.enc_layers + 2 * cfg.n_layers)
assert calls == ["queries"] * n, calls
assert set(cores) == {(1, 1, 8, 8 * part)}, cores
assert gathers == [(2, cfg.head_dim)] * 2 * n, gathers
for i, what in enumerate(("prefill", "k", "v", "cross k", "cross v",
                          "loss")):
    _close(got[i], c["want"][i], ("whisper", what))
for k, w in c["want"][6].items():
    _close(got[6][k], w, ("whisper", k))
if RANK == 0:
    print("OK whisper")
attention.Q_CHUNK = LAYER_CHUNK
for c in d["layers"]:
    cfg = _cfg(get_config, window=c["window"])
    calls.clear(), cores.clear()
    got = _layer(cfg, *c["args"], mesh)
    assert calls == ["queries"], calls
    assert cores == [(1, 1, 16, 16 * part)], cores
    for t in got[1:3]:
        assert tuple(t.placements) == (Shard(0), Shard(2)), t.placements
    for i, what in enumerate(("out", "k", "v")):
        _close(got[i], c["want"][i], (c["window"], what))
    for i, (g, w) in enumerate(zip(got[3], c["want"][3])):
        _close(g, w, (c["window"], "grad", i))
    if RANK == 0:
        print("OK layer", c["window"])
"""


@pytest.fixture(scope="module")
def ranks_2x4(tmp_path_factory):
    """Rank 0's log of one run on 2x4 gloo ranks of the whisper smoke
    config and the layer on both routes, against ``mesh=None``'s results
    made here."""
    cfg, params, toks, labels, frames, _ = _inputs()
    args = (params, toks, labels, frames)
    whisper = {"args": args, "want": _run_encdec(*args, cfg)}
    layers = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "Q_CHUNK", LAYER_CHUNK)
        for _, window in LAYER_CASES:
            args = _layer_setup(window)
            layers.append({"window": window, "args": args,
                           "want": _layer(_cfg(get_config, window=window),
                                          *args)})
    tmp = tmp_path_factory.mktemp("seq_exchange_2x4")
    torch.save({"whisper": whisper, "layers": layers}, tmp / "in.pt")
    helpers = ("from repro_torch.configs import get_config\n"
               f"LAYER_CHUNK = {LAYER_CHUNK}\n") + "".join(
        textwrap.dedent(inspect.getsource(f)) + "\n"
        for f in (_cfg, _run_encdec, _layer, _full, _close))
    return _run_ranks(tmp, 8, helpers + RANK_BODY)


MESH_2X4 = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                 axis_names=("data", "model"))


def test_whisper_queries_split_match_one_device(ranks_2x4):
    """whisper-base's smoke config with 2 heads on 2x4 ranks at one row a
    data rank: every attention core of the encoder and the decoder's
    self- and cross-attention, in the prefill and the train step, scores
    one head of one row for the rank's half of the queries, k and v each
    gathered one head wide over the head's 2 ranks, never on the kv-head
    groups; the prefill's logits and caches, the loss and every gradient
    within 1e-5 of ``mesh=None``'s max |value|; ``mesh=None``'s logits
    within 1e-5 of the reference's max |logit|."""
    cfg, params, toks, labels, frames, ref = _inputs()
    assert not attention.row_exchange(cfg, MESH_2X4, B)
    assert attention.query_exchange(cfg, MESH_2X4, B, DEC_S) == 2
    assert attention.query_exchange(cfg, MESH_2X4, B, cfg.enc_seq) == 2
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
def test_causal_layer_queries_split_on_2x4_ranks(ranks_2x4, small_chunks,
                                                 route, window):
    """One causal layer of 2 heads at (2, 32) in query chunks of 8, each
    rank scoring its head for 16 queries from its first (0 or 16) on the
    chunked route and (window 16) the banded one: the output, k and v (on
    their own flat shards) and every gradient within 1e-5 of
    ``mesh=None``'s max |value|; ``mesh=None``'s output within 1e-5 of the
    reference's."""
    cfg = _cfg(get_config, window=window)
    assert attention.prefill_route(cfg, LAYER_S // 2) == route
    assert attention.query_exchange(cfg, MESH_2X4, B, LAYER_S) == 2
    w, x, dout = _layer_setup(window)
    out = _layer(cfg, w, x, dout)[0]
    jcfg = _cfg(j_get_config, window=window)
    want, _, _ = j_attention.attention(
        jnp.asarray(x.numpy()),
        j_attention.LayerAttnParams(*(jnp.asarray(t.numpy()) for t in w)),
        jcfg)
    _close(out, torch.from_numpy(np.array(want)), "reference")
    assert f"OK layer {window}\n" in ranks_2x4


# -- one rank: bit for bit ---------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_route_on_one_rank_is_bit_for_bit(one_rank_mesh, monkeypatch):
    """The route forced on a (1, 1) mesh with r = 1 (a one-head config: the
    all-to-alls and the gathers are identities): whisper's prefill, its
    four caches, the loss and every gradient equal ``mesh=None``'s bit for
    bit, every core on the route."""
    cfg, params, toks, labels, frames, _ = _inputs(heads=1)
    assert not attention.query_exchange(cfg, one_rank_mesh, B, DEC_S)
    calls, queries = [], attention._on_head_queries

    def counted(*args, **kwargs):
        calls.append(args[-1])
        return queries(*args, **kwargs)

    want = _run_encdec(params, toks, labels, frames, cfg)
    monkeypatch.setattr(attention, "query_exchange",
                        lambda cfg, mesh, batch, seq: 1)
    monkeypatch.setattr(attention, "_on_head_queries", counted)
    got = _run_encdec(params, toks, labels, frames, cfg, one_rank_mesh)
    assert calls == [1] * 2 * (cfg.enc_layers + 2 * cfg.n_layers), calls
    for i in range(6):
        assert torch.equal(_full(got[i]), want[i]), i
    for k, w in want[6].items():
        assert torch.equal(_full(got[6][k]), w), k


def test_route_raises_where_it_cannot_split(one_rank_mesh):
    """No fallback hides the route: queries or head dims that do not split
    over r ranks raise, and so does a head group that cannot form (2
    ranks a head on one rank)."""
    q = torch.zeros(1, 6, 4)

    def core(q, k, v, q0):
        return q

    mesh4 = types.SimpleNamespace(shape={"data": 2, "model": 4},
                                  axis_names=("data", "model"))
    with pytest.raises(ValueError, match="do not split"):
        attention._on_head_queries(core, mesh4, q[:, :5], q[:, :5],
                                   q[:, :5], 2)
    with pytest.raises(ValueError, match="do not split"):
        attention._on_head_queries(core, mesh4, q[..., :2], q, q, 2)
    with pytest.raises(RuntimeError):
        attention._on_head_queries(core, one_rank_mesh, q, q, q, 2)


# -- the route each (arch, shape, mesh) takes --------------------------------------

ROW_ARCHS = ("whisper-base",)
KV_GROUP_ARCHS = ("mixtral-8x7b", "h2o-danube-3-4b")
PADDED_ARCHS = ("hymba-1.5b", "granite-moe-3b-a800m")
QUERY_PAIRS = {("whisper-base", "prefill_32k", "2x16x16")}


def _mesh(name):
    shape = MESHES[name]
    return types.SimpleNamespace(shape=shape, axis_names=tuple(shape))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_query_route_taken_for_exactly_its_pairs(arch, mesh_name):
    """Over every shape of the reference's sweep on each production mesh:
    the query route is taken by whisper-base's prefill_32k on 2x16x16
    alone (1 row a data rank) and by no pair that trades rows, gathers
    k/v over a kv head's group or pads the q heads; those routes pick as
    before (rows for whisper-base wherever its local batch is even, the
    kv-head group for mixtral and h2o-danube-3, padding for hymba and
    granite); without a mesh and on one rank none of them applies."""
    cfg = get_config(arch)
    mesh = _mesh(mesh_name)
    one = types.SimpleNamespace(shape={"data": 1, "model": 1},
                                axis_names=("data", "model"))
    for shape in shapes_for(cfg):
        B_, S = shape.global_batch, shape.seq_len
        rq = attention.query_exchange(cfg, mesh, B_, S)
        assert rq == (2 if (arch, shape.name, mesh_name) in QUERY_PAIRS
                      else 0), shape.name
        rows = attention.row_exchange(cfg, mesh, B_)
        assert rows == (2 if arch in ROW_ARCHS and not rq else 0), shape.name
        assert attention._on_own_q_heads(cfg, mesh) == (
            arch in KV_GROUP_ARCHS)
        assert (attention.q_heads(cfg, mesh) != cfg.n_heads) == (
            arch in PADDED_ARCHS)
        for m in (one, None):
            assert not attention.query_exchange(cfg, m, B_, S)
            assert not attention.row_exchange(cfg, m, B_)


@pytest.mark.parametrize("batch,seq,want", [
    (32, 32768, 2),      # prefill_32k: 1 row a data rank
    (32, 32767, 0),      # an odd S: the heads stay whole on every rank
    (1, 448, 2),         # a batch the data axes do not divide: 1 row
    (64, 32768, 0),      # 2 rows a data rank: rows are traded instead
    (96, 448, 2),        # 3 rows a data rank
])
def test_whisper_query_route_on_two_pods(batch, seq, want):
    """whisper-base on 2x16x16 (32 data ranks, 2 model ranks a head): the
    query route wherever the local batch is odd and S even; rows are
    traded wherever the local batch is even."""
    cfg, mesh = get_config("whisper-base"), _mesh("2x16x16")
    assert attention.query_exchange(cfg, mesh, batch, seq) == want
    local = batch // 32 if batch % 32 == 0 else batch
    assert attention.row_exchange(cfg, mesh, batch) == (
        0 if local % 2 else 2)

