"""Decode attention on a cache sharded inside a kv head, against
``mesh=None``, the reference and the reference's dry-run.

Where the model axis does not divide the kv heads but they divide it
(mixtral's, granite's and h2o-danube3's 8 kv heads, whisper's decoder's 8
heads, on model 16), ``launch.specs.decode_state_sharding`` leaves each
rank Dh * Hkv / tp consecutive dims of one kv head.  ``decode_attention``
then runs its core on the cache's own shards
(``attention._decode_on_split_heads``): partial scores summed over the
ranks of one head, each rank's dims of the value product, no gather of
the cache; where the cache's slots are sharded over the data axes too
(batch 1, long_500k: mixtral's and h2o-danube-3's 8 kv heads on model
16), on each rank's own dims of its own slots, the softmax and the value
product completed over the data axes.  A small GQA layer (4 q heads and 2
kv heads of 16 dims, 8 dims a rank on model 4) decodes eight steps on 2x4
gloo ranks (the helpers of ``test_torch_distributed.py``), at batch 2
with the cache's batch over 'data' and at batch 1 with its slots over
'data', each into a full cache and into a ring that wraps: the outputs
within 1e-5 of ``mesh=None``'s max in f32 and within 2^-5 in bf16 (the
reference's float tolerances; the partial dot products are summed in
another order), the caches bit for bit (they are copies; at batch 1 the
mesh's k/v projection rounds otherwise than ``mesh=None``'s one-row
product, so they are held bit for bit against the split-head core's with
the slots replicated over 'data', and within the tolerance of
``mesh=None``'s).  ``mesh=None`` itself is held against the reference's
``decode_attention`` within the same tolerances.  On a one-rank mesh no
head is split and the decode is ``mesh=None``'s bit for bit.

The dry-run: the families that take the branch take it in every layer on
a fake mesh and gather no cache shard at the attention, mixtral's and
h2o-danube-3's at batch 1 on a sequence-sharded cache too; mixtral-8x7b
decode_32k cut to 2 layers on a fake (2, 16, 16) mesh all-gathers at
most the reference's bytes a rank and moves at most twice its wire bytes
(an all-reduce of the whole scores over the 16 model ranks would not),
and its long_500k at 2 layers there all-gathers at most the reference's
bytes a rank.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as tr
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import attention
from repro_torch.sharding import P, mesh_scope, place

from test_torch_distributed import REPO, _run_ranks

B, STEPS, SEQ = 2, 8, 8
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
DRY_LAYERS = 2


def _cfg(get, window, dtype: str, heads=(4, 2)):
    """qwen's smoke layer with ``heads`` (q, kv) heads of 16 dims: 4 q and
    2 kv heads by default; (10, 5) lays 5 kv heads over model 4 as
    hymba's 5 lie over model 16, each rank's flat cache shard crossing a
    head boundary."""
    import dataclasses
    return dataclasses.replace(get("qwen1.5-0.5b").smoke(), n_heads=heads[0],
                               n_kv_heads=heads[1], dtype=dtype,
                               sliding_window=window)


def _setup(window, dtype: str, seed: int = 0, batch: int = B, heads=(4, 2)):
    """(cfg, f32 weights (wq, wk, wv, wo), xs (STEPS, batch, 1, d),
    smax)."""
    cfg = _cfg(get_config, window, dtype, heads)
    rng = np.random.default_rng(seed)
    d, qd, kd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    w = tuple((0.2 * rng.standard_normal(s)).astype(np.float32)
              for s in ((d, qd), (d, kd), (d, kd), (qd, d)))
    xs = rng.standard_normal((STEPS, batch, 1, d)).astype(np.float32)
    return cfg, w, xs, attention.cache_size(cfg, SEQ)


def _decode(cfg, w, xs, smax, mesh=None, cspec=None, donate=False):
    """The port's decode steps -> (outputs, cache_k, cache_v); on a mesh
    the weights by the sharding rules, the caches on ``cspec`` and the
    inputs' batch as the caches'.  ``donate``: every step writes into the
    caches it is given, and every step's caches are the first step's
    storages (a rank's own shards on a mesh).  Self-contained: the rank
    processes run its source."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.models import attention
    from repro_torch.sharding import P, mesh_scope, place

    def storage(t):
        t = t.to_local() if isinstance(t, DTensor) else t
        return t.untyped_storage().data_ptr()

    B = xs.shape[1]
    dt = getattr(torch, cfg.dtype)
    p = attention.LayerAttnParams(*(torch.from_numpy(a).to(dt) for a in w))
    ck = torch.zeros(B, smax, cfg.kv_dim, dtype=dt)
    cv = torch.zeros_like(ck)
    if mesh is not None:
        specs = (P(None, "model"),) * 3 + (P("model", None),)
        p = attention.LayerAttnParams(*(place(t, mesh, s)
                                        for t, s in zip(p, specs)))
        ck, cv = place(ck, mesh, cspec), place(cv, mesh, cspec)
    held = storage(ck), storage(cv)
    outs = []
    with torch.no_grad(), mesh_scope(mesh):
        for i, x in enumerate(xs):
            x = torch.from_numpy(x).to(dt)
            if mesh is not None:
                x = place(x, mesh, P(cspec[0], None, None))
            o, ck, cv = attention.decode_attention(x, p, cfg, ck, cv, i,
                                                   mesh=mesh, donate=donate)
            outs.append(o)
            if donate:
                assert (storage(ck), storage(cv)) == held, i
    return outs, ck, cv


def _reference(window, dtype: str, heads, w, xs, smax):
    """The reference's eight decode steps on the same weights and inputs."""
    cfg = _cfg(j_get_config, window, dtype, heads)
    dt = getattr(jnp, dtype)
    p = j_attn.LayerAttnParams(*(jnp.asarray(a, dt) for a in w))
    ck = jnp.zeros((xs.shape[1], smax, cfg.kv_dim), dt)
    cv = jnp.zeros_like(ck)
    outs = []
    for i, x in enumerate(xs):
        o, ck, cv = j_attn.decode_attention(jnp.asarray(x, dt), p, cfg, ck,
                                            cv, jnp.int32(i))
        outs.append(np.asarray(o, np.float32))
    return outs


def _close(got, want, tol):
    """|got - want| within ``tol`` of max |want|."""
    import torch
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), err


# -- 2x4 gloo ranks ---------------------------------------------------------------

def test_split_head_decode_on_2x4_ranks(tmp_path):
    """Eight steps with a full cache of 8 slots and a ring of 4 that wraps,
    f32 and bf16, at batch 2 (the cache's batch over 'data') and at batch
    1 (its slots over 'data', as long_500k lays it out): every step's
    output within the float tolerance of ``mesh=None``'s (itself within it
    of the reference's), the caches on their layout and bit for bit
    (at batch 1 against the same steps with the slots replicated over
    'data', and within the tolerance of ``mesh=None``'s), and every step
    through the split-head core, none through the sequence-sharded
    one.  The same with 5 kv heads (hymba's layout: each rank's flat
    cache shard crosses a head boundary, so the kv-group core at batch 2
    and the sequence-sharded core at batch 1 read a copy gathered over
    'model'), its caches within the tolerance of ``mesh=None``'s.  Every
    case also decodes donated (``donate=True``): outputs and caches equal
    the undonated run's bit for bit, on the same layout, every step's
    caches the stored shards it was given, which so hold each new
    slot."""
    cases = []
    for heads in ((4, 2), (10, 5)):
        for batch in (B, 1):
            for window in (None, 4):
                for dtype in ("float32", "bfloat16"):
                    cfg, w, xs, smax = _setup(window, dtype, batch=batch,
                                              heads=heads)
                    outs, ck, cv = _decode(cfg, w, xs, smax)
                    for got, want in zip(outs, _reference(
                            window, dtype, heads, w, xs, smax)):
                        _close(got, want, TOL[dtype])
                    cases.append({"heads": heads, "window": window,
                                  "dtype": dtype, "w": w, "xs": xs,
                                  "smax": smax, "outs": outs, "ck": ck,
                                  "cv": cv})
    torch.save(cases, tmp_path / "in.pt")
    helpers = "".join(textwrap.dedent(inspect.getsource(f)) + "\n"
                      for f in (_cfg, _decode, _close))
    out = _run_ranks(tmp_path, 8, helpers + textwrap.dedent(f"""
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import compat_make_mesh
        from repro_torch.models import attention
        from repro_torch.sharding import P, to_placements
        calls = {{"split": [], "seq": []}}

        def counting(name, fn):
            def counted(*a, **k):
                calls[name].append(1)
                return fn(*a, **k)
            return counted

        attention._decode_on_split_heads = counting(
            "split", attention._decode_on_split_heads)
        attention._decode_on_seq_shards = counting(
            "seq", attention._decode_on_seq_shards)
        mesh = compat_make_mesh((2, 4), ("data", "model"))
        for c in torch.load(os.path.join(DATA, "in.pt"), weights_only=False):
            cfg = _cfg(get_config, c["window"], c["dtype"], c["heads"])
            tol = {TOL!r}[c["dtype"]]
            seq = c["xs"].shape[1] == 1
            split = c["heads"][1] == 2
            cspec = P(None, "data", "model") if seq else P("data", None,
                                                           "model")
            n = {{k: len(v) for k, v in calls.items()}}
            outs, ck, cv = _decode(cfg, c["w"], c["xs"], c["smax"], mesh,
                                   cspec)
            assert len(calls["split"]) - n["split"] == (
                {STEPS} if split else 0), calls
            assert len(calls["seq"]) - n["seq"] == (
                {STEPS} if seq and not split else 0), calls
            for g, want in zip(outs, c["outs"]):
                _close(g.full_tensor(), want, tol)
            # donated: the same numbers, written into the stored shards
            douts, dk, dv = _decode(cfg, c["w"], c["xs"], c["smax"], mesh,
                                    cspec, donate=True)
            for g, want in zip(douts, outs):
                assert torch.equal(g.full_tensor(), want.full_tensor())
            for g, want in ((dk, ck), (dv, cv)):
                assert tuple(g.placements) == to_placements(cspec, mesh)
                assert torch.equal(g.full_tensor(), want.full_tensor()), (
                    c["heads"], c["window"], c["dtype"], tuple(cspec))
            wants = [(ck, c["ck"]), (cv, c["cv"])]
            if not split:
                for g, want in wants:
                    _close(g.full_tensor(), want, tol)
                continue
            if seq:
                # at batch 1 the mesh's k/v projection rounds otherwise than
                # mesh=None's one-row product: the caches are held within
                # the tolerance of mesh=None's, and bit for bit against the
                # split-head core's with the slots replicated over 'data'
                _, rk, rv = _decode(cfg, c["w"], c["xs"], c["smax"], mesh,
                                    P(None, None, "model"))
                for g, want in wants:
                    _close(g.full_tensor(), want, tol)
                wants = [(ck, rk.full_tensor()), (cv, rv.full_tensor())]
            for g, want in wants:
                assert tuple(g.placements) == to_placements(cspec, mesh)
                assert torch.equal(g.full_tensor(), want), (
                    c["window"], c["dtype"], tuple(cspec))
        if RANK == 0:
            print("OK split-head decode")
    """))
    assert "OK split-head decode" in out


# -- one rank: bit for bit ---------------------------------------------------------

@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 4])
def test_one_rank_decode_is_bit_for_bit(one_rank_mesh, window, dtype):
    """At (1, 1) no kv head is split (``_split_in_head`` is False): the
    outputs and caches equal ``mesh=None``'s bit for bit."""
    cfg, w, xs, smax = _setup(window, dtype, seed=1)
    want, wk, wv = _decode(cfg, w, xs, smax)
    cspec = P("data", None, "model")
    got, gk, gv = _decode(cfg, w, xs, smax, one_rank_mesh, cspec)
    assert not attention._split_in_head(gk, one_rank_mesh, cfg.n_kv_heads)
    for g, o in zip(got, want):
        assert torch.equal(g.full_tensor(), o)
    assert torch.equal(gk.full_tensor(), wk)
    assert torch.equal(gv.full_tensor(), wv)


# -- the dry-run -------------------------------------------------------------------

def _trace(cfg, shape, mesh_shape, monkeypatch, seq_calls=0):
    """The port's cell on a fake mesh -> (traced, split-head core calls),
    asserting ``seq_calls`` calls of the sequence-sharded core."""
    calls = {"split": 0, "seq": 0}

    def counting(name, fn):
        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    for name, fn in (("split", "_decode_on_split_heads"),
                     ("seq", "_decode_on_seq_shards")):
        monkeypatch.setattr(attention, fn,
                            counting(name, getattr(attention, fn)))
    traced = D.trace_cell(cfg, shape, mesh_shape)
    assert calls["seq"] == seq_calls, calls
    return traced, calls["split"]


def _cache_sites(traced, B_l, smax, kv_shard, where="models/attention.py"):
    """No all-gather at the old group core's entry (``_on_kv_groups``), and
    each all-gather site whose frames name ``where`` moves (per call) less
    than one rank's (B_l, smax, kv_shard) bf16 cache shard."""
    gathers = [s for s in traced["sites"] if s["op"] == "all-gather"]
    assert not [s for s in gathers if "_on_kv_groups" in s["site"]], gathers
    for s in gathers:
        if where in s["site"]:
            assert s["wire_bytes"] / s["count"] < B_l * smax * kv_shard * 2, s


# (arch, fake mesh): 2 kv heads of the smoke configs over model 4, whisper's
# 4 decoder heads over model 8
SPLIT_CASES = (("mixtral-8x7b", (2, 4)), ("granite-moe-3b-a800m", (2, 4)),
               ("h2o-danube-3-4b", (2, 4)), ("whisper-base", (2, 8)))


@pytest.mark.parametrize("arch,mesh_shape", SPLIT_CASES,
                         ids=[c[0] for c in SPLIT_CASES])
def test_families_take_the_split_head_core(arch, mesh_shape, monkeypatch):
    """A decode step of each family whose kv heads the model axis splits
    (smoke configs, a fake mesh) runs the split-head core in every layer
    and gathers no cache shard at the attention."""
    cfg = get_config(arch).smoke()
    tp = mesh_shape[1]
    assert cfg.n_kv_heads % tp and tp % cfg.n_kv_heads == 0
    shape = ShapeConfig("decode_64", 64, 8, "decode")
    traced, calls = _trace(cfg, shape, mesh_shape, monkeypatch)
    assert calls == cfg.n_layers, calls
    # at smoke width a cache shard is smaller than the projections' small
    # gathers: hold the core's own sites to it
    _cache_sites(traced, shape.global_batch // mesh_shape[0],
                 attention.cache_size(cfg, shape.seq_len), cfg.kv_dim // tp,
                 where="_decode_on_split_heads")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "h2o-danube-3-4b"])
def test_long_context_decode_takes_the_split_head_core(arch, monkeypatch):
    """A batch-1 long-context decode step (the cache's slots over 'data',
    its 2 kv heads split over model 4) of mixtral's and h2o-danube-3's
    smoke configs on a fake (2, 4) mesh runs the split-head core, not the
    sequence-sharded one, in every layer and gathers no cache shard
    there."""
    cfg = get_config(arch).smoke()
    shape = ShapeConfig("long_64", 64, 1, "decode")
    smax = attention.cache_size(cfg, shape.seq_len)
    assert smax % 2 == 0 and cfg.n_kv_heads == 2
    traced, calls = _trace(cfg, shape, (2, 4), monkeypatch)
    assert calls == cfg.n_layers, calls
    _cache_sites(traced, 1, smax // 2, cfg.kv_dim // 4,
                 where="_decode_on_split_heads")


def test_hymba_keeps_the_group_core_on_model_16(monkeypatch):
    """hymba-1.5b's 5 kv heads over model 16: 20-value shards cross head
    boundaries, so its long-context decode keeps the sequence-sharded
    core."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=1)
    _, calls = _trace(cfg, get_shape("long_500k"), (16, 16), monkeypatch,
                      seq_calls=1)
    assert calls == 0


@pytest.fixture(scope="module")
def reference_dryrun():
    """The reference's mixtral decode_32k and long_500k cut to 2 layers on
    the 2x16x16 mesh, compiled in a subprocess started when the first test
    asks; each cell under ``"arch:shape"``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "scripts", "dryrun_parity.py"),
         "--reference-only", "--layers", str(DRY_LAYERS), "--multi-pod",
         "--cell=mixtral-8x7b:decode_32k", "--cell=mixtral-8x7b:long_500k"],
        env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    result = {}

    def get():
        if not result:
            out, err = proc.communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.startswith("REF ")]
            assert proc.returncode == 0 and lines, err[-4000:]
            result.update(json.loads(lines[-1][4:]))
        return result

    yield get
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def test_mixtral_decode_gathers_at_most_the_reference(reference_dryrun,
                                                      monkeypatch):
    """mixtral-8x7b decode_32k at 2 layers on a fake (2, 16, 16) mesh: the
    split-head core in both layers; all-gather wire bytes a rank at most
    the reference's and all wire bytes at most twice its; no all-gather at
    the attention moves a cache shard; each layer's score all-reduce spans
    the 2 ranks of one kv head."""
    groups = []
    add = tr.CollectiveStats.add

    def recording(self, op, size, ranks):
        if op == "all-reduce":
            groups.append(len(ranks))
        return add(self, op, size, ranks)

    monkeypatch.setattr(tr.CollectiveStats, "add", recording)
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=DRY_LAYERS)
    shape = get_shape("decode_32k")
    traced, calls = _trace(cfg, shape, (2, 16, 16), monkeypatch)
    assert calls == DRY_LAYERS
    assert groups.count(2) >= DRY_LAYERS, groups
    coll = traced["collective"]
    ref = reference_dryrun()["mixtral-8x7b:decode_32k"]
    got = coll.bytes_by_op.get("all-gather", 0.0)
    assert got <= ref["all_gather"], (got, ref)
    assert coll.wire_bytes <= 2 * ref["wire_bytes"], (coll.wire_bytes, ref)
    _cache_sites(traced, shape.global_batch // 32,
                 attention.cache_size(cfg, shape.seq_len), cfg.kv_dim // 16)


def test_mixtral_long_context_decode_gathers_at_most_the_reference(
        reference_dryrun, monkeypatch):
    """mixtral-8x7b long_500k at 2 layers on a fake (2, 16, 16) mesh (batch
    1, the cache's 4,096 slots over the 32 data ranks and its 8 kv heads
    over model 16): the split-head core in both layers, all-gather wire
    bytes a rank at most the reference's, and no all-gather at the
    attention moves a cache shard."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), n_layers=DRY_LAYERS)
    shape = get_shape("long_500k")
    traced, calls = _trace(cfg, shape, (2, 16, 16), monkeypatch)
    assert calls == DRY_LAYERS
    ref = reference_dryrun()["mixtral-8x7b:long_500k"]
    got = traced["collective"].bytes_by_op.get("all-gather", 0.0)
    assert got <= ref["all_gather"], (got, ref)
    _cache_sites(traced, 1, attention.cache_size(cfg, shape.seq_len) // 32,
                 cfg.kv_dim // 16)
