"""The port's dry-run (``repro_torch.launch.{specs,dryrun}``) against the
reference's ``repro.launch.{specs,dryrun}``.

The abstract trees (``abstract_params``, ``abstract_train_state``,
``input_specs``, ``abstract_decode_state``; meta tensors against
``ShapeDtypeStruct``s) equal the reference's shape for shape and dtype for
dtype for all ten archs; the decode state's ``index`` is the port's host
int 0.  ``batch_sharding`` and ``decode_state_sharding`` equal the
reference's specs on the (16, 16), (2, 16, 16) and (2, 4) meshes (a
``SimpleNamespace`` with the mesh's names and sizes on the port's side, an
``AbstractMesh`` on the reference's).

The counters hold known answers on fake meshes of the ``fake`` process
group: per-rank FLOPs of a sharded MLP, the collectives of known
redistributes and of the three collectives of ``test_roofline_pruning``'s
HLO sample, op by op, and their pricing by node.  A traced step counts every
layer (the FLOPs of 1, 2 and 3 layers differ by the same amount), a
one-rank mesh counts what no mesh counts, and smoke cells of every kind
trace on a fake (2, 4) mesh without allocating, writing the reference's
report keys.
"""
import dataclasses
import io
import json
import math
import os
import socket
import subprocess
import sys
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_shape as j_get_shape
from repro.configs.base import shapes_for as j_shapes_for
from repro.launch import dryrun as j_dryrun
from repro.launch import roofline as jr
from repro.launch import specs as j_specs
from repro.models.params import abstract_params as j_abstract_params

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as tr
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.models.params import abstract_params
from repro_torch.sharding import mesh_shape

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}


def _dt(x) -> str:
    """A dtype's name: ``bfloat16``, ``float8_e4m3fn``, ``int32``, ..."""
    if isinstance(x, torch.dtype):
        return str(x).removeprefix("torch.")
    return np.dtype(x).name


def _same_leaf(got, want, what=""):
    assert isinstance(got, torch.Tensor) and got.device.type == "meta", what
    assert tuple(got.shape) == tuple(want.shape), (what, got.shape,
                                                   want.shape)
    assert _dt(got.dtype) == _dt(want.dtype), (what, got.dtype, want.dtype)


def _same_tree(got: dict, want: dict, what=""):
    assert set(got) == set(want), what
    for k in want:
        _same_leaf(got[k], want[k], f"{what}/{k}")


def _ns(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _tuple(spec):
    def entry(e):
        if isinstance(e, (list, tuple)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(entry(e) for e in spec)


def _decode_shapes(arch):
    return [s.name for s in j_shapes_for(j_get_config(arch))
            if s.kind == "decode"]


# -- the abstract trees --------------------------------------------------------

@pytest.mark.parametrize("tp_total", [1, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_equal_the_reference(arch, tp_total):
    got = abstract_params(get_config(arch), max_seq=4096, tp_total=tp_total)
    want = j_abstract_params(j_get_config(arch), max_seq=4096,
                             tp_total=tp_total)
    _same_tree(got, want, arch)


@pytest.mark.parametrize("grad_compress", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_equals_the_reference(arch, grad_compress):
    got = specs.abstract_train_state(get_config(arch), get_shape("train_4k"),
                                     16, grad_compress)
    want = j_specs.abstract_train_state(j_get_config(arch),
                                        j_get_shape("train_4k"), 16,
                                        grad_compress)
    _same_tree(got.params, want.params, "params")
    _same_tree(got.opt.mu, want.opt.mu, "mu")
    _same_tree(got.opt.nu, want.opt.nu, "nu")
    _same_leaf(got.opt.count, want.opt.count, "count")
    assert (got.err_fb is None) == (want.err_fb is None)
    if want.err_fb is not None:
        _same_tree(got.err_fb, want.err_fb, "err_fb")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference_for_every_shape(arch):
    for shape in j_shapes_for(j_get_config(arch)):
        got = specs.input_specs(get_config(arch), get_shape(shape.name))
        want = j_specs.input_specs(j_get_config(arch), shape)
        _same_tree(got, want, f"{arch} {shape.name}")


def _decode_cases():
    return [(arch, shape, kv) for arch in ARCH_IDS
            for shape in _decode_shapes(arch)
            for kv in (None, "float8_e4m3fn")]


@pytest.mark.parametrize("arch,shape,kv", _decode_cases())
def test_abstract_decode_state_equals_the_reference(arch, shape, kv):
    got = specs.abstract_decode_state(get_config(arch), get_shape(shape), kv)
    want = j_specs.abstract_decode_state(j_get_config(arch),
                                         j_get_shape(shape), kv)
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name in want._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "index":
            # the port's host int, the reference's 0-d int32
            assert g == 0 and isinstance(g, int)
            assert w.shape == () and _dt(w.dtype) == "int32"
            continue
        assert (g is None) == (w is None), name
        if w is not None:
            _same_leaf(g, w, name)


def test_kv_dtype_names_resolve():
    assert specs.kv_dtype_of(None) == torch.bfloat16
    assert specs.kv_dtype_of("float8_e4m3fn") == torch.float8_e4m3fn
    assert specs.kv_dtype_of("float16") == torch.float16
    with pytest.raises(ValueError, match="dtype"):
        specs.kv_dtype_of("no_such_dtype")


# -- the shardings ---------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_sharding_equals_the_reference(arch, mesh):
    """Every shape's inputs, long_500k's replicated batch of 1 included,
    and decode's tokens."""
    shape, axes = MESHES[mesh]
    jm = AbstractMesh(shape, axes)
    for s in j_shapes_for(j_get_config(arch)):
        jin = j_specs.input_specs(j_get_config(arch), s)
        want = j_specs.batch_sharding(jin, jm)
        got = specs.batch_sharding(
            specs.input_specs(get_config(arch), get_shape(s.name)), _ns(mesh))
        assert set(got) == set(want)
        for k in want:
            assert _tuple(got[k].spec) == _tuple(want[k].spec), \
                (s.name, k, got[k].spec, want[k].spec)
        if s.global_batch == 1:
            assert all(_tuple(v.spec) == () for v in got.values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_sharding_equals_the_reference(arch, mesh):
    """decode_32k (batch over the data axes) and long_500k (batch 1: the
    cache's sequence dim over them instead)."""
    shape, axes = MESHES[mesh]
    jm = AbstractMesh(shape, axes)
    for s in _decode_shapes(arch):
        js = j_specs.abstract_decode_state(j_get_config(arch), j_get_shape(s))
        ts = specs.abstract_decode_state(get_config(arch), get_shape(s))
        want = j_specs.decode_state_sharding(j_get_config(arch), js, jm)
        got = specs.decode_state_sharding(get_config(arch), ts, _ns(mesh))
        assert type(got) is type(ts)
        for name, g, w in zip(want._fields, got, want):
            assert (g is None) == (w is None), name
            if w is not None:
                assert _tuple(g.spec) == _tuple(w.spec), \
                    (s, name, g.spec, w.spec)
        if s == "long_500k" and ts.cache_k is not None:
            dp = "data" if len(shape) == 2 else ("pod", "data")
            assert _tuple(got.cache_k.spec)[1:3] == (None, dp)


# -- the counters, with known answers ------------------------------------------

def _fake():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=False)


def test_counter_counts_one_rank_of_a_sharded_mlp():
    """x (256, 4096, 2048) over 'data', W1 column- and W2 row-sharded over
    'model' on (16, 16): each rank does 2 * 2^37 FLOPs = 2^38, where
    ``FlopCounterMode`` counts the global shapes, 2^46.  The row-sharded
    product's partial sums stay partial: no collective."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.utils.flop_counter import FlopCounterMode
    with D.fake_group(256):
        mesh = D._make_mesh((16, 16))
        with _fake():
            x = distribute_tensor(torch.empty(256, 4096, 2048,
                                              dtype=torch.bfloat16),
                                  mesh, [Shard(0), Replicate()])
            w1 = distribute_tensor(torch.empty(2048, 8192,
                                               dtype=torch.bfloat16),
                                   mesh, [Replicate(), Shard(1)])
            w2 = distribute_tensor(torch.empty(8192, 2048,
                                               dtype=torch.bfloat16),
                                   mesh, [Replicate(), Shard(0)])

            def mlp(x, w1, w2):
                return (x @ w1) @ w2

            y, c, mem = D.measure(mlp, x, w1, w2)
            with FlopCounterMode(display=False) as fc:
                mlp(x, w1, w2)
    assert c.flops == 2 ** 38
    assert fc.get_total_flops() == 2 ** 46
    assert c.collective.counts == {}
    # bytes: x's, W1's and the (16, 4096, 512) product's shards in and out
    # of the first matmul, then those of the second (views left out)
    xs, w1s, h = 16 * 4096 * 2048, 2048 * 512, 16 * 4096 * 512
    w2s, ys = 512 * 2048, 16 * 4096 * 2048
    assert c.bytes == 2 * ((xs + w1s + h) + (h + w2s + ys))
    assert mem["argument_bytes"] == 2 * (xs + w1s + w2s)
    assert mem["output_bytes"] == 2 * ys
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]


def test_decomposed_propagation_adds_nothing_to_the_counts():
    """An op with no sharding strategy of its own (hardswish on this torch)
    is propagated through its decomposition, run on global-shape meta
    tensors on a one-rank mesh DTensor makes and keeps: on a fake (2, 2)
    mesh, ``measure``'s peak is the local shards' bytes alone (f32 (24, 40,
    56) in and out, the input's (48, 40, 56) sharded over 'data'), and the
    counter counts the one local op; neither counts the propagation's
    tensors, nor its mesh's."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._python_dispatch import TorchDispatchMode

    meta_ops = []

    class _Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **(kwargs or {}))
            if any(t.device.type == "meta" for t in D._tensors(out)):
                meta_ops.append(func)
            return out

    def step(x):
        with _Spy():
            return F.hardswish(x)

    with D.fake_group(4):
        mesh = D._make_mesh((2, 2))
        with _fake():
            x = distribute_tensor(torch.empty(48, 40, 56), mesh,
                                  [Shard(0), Replicate()])
            y, c, mem = D.measure(step, x)
    local = 24 * 40 * 56 * 4
    assert meta_ops, "hardswish no longer propagates through its decomposition"
    assert tuple(y.to_local().shape) == (24, 40, 56)
    assert mem["peak_bytes"] == 2 * local
    assert (c.ops, c.bytes, c.flops) == (1, 2 * local, 0)


def test_counter_counts_each_collective_of_known_redistributes():
    """On (16, 16): a partial f32 (16, 1024) to replicated is one
    all-reduce over 'model', a bf16 (4096, 512) sharded on 'model' to
    replicated one all-gather of the gathered result, and a Shard(0) ->
    Shard(1) reshard one all-to-all of the local shard (the fake group's
    CPU mesh runs it as an all-gather and a chunk, which the counter takes
    for the all-to-all an NCCL mesh runs); the ring wire bytes are the
    reference's formulas, each group of 16 ranks spanning two nodes."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    with D.fake_group(256):
        mesh = D._make_mesh((16, 16))
        with _fake():
            p = DTensor.from_local(torch.empty(16, 1024), mesh,
                                   [Replicate(), Partial()])
            g = distribute_tensor(torch.empty(4096, 512, dtype=torch.bfloat16),
                                  mesh, [Replicate(), Shard(0)])
            a = distribute_tensor(torch.empty(256, 256, dtype=torch.bfloat16),
                                  mesh, [Replicate(), Shard(0)])
            _, c1, _ = D.measure(lambda t: t.redistribute(
                mesh, [Replicate(), Replicate()]), p)
            _, c2, _ = D.measure(lambda t: t.redistribute(
                mesh, [Replicate(), Replicate()]), g)
            out, c3, _ = D.measure(lambda t: t.redistribute(
                mesh, [Replicate(), Shard(1)]), a)
            assert tuple(out.to_local().shape) == (256, 16)
    ar = 2 * 15 / 16 * 16 * 1024 * 4
    ag = 15 / 16 * 4096 * 512 * 2
    a2a = 15 / 16 * 16 * 256 * 2
    assert dict(c1.collective.counts) == {"all-reduce": 1}
    assert c1.collective.bytes_by_op == {"all-reduce": ar}
    assert dict(c2.collective.counts) == {"all-gather": 1}
    assert c2.collective.bytes_by_op == {"all-gather": ag}
    assert dict(c3.collective.counts) == {"all-to-all": 1}
    assert c3.collective.bytes_by_op == {"all-to-all": a2a}
    for c, w in ((c1, ar), (c2, ag), (c3, a2a)):
        assert c.collective.ib_wire_bytes == c.collective.wire_bytes == w
        assert c.collective.nvlink_wire_bytes == 0


def test_counter_refuses_a_torch_that_goes_round_its_alltoall_mark(
        monkeypatch):
    """Where ``placement_types`` no longer calls ``shard_dim_alltoall`` by
    that name, the marks raise instead of counting a Shard->Shard reshard
    as the cpu mesh's all-gather, and patch nothing."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    prop = ShardingPropagator._propagate_tensor_meta_non_cached
    monkeypatch.setattr(placement_types, "shard_dim_alltoall",
                        lambda *a: None)
    with pytest.raises(RuntimeError, match="cannot count all-to-alls"):
        with D._Marks.active():
            pass
    assert ShardingPropagator._propagate_tensor_meta_non_cached is prop
    assert D._Marks._users == 0 and D._Marks._saved == []


def test_counted_collectives_equal_the_hlo_sample_op_by_op():
    """The three collectives of ``test_roofline_pruning.HLO_SAMPLE``, run
    through ``_c10d_functional``: an all-reduce of f32 (16, 1024) over 16
    ranks, an all-gather to bf16 (4096, 512) over 16 and a reduce-scatter
    to bf16 (256, 512) over 8 give the parser's counts and wire bytes;
    the 8-rank group lies in one node (NVLink), the 16-rank ones span two
    (InfiniBand)."""
    import torch.distributed._functional_collectives as funcol
    from test_roofline_pruning import HLO_SAMPLE
    with D.fake_group(256):
        g16 = D._make_mesh((16, 16)).get_group("model")
        g8 = D._make_mesh((32, 8)).get_group("model")
        with _fake():
            ar = torch.empty(16, 1024)
            ag = torch.empty(256, 512, dtype=torch.bfloat16)
            rs = torch.empty(2048, 512, dtype=torch.bfloat16)

            def collectives(ar, ag, rs):
                return (funcol.all_reduce(ar, "sum", g16),
                        funcol.all_gather_tensor(ag, 0, g16),
                        funcol.reduce_scatter_tensor(rs, "sum", 0, g8))

            outs, c, _ = D.measure(collectives, ar, ag, rs)
    assert [tuple(o.shape) for o in outs] == [(16, 1024), (4096, 512),
                                              (256, 512)]
    want = jr.parse_collectives(HLO_SAMPLE)
    got = c.collective
    for op in ("all-reduce", "all-gather", "reduce-scatter"):
        assert got.counts[op] == want.counts[op] == 1
        assert got.bytes_by_op[op] == want.bytes_by_op[op], op
    assert got.nvlink_wire_bytes == want.bytes_by_op["reduce-scatter"]
    assert got.ib_wire_bytes == (want.bytes_by_op["all-reduce"]
                                 + want.bytes_by_op["all-gather"])
    rep = tr.RooflineReport("a", "s", "16x16", 256, 0.0, 0.0, got, 1.0)
    assert rep.collective_s == (got.nvlink_wire_bytes / 450e9
                                + got.ib_wire_bytes / 50e9)


def _smoke(arch, **kw):
    return dataclasses.replace(get_config(arch).smoke(), **kw)


def test_one_rank_mesh_counts_what_no_mesh_counts():
    """A smoke train step on a fake (1, 1) mesh: the same FLOPs as the same
    step with ``mesh=None`` on fake tensors, and no collective that moves
    data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train import make_train_step
    cfg = _smoke("qwen1.5-0.5b")
    shape = ShapeConfig("s", 32, 4, "train")
    on_mesh = D.trace_cell(cfg, shape, (1, 1))
    step = make_train_step(cfg, OptConfig(), remat=True)
    abstract = (specs.abstract_train_state(cfg, shape, 1, False),
                specs.input_specs(cfg, shape))
    with D._train_flags(shape), FakeTensorMode(allow_non_fake_inputs=False):
        _, alone, _ = D.measure(step, *D._fake_like(abstract, "cpu"))
    assert on_mesh["flops"] == alone.flops > 0
    assert on_mesh["collective"].wire_bytes == 0


LAYER_ARCHS = ["qwen1.5-0.5b", "mamba2-1.3b", "hymba-1.5b",
               "granite-moe-3b-a800m", "whisper-base"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", LAYER_ARCHS)
def test_every_layer_is_counted(arch, kind):
    """FLOPs of 1, 2 and 3 layers grow by the same amount a layer, exactly
    (and whisper's at 1, 2 and 3 encoder layers): the port's layer loop is
    Python, so the reference's two-point extrapolation (``_layer_points``)
    has nothing to recover."""
    shape = ShapeConfig("s", 32, 4, kind)
    f = [D.trace_cell(_smoke(arch, n_layers=n), shape, (1, 1))["flops"]
         for n in (1, 2, 3)]
    assert f[2] - f[1] == f[1] - f[0] > 0
    if arch == "whisper-base" and kind != "decode":
        e = [D.trace_cell(_smoke(arch, enc_layers=n), shape, (1, 1))["flops"]
             for n in (1, 2, 3)]
        assert e[2] - e[1] == e[1] - e[0] > 0
    assert not hasattr(D, "_layer_points")
    assert hasattr(j_dryrun, "_layer_points")


# -- smoke cells on a fake (2, 4) mesh -------------------------------------------

@pytest.fixture
def small_production(monkeypatch):
    """``run_cell`` and the CLI on smoke configs and a fake (2, 4) mesh in
    place of the 16x16 one (2x2x2 for 2x16x16; the names and files keep
    the production meshes')."""
    monkeypatch.setattr(D, "PRODUCTION_MESHES",
                        {"16x16": (2, 4), "2x16x16": (2, 2, 2)})
    monkeypatch.setattr(D, "get_config", lambda a: get_config(a).smoke())


def _run_keys():
    rep = jr.RooflineReport("a", "s", "m", 1, 1.0, 1.0, jr.CollectiveStats(),
                            1.0)
    keys = set(rep.to_dict()) | {
        "memory_analysis", "lower_s", "compile_s", "kind", "remat",
        "grad_compress", "extra", "n_params", "n_active", "status"}
    return (keys - {"compile_s"}) | {"trace_s"}


CELLS = [("qwen1.5-0.5b", "train_4k"), ("granite-moe-3b-a800m", "train_4k"),
         ("mamba2-1.3b", "prefill_32k"), ("hymba-1.5b", "prefill_32k"),
         ("whisper-base", "decode_32k"), ("mixtral-8x7b", "decode_32k")]


@pytest.fixture
def fake_modes(monkeypatch):
    """Every ``FakeTensorMode`` the dry-run makes, recorded."""
    from torch._subclasses import fake_tensor
    made = []

    class Recorded(fake_tensor.FakeTensorMode):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(fake_tensor, "FakeTensorMode", Recorded)
    return made


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cell_traces_on_a_fake_mesh(tmp_path, fake_modes,
                                          small_production, arch, shape):
    """A smoke config's production-shape cell on a fake (2, 4) mesh: the
    report has the reference's ``run_cell`` keys (``trace_s`` for
    ``compile_s``) in ``{arch}__{shape}__16x16.json``, collectives were
    counted, every term is finite, a decode cell's donated state is its
    alias bytes (none else aliases), and the fake mode took no real
    tensor."""
    r = D.run_cell(arch, shape, out_dir=str(tmp_path), verbose=False)
    assert _run_keys() <= set(r) and "compile_s" not in r
    path = tmp_path / f"{arch}__{shape}__16x16.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(r))
    assert r["chips"] == 8 and r["status"] == "ok"
    assert sum(r["collective_counts"].values()) > 0
    assert r["collective_wire_bytes"] > 0
    for k in ("flops_per_device", "bytes_per_device", "collective_wire_bytes",
              "model_flops", "compute_s", "memory_s", "collective_s",
              "step_s", "useful_flops_ratio", "mfu"):
        assert math.isfinite(r[k]) and r[k] > 0, k
    assert set(r["memory_analysis"]) >= {"argument_bytes", "output_bytes",
                                        "temp_bytes", "alias_bytes"}
    # a decode cell donates its state (the new state is the argument's
    # storage, as the reference's donate_argnums=(2,)); the others alias
    # nothing
    mem = r["memory_analysis"]
    if get_shape(shape).kind == "decode":
        assert 0 < mem["alias_bytes"] <= min(mem["argument_bytes"],
                                             mem["output_bytes"])
    else:
        assert mem["alias_bytes"] == 0
    assert fake_modes and all(not m.allow_non_fake_inputs
                              for m in fake_modes)


def _code_bytes(cfg, shape, qbits, mesh_shape):
    """One rank's bytes of the quantized leaves of ``cfg`` (codes only, no
    scales) on a fake mesh."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    with D.fake_group(math.prod(mesh_shape)):
        mesh = D._make_mesh(mesh_shape)
        params = specs.abstract_inference_params(cfg, shape, 4)
        p_sh = specs.param_sharding_for(cfg, params, mesh)
        q, q_sh = D._quantized(cfg, params, p_sh, qbits, mesh)
        total = 0
        for k, v in q.items():
            if k + "@scale" in q:
                local, _ = compute_local_shape_and_global_offset(
                    v.shape, mesh, q_sh[k].placements)
                total += math.prod(local) * v.element_size()
    return total


def test_w4_cell_halves_the_quantized_leaves_argument_bytes(
        tmp_path, small_production):
    """``--quant-bits 4`` (packed nibbles) against ``--quant-bits 8`` (int8
    codes) on the same decode cell: the arguments differ by half the W8
    codes' bytes, everything else (scales, the unquantized leaves, the
    state) equal; the quantized cells' arguments are smaller than the bf16
    cell's."""
    cfg = get_config("mixtral-8x7b").smoke()
    shape = get_shape("decode_32k")
    args = {}
    for bits in (0, 8, 4):
        r = D.run_cell("mixtral-8x7b", "decode_32k", out_dir=str(tmp_path),
                       extra={"quant_bits": bits} if bits else None,
                       tag=f"w{bits}", verbose=False)
        args[bits] = r["memory_analysis"]["argument_bytes"]
        assert r["extra"] == ({"quant_bits": bits} if bits else {})
    c8 = _code_bytes(cfg, shape, 8, (2, 4))
    c4 = _code_bytes(cfg, shape, 4, (2, 4))
    assert c8 > 0 and c4 * 2 == c8
    assert args[8] - args[4] == c8 // 2
    assert args[4] < args[8] < args[0]


def test_kv_dtype_cell_keeps_an_fp8_cache(tmp_path, small_production):
    """``--kv-dtype float8_e4m3fn`` halves the bf16 cache's argument
    bytes."""
    cfg = get_config("qwen1.5-0.5b").smoke()
    r16 = D.run_cell("qwen1.5-0.5b", "decode_32k", out_dir=str(tmp_path),
                     verbose=False)
    r8 = D.run_cell("qwen1.5-0.5b", "decode_32k", out_dir=str(tmp_path),
                    extra={"kv_dtype": "float8_e4m3fn"}, tag="fp8",
                    verbose=False)
    state = specs.abstract_decode_state(cfg, get_shape("decode_32k"))
    cache = 2 * state.cache_k.numel() * 2 // 8       # k and v, bf16, 8 ranks
    assert r16["memory_analysis"]["argument_bytes"] - \
        r8["memory_analysis"]["argument_bytes"] == cache // 2


# -- the CLI and the launcher ----------------------------------------------------

def test_cli_writes_a_cell_and_skips_it_when_cached(tmp_path, capsys,
                                                    small_production):
    argv = ["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
            "--out", str(tmp_path)]
    D.main(argv)
    out = capsys.readouterr().out
    path = tmp_path / "qwen1.5-0.5b__decode_32k__16x16.json"
    assert path.exists()
    assert "[ok] qwen1.5-0.5b x decode_32k x 16x16: trace=" in out
    assert "all requested cells traced OK" in out
    stamp = os.stat(path).st_mtime_ns
    D.main(argv)
    out = capsys.readouterr().out
    assert "[skip] qwen1.5-0.5b x decode_32k x 16x16 (cached)" in out
    assert os.stat(path).st_mtime_ns == stamp
    D.main(argv + ["--force", "--both-meshes", "--tag", "t"])
    out = capsys.readouterr().out
    assert (tmp_path / "qwen1.5-0.5b__decode_32k__16x16_t.json").exists()
    assert (tmp_path / "qwen1.5-0.5b__decode_32k__2x16x16_t.json").exists()
    r = json.loads((tmp_path / "qwen1.5-0.5b__decode_32k__2x16x16_t.json"
                    ).read_text())
    assert r["chips"] == 8
    with pytest.raises(SystemExit):
        D.main(["--arch", "qwen1.5-0.5b", "--out", str(tmp_path)])


def test_cli_reports_a_failing_cell_and_exits_1(tmp_path, capsys,
                                                small_production):
    """A cell that raises is reported and the run exits 1 after the
    others (here: a microbatch count that does not divide the batch)."""
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                "--microbatches", "3", "--out", str(tmp_path)])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "[FAIL] qwen1.5-0.5b x train_4k x 16x16" in out
    assert "1 FAILURES:" in out


def test_launcher_takes_the_production_mesh_under_a_launcher():
    """With a default group of 256 ranks (a launcher's; here the fake
    backend's) the launcher's mesh is the 16x16 production mesh, under
    ``--smoke`` the local mesh over those ranks; a process alone has no
    mesh."""
    assert not dist.is_initialized()
    assert launch_train.launch_mesh(False, "cpu") is None
    with D.fake_group(256):
        assert mesh_shape(launch_train.launch_mesh(False, "cpu")) == \
            {"data": 16, "model": 16}
        assert mesh_shape(launch_train.launch_mesh(True, "cpu")) == \
            {"data": 256, "model": 1}
    with D.fake_group(512):
        assert mesh_shape(launch_train.launch_mesh(False, "cpu")) == \
            {"pod": 2, "data": 16, "model": 16}
    with D.fake_group(4):
        with pytest.raises(ValueError, match="256 or 512 ranks"):
            launch_train.launch_mesh(False, "cpu")
        assert mesh_shape(launch_train.launch_mesh(True, "cpu")) == \
            {"data": 4, "model": 1}


def _launched(monkeypatch, world: int, rank: int = 0):
    """The environment ``torchrun`` gives a rank of a ``world``-rank run."""
    for k, v in (("RANK", rank), ("LOCAL_RANK", rank), ("WORLD_SIZE", world),
                 ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", 1)):
        monkeypatch.setenv(k, str(v))


def test_launcher_main_joins_the_launchers_group(monkeypatch, tmp_path):
    """``main()`` under a launcher's environment of 256 ranks joins the
    group (``env://``; here answered by the fake backend, whose collectives
    move nothing, so the step's values are not looked at), trains on the
    16x16 production mesh and destroys the group it joined."""
    real_init = dist.init_process_group
    joined = []

    def fake_init(backend, init_method=None, **kw):
        joined.append((backend, init_method))
        from torch.testing._internal.distributed.fake_pg import FakeStore
        real_init("fake", store=FakeStore(), rank=int(os.environ["RANK"]),
                  world_size=int(os.environ["WORLD_SIZE"]))

    _launched(monkeypatch, 256)
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(launch_train, "get_config",
                        lambda arch: get_config(arch).smoke())
    out = io.StringIO()
    with redirect_stdout(out):
        result = launch_train.main(
            ["--device", "cpu", "--steps", "1", "--seq", "32", "--batch",
             "16", "--ckpt-dir", str(tmp_path / "ck")])
    assert joined == [("gloo", "env://")]
    first = out.getvalue().splitlines()[0]
    assert "mesh={'data': 16, 'model': 16}" in first, first
    assert result.final_step == 1
    assert not dist.is_initialized()


def test_launcher_refuses_a_world_without_a_production_mesh(monkeypatch):
    """Without ``--smoke`` a launcher's world of another size than 256 or
    512 raises before any rank joins a group, as the reference does
    without a pod; it never trains each rank alone."""
    _launched(monkeypatch, 8, rank=3)
    monkeypatch.setattr(dist, "init_process_group", None)   # never reached
    with pytest.raises(ValueError, match="the launcher started 8"):
        launch_train.main(["--device", "cpu", "--steps", "1"])
    assert not dist.is_initialized()


def test_launcher_smoke_on_two_launched_ranks(tmp_path):
    """``python -m repro_torch.launch.train --smoke`` on two ranks with the
    environment ``torchrun`` sets (a real ``env://`` rendezvous on
    localhost, gloo): both ranks take the (2, 1) local mesh, log the same
    losses, and those equal a one-process run's within the distributed
    tests' 2e-2."""
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--seq", "32",
            "--batch", "4"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1")
    errs = [tmp_path / f"rank{r}.err" for r in range(2)]
    procs = []
    for r in range(2):
        with open(errs[r], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *args,
                 "--ckpt-dir", str(tmp_path / "ck")],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=err,
                text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o, e in zip(procs, outs, errs):
        assert p.returncode == 0, o + e.read_text()
    lines = [o.strip().splitlines() for o in outs]
    for ls in lines:
        assert "mesh={'data': 2, 'model': 1}" in ls[0], ls[0]
        assert ls[-1].startswith("done: steps=2 restarts=0 loss "), ls[-1]
    assert lines[0][-1] == lines[1][-1]
    out = io.StringIO()
    with redirect_stdout(out):
        one = launch_train.main(args + ["--ckpt-dir", str(tmp_path / "one")])
    assert "mesh={'data': 1, 'model': 1}" in out.getvalue()
    got = [float(x) for x in
           lines[0][-1].split(" loss ")[1].split(" stragglers")[0]
           .split(" -> ")]
    want = [one.metrics_log[0]["loss"], one.metrics_log[-1]["loss"]]
    np.testing.assert_allclose(got, want, rtol=2e-2)
