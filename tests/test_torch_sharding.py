"""The port's sharding rules against the reference's (``repro.sharding``).

The reference's rules read only a mesh's ``shape`` and ``axis_names``, so a
``SimpleNamespace`` with those stands in for a JAX mesh on both sides.  For
every parameter of all ten archs (``param_shapes`` at ``tp_total`` 1 and
16, ``max_seq`` 4096) and the meshes (16, 16), (2, 16, 16), (2, 4) and
(1, 1): ``param_spec`` and ``opt_state_spec`` equal the reference's, entry
for entry; ``batch_axes``/``dp_size``/``tp_size`` agree;
``to_placements`` gives the local shapes that
``NamedSharding(AbstractMesh, spec).shard_shape`` gives (on a
``DeviceMesh`` over the fake process group, rank 0); and
``decode_state_shardings`` agrees spec for spec.
"""
import types

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from repro import sharding as j_sharding
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.models import encdec as j_encdec
from repro.models import transformer as j_transformer
from repro.models.params import param_shapes as j_param_shapes
from repro.runtime import serve as j_serve

from repro_torch import sharding
from repro_torch.launch.mesh import compat_make_mesh
from repro_torch.models import encdec, transformer
from repro_torch.runtime import serve

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}


def _ns(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)


def _tuple(spec):
    """A spec as a plain tuple; one axis in a tuple is that axis (JAX's
    ``PartitionSpec`` writes ``("data",)`` as ``"data"``)."""
    def entry(e):
        if isinstance(e, (list, tuple)):
            return e[0] if len(e) == 1 else tuple(e)
        return e
    return tuple(entry(e) for e in spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("tp_total", [1, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_state_specs_match_reference(arch, tp_total, mesh):
    m = _ns(mesh)
    shapes = j_param_shapes(j_get_config(arch), max_seq=4096,
                            tp_total=tp_total)
    assert shapes
    for path, shape in shapes.items():
        want = j_sharding.param_spec(path, shape, m)
        got = sharding.param_spec(path, shape, m)
        assert isinstance(got, sharding.P)
        assert _tuple(got) == _tuple(want), (path, shape, got, want)
        assert _tuple(sharding.opt_state_spec(path, shape, m)) == _tuple(
            j_sharding.opt_state_spec(path, shape, m)), (path, shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_axes_match_reference(mesh):
    m = _ns(mesh)
    assert sharding.batch_axes(m) == j_sharding.batch_axes(m)
    assert sharding.dp_size(m) == j_sharding.dp_size(m)
    assert sharding.tp_size(m) == j_sharding.tp_size(m)
    assert _tuple(sharding.batch_spec(m, None)) == _tuple(
        j_sharding.batch_spec(m, None))


@pytest.fixture
def fake_mesh():
    """A ``DeviceMesh`` of a given shape over the fake process group (no
    collective runs), torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(name, rank=0):
        shape, axes = MESHES[name]
        n = 1
        for s in shape:
            n *= s
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=n)
        return compat_make_mesh(shape, axes)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_to_placements_gives_the_reference_shard_shapes(fake_mesh, mesh):
    """Every parameter and moment spec of all ten archs (tp_total 16) and
    the batch specs: the rank-0 local shape of ``to_placements`` on the
    DeviceMesh == ``shard_shape`` on the reference's abstract mesh."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, axes = MESHES[mesh]
    dm = fake_mesh(mesh)
    jm = AbstractMesh(shape, axes)
    m = _ns(mesh)
    cases = [(sharding.batch_spec(m, None), (512, 4096)),
             (sharding.batch_spec(m, None, "model"), (64, 32, 1024))]
    for arch in ARCH_IDS:
        for path, pshape in j_param_shapes(j_get_config(arch), max_seq=4096,
                                           tp_total=16).items():
            cases.append((sharding.param_spec(path, pshape, m), pshape))
            cases.append((sharding.opt_state_spec(path, pshape, m), pshape))
    for spec, gshape in cases:
        local, _ = compute_local_shape_and_global_offset(
            gshape, dm, sharding.to_placements(spec, dm))
        want = JNamedSharding(jm, JP(*spec)).shard_shape(tuple(gshape))
        assert tuple(local) == tuple(want), (spec, gshape, local, want)


def test_to_placements_puts_the_pod_axis_major(fake_mesh):
    """``("pod", "data")`` on one dim: Shard on both mesh dims, the pod
    offset the major one: rank 16 (pod 0, data 1) holds rows 2-3 of 64,
    the 2nd of 32 row blocks (data major would give it the 3rd)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dm = fake_mesh("2x16x16", rank=16)
    assert tuple(dm.get_coordinate()) == (0, 1, 0)
    pl = sharding.to_placements(sharding.P(("pod", "data"), "model"), dm)
    assert pl == (Shard(0), Shard(0), Shard(1))
    assert sharding.to_placements(sharding.P(), dm) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(sharding.P(("data", "pod")), dm)
    local, off = compute_local_shape_and_global_offset((64, 32), dm, pl)
    assert tuple(local) == (2, 2) and tuple(off) == (2, 0)


def _state_of(arch):
    """The reference's abstract decode state and the port's state of the
    same shapes (meta tensors)."""
    cfg = j_get_config(arch)
    if cfg.family == "audio":
        js = j_encdec.abstract_decode_state(cfg, 8, 4096)
        cls = encdec.EncDecDecodeState
    else:
        js = j_transformer.abstract_decode_state(cfg, 8, 4096)
        cls = transformer.DecodeState
    ts = cls(*(None if x is None else
               (0 if x.ndim == 0 else torch.empty(x.shape, device="meta"))
               for x in js))
    return cfg, js, ts


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_state_shardings_match_reference(arch, mesh):
    shape, axes = MESHES[mesh]
    cfg, js, ts = _state_of(arch)
    want = j_serve.decode_state_shardings(cfg, js, AbstractMesh(shape, axes))
    got = serve.decode_state_shardings(cfg, ts, _ns(mesh))
    assert type(got) is type(ts)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert _tuple(g.spec) == _tuple(w.spec), (g.spec, w.spec)
