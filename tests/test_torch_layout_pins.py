"""The layout pins of ``repro_torch.sharding`` (no reference counterpart:
JAX's ``with_sharding_constraint`` is one primitive that GSPMD also
applies to the cotangent).

``pin`` is ``constrain`` that also holds the gradient: on a fake (2, 4)
mesh (``torch.testing``'s fake backend, fake tensors) its forward gives
``constrain``'s layout from every layout that comes in, and the gradient
reaching its input has the pinned placements whatever layout the
cotangent came in (``constrain`` passes it on as it comes where the
layout already matched).  ``pin_residual`` lays a (B, S, d) residual out
batch-sharded over the data axes (where they divide the batch) and whole
over 'model' (whole on data axes of one rank, where a shard holds every
row).  Both are the identity without a mesh and on a plain
tensor.  ``pin_residual`` holds its cotangent as ``pin`` does: the
gradient reaching its input is batch-sharded and whole over 'model'
whatever layout the cotangent came in.  On a one-rank gloo mesh the
forward and the gradient of both pins equal the plain tensor's bit for
bit.
"""
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.sharding import (P, constrain, mesh_scope, pin,
                                  pin_residual, place)

# placements on the (data=2, model=4) mesh, by name
LAYOUTS = ("replicated", "batch", "batch_model", "seq_model", "partial")
SPECS = (P("data", None, "model"), P("data", None, None), P(None, None, None))


def _placements(name: str):
    from torch.distributed.tensor import Partial, Replicate, Shard
    return {"replicated": (Replicate(), Replicate()),
            "batch": (Shard(0), Replicate()),
            "batch_model": (Shard(0), Shard(2)),
            "seq_model": (Shard(0), Shard(1)),
            "partial": (Shard(0), Partial())}[name]


def _fake_dtensor(mesh, layout: str, requires_grad: bool = False):
    """A (4, 8, 16) f32 DTensor on ``mesh`` with ``layout`` (under the
    active fake mode)."""
    from torch.distributed.tensor import DTensor, Partial
    pl = _placements(layout)
    if any(isinstance(p, Partial) for p in pl):
        t = DTensor.from_local(torch.empty(2, 8, 16), mesh, pl,
                               run_check=False)
    else:
        t = place(torch.empty(4, 8, 16), mesh, P()).redistribute(mesh, pl)
    return t.detach().requires_grad_(requires_grad)


@pytest.fixture
def fake_mesh():
    """A (data=2, model=4) mesh on a fake group of 8 ranks, under a fake
    mode that takes no real tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with D.fake_group(8):
        mesh = D._make_mesh((2, 4))
        with FakeTensorMode(allow_non_fake_inputs=False), mesh_scope(mesh):
            yield mesh


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_pin_forward_is_constrains(fake_mesh, layout, spec):
    """From every layout, ``pin`` gives ``constrain``'s placements and
    global shape."""
    x = _fake_dtensor(fake_mesh, layout)
    want = constrain(x, fake_mesh, spec)
    got = pin(x, fake_mesh, spec)
    assert tuple(got.placements) == tuple(want.placements)
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("grad_layout", LAYOUTS)
@pytest.mark.parametrize("layout", ["batch", "batch_model"])
def test_pin_holds_the_cotangent(fake_mesh, layout, grad_layout):
    """The gradient reaching ``pin``'s input has the pinned placements,
    whatever layout the cotangent comes in; through ``constrain`` on an
    input whose layout already matches, it keeps the layout it came in."""
    spec = P("data", None, "model")
    want = tuple(_placements("batch_model"))
    x = _fake_dtensor(fake_mesh, layout, requires_grad=True)
    g = _fake_dtensor(fake_mesh, grad_layout)
    (gx,) = torch.autograd.grad(pin(x, fake_mesh, spec), x, g)
    assert tuple(gx.placements) == want
    if layout == "batch_model":
        (free,) = torch.autograd.grad(constrain(x, fake_mesh, spec), x, g)
        assert tuple(free.placements) == tuple(g.placements)


@pytest.mark.parametrize("batch, want", [(4, "batch"), (3, "replicated")])
def test_pin_residual_shards_the_batch_where_the_data_axis_divides_it(
        fake_mesh, batch, want):
    """``P(("data",), None, None)`` for a batch of 4 on data 2; whole for
    a batch of 3, which the data axis does not divide; a partial sum over
    'model' is reduced."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    x = DTensor.from_local(torch.empty(batch, 8, 16), fake_mesh,
                           (Replicate(), Partial()), run_check=False)
    assert tuple(pin_residual(x, fake_mesh).placements) == \
        tuple(_placements(want))


@pytest.mark.parametrize("axes, batch, want", [
    ({"data": 1, "model": 1}, 1, P(None, None, None)),
    ({"data": 1, "model": 1}, 4, P(None, None, None)),
    ({"data": 2, "model": 4}, 2, P(("data",), None, None)),
    ({"data": 2, "model": 4}, 3, P(None, None, None)),
    ({"pod": 2, "data": 16, "model": 16}, 32,
     P(("pod", "data"), None, None)),
], ids=["1x1-batch1", "1x1-batch4", "2x4-batch2", "2x4-batch3",
        "2x16x16-batch32"])
def test_residual_spec_shards_the_batch_over_data_ranks_that_divide_it(
        axes, batch, want):
    """The batch over the data axes where they hold more than one rank and
    divide it, else whole: on data axes of one rank a shard holds every
    row, and a batch of 1 left whole is one every torch's DTensor flattens
    with the sequence."""
    from types import SimpleNamespace
    from repro_torch.sharding import batch_entry, residual_spec
    mesh = SimpleNamespace(shape=axes, axis_names=tuple(axes))
    assert residual_spec(batch, mesh) == want
    assert batch_entry(batch, mesh) == want[0]


@pytest.mark.parametrize("grad_layout", LAYOUTS)
@pytest.mark.parametrize("layout", ["batch", "partial"])
def test_pin_residual_holds_the_cotangent(fake_mesh, layout, grad_layout):
    """The gradient reaching ``pin_residual``'s input (a residual add's
    sum, or a row-parallel product's partial sums) has
    ``residual_spec``'s placements, batch-sharded and whole over 'model',
    whatever layout the cotangent comes in."""
    from repro_torch.sharding import residual_spec, to_placements
    want = to_placements(residual_spec(4, fake_mesh), fake_mesh)
    assert want == _placements("batch")
    x = _fake_dtensor(fake_mesh, layout, requires_grad=True)
    g = _fake_dtensor(fake_mesh, grad_layout)
    (gx,) = torch.autograd.grad(pin_residual(x, fake_mesh), x, g)
    assert tuple(gx.placements) == want


def test_pins_are_the_identity_without_a_mesh_and_on_a_plain_tensor():
    t = torch.randn(2, 3, 4, requires_grad=True)
    assert pin(t, None, P("data", None, "model")) is t
    assert pin_residual(t, None) is t
    with D.fake_group(8):
        mesh = D._make_mesh((2, 4))
        assert pin(t, mesh, P("data", None, "model")) is t


@pytest.fixture
def one_rank_mesh():
    """A (1, 1) mesh on a one-rank gloo group in this process."""
    yield make_local_mesh(device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pins_on_one_rank_are_bit_for_bit(one_rank_mesh, dtype):
    """At (1, 1) the pinned forward and the gradient through ``pin`` and
    ``pin_residual`` equal the plain tensor's bit for bit, from a
    partial-sum residual too."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    mesh = one_rank_mesh
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(2, 5, 8, generator=gen).to(dtype)
    w = torch.randn(2, 5, 8, generator=gen).to(dtype)
    x = a.clone().requires_grad_(True)
    (x * x * w).sum().backward()
    with mesh_scope(mesh):
        d = place(a, mesh, P("data", None, None)).requires_grad_(True)
        y = pin(d * d, mesh, P("data", None, "model"))
        assert torch.equal(y.full_tensor(), a * a)
        (y * place(w, mesh, P("data", None, None))).sum().backward()
        assert torch.equal(d.grad.full_tensor(), x.grad)
        part = DTensor.from_local(a, mesh, (Shard(0), Partial()))
        assert torch.equal(pin_residual(part, mesh).full_tensor(), a)
        r = place(a, mesh, P("data", None, None)).requires_grad_(True)
        y = pin_residual(r * r, mesh)
        assert torch.equal(y.full_tensor(), a * a)
        (y * place(w, mesh, P("data", None, None))).sum().backward()
        assert torch.equal(r.grad.full_tensor(), x.grad)
