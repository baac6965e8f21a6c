"""Sharding rules for the production mesh (counterpart of
``repro.sharding``), on a ``torch.distributed`` ``DeviceMesh``.

Axis conventions:
  - ``pod``   : data-parallel replication across pods (multi-pod mesh only)
  - ``data``  : data parallelism (batch / tokens)
  - ``model`` : tensor parallelism (flattened head dims, FFN hidden, vocab,
    experts)

A partition spec is the port's own :class:`P`, one entry per tensor dim:
``None``, an axis name or a tuple of names, as ``jax.sharding.PartitionSpec``
writes it, so ``_RULES`` reads line for line like the reference's.
:func:`to_placements` turns a spec into DTensor placements, one
``Shard(d)``/``Replicate()`` per mesh dim.  A tensor dim sharded over
``("pod", "data")`` has the pod axis as the major one, as in JAX.

The rules read only a mesh's axis names and sizes (:func:`mesh_shape`): a
``DeviceMesh`` with ``mesh_dim_names``, or any object with the reference's
``shape`` dict and ``axis_names``.  A dim the axes do not divide evenly is
sharded the way ``torch.chunk`` splits it (the last ranks hold less), where
JAX pads every shard to the same size; the explicit rules below shard only
divisible dims, so only the layout pins inside the models meet that case.

The layout pins: :func:`constrain` redistributes an activation in the
forward only; :func:`pin` also holds its cotangent to the same layout,
as JAX transposes a ``with_sharding_constraint``.  The residual stream is
pinned after every residual add (:func:`pin_residual`) and holds its
cotangent too, so each layer's backward starts from the residual's
layout, batch-sharded and whole over 'model'.  The one-token decode pins
its residual stream at the same places, so its norms and projections see
the forward's layout on every torch.

:func:`group_all_to_all` and :func:`group_gather` exchange a rank's local
tensor with the few ranks of a process group (the model ranks that hold
one head) where autograd records it, inside a :func:`shard_map` body.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Sequence, Tuple

import torch


class P(tuple):
    """Partition spec: ``P(None, "model")``, ``P(("pod", "data"), None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a reference-like mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def batch_axes(mesh):
    """Axes used for data parallelism (pod axis folded in when present)."""
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    n = shape["data"]
    if "pod" in shape:
        n *= shape["pod"]
    return n


def tp_size(mesh) -> int:
    return mesh_shape(mesh)["model"]


def to_placements(spec: Sequence, mesh) -> tuple:
    """One DTensor placement per mesh dim for ``spec``: ``Shard(d)`` on the
    mesh dims that tensor dim ``d`` names, ``Replicate()`` on the others.
    Names on one tensor dim must follow the mesh's order (major first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} on one dim must "
                             f"follow the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def place(self, x: torch.Tensor):
        """A global tensor (the same on every rank) or a DTensor -> a DTensor
        with this layout."""
        return place(x, self.mesh, self.spec)


def ns(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def batch_spec(mesh, *rest) -> P:
    """Spec with the batch dim sharded over all DP axes."""
    return P(batch_axes(mesh), *rest)


def place(x: torch.Tensor, mesh, spec: Sequence):
    """``jax.device_put`` onto ``NamedSharding(mesh, spec)``: a plain tensor
    holds the global value on every rank and is cut to this rank's shard; a
    DTensor is redistributed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)


def constrain(x, mesh, spec: Sequence):
    """``with_sharding_constraint``: redistribute a DTensor to ``spec``
    (identity without a mesh or on a plain tensor, which lies whole on
    this rank: the one-device path)."""
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    placements = to_placements(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def holds(x, mesh, spec: Sequence) -> bool:
    """Whether the DTensor ``x`` lies on ``spec``'s layout already, so a
    :func:`shard_map` body that takes it there gets ``x``'s own local
    shard (a view of its storage, which an in-place update reaches) and
    not a redistributed copy."""
    from torch.distributed.tensor import DTensor
    return (isinstance(x, DTensor)
            and tuple(x.placements) == _placements(spec, mesh))


def store(dst, src):
    """``dst`` overwritten in place with ``src``, on ``dst``'s own layout
    (a DTensor ``src`` redistributed to it first) -> ``dst``: a donated
    state's form of returning ``src``."""
    from torch.distributed.tensor import DTensor
    if isinstance(dst, DTensor) and isinstance(src, DTensor) and \
            tuple(src.placements) != tuple(dst.placements):
        src = src.redistribute(dst.device_mesh, dst.placements)
    with torch.no_grad():
        return dst.copy_(src)


class _Pin(torch.autograd.Function):
    """:func:`constrain` forward, and on the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        y = constrain(x, mesh, spec)
        return x.view_as(x) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return constrain(g, ctx.mesh, ctx.spec), None, None


def pin(x, mesh, spec: Sequence):
    """:func:`constrain` that also holds the cotangent to ``spec``, as JAX
    constrains the transpose of a ``with_sharding_constraint`` (identity
    without a mesh or on a plain tensor)."""
    from torch.distributed.tensor import DTensor
    if mesh is None or not isinstance(x, DTensor):
        return x
    return _Pin.apply(x, mesh, spec)


def batch_entry(batch: int, mesh):
    """A spec's entry for a batch dim of ``batch`` rows: the data axes
    where they hold more than one rank and divide the batch, else None
    (whole).  On data axes of one rank a shard and a replica hold the same
    rows, and only the whole dim is one that every torch's DTensor flattens
    with the sequence (a ``Shard(0)`` of a batch of 1 it may refuse)."""
    dp = dp_size(mesh)
    return batch_axes(mesh) if dp > 1 and batch % dp == 0 else None


def residual_spec(batch: int, mesh) -> P:
    """A (B, S, d) activation as the reference's compiled program keeps the
    residual stream: the batch over the data axes (:func:`batch_entry`),
    whole over 'model'."""
    return P(batch_entry(batch, mesh), None, None)


def pin_residual(x, mesh):
    """A residual-stream activation pinned to :func:`residual_spec` (a
    row-parallel product's partial sums reduced here), its cotangent too
    (:func:`pin`): the gradient leaves each residual add batch-sharded and
    whole over 'model', as JAX transposes the reference's constraint,
    where DTensor would pass on the layout it came in and reduce-scatter
    and re-gather it in the layer below.  Identity without a mesh or on a
    plain tensor."""
    if mesh is None:
        return x
    return pin(x, mesh, residual_spec(x.shape[0], mesh))


def _placements(spec, mesh) -> tuple:
    """A spec, or a tuple of DTensor placements passed through as they are
    (for a ``Partial`` output, which a spec cannot name)."""
    from torch.distributed.tensor import Placement
    if len(spec) and all(isinstance(p, Placement) for p in spec):
        return tuple(spec)
    return to_placements(spec, mesh)


def with_global_shape(t, shape):
    """Re-wrap a DTensor that ``local_map`` built from an uneven shard (it
    takes every shard for a full one) with its true global ``shape``."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    if tuple(t.shape) == shape:
        return t
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(t.to_local(), t.device_mesh, t.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def with_partial(spec, mesh, axes, reduce_op: str = "sum") -> tuple:
    """``spec``'s placements with ``Partial(reduce_op)`` on the mesh dims
    named in ``axes``: an output each of those ranks holds one term of."""
    from torch.distributed.tensor import Partial
    pl = list(_placements(spec, mesh))
    names = axis_names(mesh)
    for a in axes:
        pl[names.index(a)] = Partial(reduce_op)
    return tuple(pl)


def shard_map(fn, mesh, in_specs, out_specs, out_shapes=None):
    """The reference's ``shard_map`` on ``local_map``: ``fn`` runs on each
    rank's local shards of its DTensor arguments (redistributed to
    ``in_specs`` first; ``None`` for an argument that is not a tensor) and
    its outputs become DTensors with ``out_specs`` (a spec, or a tuple of
    placements such as ``(Shard(0), Partial())``; several outputs take a
    list).  ``out_shapes`` gives the global shapes of outputs whose shards
    may be uneven (``local_map`` would take the local shard for a full one).

    Gradients follow JAX's transpose of ``shard_map``: an input replicated
    over a mesh dim on which some output varies (is sharded or partial)
    gets a partial-sum gradient there (each rank holds its term), otherwise
    the input's own placements."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    in_pl = tuple(None if s is None else _placements(s, mesh)
                  for s in in_specs)
    multi = isinstance(out_specs, list)
    outs = [_placements(s, mesh) for s in (out_specs if multi
                                            else [out_specs])]
    varying = {i for o in outs for i, pl in enumerate(o)
               if not isinstance(pl, Replicate)}
    grad_pl = tuple(
        None if pl is None else tuple(
            Partial() if isinstance(p, Replicate) and i in varying else p
            for i, p in enumerate(pl))
        for pl in in_pl)
    # local_map reads a tuple as one entry per output: one output's
    # placements go in as a list
    out_pl = tuple(outs) if multi else list(outs[0])
    mapped = local_map(fn, out_placements=out_pl, in_placements=in_pl,
                       in_grad_placements=grad_pl, device_mesh=mesh,
                       redistribute_inputs=True)

    def call(*args):
        out = mapped(*args)
        if out_shapes is None:
            return out
        if not multi:
            return with_global_shape(out, out_shapes)
        return tuple(o if s is None else with_global_shape(o, s)
                     for o, s in zip(out, out_shapes))

    return call


@contextlib.contextmanager
def mesh_scope(mesh):
    """Context for model code on DTensors: the plain tensors it makes
    (positions, masks, zero accumulators) join DTensor ops as replicated
    values (``implicit_replication``; the setting is thread state that
    autograd carries into its backward threads).  The previous setting is
    restored on exit, where ``implicit_replication`` would turn it off and
    so end an enclosing scope early.  A no-op without a mesh."""
    if mesh is None:
        yield
        return
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)


def heads_view(t, shape, n_heads: int, mesh=None):
    """``t.reshape(shape)`` between a flat (.., H*D, ..) dim and (.., H, D,
    ..).  On a mesh whose model axis does not divide the ``n_heads`` the
    dim is gathered over 'model' first: DTensor cannot split or flatten an
    uneven shard (JAX pads one)."""
    if mesh is not None and n_heads % tp_size(mesh):
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            t = gather_axis(t, mesh, "model")
    return t.reshape(shape)


def gather_axis(x, mesh, axis: str):
    """A DTensor with mesh dim ``axis`` replicated (an all-gather of what
    it shards there); other mesh dims keep their placements."""
    from torch.distributed.tensor import Replicate
    names = axis_names(mesh)
    return x.redistribute(mesh, [Replicate() if n == axis else p
                                 for n, p in zip(names, x.placements)])


def _c10d():
    return torch.ops._c10d_functional


def _all_to_all(t, group, split_dim: int, cat_dim: int):
    """``t`` cut into the group's size of equal chunks along ``split_dim``,
    chunk i sent to group rank i; the chunks received joined along
    ``cat_dim`` in group-rank order."""
    import torch.distributed as dist
    r = dist.get_world_size(group)
    x = torch.stack(t.chunk(r, split_dim)).contiguous()
    y = _c10d().wait_tensor(_c10d().all_to_all_single(
        x, [1] * r, [1] * r, group.group_name))
    return torch.cat(y.unbind(0), dim=cat_dim)


class _GroupAllToAll(torch.autograd.Function):
    """:func:`_all_to_all`; its backward the inverse exchange."""

    @staticmethod
    def forward(ctx, t, group, split_dim, cat_dim):
        ctx.group, ctx.dims = group, (split_dim, cat_dim)
        return _all_to_all(t, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(g, ctx.group, cat_dim, split_dim), None, None, None


def group_all_to_all(t, group, split_dim: int, cat_dim: int):
    """An all-to-all over a process group of ``t`` (a rank's local tensor)
    that autograd records: ``t`` cut into the group's size of chunks along
    ``split_dim``, chunk i to group rank i, and the chunks each rank
    receives joined along ``cat_dim`` in group-rank order.  The gradient
    runs the inverse exchange."""
    return _GroupAllToAll.apply(t, group, split_dim, cat_dim)


class _GroupGather(torch.autograd.Function):
    """All-gather along ``dim`` over a process group; its backward the
    reduce-scatter (sum) of the gradient along ``dim``."""

    @staticmethod
    def forward(ctx, t, group, dim):
        import torch.distributed as dist
        r = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.r = group, dim, r
        y = _c10d().wait_tensor(_c10d().all_gather_into_tensor(
            t.contiguous(), r, group.group_name))
        return torch.cat(y.chunk(r, 0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        x = torch.cat(g.chunk(ctx.r, ctx.dim), dim=0).contiguous()
        y = _c10d().wait_tensor(_c10d().reduce_scatter_tensor(
            x, "sum", ctx.r, ctx.group.group_name))
        return y, None, None


def group_gather(t, group, dim: int):
    """``t`` (a rank's local tensor) all-gathered along ``dim`` over a
    process group, in group-rank order, where autograd records it: each
    rank's gradient is the group's sum of the gathered gradients at its
    own part (a reduce-scatter)."""
    return _GroupGather.apply(t, group, dim)


def padded_heads(n_heads: int, tp: int) -> int:
    """``n_heads`` padded with zero heads to a multiple of ``tp`` (the
    reference pads uneven head counts on 'model'), so each of ``tp`` model
    ranks holds the same number of whole heads, at least one."""
    return -(-n_heads // tp) * tp


def zero_pad(t, dim: int, n: int, mesh, spec=None):
    """``t`` with ``n`` zeros appended along ``dim``, laid out as ``spec``
    if given.  A DTensor is made whole over 'model' first (a weight or a
    state: DTensor cannot append to an uneven or a misaligned shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = gather_axis(t, mesh, "model")
    shape = list(t.shape)
    shape[dim] = n
    out = torch.cat([t, t.new_zeros(shape)], dim=dim)
    return out if spec is None else constrain(out, mesh, spec)


# ---------------------------------------------------------------------------
# Parameter sharding rules.
#
# Parameters are stored in a flat dict {path: tensor}; the rule is selected
# by path suffix.  Stacked-over-layers params have a leading L dim (never
# sharded).
# ---------------------------------------------------------------------------

_RULES = (
    # (suffix, candidate specs WITHOUT the leading layer-stack dim; first whose
    #  sharded dims divide the model axis wins)
    ("embed/table", (P("model", None),)),          # (V, d) vocab-sharded
    ("lm_head/w", (P(None, "model"),)),            # (d, V)
    ("attn/wq", (P(None, "model"),)),              # (d, H*Dh)
    ("attn/wk", (P(None, "model"),)),              # (d, Hkv*Dh)
    ("attn/wv", (P(None, "model"),)),
    ("attn/wo", (P("model", None),)),              # (H*Dh, d)
    ("attn/bq", (P("model"),)),
    ("attn/bk", (P("model"),)),
    ("attn/bv", (P("model"),)),
    ("mlp/w_gate", (P(None, "model"),)),           # (d, f)
    ("mlp/w_up", (P(None, "model"),)),
    ("mlp/w_down", (P("model", None),)),           # (f, d)
    ("moe/w_gate", (P("model", None, None, None),)),  # (tp_total, E/ep, d, f/tp)
    ("moe/w_up", (P("model", None, None, None),)),
    ("moe/w_down", (P("model", None, None, None),)),
    ("moe/router", (P(),)),                        # (d, E) replicated (tiny)
    ("ssm/w_z", (P(None, "model"),)),              # (d, d_inner)
    ("ssm/w_x", (P(None, "model"),)),
    ("ssm/w_bc", (P(None, "model"),)),             # (d, 2GN)
    ("ssm/w_dt", (P(),)),                          # (d, H) tiny: replicate
    ("ssm/w_out", (P("model", None),)),            # (d_inner, d)
    ("ssm/conv", (P(None, "model"),)),             # (K, conv_dim)
    ("ssm/A_log", (P("model"),)),                  # (H,) if H % 16 == 0
    ("ssm/D", (P("model"),)),
    ("ssm/dt_bias", (P("model"),)),
    ("ssm/norm_w", (P("model"),)),
    ("cross/wq", (P(None, "model"),)),
    ("cross/wk", (P(None, "model"),)),
    ("cross/wv", (P(None, "model"),)),
    ("cross/wo", (P("model", None),)),
)


def param_spec(path: str, shape: Sequence[int], mesh, stacked: bool = True) -> P:
    """Spec for parameter ``path`` with given global ``shape``.

    Falls back to replication when no candidate's sharded dim divides the
    model-axis size (the reference's jax rejects uneven explicit
    shardings)."""
    tp = tp_size(mesh)
    for suffix, specs in _RULES:
        if not path.endswith(suffix):
            continue
        for spec in specs:
            parts = list(spec)
            lead = 1 if (stacked and len(shape) == len(parts) + 1) else 0
            parts = [None] * lead + parts
            if len(parts) != len(shape):
                continue  # rank mismatch: try next candidate
            if all(ax != "model" or shape[i] % tp == 0 for i, ax in enumerate(parts)):
                return P(*parts)
        return P()  # no candidate fits: replicate (small tensors only)
    return P()  # norms, biases, scales: replicated


def param_sharding(params: dict, mesh, stacked: bool = True) -> dict:
    return {
        k: NamedSharding(mesh, param_spec(k, v.shape, mesh, stacked=stacked))
        for k, v in params.items()
    }


def opt_state_spec(path: str, shape: Sequence[int], mesh) -> P:
    """ZeRO-1: moments additionally sharded over ``data`` on the largest
    even-divisible dim not already sharded by the param rule."""
    base = param_spec(path, shape, mesh, stacked=True)
    parts = list(base) + [None] * (len(shape) - len(base))
    dsz = mesh_shape(mesh)["data"]
    # pick the largest dim that is free and divides the data axis
    cands = [i for i, ax in enumerate(parts) if ax is None and shape[i] % dsz == 0]
    if cands:
        i = max(cands, key=lambda i: shape[i])
        parts[i] = "data"
    return P(*parts)


def place_tree(tree, shardings):
    """``jax.device_put(tree, shardings)`` over dicts and NamedTuples: each
    tensor onto the :class:`NamedSharding` at its place in ``shardings``
    (a plain tensor holds the global value on every rank).  A leaf whose
    sharding is None, or that is not a tensor (a decode state's host
    index), stays as it is."""
    if isinstance(tree, dict):
        return {k: place_tree(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(place_tree(v, s)
                            for v, s in zip(tree, shardings)))
    if isinstance(tree, torch.Tensor) and shardings is not None:
        return shardings.place(tree)
    return tree
