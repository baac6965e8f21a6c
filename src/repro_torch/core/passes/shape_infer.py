"""Shape/dtype inference pass (counterpart of ``repro.core.passes.shape_infer``).

Statically annotates every FIFO tensor in the graph (``Graph.value_info``)
with its shape and dtype.  The streaming writers size line buffers and FIFO
depths from these annotations, and the distributed writer derives output
sharding specs, so inference must agree exactly with what the executables
produce — ``tests/test_passes.py`` checks inferred vs. executed shapes.

The leading (batch) dim may be the symbolic :data:`repro_torch.core.ir.BATCH`
marker; every rule propagates it untouched, so a batch-polymorphic graph gets
fully-static *per-item* annotations (spatial dims, channels) — exactly the
part FIFO sizing needs — while the executable stays free over the batch.
"""
from __future__ import annotations

import math
from itertools import zip_longest
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.ir import (BATCH, Dim, Graph, Node, TensorInfo, has_symbolic,
                           is_symbolic, static_elems)

Shape = Tuple[Dim, ...]

_RULES: Dict[str, Callable] = {}


def _rule(op: str):
    def deco(fn):
        _RULES[op] = fn
        return fn
    return deco


def _conv_spatial(size: int, k: int, s: int, pads, axis: int) -> int:
    if pads == "SAME":
        return math.ceil(size / s)
    if pads == "VALID":
        return (size - k) // s + 1
    # ONNX explicit pads [t, l, b, r]: axis 0 (H) -> t+b, axis 1 (W) -> l+r
    total = pads[axis] + pads[axis + len(pads) // 2]
    return (size + total - k) // s + 1


@_rule("Conv")
@_rule("FusedConv")
def _shape_conv(node: Node, ins: List[Shape]) -> List[Shape]:
    x, w = ins[0], ins[1]                      # NHWC, HWIO
    if int(node.attrs.get("group", 1)) != 1:
        raise ValueError(
            f"node {node.name}: grouped Conv must be normalized before "
            "inference (reader.normalize_groups rewrites depthwise groups "
            "to DepthwiseConv)")
    kh, kw = node.attrs.get("kernel_shape", w[:2])
    sh, sw = node.attrs.get("strides", (1, 1))
    pads = node.attrs.get("pads", "SAME")
    return [(x[0], _conv_spatial(x[1], kh, sh, pads, 0),
             _conv_spatial(x[2], kw, sw, pads, 1), w[3])]


@_rule("DepthwiseConv")
@_rule("FusedDepthwiseConv")
def _shape_depthwise(node: Node, ins: List[Shape]) -> List[Shape]:
    x, w = ins[0], ins[1]                      # NHWC, HWIO (kh, kw, 1, C)
    if int(w[2]) != 1:
        raise ValueError(
            f"node {node.name}: depthwise weights must be (kh, kw, 1, C), "
            f"got {tuple(w)}")
    if not is_symbolic(x[3]) and int(x[3]) != int(w[3]):
        raise ValueError(
            f"node {node.name}: depthwise channel mismatch — input has "
            f"{x[3]} channels, weights {w[3]}")
    kh, kw = node.attrs.get("kernel_shape", w[:2])
    sh, sw = node.attrs.get("strides", (1, 1))
    pads = node.attrs.get("pads", "SAME")
    return [(x[0], _conv_spatial(x[1], kh, sh, pads, 0),
             _conv_spatial(x[2], kw, sw, pads, 1), w[3])]


@_rule("MaxPool")
def _shape_maxpool(node: Node, ins: List[Shape]) -> List[Shape]:
    x = ins[0]
    k = tuple(node.attrs["kernel_shape"])
    s = tuple(node.attrs.get("strides", k))
    # reduce_window with VALID padding
    return [(x[0], (x[1] - k[0]) // s[0] + 1, (x[2] - k[1]) // s[1] + 1, x[3])]


@_rule("BatchNormalization")
@_rule("Relu")
@_rule("Softmax")
@_rule("Identity")
def _shape_elementwise(node: Node, ins: List[Shape]) -> List[Shape]:
    return [ins[0]]


@_rule("Gemm")
@_rule("FusedGemm")
@_rule("MatMul")
def _shape_matmul(node: Node, ins: List[Shape]) -> List[Shape]:
    x, w = ins[0], ins[1]
    return [(*x[:-1], w[-1])]


@_rule("Add")
def _shape_add(node: Node, ins: List[Shape]) -> List[Shape]:
    # numpy-style broadcast extended with the symbolic batch dim: BATCH
    # broadcasts with itself and with 1, never with a concrete size > 1.
    out: List[Dim] = []
    for a, b in zip_longest(reversed(ins[0]), reversed(ins[1]), fillvalue=1):
        if a == b or b == 1:
            out.append(a)
        elif a == 1:
            out.append(b)
        elif is_symbolic(a) or is_symbolic(b):
            raise ValueError(
                f"node {node.name}: cannot broadcast symbolic dim against "
                f"concrete size ({a} vs {b})")
        else:
            out.append(int(np.broadcast_shapes((a,), (b,))[0]))
    return [tuple(reversed(out))]


@_rule("Flatten")
def _shape_flatten(node: Node, ins: List[Shape]) -> List[Shape]:
    x = ins[0]
    return [(x[0], int(np.prod([int(d) for d in x[1:]])))]


@_rule("Reshape")
def _shape_reshape(node: Node, ins: List[Shape]) -> List[Shape]:
    target = list(node.attrs["shape"])
    if -1 not in target and has_symbolic(ins[0]):
        raise ValueError(
            f"node {node.name}: reshape of a batch-polymorphic tensor needs "
            f"a -1 wildcard to carry the symbolic batch (got {target})")
    if -1 in target:
        known = int(np.prod([d for d in target if d != -1]))
        if has_symbolic(ins[0]):
            # the -1 slot absorbs the symbolic batch; per-item volume must
            # already be covered by the concrete target dims
            if static_elems(ins[0]) != known:
                raise ValueError(
                    f"node {node.name}: reshape of a batch-polymorphic tensor "
                    "must keep the per-item volume in concrete dims "
                    f"({static_elems(ins[0])} != {known})")
            target[target.index(-1)] = BATCH
        else:
            target[target.index(-1)] = int(np.prod(ins[0])) // max(known, 1)
    return [tuple(target)]


@_rule("Split")
def _shape_split(node: Node, ins: List[Shape]) -> List[Shape]:
    x = list(ins[0])
    axis = node.attrs.get("axis", -1)
    if is_symbolic(x[axis]):
        raise ValueError(f"node {node.name}: cannot Split the symbolic "
                         "batch dim")
    x[axis] = x[axis] // len(node.outputs)
    return [tuple(x)] * len(node.outputs)


def infer_shapes(graph: Graph) -> Graph:
    """Annotate ``graph.value_info`` for every tensor; returns the graph."""
    vi: Dict[str, TensorInfo] = {}
    for t in graph.inputs:
        vi[t.name] = TensorInfo(t.name, tuple(t.shape), t.dtype)
    for k, v in graph.initializers.items():
        vi[k] = TensorInfo(k, tuple(v.shape), str(v.dtype))
    for n in graph.topo_order():
        ins = [tuple(vi[i].shape) for i in n.inputs]
        dtype = vi[n.inputs[0]].dtype if n.inputs else "float32"
        shapes = _RULES[n.op](n, ins)
        for oname, shape in zip(n.outputs, shapes):
            vi[oname] = TensorInfo(
                oname, tuple(d if is_symbolic(d) else int(d) for d in shape),
                dtype)
    graph.value_info = vi
    return graph
