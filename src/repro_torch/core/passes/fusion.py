"""Conv + BatchNormalization (+ Relu) fusion pass (counterpart of
``repro.core.passes.fusion``; the BN fold runs in numpy exactly as there).

Folds inference-mode BatchNormalization into the preceding Conv's Weight/Bias
actors and absorbs a trailing Relu, emitting a single ``FusedConv`` node —
the standard graph-level optimization for streaming accelerators (one actor,
one FIFO hop, no BN multiplier in the datapath).

The paper's CNN interleaves a MaxPool between the Conv and the BN
(``Conv -> MaxPool -> BN -> Relu``).  BN is a per-channel affine
``z = inv * y + c`` with ``inv = scale / sqrt(var + eps)``; an affine with
``inv > 0`` commutes with the per-channel max window, so the pass also fuses
*across* a single interposed MaxPool:

    BN(Pool(Conv(x))) = Pool(inv * Conv(x) + c) = Pool(FusedConv(x))
    Relu(Pool(y))     = Pool(Relu(y))                    (Relu is monotone)

guarded by an explicit ``inv > 0`` check per channel (negative BN scales fall
back to the unfused form).  All intermediate FIFOs must have exactly one
consumer and must not be graph outputs.

:func:`fuse_gemm_relu` is the MLP-topology analogue (Table I): a ``Gemm``
whose single consumer is a ``Relu`` becomes one ``FusedGemm`` actor, so the
fully-connected stack reaches the fused kernel epilogue (bias + ReLU +
activation quant in-VMEM) the same way FusedConv does.

``DepthwiseConv`` chains fuse identically (BN's per-channel affine
broadcasts over the HWIO depthwise weight's last dim), emitting
``FusedDepthwiseConv``.  :func:`reorder_relu_maxpool` is the remaining
window-commutation rewrite: leftover ``Relu -> MaxPool`` chains swap so the
inter-actor FIFO carries the pooled tensor.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional

import numpy as np

from repro_torch.core.ir import Graph, Node


def _single_consumer(graph: Graph, tensor: str) -> Optional[Node]:
    if tensor in set(graph.outputs):
        return None
    cs = graph.consumer_index().get(tensor, [])
    return cs[0] if len(cs) == 1 else None


def fuse_gemm_relu(graph: Graph) -> Graph:
    """Fold ``Gemm -> Relu`` chains into single ``FusedGemm`` nodes.

    Pure graph surgery (no weight rewrite): the FusedGemm keeps the Gemm's
    inputs and name, takes the Relu's output tensor, and records the fold in
    ``attrs["relu"]`` / ``attrs["fused_from"]`` — the same contract FusedConv
    uses, so every writer's fused-epilogue machinery applies unchanged."""
    drop = set()
    fused: Dict[str, Node] = {}
    for gemm in graph.nodes:
        if gemm.op != "Gemm":
            continue
        relu = _single_consumer(graph, gemm.outputs[0])
        if relu is None or relu.op != "Relu":
            continue
        attrs = dict(gemm.attrs)
        attrs["relu"] = True
        attrs["fused_from"] = [relu.name]
        fused[gemm.name] = Node("FusedGemm", gemm.name, list(gemm.inputs),
                                [relu.outputs[0]], attrs,
                                dtconfig=gemm.dtconfig)
        drop.add(relu.name)
    if not fused:
        return graph
    nodes = [fused.get(n.name, n) for n in graph.nodes if n.name not in drop]
    g = Graph(graph.name, nodes, graph.inputs, graph.outputs,
              graph.initializers)
    g.validate()
    return g


def reorder_relu_maxpool(graph: Graph) -> Graph:
    """Swap ``Relu -> MaxPool`` chains into ``MaxPool -> Relu``.

    Relu is monotone, so it commutes with the per-channel max window —
    ``Pool(Relu(x)) == Relu(Pool(x))`` elementwise.  Pooling first shrinks
    the tensor the Relu actor (and the FIFO feeding it) carries by the pool
    window's area, and leaves the Relu adjacent to whatever consumes it —
    where the Conv/Gemm fusion passes can claim it.  Runs after the fusion
    passes so it only reorders chains those passes left behind."""
    swaps: Dict[str, Node] = {}       # node name -> replacement
    for relu in graph.nodes:
        if relu.op != "Relu":
            continue
        pool = _single_consumer(graph, relu.outputs[0])
        if pool is None or pool.op != "MaxPool":
            continue
        pre = f"{pool.name}_pre_relu"
        # the pool moves to the Relu's slot (consuming its input), the Relu
        # to the pool's slot (producing its output) — topo order preserved
        swaps[relu.name] = Node("MaxPool", pool.name, [relu.inputs[0]], [pre],
                                dict(pool.attrs), dtconfig=pool.dtconfig)
        swaps[pool.name] = Node("Relu", relu.name, [pre], [pool.outputs[0]],
                                dict(relu.attrs), dtconfig=relu.dtconfig)
    if not swaps:
        return graph
    g = Graph(graph.name, [swaps.get(n.name, n) for n in graph.nodes],
              graph.inputs, graph.outputs, graph.initializers)
    g.validate()
    return g


def fuse_conv_bn_relu(graph: Graph) -> Graph:
    inits = dict(graph.initializers)
    drop = set()                      # node names removed by fusion
    fused: Dict[str, Node] = {}       # conv name -> FusedConv replacement
    pool_rewire: Dict[str, str] = {}  # pool name -> new output tensor name

    for conv in graph.nodes:
        if conv.op not in ("Conv", "DepthwiseConv"):
            continue
        nxt = _single_consumer(graph, conv.outputs[0])
        pool = None
        if nxt is not None and nxt.op == "MaxPool":
            pool = nxt
            nxt = _single_consumer(graph, pool.outputs[0])
        if nxt is None or nxt.op != "BatchNormalization":
            continue
        bn = nxt
        stats = [inits.get(i) for i in bn.inputs[1:5]]
        if any(s is None for s in stats):
            continue  # BN stats must be compile-time constants
        scale, bias, mean, var = (np.asarray(s, np.float64) for s in stats)
        eps = bn.attrs.get("epsilon", 1e-5)
        inv = scale / np.sqrt(var + eps)
        if pool is not None and not np.all(inv > 0):
            continue  # negative BN scale does not commute with MaxPool
        # the fold rescales W/b in place, so they must be private to this conv
        # (tied weights would corrupt the sharing node)
        if any(len(graph.consumers_of(t)) != 1 for t in conv.inputs[1:]):
            continue
        relu = _single_consumer(graph, bn.outputs[0])
        if relu is not None and relu.op != "Relu":
            relu = None
        tail = relu if relu is not None else bn

        # fold BN into the Weight/Bias actors (HWIO: out-channel is last dim)
        wname = conv.inputs[1]
        w = np.asarray(inits[wname])
        inits[wname] = (np.asarray(w, np.float64) * inv).astype(w.dtype)
        shift = bias - mean * inv
        if len(conv.inputs) > 2:
            bname = conv.inputs[2]
            b = np.asarray(inits[bname])
            inits[bname] = (np.asarray(b, np.float64) * inv + shift
                            ).astype(b.dtype)
            fin = list(conv.inputs)
        else:
            bname = f"{conv.name}/fused_bias"
            inits[bname] = shift.astype(w.dtype)
            fin = list(conv.inputs) + [bname]

        attrs = dict(conv.attrs)
        attrs["relu"] = relu is not None
        attrs["fused_from"] = [x.name for x in (bn, relu) if x is not None]
        if pool is None:
            outs = [tail.outputs[0]]
        else:
            outs = [conv.outputs[0]]
            pool_rewire[pool.name] = tail.outputs[0]
        fop = "FusedDepthwiseConv" if conv.op == "DepthwiseConv" else "FusedConv"
        fused[conv.name] = Node(fop, conv.name, fin, outs, attrs,
                                dtconfig=conv.dtconfig)
        drop.add(bn.name)
        if relu is not None:
            drop.add(relu.name)

    if not fused:
        return graph

    new_nodes = []
    for n in graph.nodes:
        if n.name in drop:
            continue
        if n.name in fused:
            new_nodes.append(fused[n.name])
        elif n.name in pool_rewire:
            new_nodes.append(replace(n, outputs=[pool_rewire[n.name]]))
        else:
            new_nodes.append(n)
    g = Graph(graph.name, new_nodes, graph.inputs, graph.outputs, inits)
    g.validate()
    return g
