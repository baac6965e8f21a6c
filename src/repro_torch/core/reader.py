"""The Reader half of the ONNXParser (counterpart of ``repro.core.reader``):
builds the IR from model descriptions.

Sources supported:
  * ONNX-shaped JSON (+ npz weights)              — ``read_json`` / ``read_file``
  * the paper's CNN (repro_torch.models.cnn params) — ``cnn_to_ir``
  * a generic MLP description                     — ``mlp_to_ir``

Every reader runs the shape-inference pass on the graph it produces, so a
freshly read IR already carries ``value_info`` annotations for downstream
passes and writers (further rewrites re-infer as part of the pipeline).

By default the graph input's leading dim is the *symbolic* batch marker
(:data:`repro_torch.core.ir.BATCH`), so one compiled artifact serves any request
size — pass ``batch=<int>`` to pin a literal batch (the pre-polymorphism
behaviour, still used when lowering ahead-of-time for a fixed shape).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.mnist_cnn import CNNConfig
from repro_torch.configs.separable_cnn import SeparableCNNConfig
from repro_torch.core.ir import BATCH, Dim, Graph, Node, TensorInfo
from repro_torch.core.passes.shape_infer import infer_shapes
from repro_torch.device import to_numpy


def normalize_groups(graph: Graph) -> Graph:
    """Rewrite ONNX grouped Convs into the IR's explicit ops.

    ``group == 1`` (or absent) stays a plain Conv (the attribute is dropped);
    ``group == C`` with HWIO weights (kh, kw, 1, C) becomes DepthwiseConv —
    the form the direct Pallas kernel consumes.  Anything between (grouped
    but not depthwise) has no lowering here and is rejected up front rather
    than miscompiled downstream.
    """
    for node in graph.nodes:
        if node.op != "Conv" or "group" not in node.attrs:
            continue
        group = int(node.attrs["group"])
        if group == 1:
            del node.attrs["group"]
            continue
        w = graph.initializers.get(node.inputs[1])
        if w is None:
            raise ValueError(
                f"grouped Conv '{node.name}' needs an initializer weight to "
                f"normalize (input '{node.inputs[1]}' is activation-fed)")
        if w.ndim != 4 or w.shape[2] != 1 or w.shape[3] != group:
            raise ValueError(
                f"Conv '{node.name}' with group={group} is not depthwise "
                f"(weights {tuple(w.shape)}, expected (kh, kw, 1, {group})); "
                f"general grouped conv has no lowering")
        node.op = "DepthwiseConv"
        del node.attrs["group"]
    return graph


def read_json(text: str, weights: Optional[Dict[str, np.ndarray]] = None) -> Graph:
    return infer_shapes(normalize_groups(Graph.from_json(text, weights)))


def read_file(path: str) -> Graph:
    return infer_shapes(normalize_groups(Graph.load(path)))


def cnn_to_ir(cfg: CNNConfig, params: Dict[str, np.ndarray],
              batch: Optional[int] = None) -> Graph:
    """The paper's 2-conv-block + FC MNIST classifier as an IR graph.

    Layout is NHWC; Conv weights HWIO (converted by the writers as needed).
    ``batch=None`` (default) records the symbolic batch dim — the compiled
    executable then serves any leading-dim size from one artifact.
    """
    h, w = cfg.image_hw
    nodes = []
    inits: Dict[str, np.ndarray] = {}
    x = "input"
    for i, cout in enumerate(cfg.conv_channels):
        wname, bname = f"conv{i}/w", f"conv{i}/b"
        inits[wname] = to_numpy(params[wname])
        inits[bname] = to_numpy(params[bname])
        nodes.append(Node("Conv", f"conv{i}", [x, wname, bname], [f"conv{i}_out"],
                          {"kernel_shape": [cfg.kernel_size] * 2, "pads": "SAME",
                           "strides": [1, 1]}))
        nodes.append(Node("MaxPool", f"pool{i}", [f"conv{i}_out"], [f"pool{i}_out"],
                          {"kernel_shape": [cfg.pool] * 2, "strides": [cfg.pool] * 2}))
        for stat in ("scale", "bias", "mean", "var"):
            inits[f"bn{i}/{stat}"] = to_numpy(params[f"bn{i}/{stat}"])
        nodes.append(Node("BatchNormalization", f"bn{i}",
                          [f"pool{i}_out", f"bn{i}/scale", f"bn{i}/bias",
                           f"bn{i}/mean", f"bn{i}/var"], [f"bn{i}_out"],
                          {"epsilon": 1e-5}))
        nodes.append(Node("Relu", f"relu{i}", [f"bn{i}_out"], [f"relu{i}_out"]))
        x = f"relu{i}_out"
        h, w = h // cfg.pool, w // cfg.pool
    nodes.append(Node("Flatten", "flatten", [x], ["flat"]))
    inits["fc/w"] = to_numpy(params["fc/w"])
    inits["fc/b"] = to_numpy(params["fc/b"])
    nodes.append(Node("Gemm", "fc", ["flat", "fc/w", "fc/b"], ["logits"]))
    bdim: Dim = BATCH if batch is None else int(batch)
    g = Graph(
        name="mnist-cnn",
        nodes=nodes,
        inputs=[TensorInfo("input", (bdim, cfg.image_hw[0], cfg.image_hw[1],
                                     cfg.in_channels))],
        outputs=["logits"],
        initializers=inits,
    )
    g.validate()
    return infer_shapes(g)


def separable_cnn_to_ir(cfg: SeparableCNNConfig, params: Dict[str, np.ndarray],
                        batch: Optional[int] = None) -> Graph:
    """The MobileNet-style depthwise-separable classifier as an IR graph.

    Conv stem + Relu + MaxPool, then per block DepthwiseConv(3x3, stride) +
    BN + Relu and pointwise Conv(1x1) + BN + Relu, Flatten, Gemm.  The stem's
    Relu -> MaxPool order is the textbook (commutable) one — the reordering
    pass swaps it so the FIFO between them carries the pooled tensor.
    Layout NHWC; depthwise weights HWIO (kh, kw, 1, C).
    """
    k = cfg.kernel_size
    nodes = []
    inits: Dict[str, np.ndarray] = {}
    inits["stem/w"] = to_numpy(params["stem/w"])
    inits["stem/b"] = to_numpy(params["stem/b"])
    nodes.append(Node("Conv", "stem", ["input", "stem/w", "stem/b"],
                      ["stem_out"],
                      {"kernel_shape": [k, k], "pads": "SAME",
                       "strides": [1, 1]}))
    nodes.append(Node("Relu", "stem_relu", ["stem_out"], ["stem_relu_out"]))
    nodes.append(Node("MaxPool", "stem_pool", ["stem_relu_out"], ["pool_out"],
                      {"kernel_shape": [cfg.pool] * 2,
                       "strides": [cfg.pool] * 2}))
    x = "pool_out"
    for i, (cout, stride) in enumerate(cfg.blocks):
        for layer, conv_op, attrs in (
                (f"dw{i}", "DepthwiseConv",
                 {"kernel_shape": [k, k], "pads": "SAME",
                  "strides": [stride, stride]}),
                (f"pw{i}", "Conv",
                 {"kernel_shape": [1, 1], "pads": "VALID",
                  "strides": [1, 1]})):
            inits[f"{layer}/w"] = to_numpy(params[f"{layer}/w"])
            inits[f"{layer}/b"] = to_numpy(params[f"{layer}/b"])
            nodes.append(Node(conv_op, layer, [x, f"{layer}/w", f"{layer}/b"],
                              [f"{layer}_out"], attrs))
            for stat in ("scale", "bias", "mean", "var"):
                inits[f"{layer}_bn/{stat}"] = to_numpy(
                    params[f"{layer}_bn/{stat}"])
            nodes.append(Node("BatchNormalization", f"{layer}_bn",
                              [f"{layer}_out", f"{layer}_bn/scale",
                               f"{layer}_bn/bias", f"{layer}_bn/mean",
                               f"{layer}_bn/var"], [f"{layer}_bn_out"],
                              {"epsilon": 1e-5}))
            nodes.append(Node("Relu", f"{layer}_relu", [f"{layer}_bn_out"],
                              [f"{layer}_relu_out"]))
            x = f"{layer}_relu_out"
    nodes.append(Node("Flatten", "flatten", [x], ["flat"]))
    inits["fc/w"] = to_numpy(params["fc/w"])
    inits["fc/b"] = to_numpy(params["fc/b"])
    nodes.append(Node("Gemm", "fc", ["flat", "fc/w", "fc/b"], ["logits"]))
    bdim: Dim = BATCH if batch is None else int(batch)
    g = Graph(
        name=cfg.name,
        nodes=nodes,
        inputs=[TensorInfo("input", (bdim, cfg.image_hw[0], cfg.image_hw[1],
                                     cfg.in_channels))],
        outputs=["logits"],
        initializers=inits,
    )
    g.validate()
    return infer_shapes(g)


def mlp_to_ir(layer_sizes, params: Dict[str, np.ndarray],
              batch: Optional[int] = None, name: str = "mlp") -> Graph:
    """Fully-connected stack (the HLS4ML comparison topology, Table I).
    ``batch=None`` records the symbolic batch dim (see :func:`cnn_to_ir`)."""
    nodes = []
    inits: Dict[str, np.ndarray] = {}
    x = "input"
    for i in range(len(layer_sizes) - 1):
        wn, bn = f"fc{i}/w", f"fc{i}/b"
        inits[wn], inits[bn] = to_numpy(params[wn]), to_numpy(params[bn])
        out = f"fc{i}_out" if i < len(layer_sizes) - 2 else "logits"
        nodes.append(Node("Gemm", f"fc{i}", [x, wn, bn], [out]))
        if i < len(layer_sizes) - 2:
            nodes.append(Node("Relu", f"relu{i}", [out], [f"relu{i}_out"]))
            x = f"relu{i}_out"
    bdim: Dim = BATCH if batch is None else int(batch)
    g = Graph(name, nodes, [TensorInfo("input", (bdim, layer_sizes[0]))],
              ["logits"], inits)
    g.validate()
    return infer_shapes(g)
