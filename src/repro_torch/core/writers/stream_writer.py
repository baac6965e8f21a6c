"""Writer 2: IR -> streaming actor pipeline, target ``"stream"`` (counterpart
of ``repro.core.writers.stream_writer``, the HLS-Writer analogue).

Retargets Conv / FusedConv nodes onto the line-buffer convolution
(``csrc/conv2d_stream.cu`` on the GPU; the paper's Fig. 2 template: Line
Buffer + Conv actor + resident Weight/Bias actors, with the fusion pass's
folded BatchNormalization and a trailing ReluActor) and emits an XDF-style
topology description — the artifact the Multi-Dataflow Composer consumes
(``topology()``).  Every other op resolves as in the float ``torch`` target,
DepthwiseConv included.  Each FIFO in the topology is labelled with the
*consumer actor's* per-layer ``Dx-Wy`` datatype.

FIFO sizing
-----------
Every connection carries a ``depth`` (elements) derived from the producer
tensor's ``Graph.value_info`` annotation — the buffer a streaming
implementation must provision before the consumer can fire:

* **windowed consumers** (Conv / FusedConv / DepthwiseConv /
  FusedDepthwiseConv / MaxPool) use the line-buffer model: ``(kh - 1)`` full
  image rows plus ``kw`` pixels of the NHWC stream, i.e.
  ``(kh - 1) * W * C + kw * C`` elements;
* **matrix consumers** (Gemm / MatMul) need the whole per-item activation
  vector resident before the first MAC, so the depth is the tensor's static
  per-item volume;
* **pointwise consumers** (Relu, BatchNormalization, Softmax, Flatten, ...)
  need one pixel's channel vector in flight.

Depths are multiplied by ``fifo_slack`` (rate-mismatch headroom) and
reported per FIFO in bytes at the consumer's activation precision;
``topology()`` sums them as ``total_fifo_bytes``.  The batch dim never
enters: FIFOs buffer per-item streams, so one sized topology is valid for
any batch.

Actor targets name this package's implementations: ``cuda/conv2d_stream``
for the convs, ``cuda/qconv_dw`` for the depthwise actors (the reference
labels them ``pallas/...``), ``torch`` for the rest.
"""
from __future__ import annotations

import json
import math
from typing import Dict

import torch

from repro_torch.core.ir import Node, TensorInfo, static_elems
from repro_torch.core.passes.shape_infer import infer_shapes
from repro_torch.core.writers.registry import register_op
from repro_torch.core.writers.torch_writer import TorchWriter
from repro_torch.device import DeviceLike
from repro_torch.kernels.conv2d_stream.ops import (conv2d_stream,
                                                   require_stream_window)


@register_op("Conv", target="stream")
def _op_conv_stream(node: Node, env):
    x, w = env[node.inputs[0]], env[node.inputs[1]]
    b = env[node.inputs[2]] if len(node.inputs) > 2 else None
    require_stream_window(node.name, int(w.shape[0]), int(w.shape[1]),
                          node.attrs.get("strides", (1, 1)),
                          node.attrs.get("pads", "SAME"))
    return conv2d_stream(x, w, b)


@register_op("FusedConv", target="stream")
def _op_fused_conv_stream(node: Node, env):
    y = _op_conv_stream(node, env)
    if node.attrs.get("relu"):
        y = torch.relu(y)
    return y


_CONV_OPS = ("Conv", "FusedConv")
# grouped (depthwise) consumers: same line-buffer firing rule as Conv — the
# NHWC stream buffers all C channels per pixel regardless of grouping
_DW_OPS = ("DepthwiseConv", "FusedDepthwiseConv")
# consumers whose firing rule needs a sliding window of the input stream
_WINDOWED_OPS = _CONV_OPS + _DW_OPS + ("MaxPool",)
# consumers that reduce over the whole per-item activation vector
_MATRIX_OPS = ("Gemm", "FusedGemm", "MatMul")


class StreamWriter(TorchWriter):
    """The streaming target on ``device`` (default ``"cuda"``);
    ``fifo_slack`` scales every derived FIFO depth."""

    target = "stream"

    def __init__(self, graph, dtconfig=None, act_ranges=None, *,
                 device: DeviceLike = None, fifo_slack: float = 1.0):
        super().__init__(graph, dtconfig, act_ranges, device=device)
        if fifo_slack <= 0:
            raise ValueError(f"fifo_slack must be positive, got {fifo_slack}")
        self.fifo_slack = float(fifo_slack)

    # ---- FIFO sizing (value_info-driven) ----------------------------------
    def _tensor_info(self, tensor: str) -> TensorInfo:
        if tensor not in self.graph.value_info:
            infer_shapes(self.graph)
        return self.graph.value_info[tensor]

    def fifo_depth(self, tensor: str, consumer: Node) -> int:
        """Elements the FIFO feeding ``consumer`` must hold (before slack)."""
        shape = self._tensor_info(tensor).shape
        if consumer.op in _WINDOWED_OPS and len(shape) >= 4:
            ks = consumer.attrs.get("kernel_shape")
            if ks is None:
                # Conv may omit kernel_shape; the window is the weight's HW
                ks = self.graph.initializers[consumer.inputs[1]].shape[:2]
            kh, kw = (int(k) for k in ks)
            w, c = int(shape[-2]), int(shape[-1])
            depth = (kh - 1) * w * c + kw * c
        elif consumer.op in _MATRIX_OPS:
            # per-item volume: the leading dim is the batch whether symbolic
            # or pinned — FIFOs buffer one item's stream
            depth = static_elems(shape[1:])
        else:
            depth = int(shape[-1])
        return max(1, math.ceil(depth * self.fifo_slack))

    # ---- dataflow topology (XDF analogue) ---------------------------------
    def topology(self) -> Dict:
        """Actors + sized FIFO connections of the streaming accelerator."""
        order = self.graph.topo_order()
        producers = self.graph.producer_index()
        input_names = {t.name for t in self.graph.inputs}
        actors = []
        for n in order:
            is_conv = n.op in _CONV_OPS
            is_dw = n.op in _DW_OPS
            if is_conv:
                target = "cuda/conv2d_stream"
            elif is_dw:
                target = "cuda/qconv_dw"
            else:
                target = "torch"
            actor = {"name": n.name, "class": n.op, "target": target}
            if is_conv or is_dw:
                w = self.graph.initializers[n.inputs[1]]
                # the depthwise actor MACs each channel against its own taps
                # straight out of the line buffer — no patch/im2col stage
                sub = ["LineBuffer",
                       "DepthwiseActor" if is_dw else "ConvActor",
                       "WeightActor", "BiasActor"]
                if n.attrs.get("relu"):
                    sub.append("ReluActor")
                actor["sub_actors"] = sub
                actor["weight_shape"] = [int(d) for d in w.shape]
                if n.op in ("FusedConv", "FusedDepthwiseConv"):
                    actor["fused"] = n.attrs.get("fused_from", [])
            actors.append(actor)
        conns = []
        fifo_id = 0          # global counter: ids must be unique network-wide
        total_bytes = 0
        for n in order:
            dt = self.node_dt(n)
            for i in n.inputs:
                if i in producers:
                    src = producers[i].name
                elif i in input_names:
                    src = "input"
                else:
                    continue  # weight/bias initializers are not FIFOs
                depth = self.fifo_depth(i, n)
                depth_bytes = math.ceil(depth * dt.act_bits / 8)
                total_bytes += depth_bytes
                conns.append({"fifo": f"f{fifo_id}", "tensor": i,
                              "src": src, "dst": n.name,
                              "depth": depth, "depth_bytes": depth_bytes,
                              "datatype": f"D{dt.act_bits}-W{dt.weight_bits}"})
                fifo_id += 1
        return {"network": self.graph.name, "actors": actors,
                "connections": conns, "fifo_slack": self.fifo_slack,
                "total_fifo_bytes": total_bytes}

    def save_topology(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.topology(), f, indent=1)
