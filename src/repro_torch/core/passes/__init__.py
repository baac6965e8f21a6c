"""Pass-based graph compiler for the ONNX-like IR (counterpart of
``repro.core.passes``).

``default_pipeline(dtconfig)``: fuse Conv/DepthwiseConv+BN(+Relu) chains and
Gemm+Relu, reorder leftover Relu->MaxPool chains, fold constants, sweep dead
nodes, infer shapes, assign per-layer precision.  Each pass is a function
``Graph -> Graph``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

from repro_torch.core.ir import Graph
from repro_torch.core.passes.cleanup import eliminate_dead_nodes, fold_constants
from repro_torch.core.passes.fusion import (fuse_conv_bn_relu, fuse_gemm_relu,
                                            reorder_relu_maxpool)
from repro_torch.core.passes.precision import (explore_mixed_precision,
                                               make_assign_precision,
                                               quantizable_layers,
                                               strip_precision)
from repro_torch.core.passes.shape_infer import infer_shapes

GraphPass = Callable[[Graph], Graph]


@dataclass
class PassManager:
    """Runs a pass sequence, validating the graph after each rewrite."""
    passes: Sequence[GraphPass]

    def run(self, graph: Graph) -> Graph:
        for p in self.passes:
            out = p(graph)
            graph = graph if out is None else out
            graph.validate()
        return graph


def default_pipeline(dtconfig=None) -> List[GraphPass]:
    """The standard compile pipeline (see module docstring)."""
    return [*structural_pipeline(), make_assign_precision(dtconfig)]


def structural_pipeline() -> List[GraphPass]:
    """The graph rewrites only (no precision annotation)."""
    return [fuse_conv_bn_relu, fuse_gemm_relu, reorder_relu_maxpool,
            fold_constants, eliminate_dead_nodes, infer_shapes]


__all__ = [
    "GraphPass", "PassManager", "default_pipeline", "structural_pipeline",
    "infer_shapes", "fuse_conv_bn_relu", "fuse_gemm_relu",
    "reorder_relu_maxpool", "fold_constants", "eliminate_dead_nodes",
    "make_assign_precision", "explore_mixed_precision", "quantizable_layers",
    "strip_precision",
]
