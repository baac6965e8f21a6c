"""Per-layer precision assignment (counterpart of
``repro.core.passes.precision``).

:func:`make_assign_precision` stamps a
:class:`~repro_torch.quant.qtypes.DatatypeConfig` onto every node
(``Node.dtconfig``) from a uniform config or a
:class:`~repro_torch.quant.qtypes.PrecisionMap`.  The greedy explorer
(``explore_mixed_precision``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, List, Optional

from repro_torch.core.ir import Graph, Node
from repro_torch.quant.qtypes import PrecisionMap

# ops with weight initializers worth exploring per-layer
WEIGHT_OPS = ("Conv", "FusedConv", "DepthwiseConv", "FusedDepthwiseConv",
              "Gemm", "FusedGemm", "MatMul")


def _as_map(dt) -> Optional[PrecisionMap]:
    if dt is None:
        return None
    if isinstance(dt, PrecisionMap):
        return dt
    return PrecisionMap(dt)


def make_assign_precision(dtconfig) -> Callable[[Graph], Graph]:
    """Pass factory: annotate every node with its per-layer datatype.
    ``None`` leaves the graph untouched."""
    pm = _as_map(dtconfig)

    def assign_precision(graph: Graph) -> Graph:
        if pm is None:
            return graph
        nodes = [replace(n, dtconfig=pm.for_node(n.name)) for n in graph.nodes]
        return Graph(graph.name, nodes, graph.inputs, graph.outputs,
                     graph.initializers, graph.value_info)

    return assign_precision


def strip_precision(graph: Graph) -> Graph:
    """Drop every per-node precision annotation (the float view of an
    annotated graph — calibration runs on this)."""
    if all(n.dtconfig is None for n in graph.nodes):
        return graph
    nodes = [replace(n, dtconfig=None) for n in graph.nodes]
    return Graph(graph.name, nodes, graph.inputs, graph.outputs,
                 graph.initializers, graph.value_info)


def quantizable_layers(graph: Graph) -> List[Node]:
    inits = graph.initializers
    return [n for n in graph.topo_order()
            if n.op in WEIGHT_OPS
            and any(i in inits and inits[i].ndim >= 2 for i in n.inputs)]
