"""Constant folding and dead-node elimination passes (counterpart of
``repro.core.passes.cleanup``).  Folding evaluates nodes with the port's own
op registry on host tensors."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.ir import Graph, Node
from repro_torch.device import as_tensor, to_numpy

# ops whose folding would materialize large new tensors for no win
_NO_FOLD = {"Conv", "FusedConv"}


def fold_constants(graph: Graph) -> Graph:
    """Evaluate nodes whose inputs are all compile-time constants
    (initializers) with the reference op implementations and promote their
    outputs to initializers.  The now-dead nodes are left for
    :func:`eliminate_dead_nodes` to sweep."""
    from repro_torch.core.writers.registry import resolve

    inits = dict(graph.initializers)
    new_nodes: List[Node] = []
    for n in graph.topo_order():
        foldable = (n.op not in _NO_FOLD and n.inputs
                    and all(i in inits for i in n.inputs))
        if not foldable:
            new_nodes.append(n)
            continue
        env = {i: as_tensor(np.asarray(inits[i])) for i in n.inputs}
        y = resolve(n.op, "torch")(n, env)
        outs = y if isinstance(y, tuple) else (y,)
        for oname, oval in zip(n.outputs, outs):
            inits[oname] = to_numpy(oval)
    if len(new_nodes) == len(graph.nodes):
        return graph
    g = Graph(graph.name, new_nodes, graph.inputs, graph.outputs, inits)
    g.validate()
    return g


def eliminate_dead_nodes(graph: Graph) -> Graph:
    """Drop nodes (and initializers) that cannot reach a graph output —
    e.g. the BN statistics left behind by the fusion pass."""
    needed = set(graph.outputs)
    keep: List[Node] = []
    for n in reversed(graph.topo_order()):
        if any(o in needed for o in n.outputs):
            keep.append(n)
            needed.update(n.inputs)
    keep.reverse()
    inits: Dict[str, np.ndarray] = {k: v for k, v in graph.initializers.items()
                                    if k in needed}
    if len(keep) == len(graph.nodes) and len(inits) == len(graph.initializers):
        return graph
    g = Graph(graph.name, keep, graph.inputs, graph.outputs, inits)
    g.validate()
    return g
