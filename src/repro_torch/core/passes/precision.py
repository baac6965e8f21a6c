"""Per-layer precision assignment and greedy mixed-precision exploration
(counterpart of ``repro.core.passes.precision``).

* :func:`make_assign_precision` stamps a
  :class:`~repro_torch.quant.qtypes.DatatypeConfig` onto every node
  (``Node.dtconfig``) from a uniform config or a
  :class:`~repro_torch.quant.qtypes.PrecisionMap`.
* :func:`explore_mixed_precision` is a greedy sensitivity search over the
  float ``torch`` target: every weighted layer starts at the top rung of the
  bit ladder; each step lowers the one layer whose next rung best keeps
  top-1 agreement with the float reference, and the search stops when no
  move stays within the tolerance.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.ir import Graph, Node
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.quant.ptq import top1_agreement
from repro_torch.quant.qtypes import DatatypeConfig, PrecisionMap

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


def explore_mixed_precision(
        graph: Graph, calib_inputs: Tuple, *,
        act_bits: int = 16,
        ladder: Sequence[int] = (16, 8, 4, 2),
        tol: float = 0.02,
        device: DeviceLike = None,
) -> Tuple[PrecisionMap, List[Dict]]:
    """Greedy per-layer weight-precision descent on a (pass-transformed)
    graph, on ``device`` (default ``"cuda"``).  Returns ``(PrecisionMap,
    history)`` where history records each accepted move with its top-1
    agreement vs. the float reference."""
    from repro_torch.core.writers.torch_writer import (TorchWriter,
                                                       float_reference)

    dev = resolve_device(device)
    ref_logits, act_ranges = float_reference(graph, calib_inputs, dev)

    layers = [n.name for n in quantizable_layers(graph)]
    bits = {name: ladder[0] for name in layers}
    ladder = list(ladder)

    def evaluate(candidate: Dict[str, int]) -> float:
        pm = PrecisionMap(DatatypeConfig(act_bits, ladder[0]),
                          {n: DatatypeConfig(act_bits, b)
                           for n, b in candidate.items()})
        g = make_assign_precision(pm)(graph)
        w = TorchWriter(g, pm.default, act_ranges, device=dev)
        return top1_agreement(w.build()(*calib_inputs), ref_logits)

    history: List[Dict] = []
    while True:
        best = None
        for name in layers:
            rung = ladder.index(bits[name])
            if rung + 1 >= len(ladder):
                continue
            trial = dict(bits)
            trial[name] = ladder[rung + 1]
            agree = evaluate(trial)
            if agree >= 1.0 - tol and (best is None or agree > best[1]):
                best = (name, agree, trial)
        if best is None:
            break
        name, agree, bits = best
        history.append({"layer": name, "weight_bits": bits[name],
                        "agreement": agree})
    pm = PrecisionMap(DatatypeConfig(act_bits, ladder[0]),
                      {n: DatatypeConfig(act_bits, b) for n, b in bits.items()})
    return pm, history
