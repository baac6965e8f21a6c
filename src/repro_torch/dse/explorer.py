"""Resource-constrained design-space explorer (counterpart of
``repro.dse.explorer``).

Constrained DSE over the flow's working points, in two stages:

1. **Analytical screen** (no model execution): every candidate
   configuration — activation code bits x FIFO slack x per-layer weight-bit
   caps x runtime rung — is costed in the roofline model's terms
   (``PackedWeights.view_bytes`` with caps, stream-topology
   ``total_fifo_bytes``, im2col scratch bytes at the largest batch bucket,
   ``predict_latency_s`` over the graph's MAC count with the H100's
   constants) and checked against the
   :class:`~repro_torch.dse.budget.ResourceBudget`.
2. **Accuracy check on survivors**: the surviving rungs of the chosen
   compile configuration run the calibration batch through the packed
   ``qtorch`` path on the explorer's device (the ``qgemm`` and ``qconv_dw``
   kernels on a GPU, their plain versions on the CPU; the integer path is
   exact against its plain version, so both give the same front) and are
   scored by top-1 agreement with the float reference.

Dominated points are pruned and the result is a serializable
:class:`~repro_torch.dse.pareto.ParetoFront` the serving runtime consumes.
Runtime axes (the rung ladder) become points of the front, all servable from
ONE packed writer; compile axes (act bits, FIFO slack, per-layer caps) are
shared by the whole front, and the best feasible candidate is chosen
deterministically (most feasible rungs, then largest FIFO slack, then
highest act precision, then fewest bytes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.adaptive import WorkingPoint
from repro_torch.core.passes import (PassManager, make_assign_precision,
                                     quantizable_layers, structural_pipeline)
from repro_torch.core.writers.qtorch_writer import QTorchWriter
from repro_torch.core.writers.stream_writer import StreamWriter
from repro_torch.core.writers.torch_writer import float_reference
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dse.budget import BudgetInfeasibleError, ResourceBudget
from repro_torch.dse.pareto import ParetoFront, ParetoPoint, prune_dominated
from repro_torch.kernels.autotune import tuned_entries
from repro_torch.launch.roofline import (graph_mac_count, im2col_scratch_bytes,
                                         predict_latency_s)
from repro_torch.quant.pack import PackedWeights
from repro_torch.quant.ptq import top1_agreement
from repro_torch.quant.qtypes import DatatypeConfig, PrecisionMap
from repro_torch.runtime.scheduler import LatencyEWMA, _pow2_ladder

_DW_OPS = ("DepthwiseConv", "FusedDepthwiseConv")


def scratch_bytes_for(graph, *, batch: int, act_bytes: int,
                      dw_mode: str = "direct") -> int:
    """The im2col scratch term of one candidate: patch-tensor bytes at the
    largest batch bucket.  With the direct depthwise kernel
    (``dw_mode="direct"``) depthwise convs read the padded activation in
    place, so only regular convs materialize patches."""
    per_node = im2col_scratch_bytes(graph, batch=batch, act_bytes=act_bytes)
    if dw_mode != "direct":
        return per_node["_total"]
    ops = {n.name: n.op for n in graph.nodes}
    return sum(v for k, v in per_node.items()
               if k != "_total" and ops.get(k) not in _DW_OPS)


@dataclass
class _Candidate:
    """One compile configuration with its screened rungs."""
    act_bits: int
    fifo_slack: float
    caps: Dict[str, int]
    graph: object                      # precision-annotated graph
    pm: PrecisionMap
    fifo_bytes: int
    feasible: List[Tuple[int, Dict]] = field(default_factory=list)
    violations: Dict[int, Dict] = field(default_factory=dict)

    def sort_key(self):
        best = min((m["total_bytes"] for _, m in self.feasible),
                   default=float("inf"))
        return (-len(self.feasible), -self.fifo_slack, -self.act_bits, best)


class DesignSpaceExplorer:
    """Joint search over per-layer weight bits, activation bits, FIFO slack
    and the batch-bucket ladder under a :class:`ResourceBudget`, on
    ``device`` (default ``"cuda"``; ``"cpu"`` runs the plain path).

    ``ladder`` is the runtime rung ladder (uniform view bits, highest
    first); ``act_bits_choices`` / ``fifo_slack_choices`` the compile axes;
    ``per_layer`` enables the sensitivity sweep assigning sub-rung weight
    caps to layers that tolerate them (``layer_tol`` top-1 agreement loss);
    ``latency`` optionally feeds the measured term from a serving tenant's
    :class:`~repro_torch.runtime.scheduler.LatencyEWMA`."""

    def __init__(self, graph, calib_inputs: tuple, *,
                 budget: Optional[ResourceBudget] = None,
                 ladder: Sequence[int] = (8, 4, 2),
                 act_bits_choices: Sequence[int] = (8,),
                 fifo_slack_choices: Sequence[float] = (2.0, 1.0),
                 per_layer: bool = True,
                 layer_tol: float = 0.02,
                 dw_mode: str = "direct",
                 latency: Optional[LatencyEWMA] = None,
                 device: DeviceLike = None):
        if not ladder:
            raise ValueError("ladder must name at least one rung")
        self.device = resolve_device(device)
        self.graph = PassManager(structural_pipeline()).run(graph)
        self.calib_inputs = calib_inputs
        self.budget = budget or ResourceBudget()
        self.ladder = tuple(sorted({int(b) for b in ladder}, reverse=True))
        self.act_bits_choices = tuple(sorted({int(a) for a in act_bits_choices},
                                             reverse=True))
        self.fifo_slack_choices = tuple(sorted({float(s) for s in
                                                fifo_slack_choices},
                                               reverse=True))
        self.per_layer = per_layer
        self.layer_tol = float(layer_tol)
        self.dw_mode = dw_mode
        self.latency = latency
        # quantized once for the byte accounting (host copy: only sizes are
        # read); every candidate is a view of it
        self.packed = PackedWeights.from_initializers(self.graph.initializers)
        # float reference + calibrated activation ranges, one capture
        self.ref_logits, self.act_ranges = float_reference(
            self.graph, calib_inputs, self.device)
        self.buckets = _pow2_ladder(self.budget.max_batch)

    # -- accuracy oracle -----------------------------------------------------
    def _agreement(self, pm: PrecisionMap, graph, bits: int) -> float:
        """Top-1 agreement of the packed qtorch path at one rung vs the float
        reference."""
        w = QTorchWriter(graph, pm.default, self.act_ranges,
                         device=self.device)
        return top1_agreement(w.build(bits=bits)(*self.calib_inputs),
                              self.ref_logits)

    # -- per-layer sensitivity sweep ----------------------------------------
    def layer_caps(self) -> Dict[str, int]:
        """Per-layer weight-bit caps: the lowest sub-rung each weighted layer
        tolerates alone (others at the top rung) within ``layer_tol``
        agreement.  Realized at runtime through ``QTorchContext.weight_bits``
        — a capped layer streams its cap even at the W8 point."""
        if not self.per_layer or len(self.ladder) < 2:
            return {}
        act = self.act_bits_choices[0]
        caps: Dict[str, int] = {}
        for n in quantizable_layers(self.graph):
            for b in sorted(self.ladder[1:]):        # most aggressive first
                pm = PrecisionMap(DatatypeConfig(act, self.ladder[0]),
                                  {n.name: DatatypeConfig(act, b)})
                ga = make_assign_precision(pm)(self.graph)
                if self._agreement(pm, ga, self.ladder[0]) \
                        >= 1.0 - self.layer_tol:
                    caps[n.name] = b
                    break
        return caps

    # -- analytical screen ---------------------------------------------------
    def _screen(self, caps: Dict[str, int]) -> List[_Candidate]:
        macs = graph_mac_count(self.graph, batch=self.buckets[-1])["_total"]
        flops = 2.0 * macs
        cands: List[_Candidate] = []
        for a in self.act_bits_choices:
            pm = PrecisionMap(DatatypeConfig(a, self.ladder[0]),
                              {name: DatatypeConfig(a, b)
                               for name, b in sorted(caps.items())})
            ga = make_assign_precision(pm)(self.graph)
            act_bytes = 1 if a <= 8 else 4
            scratch = scratch_bytes_for(ga, batch=self.buckets[-1],
                                        act_bytes=act_bytes,
                                        dw_mode=self.dw_mode)
            for s in self.fifo_slack_choices:
                # built for its topology only; never executed
                sw = StreamWriter(ga, pm.default, self.act_ranges,
                                  fifo_slack=s, device=self.device)
                fifo = int(sw.topology()["total_fifo_bytes"])
                cand = _Candidate(a, s, dict(caps), ga, pm, fifo)
                for b in self.ladder:
                    wb = int(self.packed.view_bytes(b, caps=caps))
                    metrics = {
                        "weight_bytes": wb,
                        "fifo_bytes": fifo,
                        "scratch_bytes": scratch,
                        "total_bytes": wb + fifo + scratch,
                        "predicted_latency_s": predict_latency_s(
                            flops, wb + scratch),
                    }
                    bad = self.budget.check(metrics)
                    if bad:
                        cand.violations[b] = bad
                    else:
                        cand.feasible.append((b, metrics))
                cands.append(cand)
        return cands

    # -- the full pipeline ---------------------------------------------------
    def explore(self) -> ParetoFront:
        caps = self.layer_caps()
        cands = self._screen(caps)
        best = min(cands, key=_Candidate.sort_key)
        if not best.feasible:
            # every rung of every configuration missed a ceiling: report the
            # closest rung (fewest bytes) of the closest configuration
            rung = self.ladder[-1]
            bad = best.violations.get(rung, {})
            raise BudgetInfeasibleError(
                f"no working point of {self.graph.name!r} fits the budget "
                f"({', '.join(self.budget.describe()) or 'unconstrained'}); "
                f"closest candidate (W{rung}, act={best.act_bits}, "
                f"fifo_slack={best.fifo_slack:g}) violates: "
                f"{self.budget.violations_str(bad)}",
                violations=bad)
        measured = (self.latency.estimate(self.buckets[-1])
                    if self.latency is not None else None)
        pts = []
        for b, metrics in best.feasible:
            agree = self._agreement(best.pm, best.graph, b)
            pts.append(ParetoPoint(
                WorkingPoint(f"w{b}", b, act_bits=best.act_bits),
                weight_bytes=metrics["weight_bytes"],
                fifo_bytes=metrics["fifo_bytes"],
                scratch_bytes=metrics["scratch_bytes"],
                predicted_latency_s=metrics["predicted_latency_s"],
                agreement=agree,
                measured_latency_s=measured))
        return ParetoFront(
            graph_name=self.graph.name,
            points=prune_dominated(pts),
            act_bits=best.act_bits,
            fifo_slack=best.fifo_slack,
            per_layer_bits=dict(best.caps),
            buckets=self.buckets,
            budget=self.budget if self.budget.constrained else None,
            tuned_tilings=len(tuned_entries()))
