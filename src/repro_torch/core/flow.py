"""End-to-end DesignFlow — the paper's Fig. 1 (counterpart of
``repro.core.flow``).

ONNX-like model -> Reader (IR) -> compiler passes (fusion, constant folding,
DCE, shape inference, per-layer precision) -> calibration on the float
reference -> per-target writer -> batch-polymorphic executables, and
``FlowResult.serve_adaptive`` -> an ``AccelServer`` that switches W8/W4/W2 per
batch over ONE packed weight buffer.

Targets: ``"torch"`` (float reference, :class:`TorchWriter`), ``"stream"``
(the streaming line-buffer accelerator with its XDF-style topology,
:class:`StreamWriter`) and ``"qtorch"`` (packed-weight engine,
:class:`QTorchWriter`: fully integer at activation precisions up to 8 bits,
float activations above).  ``DesignFlow.compose_adaptive`` is the MDC step:
working points over one int8 master tree (:class:`AdaptiveAccelerator`).
``DesignFlow.explore`` is the resource-constrained design-space explorer
(:mod:`repro_torch.dse`): its :class:`~repro_torch.dse.ParetoFront` feeds
``run(**front.run_kwargs())`` and ``serve_adaptive(points=front)``;
``explore_mixed_precision`` is the greedy per-layer search.  Everything runs
on the flow's device: ``DesignFlow(graph, device=None)`` means ``"cuda"``
and raises when CUDA is missing; pass ``device="cpu"`` for the plain path.
``"dist"`` (:class:`DistWriter`) is the float interpreter as an SPMD
executable on a device mesh: ``writers["dist"].build_batched(mesh)``.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field, fields
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from repro_torch.core.adaptive import (AdaptiveAccelerator, PointSelector,
                                       RuntimePolicy, WorkingPoint,
                                       shared_point_executables)
from repro_torch.core.ir import Graph
from repro_torch.core.passes import (PassManager, default_pipeline,
                                     explore_mixed_precision, strip_precision,
                                     structural_pipeline)
from repro_torch.core.writers.dist_writer import DistWriter
from repro_torch.core.writers.qtorch_writer import QTorchWriter
from repro_torch.core.writers.stream_writer import StreamWriter
from repro_torch.core.writers.torch_writer import (BatchedExecutable,
                                                   TorchWriter,
                                                   float_reference)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.quant.ptq import graph_weight_stats
from repro_torch.quant.qtypes import DatatypeConfig, PrecisionMap

WRITERS = {"torch": TorchWriter, "stream": StreamWriter, "dist": DistWriter,
           "qtorch": QTorchWriter}

# default adaptive ladder: the paper's W8/W4/W2 nested working points
DEFAULT_POINTS = (WorkingPoint("w8", 8), WorkingPoint("w4", 4),
                  WorkingPoint("w2", 2))

Precision = Union[DatatypeConfig, PrecisionMap]


@dataclass(frozen=True)
class WriterOptions:
    """Typed writer configuration: a set field is forwarded to each target
    writer that accepts it."""

    fifo_slack: Optional[float] = None      # stream: FIFO depth headroom
    default_bits: Optional[int] = None      # qtorch: build(bits=None) point
    int8_act: Optional[bool] = None         # qtorch: fully-integer dataflow
    packed_weights: Optional[bool] = None   # qtorch: sub-byte residency
    dw_mode: Optional[str] = None           # qtorch: "direct" | "im2col"

    def __post_init__(self):
        if self.dw_mode is not None and self.dw_mode not in ("direct",
                                                             "im2col"):
            raise ValueError(f"dw_mode must be 'direct' or 'im2col', "
                             f"got {self.dw_mode!r}")
        if self.fifo_slack is not None and self.fifo_slack <= 0:
            raise ValueError(f"fifo_slack must be positive, "
                             f"got {self.fifo_slack}")

    def set_fields(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) is not None}


def _writer_params(cls) -> set:
    """Optional constructor keywords a writer class accepts (everything past
    the positional graph/dtconfig/act_ranges triple and the device)."""
    sig = inspect.signature(cls.__init__)
    return {name for name in sig.parameters
            if name not in ("self", "graph", "dtconfig", "act_ranges",
                            "device")}


@dataclass
class FlowResult:
    graph: Graph                      # the pass-transformed graph
    writers: Dict[str, TorchWriter]
    executables: Dict[str, Callable]  # raw interpreters (shape-polymorphic)
    act_ranges: Dict[str, float]
    stats: Dict[str, float] = field(default_factory=dict)
    batched: Dict[str, BatchedExecutable] = field(default_factory=dict)

    def serve(self, target: str = "torch", **kwargs):
        """A batch-coalescing :class:`~repro_torch.runtime.serve.AccelServer`
        over this result's batched artifact for ``target``; keyword
        arguments pass through to the server."""
        from repro_torch.runtime.serve import AccelServer
        if target not in self.batched:
            raise KeyError(f"no batched artifact for target {target!r}; "
                           f"have {tuple(self.batched)}")
        kwargs.setdefault("signature", tuple(
            (tuple(int(d) for d in t.shape[1:]), str(t.dtype))
            for t in self.graph.inputs))
        return AccelServer(self.batched[target], **kwargs)

    def serve_adaptive(self, points=DEFAULT_POINTS, target: str = "qtorch",
                       policy: Optional[PointSelector] = None,
                       batch_cache: int = 8,
                       selector: Optional[PointSelector] = None, **kwargs):
        """An ``AccelServer`` whose per-batch working points ALL read one
        shared :class:`~repro_torch.quant.pack.PackedWeights` buffer (needs
        the ``"qtorch"`` target).  ``points`` is a sequence of
        :class:`~repro_torch.core.adaptive.WorkingPoint` or a
        :class:`~repro_torch.dse.ParetoFront` (the explorer's output).  The
        point per batch comes from ``selector`` or the legacy ``policy``; with
        neither, an open-loop
        :class:`~repro_torch.core.adaptive.RuntimePolicy` over ``points``."""
        from repro_torch.dse.pareto import ParetoFront
        if isinstance(points, ParetoFront):
            points = points.working_points()
        writer = self.writers.get(target)
        if writer is None or not hasattr(writer, "packed"):
            raise KeyError(
                f"serve_adaptive needs a packed-weight writer (target "
                f"'qtorch'); this result has {tuple(self.writers)}")
        pts = shared_point_executables(writer, points,
                                       max_entries=batch_cache)
        if selector is not None:
            return self.serve(target, selector=selector,
                              point_executables=pts, **kwargs)
        return self.serve(target, policy=policy or RuntimePolicy(list(points)),
                          point_executables=pts, **kwargs)


def _split_precision(dtconfig: Optional[Precision]
                     ) -> Tuple[Optional[DatatypeConfig], int, int]:
    """(writer default config, min act bits, min weight bits)."""
    if dtconfig is None:
        return None, 32, 32
    if isinstance(dtconfig, PrecisionMap):
        return dtconfig.default, dtconfig.min_act_bits, dtconfig.min_weight_bits
    return dtconfig, dtconfig.act_bits, dtconfig.weight_bits


class DesignFlow:
    """``DesignFlow(graph).run(targets, dtconfig, calib)`` — Fig. 1 automated,
    on ``device`` (default ``"cuda"``)."""

    def __init__(self, graph: Graph,
                 passes: Optional[Sequence[Callable]] = None, *,
                 device: DeviceLike = None):
        graph.validate()
        self.graph = graph
        self.passes = passes          # None => default pipeline per run()
        self.device = resolve_device(device)

    def transform(self, dtconfig: Optional[Precision] = None,
                  passes: Optional[Sequence[Callable]] = None) -> Graph:
        """Apply the pass pipeline; ``passes=()`` returns the raw graph."""
        if passes is None:
            passes = self.passes
        if passes is None:
            passes = default_pipeline(dtconfig)
        if not passes:
            return self.graph
        return PassManager(passes).run(self.graph)

    def calibrate(self, *calib_inputs, graph: Optional[Graph] = None
                  ) -> Dict[str, float]:
        """Run the float reference once and record per-FIFO max |x| — the
        ranges the fully-integer path turns into power-of-two code scales."""
        return float_reference(graph if graph is not None else self.graph,
                               calib_inputs, self.device)[1]

    def run(self, targets: Sequence[str] = ("torch",),
            dtconfig: Optional[Precision] = None,
            calib_inputs: Optional[tuple] = None,
            passes: Optional[Sequence[Callable]] = None,
            fifo_slack: float = 1.0,
            batch_cache: int = 8,
            writer_kwargs: Optional[Dict[str, Dict]] = None,
            options: Optional[WriterOptions] = None,
            act_ranges: Optional[Dict[str, float]] = None) -> FlowResult:
        """Compile the graph for ``targets``.

        ``act_ranges`` skips calibration and uses the given per-FIFO ranges
        (e.g. the reference package's, for a bit-for-bit comparison).
        ``fifo_slack`` scales every FIFO depth the stream writer derives
        (sugar for ``{"stream": {"fifo_slack": ...}}``).  ``options`` /
        ``writer_kwargs`` configure the writers (``writer_kwargs`` wins where
        both set a key); unknown keys raise a ``ValueError`` naming the
        writer."""
        for t in targets:
            if t not in WRITERS:
                raise KeyError(f"unknown target {t!r}; have {tuple(WRITERS)}")
        default_dt, min_act, min_wt = _split_precision(dtconfig)
        g = self.transform(dtconfig, passes)
        ranges: Dict[str, float] = dict(act_ranges or {})
        if act_ranges is None and calib_inputs is not None and min_act < 32:
            # calibrate on the float view of the compiled graph, so recorded
            # ranges are true activation ranges
            ranges = self.calibrate(*calib_inputs, graph=strip_precision(g))
        stray = sorted(set(writer_kwargs or {}) - set(targets))
        if stray:
            raise KeyError(f"writer_kwargs for {stray} not in targets "
                           f"{tuple(targets)}")
        wkw = {t: dict((writer_kwargs or {}).get(t, {})) for t in targets}
        opt_fields = options.set_fields() if options is not None else {}
        for t in targets:
            accepted = _writer_params(WRITERS[t])
            for k, v in opt_fields.items():
                if k in accepted:
                    wkw[t].setdefault(k, v)
            if t == "stream":
                wkw[t].setdefault("fifo_slack", fifo_slack)
            unknown = sorted(set(wkw[t]) - accepted)
            if unknown:
                raise ValueError(
                    f"unknown option(s) {unknown} for writer {t!r} "
                    f"({WRITERS[t].__name__}); it accepts "
                    f"{sorted(accepted) if accepted else 'no options'}")
        writers, exes, batched = {}, {}, {}
        for t in targets:
            w = WRITERS[t](g, default_dt, ranges, device=self.device, **wkw[t])
            writers[t] = w
            exes[t] = w.build()
            batched[t] = w.build_batched(max_entries=batch_cache)
        stats = {}
        if dtconfig is not None and min_wt < 32:
            stats = graph_weight_stats(g, default_dt)
        return FlowResult(g, writers, exes, ranges, stats, batched)

    # -- design-space exploration -------------------------------------------
    def explore(self, calib_inputs: tuple, *, budget=None, **kwargs):
        """Resource-constrained design-space exploration on the flow's
        device: screen candidate working points against ``budget`` (a
        :class:`~repro_torch.dse.ResourceBudget`), score the survivors on the
        calibration batch, and return the pruned
        :class:`~repro_torch.dse.ParetoFront`::

            front = flow.explore(calib, budget=budget)
            result = flow.run(("qtorch",), calib_inputs=calib,
                              **front.run_kwargs())
            srv = result.serve_adaptive(points=front,
                                        selector=front.selector(slo))

        Extra keyword arguments reach
        :class:`~repro_torch.dse.DesignSpaceExplorer` (``ladder``,
        ``act_bits_choices``, ``fifo_slack_choices``, ``per_layer``,
        ``latency``, ...).  Raises
        :class:`~repro_torch.dse.BudgetInfeasibleError` when nothing fits."""
        from repro_torch.dse import DesignSpaceExplorer
        return DesignSpaceExplorer(self.graph, calib_inputs, budget=budget,
                                   device=self.device, **kwargs).explore()

    def explore_mixed_precision(self, calib_inputs: tuple, **kwargs
                                ) -> Tuple[PrecisionMap, List[Dict]]:
        """Greedy per-layer weight-precision search against the float
        reference on the flow's device (see
        :func:`repro_torch.core.passes.explore_mixed_precision`).  The
        returned PrecisionMap feeds straight back into ``run``."""
        g = PassManager(structural_pipeline()).run(self.graph)
        return explore_mixed_precision(g, calib_inputs, device=self.device,
                                       **kwargs)

    # -- adaptive / MDC -----------------------------------------------------
    def compose_adaptive(self, points: Sequence[WorkingPoint],
                         target: str = "stream") -> AdaptiveAccelerator:
        """Merge working points over one shared-weight substrate (MDC step):
        the graph as read (no passes), its parameters quantized once to int8
        master codes, each point running ``target`` over a dequantized view
        on the flow's device."""
        base = WRITERS[target](self.graph, device=self.device)

        def apply_fn(params, *inputs):
            g = Graph(self.graph.name, self.graph.nodes, self.graph.inputs,
                      self.graph.outputs, params)
            return WRITERS[target](g, device=self.device).build()(*inputs)

        return AdaptiveAccelerator(apply_fn, dict(base.weights), points)
