"""Multi-Dataflow Composer analogue: runtime-adaptive multi-precision
accelerators, working points over one shared weight buffer, and the point
selectors (counterpart of ``repro.core.adaptive``).

The *shared substrate* is one int8 master weight buffer + per-channel
scales; W4/W2 working points are derived views of the master, so switching
precision moves no weights:

* :class:`AdaptiveAccelerator` — the MDC merge over a parameter tree
  (:func:`~repro_torch.quant.ptq.quantize_tree_native`): one executable per
  point (``static``), or one callable indexing the list of point branches
  with a host int or a 0-d tensor (``build_dynamic``), and
  ``sharing_report()`` for the merged-vs-separate bytes;
* :func:`shared_point_executables` — one batch-polymorphic executable per
  point over the ``qtorch`` writer's
  :class:`~repro_torch.quant.pack.PackedWeights`, with the
  :class:`PointSelector` family picking the point per batch;
* :class:`BrownoutSelector` — one selector shared by every replica of a
  :class:`~repro_torch.runtime.fleet.FleetRouter`, walking the whole fleet
  down the W8 -> W4 -> W2 ladder under latency or backlog pressure.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import (Callable, Deque, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import torch

from repro_torch.device import as_tensor
from repro_torch.quant.ptq import (QuantizedParams, dequantize_tree,
                                   quant_memory_bytes, quantize_tree_native)


@dataclass(frozen=True)
class WorkingPoint:
    """One merged configuration (a Pareto point from the exploration)."""
    name: str
    weight_bits: int            # 8 / 4 / 2 (derived views of the master)
    act_dtype: str = "bfloat16"  # activation stream dtype
    act_bits: Optional[int] = None  # activation code bits (DSE-emitted points)


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown activation dtype {name!r}")
    return dt


class AdaptiveAccelerator:
    """The merged multi-dataflow executable."""

    def __init__(self, apply_fn: Callable,
                 params: Dict[str, torch.Tensor],
                 points: Sequence[WorkingPoint],
                 quant_embeddings: bool = False):
        """apply_fn(params, *inputs) -> outputs; params: the full-precision
        tree, quantized here once to the shared int8 master codes."""
        self.points = list(points)
        self.apply_fn = apply_fn
        self.qparams: QuantizedParams = quantize_tree_native(
            params, quant_embeddings=quant_embeddings)
        self._compiled: Dict[str, Callable] = {}

    def _run_point(self, qtree, inputs, bits: int, dt: torch.dtype):
        qp = QuantizedParams(qtree["codes"], qtree["scales"],
                             qtree["passthrough"])
        params = dequantize_tree(qp, bits, dt)
        cast = tuple(x.to(dt) if torch.is_floating_point(x) else x
                     for x in (as_tensor(i) for i in inputs))
        return self.apply_fn(params, *cast)

    # -- static switching: one executable per point -------------------------
    def executable(self, point: WorkingPoint) -> Callable:
        if point.name not in self._compiled:
            bits, dt = point.weight_bits, _dtype(point.act_dtype)

            def run(qtree, *inputs, _bits=bits, _dt=dt):
                return self._run_point(qtree, inputs, _bits, _dt)

            self._compiled[point.name] = run
        return self._compiled[point.name]

    def __call__(self, point_name: str, *inputs):
        pt = next(p for p in self.points if p.name == point_name)
        return self.executable(pt)(self.qparams.tree(), *inputs)

    # -- dynamic switching: one callable, the point chosen by an index ------
    def build_dynamic(self) -> Callable:
        """``run(config_id, qtree, *inputs)``: the point's branch picked by
        indexing the list of branches (the reference's ``lax.switch``) with a
        host int or a 0-d integer tensor; outputs in f32."""
        branches = []
        for pt in self.points:
            bits, dt = pt.weight_bits, _dtype(pt.act_dtype)

            def branch(qtree, inputs, _bits=bits, _dt=dt):
                out = self._run_point(qtree, inputs, _bits, _dt)
                if isinstance(out, tuple):
                    return tuple(o.to(torch.float32) for o in out)
                return out.to(torch.float32)

            branches.append(branch)

        def run(config_id, qtree, *inputs):
            idx = int(config_id)
            if not 0 <= idx < len(branches):
                raise IndexError(f"config_id {idx} outside the "
                                 f"{len(branches)} working points")
            return branches[idx](qtree, inputs)

        return run

    # -- resource sharing report (MDC merge accounting) ----------------------
    def sharing_report(self) -> Dict[str, float]:
        merged = quant_memory_bytes(self.qparams, 8, packed=True)
        separate = sum(quant_memory_bytes(self.qparams, p.weight_bits,
                                          packed=True)
                       for p in self.points)
        return {
            "n_configs": len(self.points),
            "merged_weight_bytes": merged,
            "separate_weight_bytes": separate,
            "sharing_ratio": separate / max(merged, 1),
            "extra_bytes_per_config": 0.0,  # derived views: no extra storage
        }


def shared_point_executables(writer, points: Sequence[WorkingPoint], *,
                             max_entries: int = 8,
                             on_compile=None) -> Dict[str, Callable]:
    """One batch-polymorphic executable per working point, ALL reading the
    writer's single :class:`~repro_torch.quant.pack.PackedWeights` buffer.

    This is the MDC merge realized for the graph accelerators: the writer
    (a :class:`~repro_torch.core.writers.qtorch_writer.QTorchWriter`) quantized its
    weights once to int8 master codes, and each point executable differs only
    in the static ``bits`` kernel argument — switching W8 -> W4 -> W2 in
    ``AccelServer``/``RuntimePolicy`` re-builds nothing and copies no weights,
    so N points hold ~1/N of the per-point-copies weight memory.  Feed the
    result to ``AccelServer(point_executables=...)`` (or use
    ``FlowResult.serve_adaptive``)."""
    if not hasattr(writer, "packed"):
        raise TypeError(
            f"writer target {getattr(writer, 'target', '?')!r} does not hold "
            "packed weights; shared point executables need the 'qtorch' writer")
    return {p.name: writer.build_batched(max_entries=max_entries,
                                         on_compile=on_compile,
                                         bits=p.weight_bits)
            for p in points}


# ---------------------------------------------------------------------------
# Point selection: ONE protocol for every runtime point-selection surface
# ---------------------------------------------------------------------------

@runtime_checkable
class PointSelector(Protocol):
    """The unified point-selection surface.

    Historically three competing surfaces picked the working point: the
    open-loop ``RuntimePolicy.select(energy_budget_frac)`` heuristic, the
    closed-loop ``SLOController.select()``, and per-call ``bits=`` kwargs on
    the writers.  They now meet in one protocol that
    :class:`~repro_torch.runtime.serve.AccelServer` tenants consume directly
    (``selector=``):

    * ``points`` — the ladder, highest precision first (what an SLO walks);
    * ``select(budget)`` — the working point for the next batch.  Open-loop
      selectors read the batch's energy budget; closed-loop selectors ignore
      it (their signal is :meth:`observe`);
    * ``observe(latency_s)`` — feedback from every completed request.
      Open-loop selectors may no-op.

    Implementations: :class:`BudgetSelector` (open-loop energy heuristic),
    :class:`SLOController` (closed-loop p95 ladder walk),
    :class:`FixedSelector` (pin one point — the per-call ``bits=`` pattern).
    The legacy :class:`RuntimePolicy` entry point survives as a thin
    deprecation shim over :class:`BudgetSelector`.
    """

    points: Sequence[WorkingPoint]

    def select(self, budget: float = 1.0) -> WorkingPoint: ...

    def observe(self, latency_s: float) -> None: ...


@dataclass
class BudgetSelector:
    """CPS-style open-loop selector: pick the working point from the budget.

    Mirrors the paper's scenario — "when a limited energy budget is left a
    reduction in energy consumption is worth the cost of some accuracy loss".
    """
    points: List[WorkingPoint]
    thresholds: List[float] = field(default_factory=list)  # descending budgets

    def select(self, budget: float = 1.0) -> WorkingPoint:
        ths = self.thresholds or [1.0 - (i + 1) / len(self.points)
                                  for i in range(len(self.points) - 1)]
        for pt, th in zip(self.points[:-1], ths):
            if budget > th:
                return pt
        return self.points[-1]

    def observe(self, latency_s: float) -> None:
        """Open-loop: measured latency does not move the choice."""


class RuntimePolicy(BudgetSelector):
    """Deprecated alias of :class:`BudgetSelector`.

    Kept so existing call sites (``RuntimePolicy(points).select(frac)``)
    behave bit-identically; new code should construct a
    :class:`BudgetSelector` (or any other :class:`PointSelector`) and hand it
    to the server as ``selector=``.
    """

    def select(self, energy_budget_frac: float = 1.0) -> WorkingPoint:
        return super().select(energy_budget_frac)


@dataclass
class FixedSelector:
    """Pin one working point — the typed replacement for threading a
    ``bits=`` kwarg through every call: build the point's executable once and
    select it unconditionally."""
    point: WorkingPoint

    @property
    def points(self) -> List[WorkingPoint]:
        return [self.point]

    def select(self, budget: float = 1.0) -> WorkingPoint:
        return self.point

    def observe(self, latency_s: float) -> None:
        """Nothing to adapt: the point is pinned."""


# ---------------------------------------------------------------------------
# Closed-loop precision control against a latency SLO
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ServiceObjective:
    """A tenant's latency contract plus the control-loop tuning knobs.

    ``p95_latency_s`` is the target the controller defends.  ``window`` /
    ``min_samples`` size the observation window a decision needs;
    ``hold`` is the minimum number of observations between two precision
    shifts (hysteresis — it bounds oscillation and upshift-probe rate);
    ``recover_margin`` is the headroom fraction under which the controller
    tries the next-higher-precision point again (p95 below
    ``recover_margin * p95_latency_s`` == "there is headroom").
    """
    p95_latency_s: float
    window: int = 64
    min_samples: int = 8
    hold: int = 16
    recover_margin: float = 0.5

    def __post_init__(self):
        if self.p95_latency_s <= 0:
            raise ValueError("p95_latency_s must be > 0")
        if not 0.0 < self.recover_margin < 1.0:
            raise ValueError("recover_margin must be in (0, 1)")


class SLOController:
    """Feedback controller: measured request latency -> precision ladder.

    The paper's runtime adaptivity story closed with a real signal: instead
    of an open-loop energy-budget heuristic, the serving layer feeds every
    completed request's latency back in, and the controller walks the
    working-point ladder (ordered highest precision first, e.g. W8/W4/W2) —
    *down* a step when the windowed p95 violates the SLO (lower-bit views
    stream fewer weight bytes, so they are the faster/cheaper points), back
    *up* when p95 shows ``recover_margin`` headroom.  Shifting clears the
    window so the next decision is made from observations of the new point
    only, and ``hold`` observations must accumulate before any further
    shift.
    """

    def __init__(self, points: Sequence[WorkingPoint], slo: ServiceObjective):
        if not points:
            raise ValueError("SLOController needs at least one working point")
        self.points = list(points)
        self.slo = slo
        self.idx = 0                      # start at the highest precision
        self.shifts: List[Tuple[str, str]] = []   # (from, to) telemetry
        self._window: Deque[float] = deque(maxlen=slo.window)
        self._since_shift = 0

    def select(self, budget: float = 1.0) -> WorkingPoint:
        """Closed loop: the measured-latency choice; ``budget`` is ignored
        (accepted so the controller satisfies :class:`PointSelector`)."""
        return self.points[self.idx]

    @property
    def p95(self) -> float:
        from repro_torch.runtime.scheduler import percentile
        return percentile(self._window, 0.95)

    def observe(self, latency_s: float) -> None:
        """Feed one completed request's end-to-end latency."""
        self._window.append(latency_s)
        self._since_shift += 1
        if (len(self._window) < self.slo.min_samples
                or self._since_shift < self.slo.hold):
            return
        p95 = self.p95
        if p95 > self.slo.p95_latency_s and self.idx < len(self.points) - 1:
            self._shift(self.idx + 1)
        elif (p95 < self.slo.recover_margin * self.slo.p95_latency_s
                and self.idx > 0):
            self._shift(self.idx - 1)

    def _shift(self, new_idx: int) -> None:
        self.shifts.append((self.points[self.idx].name,
                            self.points[new_idx].name))
        self.idx = new_idx
        self._since_shift = 0
        self._window.clear()

    def telemetry(self) -> Dict:
        return {
            "point": self.points[self.idx].name,
            "p95_slo_s": self.slo.p95_latency_s,
            "window_p95_s": (self.p95 if self._window else None),
            "shifts": list(self.shifts),
        }


# ---------------------------------------------------------------------------
# Fleet-level graceful degradation (precision brownout)
# ---------------------------------------------------------------------------

class BrownoutSelector:
    """Fleet-wide graceful degradation: ONE :class:`PointSelector` shared by
    every replica of a :class:`~repro_torch.runtime.fleet.FleetRouter`.

    Every replica's pump thread consults the same instance (``select``) and
    feeds it every completed request's latency (``observe``), while the
    router's sentinel feeds the aggregate queue depth (``observe_depth``).
    The ladder walks down a rung (W8 -> W4 -> W2) when EITHER the windowed
    p95 violates the :class:`ServiceObjective` OR the fleet backlog crosses
    ``max_queue_depth`` — and walks back up when p95 shows
    ``recover_margin`` headroom with the backlog clear.  ``hold`` /
    ``min_samples`` hysteresis follows the objective, and shifting clears
    the window, exactly like :class:`SLOController`.

    All state is lock-guarded: N replica pump threads plus the sentinel and
    request threads touch it concurrently.
    """

    def __init__(self, points: Sequence[WorkingPoint], slo: ServiceObjective,
                 *, max_queue_depth: Optional[int] = None):
        if not points:
            raise ValueError("BrownoutSelector needs at least one point")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        self.points = list(points)
        self.slo = slo
        self.max_queue_depth = max_queue_depth
        self.idx = 0                               # highest precision first
        self.shifts: List[Tuple[str, str]] = []
        self._window: Deque[float] = deque(maxlen=slo.window)
        self._since_shift = 0
        self._depth = 0
        self._lock = threading.Lock()

    def select(self, budget: float = 1.0) -> WorkingPoint:
        """The fleet's current rung; ``budget`` is ignored (closed loop)."""
        with self._lock:
            return self.points[self.idx]

    @property
    def p95(self) -> float:
        from repro_torch.runtime.scheduler import percentile
        return percentile(self._window, 0.95)

    def _depth_over(self) -> bool:
        return (self.max_queue_depth is not None
                and self._depth > self.max_queue_depth)

    def _maybe_shift(self) -> None:
        """Caller holds the lock."""
        if self._since_shift < self.slo.hold:
            return
        depth_over = self._depth_over()
        p95 = self.p95 if len(self._window) >= self.slo.min_samples else None
        if ((depth_over or (p95 is not None and p95 > self.slo.p95_latency_s))
                and self.idx < len(self.points) - 1):
            self._shift(self.idx + 1)
        elif (p95 is not None and not depth_over
                and p95 < self.slo.recover_margin * self.slo.p95_latency_s
                and self.idx > 0):
            self._shift(self.idx - 1)

    def observe(self, latency_s: float) -> None:
        """Feed one completed request's end-to-end latency (any replica)."""
        with self._lock:
            self._window.append(latency_s)
            self._since_shift += 1
            self._maybe_shift()

    def observe_depth(self, depth: int) -> None:
        """Feed the fleet's aggregate queue depth (the router's sentinel).
        A backlog crossing can downshift before latency samples arrive."""
        with self._lock:
            self._depth = int(depth)
            self._since_shift += 1
            self._maybe_shift()

    def _shift(self, new_idx: int) -> None:
        self.shifts.append((self.points[self.idx].name,
                            self.points[new_idx].name))
        self.idx = new_idx
        self._since_shift = 0
        self._window.clear()

    def telemetry(self) -> Dict:
        with self._lock:
            return {
                "point": self.points[self.idx].name,
                "p95_slo_s": self.slo.p95_latency_s,
                "window_p95_s": (self.p95 if self._window else None),
                "queue_depth": self._depth,
                "max_queue_depth": self.max_queue_depth,
                "shifts": list(self.shifts),
            }
