"""Pareto points and the serializable front the runtime ladder walks
(counterpart of ``repro.dse.pareto``; the JSON wire format is the
reference's, so a front written by either package loads in the other).

A :class:`ParetoPoint` is one costed-and-validated working point: the
runtime rung (a :class:`~repro_torch.core.adaptive.WorkingPoint`) plus the
byte / latency / accuracy metrics the explorer derived for it.  Dominance is
over the three minimized objectives ``(total_bytes, latency, -agreement)``;
:func:`prune_dominated` is deterministic (stable order, strict dominance).

A :class:`ParetoFront` bundles the surviving points with the *compile-time*
configuration they share — activation code bits, FIFO slack, per-layer
weight-bit caps, the batch-bucket ladder, and the budget they were screened
against — because every point on one front must be servable from ONE
packed-weight writer (the paper's zero-reload precision switch).  It
round-trips through JSON (``save``/``load``) and plugs into the runtime
directly: ``working_points()`` feeds ``shared_point_executables`` /
``serve_adaptive(points=front)``, ``selector(slo=...)`` builds the
:class:`~repro_torch.core.adaptive.PointSelector` that walks it.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.adaptive import (BudgetSelector, PointSelector,
                                 ServiceObjective, SLOController,
                                 WorkingPoint)
from repro_torch.dse.budget import ResourceBudget
from repro_torch.quant.qtypes import DatatypeConfig, PrecisionMap

# bump on any front-layout change; `load` refuses mismatched files rather
# than mis-reading them
FRONT_SCHEMA = 1


class FrontFormatError(ValueError):
    """Typed deserialization failure: a front file carried wrong-typed,
    non-finite, or negative metric fields.  Raised instead of letting
    corrupted bytes/latency values propagate into ``run_kwargs()`` and
    runtime block picks — a bit-flipped cache file must fail loudly."""


def _req_int(d: Dict, key: str, *, minimum: int = 0) -> int:
    """A required non-negative integral field (bool is NOT an int here)."""
    v = d.get(key)
    if isinstance(v, bool) or not isinstance(v, (int, float)) \
            or not math.isfinite(v) or int(v) != v or int(v) < minimum:
        raise FrontFormatError(
            f"field {key!r} must be an integer >= {minimum}, got {v!r}")
    return int(v)


def _req_float(d: Dict, key: str, *, minimum: float = 0.0,
               required: bool = True) -> Optional[float]:
    """A finite non-negative float field (None allowed when optional)."""
    v = d.get(key)
    if v is None and not required:
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)) \
            or not math.isfinite(v) or v < minimum:
        raise FrontFormatError(
            f"field {key!r} must be a finite number >= {minimum}, got {v!r}")
    return float(v)


@dataclass(frozen=True)
class ParetoPoint:
    """One working point with the metrics the explorer screened it on."""

    point: WorkingPoint
    weight_bytes: int            # PackedWeights.view_bytes(bits, caps)
    fifo_bytes: int              # stream topology total_fifo_bytes
    scratch_bytes: int           # im2col patch traffic at the max bucket
    predicted_latency_s: float   # roofline max(compute, memory) term
    agreement: float             # top-1 agreement vs the float reference
    measured_latency_s: Optional[float] = None   # LatencyEWMA, when warm

    @property
    def total_bytes(self) -> int:
        return self.weight_bytes + self.fifo_bytes + self.scratch_bytes

    @property
    def latency_s(self) -> float:
        """The latency objective: measured when available, else predicted."""
        return (self.measured_latency_s if self.measured_latency_s is not None
                else self.predicted_latency_s)

    def objectives(self) -> Tuple[float, float, float]:
        """Minimized objective vector."""
        return (float(self.total_bytes), self.latency_s, -self.agreement)

    def dominates(self, other: "ParetoPoint") -> bool:
        """Strict Pareto dominance: no worse in every objective, strictly
        better in at least one."""
        a, b = self.objectives(), other.objectives()
        return all(x <= y for x, y in zip(a, b)) and a != b

    def metrics(self) -> Dict[str, float]:
        return {
            "weight_bytes": self.weight_bytes,
            "fifo_bytes": self.fifo_bytes,
            "scratch_bytes": self.scratch_bytes,
            "total_bytes": self.total_bytes,
            "predicted_latency_s": self.predicted_latency_s,
            "measured_latency_s": self.measured_latency_s,
            "agreement": self.agreement,
        }

    def to_dict(self) -> Dict:
        return {
            "name": self.point.name,
            "weight_bits": self.point.weight_bits,
            "act_dtype": self.point.act_dtype,
            "act_bits": self.point.act_bits,
            **self.metrics(),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "ParetoPoint":
        """Build from a JSON dict, rejecting corrupted metric fields
        (non-finite, negative, or wrong-typed) with a typed
        :class:`FrontFormatError` — garbage here would otherwise steer
        ``run_kwargs()`` and runtime ladder picks silently."""
        if not isinstance(d, dict):
            raise FrontFormatError(f"point entry must be a dict, got "
                                   f"{type(d).__name__}")
        name = d.get("name")
        if not isinstance(name, str) or not name:
            raise FrontFormatError(f"field 'name' must be a non-empty "
                                   f"string, got {name!r}")
        wp = WorkingPoint(name, _req_int(d, "weight_bits", minimum=1),
                          d.get("act_dtype", "bfloat16"),
                          d.get("act_bits"))
        return cls(wp,
                   weight_bytes=_req_int(d, "weight_bytes"),
                   fifo_bytes=_req_int(d, "fifo_bytes"),
                   scratch_bytes=_req_int(d, "scratch_bytes"),
                   predicted_latency_s=_req_float(d, "predicted_latency_s"),
                   agreement=_req_float(d, "agreement"),
                   measured_latency_s=_req_float(d, "measured_latency_s",
                                                 required=False))


def prune_dominated(points: Sequence[ParetoPoint]) -> List[ParetoPoint]:
    """Drop every strictly dominated point, preserving input order.

    Deterministic: dominance is strict, so objective-identical duplicates
    all survive (the explorer never emits duplicates, but property tests
    feed arbitrary sets)."""
    pts = list(points)
    return [p for p in pts
            if not any(q.dominates(p) for q in pts if q is not p)]


@dataclass
class ParetoFront:
    """The explorer's output: non-dominated points + their shared compile
    configuration, ordered highest precision first (the ladder an
    :class:`~repro_torch.core.adaptive.SLOController` walks down under
    load)."""

    graph_name: str
    points: List[ParetoPoint]
    act_bits: int = 8                     # activation code bits (compile axis)
    fifo_slack: float = 1.0               # stream FIFO headroom (compile axis)
    per_layer_bits: Dict[str, int] = field(default_factory=dict)  # weight caps
    buckets: Tuple[int, ...] = ()         # batch-bucket ladder candidates cost
    budget: Optional[ResourceBudget] = None
    # the tile picks the autotune cache held at explore time
    # (repro_torch.kernels.autotune: timed qgemm and qconv_dw tiles), as in
    # the reference: a measured latency on a tuned shape rests on the
    # kernel's timed mapping, not on the static host rule
    tuned_tilings: int = 0
    schema: int = FRONT_SCHEMA

    def __post_init__(self):
        self.points = sorted(self.points,
                             key=lambda p: -p.point.weight_bits)

    def __len__(self) -> int:
        return len(self.points)

    # -- runtime plumbing ----------------------------------------------------
    def working_points(self) -> List[WorkingPoint]:
        """The ladder ``shared_point_executables`` / ``serve_adaptive``
        consume (highest precision first)."""
        return [p.point for p in self.points]

    def precision_map(self) -> PrecisionMap:
        """The per-layer precision annotation realizing this front's caps:
        the runtime rung is further clamped per node by
        ``QTorchContext.weight_bits`` (a W4-capped layer stays W4 at the W8
        point)."""
        default = DatatypeConfig(self.act_bits, 8)
        return PrecisionMap(default,
                            {n: DatatypeConfig(self.act_bits, b)
                             for n, b in sorted(self.per_layer_bits.items())})

    def run_kwargs(self) -> Dict:
        """Keyword arguments reproducing this front's compile configuration
        through ``DesignFlow.run`` (the one documented ONNX -> constrained
        points -> server path)."""
        return {"dtconfig": self.precision_map(),
                "fifo_slack": self.fifo_slack}

    def selector(self, slo: Optional[ServiceObjective] = None
                 ) -> PointSelector:
        """A :class:`~repro_torch.core.adaptive.PointSelector` over this
        front: closed-loop (:class:`SLOController`) when an ``slo`` is given,
        else the open-loop :class:`BudgetSelector`."""
        pts = self.working_points()
        if slo is not None:
            return SLOController(pts, slo)
        return BudgetSelector(pts)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict:
        return {
            "schema": self.schema,
            "graph": self.graph_name,
            "act_bits": self.act_bits,
            "fifo_slack": self.fifo_slack,
            "per_layer_bits": dict(sorted(self.per_layer_bits.items())),
            "buckets": list(self.buckets),
            "budget": self.budget.to_dict() if self.budget else None,
            "tuned_tilings": self.tuned_tilings,
            "points": [p.to_dict() for p in self.points],
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict) -> "ParetoFront":
        if d.get("schema") != FRONT_SCHEMA:
            raise ValueError(
                f"ParetoFront schema mismatch: file has {d.get('schema')!r}, "
                f"this build reads {FRONT_SCHEMA} — re-run the explorer")
        budget = (ResourceBudget.from_dict(d["budget"])
                  if d.get("budget") else None)
        pts = d.get("points")
        if not isinstance(pts, list):
            raise FrontFormatError(
                f"field 'points' must be a list, got {type(pts).__name__}")
        return cls(graph_name=d["graph"],
                   points=[ParetoPoint.from_dict(p) for p in pts],
                   act_bits=int(d.get("act_bits", 8)),
                   fifo_slack=float(d.get("fifo_slack", 1.0)),
                   per_layer_bits={k: int(v) for k, v in
                                   d.get("per_layer_bits", {}).items()},
                   buckets=tuple(int(b) for b in d.get("buckets", ())),
                   budget=budget,
                   tuned_tilings=int(d.get("tuned_tilings", 0)))

    @classmethod
    def from_json(cls, text: str) -> "ParetoFront":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ParetoFront":
        with open(path) as f:
            return cls.from_json(f.read())
