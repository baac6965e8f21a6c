"""Resource budgets for the design-space explorer (a copy of
``repro.dse.budget``, which the port may not import).

The FPGA survey's constrained-DSE framing (DSP/BRAM ceilings) mapped onto
the terms this repo already measures:

* ``weight_bytes``  — resident streamed weight buffer of a working point
  (:meth:`repro_torch.quant.pack.PackedWeights.view_bytes`, sub-byte
  packed below W8, per-layer caps applied) — the BRAM-column analogue;
* ``fifo_bytes``    — ``total_fifo_bytes`` of the sized stream topology
  (:meth:`repro_torch.core.writers.stream_writer.StreamWriter.topology`)
  — the inter-actor buffer memory;
* ``scratch_bytes`` — im2col patch-tensor traffic
  (:func:`repro_torch.launch.roofline.im2col_scratch_bytes`) at the
  largest batch bucket — the lowering's hidden byte term;
* ``total_bytes``   — sum of the three (one ceiling when the split does not
  matter);
* ``latency_s``     — the analytical roofline latency
  (:func:`repro_torch.launch.roofline.predict_latency_s`, H100 constants)
  at the largest bucket.

Every ceiling is optional; ``None`` means unconstrained.  ``max_batch``
bounds the batch-bucket ladder the candidates are costed (and later served)
at.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Dict, List, Optional


class BudgetInfeasibleError(ValueError):
    """No candidate working point fits the budget.

    ``violations`` maps each violated term of the *closest* candidate (the
    one with the smallest total bytes) to ``(value, ceiling)`` so the caller
    can see which ceiling to relax."""

    def __init__(self, message: str,
                 violations: Optional[Dict[str, tuple]] = None):
        super().__init__(message)
        self.violations = dict(violations or {})


@dataclass(frozen=True)
class ResourceBudget:
    """Explicit resource ceilings for
    :class:`~repro_torch.dse.DesignSpaceExplorer` (all optional —
    ``ResourceBudget()`` is the unconstrained search)."""

    weight_bytes: Optional[int] = None
    fifo_bytes: Optional[int] = None
    scratch_bytes: Optional[int] = None
    total_bytes: Optional[int] = None
    latency_s: Optional[float] = None
    max_batch: int = 8

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        for f in fields(self):
            if f.name == "max_batch":
                continue
            v = getattr(self, f.name)
            if v is not None and float(v) <= 0:
                raise ValueError(f"budget ceiling {f.name} must be positive, "
                                 f"got {v}")

    def check(self, metrics: Dict[str, float]) -> Dict[str, tuple]:
        """Violated ceilings for one candidate's metric dict: ``{term:
        (value, ceiling)}`` — empty means the candidate is feasible.  The
        ``latency_s`` ceiling is checked against ``predicted_latency_s``."""
        out: Dict[str, tuple] = {}
        pairs = [("weight_bytes", metrics.get("weight_bytes")),
                 ("fifo_bytes", metrics.get("fifo_bytes")),
                 ("scratch_bytes", metrics.get("scratch_bytes")),
                 ("total_bytes", metrics.get("total_bytes")),
                 ("latency_s", metrics.get("predicted_latency_s"))]
        for term, value in pairs:
            ceiling = getattr(self, term)
            if ceiling is not None and value is not None and value > ceiling:
                out[term] = (value, ceiling)
        return out

    def violations_str(self, violations: Dict[str, tuple]) -> str:
        return "; ".join(f"{t}={v:g} > ceiling {c:g}"
                         for t, (v, c) in sorted(violations.items()))

    def to_dict(self) -> Dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_dict(cls, d: Dict) -> "ResourceBudget":
        names = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - names)
        if unknown:
            raise ValueError(f"unknown budget terms {unknown}; "
                             f"valid: {sorted(names)}")
        return cls(**d)

    @property
    def constrained(self) -> bool:
        return any(getattr(self, f.name) is not None for f in fields(self)
                   if f.name != "max_batch")

    def describe(self) -> List[str]:
        return [f"{f.name}<={getattr(self, f.name):g}" for f in fields(self)
                if f.name != "max_batch" and getattr(self, f.name) is not None]
