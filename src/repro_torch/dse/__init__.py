"""Resource-constrained design-space exploration (counterpart of
``repro.dse``).

``DesignSpaceExplorer`` screens candidate working points analytically
against a ``ResourceBudget`` (weight, FIFO and im2col scratch bytes, and a
roofline latency with the H100's constants), validates the survivors on the
calibration set through the packed ``qtorch`` path, and emits a serializable
``ParetoFront`` the serving runtime walks directly — see
``DesignFlow.explore`` for the one-call entry point and
``FlowResult.serve_adaptive(points=front)`` for consumption.
"""
from repro_torch.dse.budget import BudgetInfeasibleError, ResourceBudget
from repro_torch.dse.explorer import DesignSpaceExplorer, scratch_bytes_for
from repro_torch.dse.pareto import (FRONT_SCHEMA, ParetoFront, ParetoPoint,
                                    prune_dominated)

__all__ = [
    "BudgetInfeasibleError", "DesignSpaceExplorer", "FRONT_SCHEMA",
    "ParetoFront", "ParetoPoint", "ResourceBudget", "prune_dominated",
    "scratch_bytes_for",
]
