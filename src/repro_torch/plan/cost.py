"""Analytic cost model for oblivious plans (the paper's Fig. 9 cost
functions), a port of ``repro.plan.cost``.

Costs are communication bytes per party, from the same per-circuit
constants the ledger records (``BYTES``: AND 4, eq 20, lt 44, bit2a 8, a2b
88, b2a 256 bytes a lane). Each operator's formula lives on its
:class:`~.registry.OperatorDef` (``estimate``); :class:`CostModel` walks a
plan and dispatches. It drives comma-FROM join ordering, the join algorithm
choice and the ``cost_based`` Resizer placement: a Resizer after an
operator pays off iff its own cost is below the downstream bytes it saves
(with the strategy's E[S] = T_est + E[eta]).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from ..core.noise import NoiseStrategy
from .nodes import PlanNode
from .registry import BYTES, lookup, resizer_bytes, shuffle_bytes, sort_bytes

__all__ = ["CostModel", "BYTES", "sort_bytes", "shuffle_bytes", "resizer_bytes"]


@dataclasses.dataclass
class CostModel:
    """Walks a plan, propagating (oblivious size n, estimated true size t,
    cols) and summing bytes per party.

    ``calibration`` is any object with a ``refine(node, est, noise)`` hook
    that replaces estimates with sizes already revealed for the same
    subplan (:class:`repro_torch.state.CalibrationStore`).
    """

    table_sizes: Dict[str, int]
    table_cols: Dict[str, int]
    selectivity: float = 0.1  # the planner's default per-predicate selectivity
    join_selectivity: float = 0.01
    noise: NoiseStrategy | None = None
    calibration: object | None = None  # duck-typed: refine(node, est, noise)

    def estimate(self, node: PlanNode) -> Dict[str, float]:
        children = [self.estimate(c) for c in node.children()]
        est = lookup(type(node)).estimate(node, children, self)
        if self.calibration is not None:
            est = self.calibration.refine(node, est, self.noise)
        return est

    def _estimate_untrimmed(self, node: PlanNode) -> Dict[str, float]:
        """:meth:`estimate` with the node's own output not reduced to a
        post-trim size (its children still are): the Resizer decision must
        see the full pre-trim n at the candidate node."""
        children = [self.estimate(c) for c in node.children()]
        est = lookup(type(node)).estimate(node, children, self)
        if self.calibration is not None:
            est = self.calibration.refine(node, est, None)
        return est

    def plan_bytes(self, node: PlanNode) -> float:
        return self.estimate(node)["bytes"]

    def resizer_profitable(self, node: PlanNode) -> bool:
        """Fig. 9's decision, made locally: the Resizer's cost at this node's
        output against the per-row downstream cost (one sort-like operator)
        times the expected row reduction."""
        if self.noise is None:
            return True
        est = self._estimate_untrimmed(node)
        n, t, cols = int(est["n"]), int(est["t"]), int(est["cols"])
        s = min(t + self.noise.mean(n, t), n)
        downstream_per_row = BYTES["lt"] + BYTES["and"] * cols
        saving = (n - s) * downstream_per_row * max(math.log2(max(n, 2)), 1.0)
        return saving > resizer_bytes(n, cols)
