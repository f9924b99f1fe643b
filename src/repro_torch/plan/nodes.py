"""Plan nodes of the port: Scan, Filter, Join, Resize, Distinct, CountValid,
CountDistinct.

A plan is a tree of dataclass nodes with ``Scan`` leaves over named base
tables; each node type is registered in :mod:`.registry`. ``describe()``
strings are those of ``repro.plan.nodes`` (they name the per-node report
rows that the parity tests compare).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..core.resizer import ResizerConfig
from ..ops.filter import Pred, normalize_pred, render_pred

__all__ = ["PlanNode", "Scan", "Filter", "Join", "Distinct", "Resize", "CountValid", "CountDistinct"]


@dataclasses.dataclass
class PlanNode:
    def children(self) -> List["PlanNode"]:
        return [
            getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), PlanNode)
        ]

    def replace_children(self, new_children: List["PlanNode"]) -> "PlanNode":
        kwargs, i = {}, 0
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, PlanNode):
                kwargs[f.name] = new_children[i]
                i += 1
            else:
                kwargs[f.name] = v
        return type(self)(**kwargs)

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class Scan(PlanNode):
    table: str

    def describe(self) -> str:
        return f"Scan({self.table})"


@dataclasses.dataclass
class Filter(PlanNode):
    """Filter by a predicate tree; a plain sequence of predicates is a
    conjunction."""

    child: PlanNode
    pred: Pred

    def __post_init__(self):
        self.pred = normalize_pred(self.pred)

    def describe(self) -> str:
        return f"Filter({render_pred(self.pred)})"


@dataclasses.dataclass
class Join(PlanNode):
    left: PlanNode
    right: PlanNode
    on: Tuple[str, str]
    theta: Optional[Tuple[str, str, str]] = None

    def describe(self) -> str:
        t = f" theta={self.theta}" if self.theta else ""
        return f"Join({self.on[0]}=={self.on[1]}{t})"


@dataclasses.dataclass
class Distinct(PlanNode):
    child: PlanNode
    col: str

    def describe(self) -> str:
        return f"Distinct({self.col})"


@dataclasses.dataclass
class CountValid(PlanNode):
    """COUNT(*) over true rows -> 1-row table with an arithmetic ``cnt``."""

    child: PlanNode

    def describe(self) -> str:
        return "Count(*)"


@dataclasses.dataclass
class CountDistinct(PlanNode):
    """COUNT(DISTINCT col) -> 1-row table with an arithmetic ``cnt``."""

    child: PlanNode
    col: str

    def describe(self) -> str:
        return f"CountDistinct({self.col})"


@dataclasses.dataclass
class Resize(PlanNode):
    child: PlanNode
    cfg: ResizerConfig

    def describe(self) -> str:
        return f"Resize[{self.cfg.describe()}]"
