"""Plan nodes of the port: Scan, Filter, Having, Project, Join,
JoinSortMerge, GroupByCount, GroupBySum, GroupByAvg, OrderBy, Distinct,
CountValid, CountDistinct, Sum, Avg, Min, Max and Resize.

A plan is a tree of dataclass nodes with ``Scan`` leaves over named base
tables; each node type is registered in :mod:`.registry`. ``describe()``
strings are those of ``repro.plan.nodes``: they name the per-node report
rows, and ``pretty()`` of them is the SQL compiler's plan fingerprint.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from ..core.resizer import ResizerConfig
from ..ops.filter import And, Or, Pred, Predicate, normalize_pred, pred_leaves, render_pred

__all__ = [
    "PlanNode",
    "Scan",
    "Filter",
    "Having",
    "Project",
    "Join",
    "JoinSortMerge",
    "GroupByCount",
    "GroupBySum",
    "GroupByAvg",
    "OrderBy",
    "Distinct",
    "CountValid",
    "CountDistinct",
    "Sum",
    "Avg",
    "Min",
    "Max",
    "Resize",
]


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

    @property
    def label(self) -> str:
        return type(self).__name__

    def pretty(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children():
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return self.label


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

    @property
    def predicates(self) -> Tuple[Predicate, ...]:
        """The leaves of a flat conjunction; raises for a tree with an OR."""
        if isinstance(self.pred, Or) or (
            isinstance(self.pred, And)
            and any(not isinstance(t, Predicate) for t in self.pred.terms)
        ):
            raise ValueError("Filter holds a non-conjunctive predicate tree; use .pred")
        return pred_leaves(self.pred)

    def describe(self) -> str:
        return f"Filter({render_pred(self.pred)})"


@dataclasses.dataclass
class Having(PlanNode):
    """Post-aggregation filter (SQL HAVING): the WHERE filter's protocol on a
    GROUP BY output, whose predicate names the output columns (the count
    column is arithmetic and converts through ``a2b``). Only validity bits
    flip; the size never changes."""

    child: PlanNode
    pred: Pred

    def __post_init__(self):
        self.pred = normalize_pred(self.pred)

    def describe(self) -> str:
        return f"Having({render_pred(self.pred)})"


@dataclasses.dataclass
class Project(PlanNode):
    """Keep only the named columns (and the valid column): local, free."""

    child: PlanNode
    cols: Tuple[str, ...]

    def __post_init__(self):
        self.cols = tuple(self.cols)

    def describe(self) -> str:
        return f"Project({','.join(self.cols)})"


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
class JoinSortMerge(Join):
    """Physical sort-merge variant of :class:`Join`, introduced only by the
    planner's algorithm selection. ``describe()`` is inherited, so plan
    fingerprints do not move when the algorithm flips. ``fanout`` publicly
    bounds the build side's valid rows per key; ``build`` names that side
    (``"left"`` / ``"right"``)."""

    fanout: int = 1
    build: str = "left"


def _canonical_key(key) -> Union[str, Tuple[str, ...]]:
    """A one-column key is a plain string (the reference's canonical form)."""
    if isinstance(key, str):
        return key
    key = tuple(key)
    return key[0] if len(key) == 1 else key


class _Keyed:
    key: Union[str, Tuple[str, ...]]

    def __post_init__(self):
        self.key = _canonical_key(self.key)

    @property
    def keys(self) -> Tuple[str, ...]:
        return (self.key,) if isinstance(self.key, str) else self.key


@dataclasses.dataclass
class GroupByCount(_Keyed, PlanNode):
    """GROUP BY one or more key columns with COUNT(*)."""

    child: PlanNode
    key: Union[str, Tuple[str, ...]]
    count_name: str = "cnt"

    def describe(self) -> str:
        return f"GroupByCount({','.join(self.keys)}->{self.count_name})"


@dataclasses.dataclass
class GroupBySum(_Keyed, PlanNode):
    """GROUP BY key column(s) with SUM(col) (segmented arithmetic scan)."""

    child: PlanNode
    key: Union[str, Tuple[str, ...]]
    col: str = ""
    name: str = "sum"

    def describe(self) -> str:
        return f"GroupBySum({','.join(self.keys)}:{self.col}->{self.name})"


@dataclasses.dataclass
class GroupByAvg(_Keyed, PlanNode):
    """GROUP BY key column(s) with AVG(col): the per-group (sum, count) pair,
    divided after the reveal."""

    child: PlanNode
    key: Union[str, Tuple[str, ...]]
    col: str = ""
    name: str = "avg"

    def describe(self) -> str:
        return f"GroupByAvg({','.join(self.keys)}:{self.col}->{self.name})"


@dataclasses.dataclass
class OrderBy(PlanNode):
    child: PlanNode
    col: str
    descending: bool = False
    limit: Optional[int] = None

    def describe(self) -> str:
        return f"OrderBy({self.col}{' DESC' if self.descending else ''}, limit={self.limit})"


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
class Sum(PlanNode):
    """SUM(col) over true rows -> 1-row table with an arithmetic share."""

    child: PlanNode
    col: str
    name: str = "sum"

    def describe(self) -> str:
        return f"Sum({self.col}->{self.name})"


@dataclasses.dataclass
class Avg(PlanNode):
    """AVG(col) -> 1-row (sum, count) pair, divided after the reveal."""

    child: PlanNode
    col: str
    name: str = "avg"

    def describe(self) -> str:
        return f"Avg({self.col}->{self.name})"


@dataclasses.dataclass
class Min(PlanNode):
    """MIN(col) over true rows -> 1-row table (sort head); an empty
    selection reveals no row."""

    child: PlanNode
    col: str
    name: str = "min"

    def describe(self) -> str:
        return f"Min({self.col}->{self.name})"


@dataclasses.dataclass
class Max(PlanNode):
    """MAX(col) over true rows -> 1-row table (sort head)."""

    child: PlanNode
    col: str
    name: str = "max"

    def describe(self) -> str:
        return f"Max({self.col}->{self.name})"


@dataclasses.dataclass
class Resize(PlanNode):
    child: PlanNode
    cfg: ResizerConfig

    def describe(self) -> str:
        return f"Resize[{self.cfg.describe()}]"
