"""Operator registry for the port's plan nodes.

Each node type registers one :class:`OperatorDef`: its output schema (the
compile-time column check that runs before any MPC work), how the engine
applies it, and its Resizer-placement hints. The port runs eagerly with no
jit cache, so one ``apply(engine, node, children)`` hook serves stateless
protocols and stateful operators (Scan reads the engine's tables; Resize
folds the engine's noise counter) alike. The flags are the reference's:
``resizer="internal"`` marks where a placement may insert a Resize,
``balloons`` the product join, ``singleton`` a 1-row output, and
``post_reveal`` derives AVG's quotient from the revealed (sum, cnt) rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Type

import numpy as np

from ..core import threefry
from ..core.resizer import Resizer
from ..errors import PlanSchemaError
from ..ops.aggregate import avg_column, count_distinct, count_valid, max_column, min_column, sum_column
from ..ops.distinct import oblivious_distinct
from ..ops.filter import oblivious_filter, pred_leaves
from ..ops.groupby import oblivious_groupby_avg, oblivious_groupby_count, oblivious_groupby_sum
from ..ops.join import _disambiguate, oblivious_join
from ..ops.orderby import oblivious_orderby
from .nodes import (
    Avg,
    CountDistinct,
    CountValid,
    Distinct,
    Filter,
    GroupByAvg,
    GroupByCount,
    GroupBySum,
    Having,
    Join,
    Max,
    Min,
    OrderBy,
    PlanNode,
    Project,
    Resize,
    Scan,
    Sum,
)

__all__ = ["OperatorDef", "PlanSchema", "register", "lookup", "infer_schema"]


@dataclasses.dataclass
class PlanSchema:
    """Ordered output columns of one plan node: name -> share kind, ``"b"``
    for an XOR-shared word, ``"a"`` for an arithmetic share (a count)."""

    cols: Dict[str, str]

    @property
    def names(self) -> List[str]:
        return list(self.cols)

    def kind(self, name: str) -> str:
        return self.cols[name]

    def require(self, col: str, node: PlanNode) -> None:
        if col not in self.names:
            raise PlanSchemaError(
                f"{node.describe()} references column {col!r}, but its input "
                f"produces only {self.names}",
                node=node.describe(),
                column=col,
                available=self.names,
            )

    def require_pred(self, pred, node: PlanNode) -> None:
        for leaf in pred_leaves(pred):
            self.require(leaf.column, node)
            if isinstance(leaf.value, str) and leaf.value.startswith("col:"):
                self.require(leaf.value[4:], node)


def infer_schema(plan: PlanNode, catalog: Dict[str, List[str]]) -> PlanSchema:
    """Propagate the column set bottom-up through ``plan`` against a catalog
    (table name -> column names), raising :class:`PlanSchemaError` at the
    first unresolvable reference."""
    d = lookup(type(plan))
    children = [infer_schema(c, catalog) for c in plan.children()]
    return d.schema(plan, children, catalog)


@dataclasses.dataclass(frozen=True)
class OperatorDef:
    node_type: Type[PlanNode]
    schema: Callable[[PlanNode, List[PlanSchema], Dict[str, List[str]]], PlanSchema]
    apply: Callable  # (engine, node, children) -> SecretTable
    resizer: str = "skip"  # internal | skip
    balloons: bool = False  # output is larger than inputs (join product)
    singleton: bool = False  # 1-row output
    provides_resize_info: bool = False
    post_reveal: Optional[Callable] = None  # (node, revealed rows) -> rows


_REGISTRY: Dict[Type[PlanNode], OperatorDef] = {}


def register(d: OperatorDef) -> OperatorDef:
    if d.node_type in _REGISTRY:
        raise ValueError(f"duplicate OperatorDef for {d.node_type.__name__}")
    _REGISTRY[d.node_type] = d
    return d


def lookup(node_type: Type[PlanNode]) -> OperatorDef:
    try:
        return _REGISTRY[node_type]
    except KeyError:
        raise TypeError(f"unregistered plan node {node_type.__name__}") from None


# -----------------------------------------------------------------------------
# Operator definitions
# -----------------------------------------------------------------------------

def _scan_schema(node: Scan, children, catalog) -> PlanSchema:
    if node.table not in catalog:
        raise PlanSchemaError(
            f"Scan references unknown table {node.table!r}",
            node=node.describe(),
            table=node.table,
            available=sorted(catalog),
        )
    return PlanSchema(dict.fromkeys(catalog[node.table], "b"))


register(OperatorDef(
    node_type=Scan,
    schema=_scan_schema,
    apply=lambda eng, node, children: eng.tables[node.table],
))


def _filter_schema(node: Filter, children, catalog) -> PlanSchema:
    children[0].require_pred(node.pred, node)
    return children[0]


register(OperatorDef(
    node_type=Filter,
    schema=_filter_schema,
    apply=lambda eng, node, children: oblivious_filter(children[0], node.pred, eng.prf),
    resizer="internal",
))


def _project_schema(node: Project, children, catalog) -> PlanSchema:
    c = children[0]
    for col in node.cols:
        c.require(col, node)
    return PlanSchema({n: c.kind(n) for n in node.cols})


register(OperatorDef(
    node_type=Project,
    schema=_project_schema,
    apply=lambda eng, node, children: children[0].select_columns(node.cols),
))


def _join_schema(node: Join, children, catalog) -> PlanSchema:
    left, right = children
    left.require(node.on[0], node)
    right.require(node.on[1], node)
    if node.theta is not None:
        left.require(node.theta[0], node)
        right.require(node.theta[2], node)
    merged = dict(left.cols)
    for name, kind in right.cols.items():
        merged[_disambiguate(merged, name)] = kind
    return PlanSchema(merged)


register(OperatorDef(
    node_type=Join,
    schema=_join_schema,
    apply=lambda eng, node, children: oblivious_join(
        children[0], children[1], node.on, eng.prf, theta=node.theta,
        tile=eng.config.join_tile,
    ),
    resizer="internal",
    balloons=True,
))


def _groupby_schema(node: GroupByCount, children, catalog) -> PlanSchema:
    c = children[0]
    for k in node.keys:
        c.require(k, node)
    out = {k: c.kind(k) for k in node.keys}
    out[node.count_name] = "a"
    return PlanSchema(out)


register(OperatorDef(
    node_type=GroupByCount,
    schema=_groupby_schema,
    apply=lambda eng, node, children: oblivious_groupby_count(children[0], node.keys, eng.prf, node.count_name),
    resizer="internal",
))


def _groupby_agg_schema(out_names):
    def schema(node, children, catalog) -> PlanSchema:
        c = children[0]
        for k in node.keys:
            c.require(k, node)
        c.require(node.col, node)
        out = {k: c.kind(k) for k in node.keys}
        out.update(dict.fromkeys(out_names(node), "a"))
        return PlanSchema(out)

    return schema


def _avg_rows(name: str, rows: Dict, keep_parts: bool) -> Dict:
    """``{name} = {name}_sum // max({name}_cnt, 1)`` over revealed rows."""
    s, c = rows.get(f"{name}_sum"), rows.get(f"{name}_cnt")
    if s is None or c is None:
        return rows
    parts = (f"{name}_sum", f"{name}_cnt")
    out = {k: v for k, v in rows.items() if keep_parts or k not in parts}
    out[name] = s // np.maximum(c, 1)
    return out


register(OperatorDef(
    node_type=GroupBySum,
    schema=_groupby_agg_schema(lambda node: [node.name]),
    apply=lambda eng, node, children: oblivious_groupby_sum(children[0], node.keys, node.col, eng.prf, node.name),
    resizer="internal",
))


register(OperatorDef(
    node_type=GroupByAvg,
    schema=_groupby_agg_schema(lambda node: [f"{node.name}_sum", f"{node.name}_cnt"]),
    apply=lambda eng, node, children: oblivious_groupby_avg(children[0], node.keys, node.col, eng.prf, node.name),
    resizer="internal",
    post_reveal=lambda node, rows: _avg_rows(node.name, rows, keep_parts=False),
))


def _having_schema(node: Having, children, catalog) -> PlanSchema:
    children[0].require_pred(node.pred, node)
    return children[0]


# WHERE's protocol on the GROUP BY output: a compare on the count column goes
# through bshare_col's a2b; validity bits flip, the size stays
register(OperatorDef(
    node_type=Having,
    schema=_having_schema,
    apply=lambda eng, node, children: oblivious_filter(children[0], node.pred, eng.prf),
    resizer="internal",
))


def _orderby_schema(node: OrderBy, children, catalog) -> PlanSchema:
    children[0].require(node.col, node)
    return children[0]


register(OperatorDef(
    node_type=OrderBy,
    schema=_orderby_schema,
    apply=lambda eng, node, children: oblivious_orderby(
        children[0], node.col, eng.prf, descending=node.descending, limit=node.limit
    ),
))


def _distinct_schema(node: Distinct, children, catalog) -> PlanSchema:
    children[0].require(node.col, node)
    return children[0]


register(OperatorDef(
    node_type=Distinct,
    schema=_distinct_schema,
    apply=lambda eng, node, children: oblivious_distinct(children[0], node.col, eng.prf),
))


def _count_distinct_schema(node: CountDistinct, children, catalog) -> PlanSchema:
    children[0].require(node.col, node)
    return PlanSchema({"cnt": "a"})


register(OperatorDef(
    node_type=CountValid,
    schema=lambda node, children, catalog: PlanSchema({"cnt": "a"}),
    apply=lambda eng, node, children: count_valid(children[0], eng.prf),
    singleton=True,
))


register(OperatorDef(
    node_type=CountDistinct,
    schema=_count_distinct_schema,
    apply=lambda eng, node, children: count_distinct(children[0], node.col, eng.prf),
    singleton=True,
))


def _aggregate_schema(out_names, kind: str):
    def schema(node, children, catalog) -> PlanSchema:
        children[0].require(node.col, node)
        return PlanSchema(dict.fromkeys(out_names(node), kind))

    return schema


register(OperatorDef(
    node_type=Sum,
    schema=_aggregate_schema(lambda node: [node.name], "a"),
    apply=lambda eng, node, children: sum_column(children[0], node.col, eng.prf, node.name),
    singleton=True,
))


register(OperatorDef(
    node_type=Avg,
    schema=_aggregate_schema(lambda node: [f"{node.name}_sum", f"{node.name}_cnt"], "a"),
    apply=lambda eng, node, children: avg_column(children[0], node.col, eng.prf, node.name),
    singleton=True,
    post_reveal=lambda node, rows: _avg_rows(node.name, rows, keep_parts=True),
))


register(OperatorDef(
    node_type=Min,
    schema=_aggregate_schema(lambda node: [node.name], "b"),
    apply=lambda eng, node, children: min_column(children[0], node.col, eng.prf, node.name),
    singleton=True,
))


register(OperatorDef(
    node_type=Max,
    schema=_aggregate_schema(lambda node: [node.name], "b"),
    apply=lambda eng, node, children: max_column(children[0], node.col, eng.prf, node.name),
    singleton=True,
))


def _apply_resize(eng, node: Resize, children):
    eng._resize_ctr += 1
    rkey = threefry.fold_in(eng.key, 1000 + eng._resize_ctr)
    out, info = Resizer(node.cfg)(
        children[0],
        eng.prf.fold(900 + eng._resize_ctr),
        rkey,
    )
    eng._last_resize_info = info
    return out


register(OperatorDef(
    node_type=Resize,
    schema=lambda node, children, catalog: children[0],
    apply=_apply_resize,
    provides_resize_info=True,
))
