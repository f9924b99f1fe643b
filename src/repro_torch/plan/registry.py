"""Operator registry for the port's plan nodes.

Each node type registers one :class:`OperatorDef`: its output schema (the
compile-time column check that runs before any MPC work), how the engine
applies it, and its Resizer-placement hints. The port runs eagerly with no
jit cache, so one ``apply(engine, node, children)`` hook serves stateless
protocols and stateful operators (Scan reads the engine's tables; Resize
folds the engine's noise counter) alike.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Type

from ..core import threefry
from ..core.resizer import Resizer
from ..errors import PlanSchemaError
from ..ops.aggregate import count_distinct, count_valid
from ..ops.distinct import oblivious_distinct
from ..ops.filter import oblivious_filter, pred_leaves
from ..ops.join import _disambiguate, oblivious_join
from .nodes import CountDistinct, CountValid, Distinct, Filter, Join, PlanNode, Resize, Scan

__all__ = ["OperatorDef", "PlanSchema", "register", "lookup", "infer_schema"]


@dataclasses.dataclass
class PlanSchema:
    """Ordered output columns of one plan node: name -> share kind, ``"b"``
    for an XOR-shared word, ``"a"`` for an arithmetic share (a count)."""

    cols: Dict[str, str]

    @property
    def names(self) -> List[str]:
        return list(self.cols)

    def require(self, col: str, node: PlanNode) -> None:
        if col not in self.names:
            raise PlanSchemaError(
                f"{node.describe()} references column {col!r}, but its input "
                f"produces only {self.names}",
                node=node.describe(),
                column=col,
                available=self.names,
            )


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
    provides_resize_info: bool = False


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
    for leaf in pred_leaves(node.pred):
        children[0].require(leaf.column, node)
        if isinstance(leaf.value, str) and leaf.value.startswith("col:"):
            children[0].require(leaf.value[4:], node)
    return children[0]


register(OperatorDef(
    node_type=Filter,
    schema=_filter_schema,
    apply=lambda eng, node, children: oblivious_filter(children[0], node.pred, eng.prf),
    resizer="internal",
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
))


register(OperatorDef(
    node_type=CountDistinct,
    schema=_count_distinct_schema,
    apply=lambda eng, node, children: count_distinct(children[0], node.col, eng.prf),
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
