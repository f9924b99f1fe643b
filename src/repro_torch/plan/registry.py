"""Operator registry for the port's plan nodes.

Each node type registers one :class:`OperatorDef`: its output schema (the
compile-time column check that runs before any MPC work), how the engine
applies it, its cost ``estimate`` (``(node, child estimates, cost model) ->
{"n", "t", "cols", "bytes"}``, the analytic bytes per party that
:mod:`.cost` sums), its SQL rendering hooks (``render_rel`` for the
FROM/WHERE subtree, ``render_head``, ``render_order``, ``render_having``;
``sql_shape`` says where the node may stand in rendered SQL) and its
Resizer-placement hints. The port runs eagerly with no jit cache, so one
``apply(engine, node, children)`` hook serves stateless protocols and
stateful operators (Scan reads the engine's tables; Resize folds the
engine's noise counter) alike; in a batched pass a stateless ``apply`` runs
once under ``torch.func.vmap`` over the stacked slots, and the stateful two
give a ``batch_apply`` hook (``batchable=False`` marks the reference's
operators that never run stacked). The flags are the reference's:
``resizer="internal"`` marks where a placement may insert a Resize,
``balloons`` the joins, ``singleton`` a 1-row output, and ``post_reveal``
derives AVG's quotient from the revealed (sum, cnt) rows. Estimates and
renderings are those of ``repro.plan.registry``, float for float and
character for character.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Type

import numpy as np

from ..config import current_config
from ..core import threefry
from ..core.resizer import Resizer
from ..errors import PlanSchemaError
from ..ops.aggregate import avg_column, count_distinct, count_valid, max_column, min_column, sum_column
from ..ops.distinct import oblivious_distinct
from ..ops.filter import And, Or, oblivious_filter, pred_leaves, render_pred
from ..ops.groupby import oblivious_groupby_avg, oblivious_groupby_count, oblivious_groupby_sum
from ..ops.join import _disambiguate, oblivious_join
from ..ops.join_sortmerge import oblivious_join_sortmerge
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
    JoinSortMerge,
    Max,
    Min,
    OrderBy,
    PlanNode,
    Project,
    Resize,
    Scan,
    Sum,
)

__all__ = [
    "OperatorDef",
    "PlanSchema",
    "register",
    "lookup",
    "plan_batchable",
    "infer_schema",
    "BYTES",
    "sort_bytes",
    "shuffle_bytes",
    "resizer_bytes",
    "sortmerge_join_bytes",
]


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


def infer_schema(plan: PlanNode, catalog) -> PlanSchema:
    """Propagate the column set bottom-up through ``plan`` against a
    :class:`repro_torch.sql.catalog.Catalog`, raising
    :class:`PlanSchemaError` at the first unresolvable reference."""
    d = lookup(type(plan))
    children = [infer_schema(c, catalog) for c in plan.children()]
    return d.schema(plan, children, catalog)


@dataclasses.dataclass(frozen=True)
class OperatorDef:
    node_type: Type[PlanNode]
    schema: Callable[[PlanNode, List[PlanSchema], object], PlanSchema]
    apply: Callable  # (engine, node, children) -> SecretTable
    estimate: Callable[[PlanNode, List[Dict], object], Dict]
    render_rel: Optional[Callable] = None
    render_head: Optional[Callable] = None
    render_order: Optional[Callable] = None
    render_having: Optional[Callable] = None
    sql_shape: str = "none"  # leaf | relational | head | order | having | none
    resizer: str = "skip"  # internal | skip
    balloons: bool = False  # output is larger than inputs (join product)
    singleton: bool = False  # 1-row output
    provides_resize_info: bool = False
    post_reveal: Optional[Callable] = None  # (node, revealed rows) -> rows
    batchable: bool = True  # may run in the engine's stacked multi-query pass
    batch_apply: Optional[Callable] = None  # stateful batched-execution hook


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


def plan_batchable(plan: PlanNode) -> bool:
    """True iff every operator of ``plan`` may run inside the engine's
    stacked multi-query pass (``Engine.execute_batch``); other plans run
    serially."""
    if not lookup(type(plan)).batchable:
        return False
    return all(plan_batchable(c) for c in plan.children())


# -----------------------------------------------------------------------------
# Cost model pieces: bytes per party of each circuit and protocol
# -----------------------------------------------------------------------------

BYTES = {
    "and": 4,
    "eq": 20,
    "lt": 44,
    "bit2a": 8,
    "a2b": 88,
    "b2a": 256,
}


def _stages(n: int) -> int:
    m = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    return m * (m + 1) // 2


def sort_bytes(n: int, ncols: int) -> float:
    return _stages(n) * n * (BYTES["lt"] + BYTES["and"] * (ncols + 2))


def shuffle_bytes(n: int, ncols: int) -> float:
    return 3 * n * 4 * (ncols + 2)


def resizer_bytes(n: int, ncols: int) -> float:
    noise_add = n * (BYTES["a2b"] + BYTES["lt"] + BYTES["and"])
    return noise_add + shuffle_bytes(n, ncols) + 4 * n  # + reveal k


def _leaf_bytes(leaf) -> int:
    return BYTES["eq"] if leaf.op == "eq" else BYTES["lt"]


# -----------------------------------------------------------------------------
# SQL rendering helpers (the renderer's state comes in as ``r``)
# -----------------------------------------------------------------------------

_OP_SYM = {"eq": "=", "lt": "<", "le": "<=", "gt": ">"}


def _sql_leaf(p, qual) -> str:
    if isinstance(p.value, str) and p.value.startswith("col:"):
        return f"{qual(p.column)} {_OP_SYM[p.op]} {qual(p.value[4:])}"
    return f"{qual(p.column)} {_OP_SYM[p.op]} {int(p.value)}"


def sql_conjuncts(pred, qual) -> List[str]:
    """WHERE conjuncts of a predicate tree: top-level AND terms apart, an OR
    term as one parenthesized conjunct."""
    fmt = lambda p: _sql_leaf(p, qual)
    terms = pred.terms if isinstance(pred, And) else (pred,)
    return [f"({render_pred(t, fmt)})" if isinstance(t, Or) else render_pred(t, fmt) for t in terms]


# -----------------------------------------------------------------------------
# Operator definitions
# -----------------------------------------------------------------------------

def _scan_schema(node: Scan, children, catalog) -> PlanSchema:
    if node.table not in catalog.tables:
        raise PlanSchemaError(
            f"Scan references unknown table {node.table!r}",
            node=node.describe(),
            table=node.table,
            available=sorted(catalog.tables),
        )
    return PlanSchema(dict.fromkeys(catalog.columns(node.table), "b"))


def _scan_estimate(node: Scan, children, cm) -> Dict:
    n = cm.table_sizes[node.table]
    return {"n": n, "t": n, "cols": cm.table_cols[node.table], "bytes": 0.0}


def _render_scan(r, node: Scan):
    alias = f"t{len(r.aliases)}"
    r.aliases.append((alias, node.table))
    if node.table not in r.catalog.tables:
        raise ValueError(f"table {node.table!r} not in catalog")
    return r.schema_for_table(alias, r.catalog.columns(node.table))


register(OperatorDef(
    node_type=Scan,
    schema=_scan_schema,
    apply=lambda eng, node, children: eng.tables[node.table],
    # batched pass: every slot reads the same base table, broadcast
    batch_apply=lambda eng, node, children, ctx: eng._batch_scan(node, ctx),
    estimate=_scan_estimate,
    render_rel=_render_scan,
    sql_shape="leaf",
))


def _filter_schema(node: Filter, children, catalog) -> PlanSchema:
    children[0].require_pred(node.pred, node)
    return children[0]


def _filter_estimate(node, children, cm) -> Dict:
    c = children[0]
    leaves = pred_leaves(node.pred)
    k = len(leaves)
    cost = c["n"] * (sum(_leaf_bytes(p) for p in leaves) + BYTES["and"] * k)
    return {
        "n": c["n"],
        "t": max(c["t"] * cm.selectivity ** k, 1),
        "cols": c["cols"],
        "bytes": c["bytes"] + cost,
    }


def _render_filter(r, node: Filter):
    schema = r.walk(node.child)
    r.filters.extend(sql_conjuncts(node.pred, lambda col: r.qual(schema, col)))
    return schema


register(OperatorDef(
    node_type=Filter,
    schema=_filter_schema,
    apply=lambda eng, node, children: oblivious_filter(children[0], node.pred, eng.prf),
    estimate=_filter_estimate,
    render_rel=_render_filter,
    sql_shape="relational",
    resizer="internal",
))


def _project_schema(node: Project, children, catalog) -> PlanSchema:
    c = children[0]
    for col in node.cols:
        c.require(col, node)
    return PlanSchema({n: c.kind(n) for n in node.cols})


def _project_estimate(node: Project, children, cm) -> Dict:
    c = children[0]
    # free: a local projection keeps the row count
    return {"n": c["n"], "t": c["t"], "cols": len(node.cols), "bytes": c["bytes"]}


register(OperatorDef(
    node_type=Project,
    schema=_project_schema,
    apply=lambda eng, node, children: children[0].select_columns(node.cols),
    estimate=_project_estimate,
    render_head=lambda r, node, schema: (", ".join(r.qual(schema, c) for c in node.cols), None),
    sql_shape="head",
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


def _join_estimate(node: Join, children, cm) -> Dict:
    left, right = children
    n = left["n"] * right["n"]
    cost = n * (BYTES["eq"] + 2 * BYTES["and"])
    if node.theta:
        cost += n * (BYTES["lt"] + BYTES["and"])
    return {
        "n": n,
        "t": max(left["t"] * right["t"] * cm.join_selectivity, 1),
        "cols": left["cols"] + right["cols"],
        "bytes": left["bytes"] + right["bytes"] + cost,
    }


def _render_join(r, node: Join):
    left = r.walk(node.left)
    right = r.walk(node.right)
    right_alias, right_table = r.aliases[-1]
    conds = [f"{r.qual(left, node.on[0])} = {r.qual(right, node.on[1])}"]
    if node.theta is not None:
        lcol, op, rcol = node.theta
        conds.append(f"{r.qual(left, lcol)} {_OP_SYM[op]} {r.qual(right, rcol)}")
    r.joins.append(f"JOIN {right_table} {right_alias} ON " + " AND ".join(conds))
    return left.merge(right)


register(OperatorDef(
    node_type=Join,
    schema=_join_schema,
    apply=lambda eng, node, children: oblivious_join(
        children[0], children[1], node.on, eng.prf, theta=node.theta,
        tile=current_config().join_tile,
    ),
    estimate=_join_estimate,
    render_rel=_render_join,
    sql_shape="relational",
    resizer="internal",
    balloons=True,
))


def sortmerge_join_bytes(
    n1: int,
    n2: int,
    build_cols: int,
    probe_cols: int,
    fanout: int = 1,
    theta: bool = False,
) -> float:
    """Analytic bytes per party of the sort-merge join: the union sort over
    pow2(n1 + n2) rows, the payload's gather, the segmented scan."""
    n = 1 << max(int(math.ceil(math.log2(max(n1 + n2, 2)))), 1)
    levels = max(int(math.log2(n)), 1)
    # union sort: 3 network columns (key, origin, index), a 2-key compare
    cost = _stages(n) * n * (BYTES["lt"] + 3 * BYTES["and"])
    cost += _stages(n) * n * (BYTES["eq"] + BYTES["lt"] + 2 * BYTES["and"])
    # the gather by shuffle-and-reveal: a 1-column shuffle, an n-word
    # reveal, the (build + probe + valid)-column inverse shuffle
    w = build_cols + probe_cols + 1
    cost += 3 * n * 4 + 4 * n + 3 * n * 4 * w
    # segment boundary equality + build-row marker AND
    cost += n * (BYTES["eq"] + BYTES["and"])
    if fanout > 1:
        # rank scan (2 bit2a + 2 ring mults a level), one a2b, batched rank eq
        cost += n * 2 * BYTES["bit2a"] + levels * n * 8 + n * BYTES["a2b"]
        cost += fanout * n * (BYTES["eq"] + BYTES["and"])
    # segmented copy-last scan: 3 control ANDs + a build-width select a level
    cost += levels * fanout * n * (3 + max(build_cols, 1)) * BYTES["and"]
    # output validity
    cost += 2 * fanout * n * BYTES["and"]
    if theta:
        cost += fanout * n * (BYTES["lt"] + BYTES["and"])
    return cost


def _sortmerge_estimate(node: JoinSortMerge, children, cm) -> Dict:
    left, right = children
    bc, pc = (left["cols"], right["cols"]) if node.build == "left" else (right["cols"], left["cols"])
    n_union = 1 << max(int(math.ceil(math.log2(max(left["n"] + right["n"], 2)))), 1)
    cost = sortmerge_join_bytes(
        int(left["n"]), int(right["n"]), int(bc), int(pc), node.fanout, node.theta is not None
    )
    return {
        "n": node.fanout * n_union,
        "t": max(left["t"] * right["t"] * cm.join_selectivity, 1),
        "cols": left["cols"] + right["cols"],
        "bytes": left["bytes"] + right["bytes"] + cost,
    }


# physical only: the planner's algorithm selection introduces it after
# compilation; SQL renders from the logical Join
register(OperatorDef(
    node_type=JoinSortMerge,
    schema=_join_schema,
    apply=lambda eng, node, children: oblivious_join_sortmerge(
        children[0], children[1], node.on, eng.prf, theta=node.theta,
        fanout=node.fanout, build=node.build,
    ),
    estimate=_sortmerge_estimate,
    resizer="internal",
    balloons=True,
))


def _sortish_estimate(c: Dict, extra_key_cols: int = 0):
    """The sort-based cost core GroupBy, Distinct and OrderBy share."""
    n = 1 << max(int(math.ceil(math.log2(max(c["n"], 2)))), 0)
    cost = sort_bytes(n, c["cols"]) + n * (BYTES["eq"] + 4 * BYTES["and"])
    cost += extra_key_cols * _stages(n) * n * (BYTES["eq"] + BYTES["lt"] + 2 * BYTES["and"])
    return n, cost


def _groupby_schema(node: GroupByCount, children, catalog) -> PlanSchema:
    c = children[0]
    for k in node.keys:
        c.require(k, node)
    out = {k: c.kind(k) for k in node.keys}
    out[node.count_name] = "a"
    return PlanSchema(out)


def _groupby_estimate(node: GroupByCount, children, cm) -> Dict:
    c = children[0]
    n, cost = _sortish_estimate(c, extra_key_cols=len(node.keys) - 1)
    cost += n * 2 * BYTES["bit2a"] + math.log2(max(n, 2)) * n * 8
    return {"n": n, "t": min(c["t"], n), "cols": len(node.keys) + 1, "bytes": c["bytes"] + cost}


def _render_groupby_head(r, node: GroupByCount, schema):
    keys = [r.qual(schema, k) for k in node.keys]
    return ", ".join(keys) + f", COUNT(*) AS {node.count_name}", "GROUP BY " + ", ".join(keys)


register(OperatorDef(
    node_type=GroupByCount,
    schema=_groupby_schema,
    apply=lambda eng, node, children: oblivious_groupby_count(children[0], node.keys, eng.prf, node.count_name),
    estimate=_groupby_estimate,
    render_head=_render_groupby_head,
    sql_shape="head",
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


def _groupby_agg_estimate(node, children, cm) -> Dict:
    c = children[0]
    n, cost = _sortish_estimate(c, extra_key_cols=len(node.keys) - 1)
    # value b2a + valid bit2a + mask mult + the segmented scan over the pair
    cost += n * (BYTES["b2a"] + 2 * BYTES["bit2a"] + BYTES["and"])
    cost += math.log2(max(n, 2)) * n * 16
    return {"n": n, "t": min(c["t"], n), "cols": len(node.keys) + 2, "bytes": c["bytes"] + cost}


def _render_groupby_agg_head(kw: str, default_name: str):
    # the default name is a dialect keyword: the alias renders only when set
    def render(r, node, schema):
        keys = [r.qual(schema, k) for k in node.keys]
        alias = f" AS {node.name}" if node.name != default_name else ""
        head = ", ".join(keys) + f", {kw}({r.qual(schema, node.col)}){alias}"
        return head, "GROUP BY " + ", ".join(keys)

    return render


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
    estimate=_groupby_agg_estimate,
    render_head=_render_groupby_agg_head("SUM", "sum"),
    sql_shape="head",
    resizer="internal",
))


register(OperatorDef(
    node_type=GroupByAvg,
    batchable=False,
    schema=_groupby_agg_schema(lambda node: [f"{node.name}_sum", f"{node.name}_cnt"]),
    apply=lambda eng, node, children: oblivious_groupby_avg(children[0], node.keys, node.col, eng.prf, node.name),
    estimate=_groupby_agg_estimate,
    render_head=_render_groupby_agg_head("AVG", "avg"),
    sql_shape="head",
    resizer="internal",
    post_reveal=lambda node, rows: _avg_rows(node.name, rows, keep_parts=False),
))


def _having_schema(node: Having, children, catalog) -> PlanSchema:
    children[0].require_pred(node.pred, node)
    return children[0]


def _render_having(r, node: Having, head_node, schema) -> str:
    """HAVING clause text: the aggregate column renders back to its SQL
    expression, group keys re-qualify against the input."""
    agg = {}
    if isinstance(head_node, GroupByCount):
        agg[head_node.count_name] = "COUNT(*)"
    elif isinstance(head_node, GroupBySum):
        agg[head_node.name] = f"SUM({r.qual(schema, head_node.col)})"
    else:
        raise ValueError("HAVING renders only over GROUP BY COUNT(*)/SUM heads")
    qual = lambda col: agg.get(col) or r.qual(schema, col)
    return "HAVING " + " AND ".join(sql_conjuncts(node.pred, qual))


# WHERE's protocol on the GROUP BY output: a compare on the count column goes
# through bshare_col's a2b; validity bits flip, the size stays
register(OperatorDef(
    node_type=Having,
    schema=_having_schema,
    apply=lambda eng, node, children: oblivious_filter(children[0], node.pred, eng.prf),
    estimate=_filter_estimate,
    render_having=_render_having,
    sql_shape="having",
    resizer="internal",
))


def _orderby_schema(node: OrderBy, children, catalog) -> PlanSchema:
    children[0].require(node.col, node)
    return children[0]


def _orderby_estimate(node: OrderBy, children, cm) -> Dict:
    c = children[0]
    n, cost = _sortish_estimate(c)
    out_n = node.limit if node.limit else n
    return {"n": out_n, "t": min(c["t"], out_n), "cols": c["cols"] + 1, "bytes": c["bytes"] + cost}


def _render_order(r, node: OrderBy, head_node, schema) -> str:
    count_name = getattr(head_node, "count_name", None)
    if count_name is not None and node.col == count_name:
        return "COUNT(*)"
    return r.qual(schema, node.col)


register(OperatorDef(
    node_type=OrderBy,
    schema=_orderby_schema,
    apply=lambda eng, node, children: oblivious_orderby(
        children[0], node.col, eng.prf, descending=node.descending, limit=node.limit
    ),
    estimate=_orderby_estimate,
    render_order=_render_order,
    sql_shape="order",
))


def _distinct_schema(node: Distinct, children, catalog) -> PlanSchema:
    children[0].require(node.col, node)
    return children[0]


def _distinct_estimate(node: Distinct, children, cm) -> Dict:
    c = children[0]
    n, cost = _sortish_estimate(c)
    return {"n": n, "t": min(c["t"], n), "cols": c["cols"] + 1, "bytes": c["bytes"] + cost}


register(OperatorDef(
    node_type=Distinct,
    schema=_distinct_schema,
    apply=lambda eng, node, children: oblivious_distinct(children[0], node.col, eng.prf),
    estimate=_distinct_estimate,
    render_head=lambda r, node, schema: (f"DISTINCT {r.qual(schema, node.col)}", None),
    sql_shape="head",
))


def _count_distinct_schema(node: CountDistinct, children, catalog) -> PlanSchema:
    children[0].require(node.col, node)
    return PlanSchema({"cnt": "a"})


def _count_estimate(node, children, cm) -> Dict:
    c = children[0]
    return {"n": 1, "t": 1, "cols": 1, "bytes": c["bytes"] + c["n"] * BYTES["bit2a"]}


def _count_distinct_estimate(node: CountDistinct, children, cm) -> Dict:
    c = children[0]
    cost = c["n"] * BYTES["bit2a"] + sort_bytes(c["n"], c["cols"]) + c["n"] * BYTES["eq"]
    return {"n": 1, "t": 1, "cols": 1, "bytes": c["bytes"] + cost}


register(OperatorDef(
    node_type=CountValid,
    batchable=False,
    schema=lambda node, children, catalog: PlanSchema({"cnt": "a"}),
    apply=lambda eng, node, children: count_valid(children[0], eng.prf),
    estimate=_count_estimate,
    render_head=lambda r, node, schema: ("COUNT(*)", None),
    sql_shape="head",
    singleton=True,
))


register(OperatorDef(
    node_type=CountDistinct,
    batchable=False,
    schema=_count_distinct_schema,
    apply=lambda eng, node, children: count_distinct(children[0], node.col, eng.prf),
    estimate=_count_distinct_estimate,
    render_head=lambda r, node, schema: (f"COUNT(DISTINCT {r.qual(schema, node.col)})", None),
    sql_shape="head",
    singleton=True,
))


def _aggregate_schema(out_names, kind: str):
    def schema(node, children, catalog) -> PlanSchema:
        children[0].require(node.col, node)
        return PlanSchema(dict.fromkeys(out_names(node), kind))

    return schema


def _sum_estimate(node: Sum, children, cm) -> Dict:
    c = children[0]
    cost = c["n"] * (BYTES["b2a"] + BYTES["bit2a"] + BYTES["and"])
    return {"n": 1, "t": 1, "cols": 1, "bytes": c["bytes"] + cost}


def _avg_estimate(node: Avg, children, cm) -> Dict:
    c = children[0]
    cost = c["n"] * (BYTES["b2a"] + 2 * BYTES["bit2a"] + BYTES["and"])
    return {"n": 1, "t": 1, "cols": 2, "bytes": c["bytes"] + cost}


def _minmax_estimate(node, children, cm) -> Dict:
    # a sort head: only the aggregated column rides the sort
    c = children[0]
    n, cost = _sortish_estimate({**c, "cols": 1})
    return {"n": 1, "t": 1, "cols": 1, "bytes": c["bytes"] + cost}


def _render_aggregate_head(kw: str, default_name: str):
    # the default name is a dialect keyword: the alias renders only when set
    def render(r, node, schema):
        alias = f" AS {node.name}" if node.name != default_name else ""
        return f"{kw}({r.qual(schema, node.col)}){alias}", None

    return render


register(OperatorDef(
    node_type=Sum,
    batchable=False,
    schema=_aggregate_schema(lambda node: [node.name], "a"),
    apply=lambda eng, node, children: sum_column(children[0], node.col, eng.prf, node.name),
    estimate=_sum_estimate,
    render_head=_render_aggregate_head("SUM", "sum"),
    sql_shape="head",
    singleton=True,
))


register(OperatorDef(
    node_type=Avg,
    batchable=False,
    schema=_aggregate_schema(lambda node: [f"{node.name}_sum", f"{node.name}_cnt"], "a"),
    apply=lambda eng, node, children: avg_column(children[0], node.col, eng.prf, node.name),
    estimate=_avg_estimate,
    render_head=_render_aggregate_head("AVG", "avg"),
    sql_shape="head",
    singleton=True,
    post_reveal=lambda node, rows: _avg_rows(node.name, rows, keep_parts=True),
))


register(OperatorDef(
    node_type=Min,
    batchable=False,
    schema=_aggregate_schema(lambda node: [node.name], "b"),
    apply=lambda eng, node, children: min_column(children[0], node.col, eng.prf, node.name),
    estimate=_minmax_estimate,
    render_head=_render_aggregate_head("MIN", "min"),
    sql_shape="head",
    singleton=True,
))


register(OperatorDef(
    node_type=Max,
    batchable=False,
    schema=_aggregate_schema(lambda node: [node.name], "b"),
    apply=lambda eng, node, children: max_column(children[0], node.col, eng.prf, node.name),
    estimate=_minmax_estimate,
    render_head=_render_aggregate_head("MAX", "max"),
    sql_shape="head",
    singleton=True,
))


def _apply_resize(eng, node: Resize, children):
    eng._resize_ctr += 1
    rkey = threefry.fold_in(eng.key, 1000 + eng._resize_ctr)
    out, info = Resizer(node.cfg)(
        children[0],
        eng.prf.fold(900 + eng._resize_ctr),
        rkey,
        bucket_fn=eng.bucket_fn,
    )
    eng._last_resize_info = info
    return out


def _resize_estimate(node: Resize, children, cm) -> Dict:
    c = children[0]
    s = min(c["t"] + node.cfg.noise.mean(int(c["n"]), int(c["t"])), c["n"])
    return {"n": s, "t": c["t"], "cols": c["cols"], "bytes": c["bytes"] + resizer_bytes(c["n"], c["cols"])}


register(OperatorDef(
    node_type=Resize,
    schema=lambda node, children, catalog: children[0],
    apply=_apply_resize,
    # batched pass: per slot, each with its own noise counter; divergent
    # revealed sizes split the batch downstream
    batch_apply=lambda eng, node, children, ctx: eng._batch_resize(node, children, ctx),
    estimate=_resize_estimate,
    provides_resize_info=True,
))
