"""Plan -> SQL rendering (the inverse of compile, for compiler-shaped trees),
a port of ``repro.sql.render`` that gives the same text.

Supports the plan shapes the compiler itself emits: left-deep ``Join`` trees
over ``Filter(Scan)`` / ``Scan`` leaves (with predicate trees rendered back
to AND/OR/parenthesized conditions), an optional terminal head node
(GroupByCount / Distinct / CountValid / CountDistinct / Sum / Avg / Project)
with an optional ``Having`` above it, and an OrderBy, so
``compile_logical(render_sql(plan)) == plan`` for those
shapes (a round trip the tests check on random plans).

The renderer dispatches through the operator registry
(:mod:`repro_torch.plan.registry`): it never names node classes. Each node's
``OperatorDef`` declares where it may appear (``sql_shape``) and supplies the
hook that renders it (``render_rel`` for the FROM/WHERE subtree,
``render_head`` for the SELECT head, ``render_order`` for ORDER BY keys).
Adding an operator means registering those hooks — this module does not
change.

``Resize`` nodes are not renderable (SQL has no resizer syntax; placement is
a compilation policy) — render the logical plan before placement.
"""
from __future__ import annotations

from typing import List, Tuple

from ..plan.nodes import PlanNode
from ..plan.registry import lookup
from .catalog import Catalog, HEALTHLNK_CATALOG
from .compile import Schema

__all__ = ["render_sql"]


class _Renderer:
    """Rendering state handed to the registry hooks: alias bookkeeping, the
    WHERE conjunct list, and JOIN clauses, plus Schema helpers."""

    def __init__(self, catalog: Catalog):
        self.catalog = catalog
        self.aliases: List[Tuple[str, str]] = []  # (alias, table)
        self.filters: List[str] = []  # WHERE conjuncts in DFS order
        self.joins: List[str] = []  # "JOIN <table> <alias> ON ..." clauses

    def walk(self, node: PlanNode) -> Schema:
        d = lookup(type(node))
        if d.render_rel is None:
            if d.sql_shape == "none":
                raise ValueError(
                    f"{node.label} nodes have no SQL form — render the "
                    "logical plan (before insert_resizers)"
                )
            raise ValueError(f"cannot render node {node.describe()} inside FROM")
        return d.render_rel(self, node)

    def schema_for_table(self, alias: str, columns) -> Schema:
        return Schema.for_table(alias, columns)

    def qual(self, schema: Schema, phys: str) -> str:
        alias, col = schema.entries[phys]
        return f"{alias}.{col}"


def render_sql(plan: PlanNode, catalog: Catalog = HEALTHLNK_CATALOG) -> str:
    """Render a compiler-shaped plan back to SQL text (see module docstring)."""
    # Peel the terminal chain (outermost first):
    # [OrderBy] [Having] [head] relational*
    order_by = None
    if lookup(type(plan)).sql_shape == "order":
        order_by, plan = plan, plan.child

    having_node = None
    having_def = lookup(type(plan))
    if having_def.sql_shape == "having":
        having_node, plan = plan, plan.child

    head_node = None
    head_def = lookup(type(plan))
    if head_def.sql_shape == "head":
        head_node, plan = plan, plan.child
    if having_node is not None and head_node is None:
        raise ValueError("HAVING requires a GROUP BY head beneath it")

    r = _Renderer(catalog)
    schema = r.walk(plan)

    head = "*"
    group_clause = None
    if head_node is not None:
        head, group_clause = head_def.render_head(r, head_node, schema)

    first_alias, first_table = r.aliases[0]
    parts = [f"SELECT {head}", f"FROM {first_table} {first_alias}"]
    parts.extend(r.joins)
    if r.filters:
        parts.append("WHERE " + " AND ".join(r.filters))
    if group_clause is not None:
        parts.append(group_clause)
    if having_node is not None:
        parts.append(
            having_def.render_having(r, having_node, head_node, schema)
        )
    if order_by is not None:
        key = lookup(type(order_by)).render_order(r, order_by, head_node, schema)
        parts.append(f"ORDER BY {key} {'DESC' if order_by.descending else 'ASC'}")
        if order_by.limit is not None:
            parts.append(f"LIMIT {order_by.limit}")
    return " ".join(parts)
