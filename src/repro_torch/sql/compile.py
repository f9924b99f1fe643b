"""SQL -> PlanNode compiler with a rule-based logical optimizer, a port of
``repro.sql.compile``: the same plans, fingerprints and errors.

Pipeline::

    parse(sql)                    # AST (parser.py)
      -> resolve                  # aliases, columns, ambiguity checks
      -> classify conditions      # per-table (pushdown) / equi-join / theta
                                  # / OR-trees (pushdown or post-join Filter)
      -> join order               # explicit JOINs honored as written;
                                  # comma-FROM pools reordered cost-based
                                  # (left-deep enumeration over plan/cost.py)
      -> terminal ops             # GROUP BY / DISTINCT / COUNT / SUM / AVG /
                                  # ORDER BY / SELECT-list projection
      -> schema propagation       # registry infer_schema: typed column-set
                                  # check before any MPC work
      -> insert_resizers(...)     # Resizer placement policy (plan/policies.py)

Schema tracking mirrors :func:`repro_torch.ops.join.oblivious_join`'s column
disambiguation exactly (right-side collisions get ``r<k>.`` prefixes), so a
qualified reference like ``d.pid`` resolves to the physical column name the
executed join output will actually carry.

A ``SELECT col, ...`` list (no aggregate, no DISTINCT) compiles to a
:class:`~repro_torch.plan.nodes.Project` node — free (an oblivious projection is
local) but it narrows every downstream payload and the final reveal.

Prepared statements: :func:`plan_template` masks predicate literals with
``?`` placeholders, :func:`plan_params` extracts them, and
:func:`bind_params` re-binds a (possibly Resizer-placed) cached plan with
fresh constants; a plan cache keyed on the template fingerprint lets
``WHERE age > 40`` and ``WHERE age > 50`` share one compiled template.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..config import RuntimeConfig
from ..core.resizer import ResizerConfig
from ..ops.filter import And, Or, Pred, Predicate, normalize_pred
# the executed join's own collision-renaming IS the compiler's schema rule:
# importing it makes drift between compiled names and runtime names impossible
from ..ops.join import _disambiguate
from ..plan.cost import CostModel
from ..plan.nodes import (
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
    Scan,
    Sum,
)
from ..plan.policies import insert_resizers, select_join_algorithms
from ..errors import PlanSchemaError as SchemaError
from ..plan.registry import infer_schema, lookup
from .catalog import Catalog, HEALTHLNK_CATALOG
from .lexer import SqlError
from .parser import (
    AndExpr,
    AvgItem,
    BoolExpr,
    ColumnRef,
    Condition,
    CountDistinctItem,
    CountStar,
    MaxItem,
    MinItem,
    OrExpr,
    SelectStmt,
    SumItem,
    parse,
)

__all__ = [
    "compile_query",
    "compile_logical",
    "default_cost_model",
    "plan_fingerprint",
    "plan_template",
    "plan_params",
    "bind_params",
    "template_fingerprint",
    "Schema",
]

MAX_REORDER_TABLES = 7  # left-deep enumeration is k! — plenty for analytics


# -----------------------------------------------------------------------------
# Schema tracking
# -----------------------------------------------------------------------------



@dataclasses.dataclass
class Schema:
    """Ordered physical-name -> (alias, source column) map for a subtree."""

    entries: Dict[str, Tuple[str, str]]  # insertion-ordered

    @classmethod
    def for_table(cls, alias: str, columns: Sequence[str]) -> "Schema":
        return cls({c: (alias, c) for c in columns})

    @property
    def aliases(self) -> frozenset:
        return frozenset(a for a, _ in self.entries.values())

    def physical(self, alias: str, col: str) -> str:
        for phys, (a, c) in self.entries.items():
            if a == alias and c == col:
                return phys
        raise KeyError((alias, col))

    def merge(self, right: "Schema") -> "Schema":
        merged = dict(self.entries)
        for phys_r, origin in right.entries.items():
            merged[_disambiguate(merged, phys_r)] = origin
        return Schema(merged)


@dataclasses.dataclass
class _SubPlan:
    node: PlanNode
    schema: Schema


# -----------------------------------------------------------------------------
# Resolution
# -----------------------------------------------------------------------------

class _Resolver:
    def __init__(self, stmt: SelectStmt, catalog: Catalog, sql: str):
        self.stmt = stmt
        self.catalog = catalog
        self.sql = sql
        refs = list(stmt.tables) + [j.table for j in stmt.joins]
        self.alias_to_table: Dict[str, str] = {}
        self.from_order: List[str] = []  # aliases in FROM appearance order
        for ref in refs:
            if ref.table not in catalog.tables:
                raise SqlError(f"unknown table {ref.table!r}", sql, ref.pos)
            if ref.alias in self.alias_to_table:
                raise SqlError(f"duplicate table alias {ref.alias!r}", sql, ref.pos)
            self.alias_to_table[ref.alias] = ref.table
            self.from_order.append(ref.alias)

    def owner(self, col: ColumnRef) -> str:
        """Alias owning the column; raises on unknown/ambiguous references."""
        if col.alias is not None:
            table = self.alias_to_table.get(col.alias)
            if table is None:
                raise SqlError(f"unknown table alias {col.alias!r}", self.sql, col.pos)
            if col.name not in self.catalog.columns(table):
                raise SqlError(
                    f"unknown column {col.alias}.{col.name} (table {table!r} has "
                    f"{', '.join(self.catalog.columns(table))})",
                    self.sql,
                    col.pos,
                )
            return col.alias
        owners = [
            a
            for a in self.from_order
            if col.name in self.catalog.columns(self.alias_to_table[a])
        ]
        if not owners:
            raise SqlError(f"unknown column {col.name!r}", self.sql, col.pos)
        if len(owners) > 1:
            raise SqlError(
                f"ambiguous column {col.name!r} (in "
                + ", ".join(self.alias_to_table[a] for a in owners)
                + ") — qualify it",
                self.sql,
                col.pos,
            )
        return owners[0]


# -----------------------------------------------------------------------------
# Condition classification + predicate building
# -----------------------------------------------------------------------------

@dataclasses.dataclass
class _Cond:
    """Resolved condition: sides are (alias, column) pairs or an int."""

    cond: Condition
    left_owner: str
    right_owner: Optional[str]  # None when right is a literal

    @property
    def cross(self) -> bool:
        return self.right_owner is not None and self.right_owner != self.left_owner


def _resolve_conditions(conds: Sequence[Condition], res: _Resolver) -> List[_Cond]:
    out = []
    for c in conds:
        if c.op == "ne":
            raise SqlError("'<>' is not supported by the oblivious operators",
                           res.sql, c.pos)
        lo = res.owner(c.left)
        ro = res.owner(c.right) if isinstance(c.right, ColumnRef) else None
        out.append(_Cond(c, lo, ro))
    return out


def _bool_conjuncts(expr: Optional[BoolExpr]) -> List[BoolExpr]:
    """Top-level conjunct list of a WHERE tree (the parser flattens ANDs)."""
    if expr is None:
        return []
    if isinstance(expr, AndExpr):
        return list(expr.terms)
    return [expr]


def _expr_columns(expr: BoolExpr) -> List[ColumnRef]:
    if isinstance(expr, Condition):
        cols = [expr.left]
        if isinstance(expr.right, ColumnRef):
            cols.append(expr.right)
        return cols
    out: List[ColumnRef] = []
    for t in expr.terms:
        out.extend(_expr_columns(t))
    return out


def _expr_pos(expr: BoolExpr) -> int:
    if isinstance(expr, Condition):
        return expr.pos
    return min(_expr_pos(t) for t in expr.terms)


def _pred_from_cond(cond: Condition, to_phys) -> Predicate:
    """Condition AST -> executable Predicate; ``to_phys(ColumnRef) -> str``
    supplies the physical column name for the target scope."""
    if not isinstance(cond.right, ColumnRef):
        op, val = cond.op, int(cond.right)
        if op == "ge":  # integer domain: x >= v  <=>  x > v-1
            op, val = "gt", val - 1
        return Predicate(to_phys(cond.left), op, val)
    l, r, op = cond.left, cond.right, cond.op
    if op in ("gt", "ge"):  # normalize to lt/le by swapping sides
        l, r, op = r, l, {"gt": "lt", "ge": "le"}[op]
    return Predicate(to_phys(l), op, f"col:{to_phys(r)}")


def _pred_tree(expr: BoolExpr, to_phys) -> Pred:
    if isinstance(expr, Condition):
        return _pred_from_cond(expr, to_phys)
    terms = tuple(_pred_tree(t, to_phys) for t in expr.terms)
    return normalize_pred(And(terms) if isinstance(expr, AndExpr) else Or(terms))


def _single_table_predicate(c: _Cond, res: _Resolver) -> Predicate:
    # single-table predicates use bare source column names (leaf scope)
    return _pred_from_cond(c.cond, lambda col: col.name)


def _leaf(alias: str, preds: List[Pred], res: _Resolver) -> _SubPlan:
    table = res.alias_to_table[alias]
    node: PlanNode = Scan(table)
    if preds:
        node = Filter(node, tuple(preds))
    return _SubPlan(node, Schema.for_table(alias, res.catalog.columns(table)))


def _attach_join(
    tree: _SubPlan, leaf: _SubPlan, conds: List[_Cond], res: _Resolver
) -> _SubPlan:
    """Join ``leaf`` onto ``tree`` using every condition now in scope: the
    first equality becomes ``on``, one more le/eq (correctly oriented) becomes
    ``theta``, anything left becomes a post-join Filter."""
    tree_aliases = tree.schema.aliases
    on: Optional[Tuple[str, str]] = None
    theta: Optional[Tuple[str, str, str]] = None
    leftovers: List[_Cond] = []

    for c in sorted(conds, key=lambda c: (c.cond.op != "eq", c.cond.pos)):
        cond = c.cond
        l_in_tree = c.left_owner in tree_aliases
        if cond.op == "eq":
            l, r = (cond.left, cond.right) if l_in_tree else (cond.right, cond.left)
            pair = (
                tree.schema.physical(res.owner(l), l.name),
                leaf.schema.physical(res.owner(r), r.name),
            )
            if on is None:
                on = pair
            elif theta is None:
                theta = (pair[0], "eq", pair[1])
            else:
                leftovers.append(c)
            continue
        op = cond.op
        l, r = cond.left, cond.right
        if op in ("gt", "ge"):  # normalize to lt/le by swapping sides
            l, r, op = r, l, {"gt": "lt", "ge": "le"}[op]
            l_in_tree = not l_in_tree
        if op == "le" and theta is None and l_in_tree:
            theta = (
                tree.schema.physical(res.owner(l), l.name),
                "le",
                leaf.schema.physical(res.owner(r), r.name),
            )
        else:
            leftovers.append(c)

    if on is None:
        raise SqlError(
            f"join with {'/'.join(sorted(leaf.schema.aliases))} requires an "
            "equality condition (cartesian products are not supported)",
            res.sql,
        )
    merged = tree.schema.merge(leaf.schema)
    node: PlanNode = Join(tree.node, leaf.node, on, theta=theta)
    if leftovers:
        to_phys = lambda col: merged.physical(res.owner(col), col.name)
        preds = [_pred_from_cond(c.cond, to_phys) for c in leftovers]
        node = Filter(node, tuple(preds))
    return _SubPlan(node, merged)


def _build_in_order(
    order: Sequence[str],
    leaves: Dict[str, _SubPlan],
    cross: List[_Cond],
    res: _Resolver,
) -> _SubPlan:
    tree = leaves[order[0]]
    pending = list(cross)
    for alias in order[1:]:
        in_scope = [
            c
            for c in pending
            if {c.left_owner, c.right_owner}
            <= (tree.schema.aliases | {alias})
            and alias in (c.left_owner, c.right_owner)
        ]
        pending = [c for c in pending if c not in in_scope]
        tree = _attach_join(tree, leaves[alias], in_scope, res)
    if pending:
        c = pending[0]
        raise SqlError(f"condition {c.cond} could not be attached to any join",
                       res.sql, c.cond.pos)
    return tree


def _reorder_pool(
    pool: List[str], cross: List[_Cond], leaves: Dict[str, _SubPlan],
    res: _Resolver, cost_model: CostModel,
) -> _SubPlan:
    """Cost-based left-deep join ordering for a comma-FROM pool: enumerate
    connected permutations (FROM order first, so ties keep the user's order)
    and keep the cheapest tree under the cost model."""
    if len(pool) == 1:
        return leaves[pool[0]]
    if len(pool) > MAX_REORDER_TABLES:
        raise SqlError(
            f"comma-FROM join pools are limited to {MAX_REORDER_TABLES} tables "
            "(use explicit JOIN ... ON to fix the order)",
            res.sql,
        )
    equi_edges = {
        frozenset((c.left_owner, c.right_owner)) for c in cross if c.cond.op == "eq"
    }

    def connected(prefix_set: frozenset, nxt: str) -> bool:
        return any(frozenset((a, nxt)) in equi_edges for a in prefix_set)

    best: Optional[Tuple[float, _SubPlan]] = None
    for perm in itertools.permutations(pool):
        ok = all(
            connected(frozenset(perm[:i]), perm[i]) for i in range(1, len(perm))
        )
        if not ok:
            continue
        try:
            tree = _build_in_order(perm, leaves, cross, res)
        except SqlError:
            continue
        score = cost_model.plan_bytes(tree.node)
        if best is None or score < best[0]:
            best = (score, tree)
    if best is None:
        raise SqlError(
            "tables in FROM are not connected by equality join conditions",
            res.sql,
        )
    return best[1]


# -----------------------------------------------------------------------------
# Terminal operators
# -----------------------------------------------------------------------------

def _having_operand(operand, node, keys, phys, sql, pos):
    """HAVING operand -> a ColumnRef over the aggregate *output* schema.
    Aggregate expressions (COUNT(*)/SUM(col)) and bare alias references
    rewrite to the aggregate's output column; anything else must be a
    grouping column."""
    if isinstance(operand, CountStar):
        if not isinstance(node, GroupByCount):
            raise SqlError(
                "HAVING COUNT(*) requires a COUNT(*) aggregate", sql, pos
            )
        return ColumnRef(None, node.count_name)
    if isinstance(operand, SumItem):
        if not isinstance(node, GroupBySum) or phys(operand.col) != node.col:
            raise SqlError(
                "HAVING SUM(col) must name the selected SUM aggregate",
                sql, pos,
            )
        return ColumnRef(None, node.name)
    if isinstance(operand, (AvgItem, MinItem, MaxItem, CountDistinctItem)):
        raise SqlError(
            "HAVING supports COUNT(*)/SUM(col) aggregates only", sql, pos
        )
    agg_name = (
        node.count_name if isinstance(node, GroupByCount) else node.name
    )
    if operand.alias is None and operand.name == agg_name:
        return ColumnRef(None, agg_name)  # bare aggregate alias
    p = phys(operand)
    if p not in keys:
        raise SqlError(
            f"HAVING column {operand} is not in the GROUP BY output",
            sql, operand.pos,
        )
    return ColumnRef(None, p)


def _having_expr(expr: BoolExpr, conv) -> BoolExpr:
    """Rewrite every operand of a HAVING boolean tree via ``conv``."""
    if isinstance(expr, Condition):
        left = conv(expr.left, expr.pos)
        right = (
            expr.right if isinstance(expr.right, int)
            else conv(expr.right, expr.pos)
        )
        return Condition(left, expr.op, right, expr.pos)
    terms = tuple(_having_expr(t, conv) for t in expr.terms)
    return AndExpr(terms) if isinstance(expr, AndExpr) else OrExpr(terms)


def _apply_terminals(
    stmt: SelectStmt, sub: _SubPlan, res: _Resolver, sql: str
) -> PlanNode:
    node = sub.node

    def phys(col: ColumnRef) -> str:
        return sub.schema.physical(res.owner(col), col.name)

    aggs = [i for i in stmt.items
            if isinstance(i, (CountStar, CountDistinctItem, SumItem, AvgItem,
                              MinItem, MaxItem))]
    plain = [i for i in stmt.items if isinstance(i, ColumnRef)]

    count_name: Optional[str] = None
    if stmt.group_by:
        keys = tuple(phys(k) for k in stmt.group_by)
        if len(aggs) != 1 or not isinstance(
            aggs[0], (CountStar, SumItem, AvgItem)
        ):
            raise SqlError(
                "GROUP BY queries must select exactly one COUNT(*), SUM(col) "
                "or AVG(col) (plus the grouping columns)", sql,
            )
        if any(phys(c) not in keys for c in plain):
            raise SqlError(
                "GROUP BY queries may only select the grouping columns and "
                "the aggregate", sql,
            )
        agg = aggs[0]
        if isinstance(agg, CountStar):
            count_name = agg.alias or "cnt"
            node = GroupByCount(node, keys, count_name=count_name)
        elif isinstance(agg, SumItem):
            node = GroupBySum(node, keys, phys(agg.col), name=agg.alias or "sum")
        else:
            node = GroupByAvg(node, keys, phys(agg.col), name=agg.alias or "avg")
    elif aggs and not plain:
        if len(stmt.items) != 1:
            raise SqlError("only a single aggregate per query is supported", sql)
        item = stmt.items[0]
        if isinstance(item, CountStar):
            node = CountValid(node)
        elif isinstance(item, CountDistinctItem):
            node = CountDistinct(node, phys(item.col))
        elif isinstance(item, SumItem):
            node = Sum(node, phys(item.col), name=item.alias or "sum")
        elif isinstance(item, MinItem):
            node = Min(node, phys(item.col), name=item.alias or "min")
        elif isinstance(item, MaxItem):
            node = Max(node, phys(item.col), name=item.alias or "max")
        else:
            node = Avg(node, phys(item.col), name=item.alias or "avg")
    elif stmt.distinct:
        if len(stmt.items) != 1 or not isinstance(stmt.items[0], ColumnRef):
            raise SqlError("DISTINCT supports exactly one selected column", sql)
        node = Distinct(node, phys(stmt.items[0]))
    elif aggs:
        raise SqlError("aggregates cannot be mixed with plain columns "
                       "without GROUP BY", sql)
    elif plain:
        # plain SELECT list -> free Project (narrows payload + reveal)
        cols = []
        for c in plain:
            p = phys(c)
            if p not in cols:
                cols.append(p)
        node = Project(node, tuple(cols))

    if stmt.having is not None:
        if not stmt.group_by:
            raise SqlError("HAVING requires GROUP BY", sql)
        if isinstance(node, GroupByAvg):
            raise SqlError(
                "HAVING over AVG(col) is unsupported (the average exists "
                "only post-reveal; filter on SUM or COUNT instead)", sql,
            )
        conv = lambda op, pos: _having_operand(op, node, keys, phys, sql, pos)
        mapped = _having_expr(stmt.having, conv)
        # the Having predicate names the aggregate output schema directly
        node = Having(node, _pred_tree(mapped, lambda col: col.name))

    if stmt.order_by is not None:
        if lookup(type(node)).singleton:
            raise SqlError(
                "ORDER BY is meaningless over a bare aggregate (single row)", sql
            )
        if isinstance(stmt.order_by, CountStar):
            if count_name is None:
                raise SqlError("ORDER BY COUNT(*) requires GROUP BY", sql)
            order_col = count_name
        elif (
            count_name is not None
            and stmt.order_by.alias is None
            and stmt.order_by.name == count_name
        ):
            order_col = count_name
        else:
            order_col = phys(stmt.order_by)
            if count_name is not None and order_col not in keys:
                # the GroupByCount output carries only the keys and the count
                raise SqlError(
                    f"ORDER BY {stmt.order_by} is not in the GROUP BY output "
                    f"(order by a grouping column or COUNT(*))",
                    sql,
                    stmt.order_by.pos,
                )
            if isinstance(node, Project) and order_col not in node.cols:
                raise SqlError(
                    f"ORDER BY {stmt.order_by} must appear in the SELECT list",
                    sql,
                    stmt.order_by.pos,
                )
        node = OrderBy(node, order_col, descending=stmt.order_desc, limit=stmt.limit)
    elif stmt.limit is not None:
        raise SqlError("LIMIT requires ORDER BY", sql)
    return node


# -----------------------------------------------------------------------------
# Entry points
# -----------------------------------------------------------------------------

def default_cost_model(catalog: Catalog, noise=None, calibration=None) -> CostModel:
    """Catalog-derived cost model. ``calibration`` (any object with a
    ``refine(node, est, noise)`` hook) replaces the static selectivity
    defaults with observed revealed sizes."""
    return CostModel(
        table_sizes={t: catalog.size(t) for t in catalog.tables},
        table_cols={t: len(cols) for t, cols in catalog.tables.items()},
        noise=noise,
        calibration=calibration,
    )


def compile_logical(
    sql: str,
    catalog: Catalog = HEALTHLNK_CATALOG,
    *,
    cost_model: Optional[CostModel] = None,
    reorder_joins: bool = True,
) -> PlanNode:
    """SQL -> optimized logical plan (no Resizers): parse, resolve, push
    predicates below joins, order joins, attach terminals, schema-check."""
    stmt = parse(sql)
    res = _Resolver(stmt, catalog, sql)
    where_conjuncts = _bool_conjuncts(stmt.where)
    plain_conds = [c for c in where_conjuncts if isinstance(c, Condition)]
    or_trees = [c for c in where_conjuncts if not isinstance(c, Condition)]
    conds = _resolve_conditions(
        plain_conds + [c for j in stmt.joins for c in j.conds], res
    )
    # predicate pushdown: single-table conditions land on their base scans,
    # in SQL appearance order; single-table OR-trees push down as predicate
    # trees, multi-table OR-trees become post-join Filters
    per_alias: Dict[str, List[Tuple[int, Pred]]] = {a: [] for a in res.from_order}
    cross: List[_Cond] = []
    for c in sorted(conds, key=lambda c: c.cond.pos):
        if c.cross:
            cross.append(c)
        else:
            per_alias[c.left_owner].append(
                (c.cond.pos, _single_table_predicate(c, res))
            )
    post_join: List[Tuple[int, BoolExpr]] = []
    for expr in or_trees:
        owners = {res.owner(col) for col in _expr_columns(expr)}
        pos = _expr_pos(expr)
        if len(owners) == 1:
            tree = _pred_tree(expr, lambda col: col.name)
            per_alias[owners.pop()].append((pos, tree))
        else:
            post_join.append((pos, expr))
    leaves = {
        a: _leaf(a, [p for _, p in sorted(per_alias[a], key=lambda t: t[0])], res)
        for a in res.from_order
    }

    if stmt.joins:
        order = [stmt.tables[0].alias] + [j.table.alias for j in stmt.joins]
        sub = _build_in_order(order, leaves, cross, res)
    else:
        pool = [t.alias for t in stmt.tables]
        if reorder_joins and len(pool) > 1:
            cm = cost_model or default_cost_model(catalog)
            sub = _reorder_pool(pool, cross, leaves, res, cm)
        else:
            sub = _build_in_order(pool, leaves, cross, res)

    if post_join:
        to_phys = lambda col: sub.schema.physical(res.owner(col), col.name)
        trees = tuple(
            _pred_tree(e, to_phys) for _, e in sorted(post_join, key=lambda t: t[0])
        )
        sub = _SubPlan(Filter(sub.node, trees), sub.schema)

    plan = _apply_terminals(stmt, sub, res, sql)
    try:
        # registry schema propagation: the typed column set must resolve all
        # the way to the root before the plan is allowed near the engine
        infer_schema(plan, catalog)
    except SchemaError as e:  # pragma: no cover — resolver should catch first
        raise SqlError(str(e), sql) from e
    return plan


def compile_query(
    sql: str,
    catalog: Catalog = HEALTHLNK_CATALOG,
    *,
    placement: str = "none",
    noise=None,
    cfg_factory: Optional[Callable[[PlanNode], Optional[ResizerConfig]]] = None,
    addition: str = "parallel",
    cost_model: Optional[CostModel] = None,
    reorder_joins: bool = True,
    join_algo: Optional[str] = None,
    config: Optional[RuntimeConfig] = None,
) -> PlanNode:
    """SQL -> fully Resizer-placed physical plan.

    ``noise`` (a NoiseStrategy) builds a constant ResizerConfig factory;
    pass ``cfg_factory`` instead for per-node configs. ``placement`` follows
    :func:`repro_torch.plan.policies.insert_resizers`; ``cost_based`` placement uses
    ``cost_model`` (defaulting to one derived from the catalog sizes).

    ``join_algo`` picks the physical join algorithm per join node
    (:func:`repro_torch.plan.policies.select_join_algorithms`); it defaults
    to ``config.join_algo`` (a default :class:`RuntimeConfig`: ``auto``).
    The rewrite only fires for catalogs that declare key multiplicity
    bounds, so plans over the bare schema catalog are byte-stable.
    """
    if join_algo is None:
        join_algo = (config or RuntimeConfig()).join_algo
    plan = compile_logical(
        sql, catalog, cost_model=cost_model, reorder_joins=reorder_joins
    )
    plan = select_join_algorithms(
        plan,
        cost_model=cost_model or default_cost_model(catalog),
        catalog=catalog,
        mode=join_algo,
    )
    if placement == "none":
        return plan
    if cfg_factory is None:
        if noise is None:
            raise ValueError("placement != 'none' requires noise= or cfg_factory=")
        cfg = ResizerConfig(noise=noise, addition=addition)
        cfg_factory = lambda _node: cfg
    cm = cost_model
    if placement == "cost_based" and cm is None:
        cm = default_cost_model(catalog, noise=noise)
    return insert_resizers(plan, cfg_factory, placement=placement, cost_model=cm)


def plan_fingerprint(plan: PlanNode) -> str:
    """Stable structural identity of a plan (cache keys, accountant
    signatures): the pretty-printed tree fully determines operators,
    predicates, join conditions, and resizer configs."""
    return plan.pretty()


# -----------------------------------------------------------------------------
# Prepared statements: literal masking + re-binding
# -----------------------------------------------------------------------------

def _map_pred_literals(pred: Pred, fn) -> Pred:
    """Rebuild a predicate tree, passing each literal int through ``fn``."""
    if isinstance(pred, Predicate):
        if isinstance(pred.value, str) and pred.value.startswith("col:"):
            return pred
        return dataclasses.replace(pred, value=fn(pred.value))
    terms = tuple(_map_pred_literals(t, fn) for t in pred.terms)
    return type(pred)(terms)


def _map_plan_literals(plan: PlanNode, fn) -> PlanNode:
    """Rebuild a plan, passing every predicate literal through ``fn`` in a
    deterministic (pre-order, DFS) traversal. Resize wrappers carry no
    literals, so a logical plan and its Resizer-placed twin visit literals
    in the same order."""
    new_children = [_map_plan_literals(c, fn) for c in plan.children()]
    node = plan.replace_children(new_children)
    pred = getattr(node, "pred", None)
    if pred is not None:
        node.pred = _map_pred_literals(pred, fn)
    return node


def plan_params(plan: PlanNode) -> Tuple:
    """Predicate literals in traversal order (the prepared-statement
    parameter vector). Read-only: visits the same (children-first, then own
    predicates, leaves in DFS order) positions :func:`_map_plan_literals`
    rebuilds, without copying the tree."""
    params: List = []

    def collect_pred(pred: Pred) -> None:
        if isinstance(pred, Predicate):
            if not (isinstance(pred.value, str) and pred.value.startswith("col:")):
                params.append(pred.value)
            return
        for t in pred.terms:
            collect_pred(t)

    def walk(node: PlanNode) -> None:
        for c in node.children():
            walk(c)
        pred = getattr(node, "pred", None)
        if pred is not None:
            collect_pred(pred)

    walk(plan)
    return tuple(params)


def plan_template(plan: PlanNode) -> PlanNode:
    """The plan with every predicate literal replaced by ``?`` — the shared
    prepared-statement template (not executable; bind first)."""
    return _map_plan_literals(plan, lambda v: "?")


def template_fingerprint(plan: PlanNode) -> str:
    """Fingerprint of the literal-masked plan: equal for any two plans that
    differ only in predicate constants."""
    return plan_fingerprint(plan_template(plan))


def bind_params(plan: PlanNode, params: Sequence) -> PlanNode:
    """Re-bind a cached (template-compatible) plan with fresh literals, in
    the same traversal order :func:`plan_params` uses. The input plan is not
    mutated (it may be cache-shared)."""
    it = iter(params)

    def put(_v):
        try:
            return next(it)
        except StopIteration:
            raise ValueError("bind_params: fewer params than plan literals")

    out = _map_plan_literals(plan, put)
    leftover = sum(1 for _ in it)
    if leftover:
        raise ValueError(
            f"bind_params: {leftover} params left over — plan/template mismatch"
        )
    return out
