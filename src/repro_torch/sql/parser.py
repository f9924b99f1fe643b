"""Recursive-descent parser for the Reflex SQL dialect: the port's own copy
of ``repro.sql.parser`` (same AST, same error messages and positions).

Grammar (keywords case-insensitive, integer literals only):

    query      := SELECT select_list FROM from_clause
                  [WHERE bool_expr]
                  [GROUP BY column (',' column)*]
                  [HAVING bool_expr]              -- operands may be aggregates
                  [ORDER BY order_key [ASC|DESC]]
                  [LIMIT int] [';']
    select_list:= '*' | DISTINCT column | item (',' item)*
    item       := column | COUNT '(' '*' ')' [AS ident]
                | COUNT '(' DISTINCT column ')' [AS ident]
                | SUM '(' column ')' [AS ident]
                | AVG '(' column ')' [AS ident]
                | MIN '(' column ')' [AS ident]
                | MAX '(' column ')' [AS ident]
    from_clause:= table_ref (',' table_ref)*                -- reorderable pool
                | table_ref (JOIN table_ref ON cond (AND cond)*)*  -- fixed order
    table_ref  := ident [AS] [ident]
    bool_expr  := bool_and (OR bool_and)*         -- AND binds tighter than OR
    bool_and   := bool_prim (AND bool_prim)*
    bool_prim  := '(' bool_expr ')' | cond
    cond       := operand op operand      op := = | < | <= | > | >= | <>
    operand    := column | int
                | COUNT '(' '*' ')' | SUM '(' column ')'   -- HAVING only
                | AVG '(' column ')' | MIN '(' column ')'
                | MAX '(' column ')'
    column     := ident | ident '.' ident
    order_key  := column | COUNT '(' '*' ')'

The two FROM styles may not be mixed: comma-FROM hands the optimizer a
reorderable table pool, while explicit ``JOIN ... ON`` chains are honored as
written (so hand-tuned plans stay byte-stable through the compiler). JOIN ON
conditions stay pure conjunctions (the join operator needs an extractable
equality); disjunctions belong in WHERE, where the compiler turns them into
predicate trees.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

from .lexer import SqlError, Token, tokenize

__all__ = [
    "ColumnRef",
    "Condition",
    "AndExpr",
    "OrExpr",
    "BoolExpr",
    "TableRef",
    "JoinClause",
    "CountStar",
    "CountDistinctItem",
    "SumItem",
    "AvgItem",
    "MinItem",
    "MaxItem",
    "SelectStmt",
    "parse",
]


@dataclasses.dataclass(frozen=True)
class ColumnRef:
    alias: Optional[str]  # table alias qualifier, None if bare
    name: str
    pos: int = dataclasses.field(default=0, compare=False)

    def __str__(self) -> str:
        return f"{self.alias}.{self.name}" if self.alias else self.name


@dataclasses.dataclass(frozen=True)
class Condition:
    """left OP right; right is a ColumnRef or an int literal. Normalized so a
    literal (if any) is on the right and op is one of eq|lt|le|gt|ge|ne.

    Inside HAVING, either side may also be an aggregate item (CountStar,
    SumItem, ...) referencing the GROUP BY output."""

    left: Union[ColumnRef, "CountStar", "SumItem", "AvgItem", "MinItem", "MaxItem"]
    op: str
    right: Union[ColumnRef, int, "CountStar", "SumItem", "AvgItem", "MinItem", "MaxItem"]
    pos: int = dataclasses.field(default=0, compare=False)

    @property
    def is_column_pair(self) -> bool:
        return isinstance(self.right, ColumnRef)

    def __str__(self) -> str:
        sym = {"eq": "=", "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "ne": "<>"}
        return f"{self.left} {sym[self.op]} {self.right}"


@dataclasses.dataclass(frozen=True)
class AndExpr:
    """Conjunction of boolean subtrees (flattened)."""

    terms: Tuple["BoolExpr", ...]


@dataclasses.dataclass(frozen=True)
class OrExpr:
    """Disjunction of boolean subtrees (flattened)."""

    terms: Tuple["BoolExpr", ...]


BoolExpr = Union[Condition, AndExpr, OrExpr]


@dataclasses.dataclass(frozen=True)
class TableRef:
    table: str
    alias: str
    pos: int = dataclasses.field(default=0, compare=False)


@dataclasses.dataclass(frozen=True)
class JoinClause:
    table: TableRef
    conds: Tuple[Condition, ...]


@dataclasses.dataclass(frozen=True)
class CountStar:
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class CountDistinctItem:
    col: ColumnRef
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SumItem:
    col: ColumnRef
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class AvgItem:
    col: ColumnRef
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MinItem:
    col: ColumnRef
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MaxItem:
    col: ColumnRef
    alias: Optional[str] = None


SelectItem = Union[
    ColumnRef, CountStar, CountDistinctItem, SumItem, AvgItem, MinItem, MaxItem
]


@dataclasses.dataclass(frozen=True)
class SelectStmt:
    items: Tuple[SelectItem, ...]  # empty tuple == SELECT *
    distinct: bool
    tables: Tuple[TableRef, ...]  # comma-FROM pool (>= 1)
    joins: Tuple[JoinClause, ...]  # explicit JOIN chain (fixed order)
    where: Optional[BoolExpr]  # boolean tree (AND/OR), None when absent
    group_by: Tuple[ColumnRef, ...]  # () when absent; >1 = composite key
    order_by: Optional[Union[ColumnRef, CountStar]]
    order_desc: bool
    limit: Optional[int]
    having: Optional[BoolExpr] = None  # post-aggregation filter, None when absent


_OPS = {"EQ": "eq", "LT": "lt", "LE": "le", "GT": "gt", "GE": "ge", "NE": "ne"}
_FLIP = {"eq": "eq", "ne": "ne", "lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}
_AGG_ITEMS = {"COUNT": None, "SUM": SumItem, "AVG": AvgItem,
              "MIN": MinItem, "MAX": MaxItem}


class _Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0
        # inside HAVING, comparison operands may be aggregate expressions
        self._agg_operands = False

    # -- token plumbing -------------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str) -> Optional[Token]:
        if self.cur.kind == kind:
            return self.advance()
        return None

    def expect(self, kind: str, what: str = "") -> Token:
        if self.cur.kind != kind:
            want = what or kind
            got = self.cur.value or "end of input"
            raise SqlError(f"expected {want}, got {got!r}", self.sql, self.cur.pos)
        return self.advance()

    def error(self, msg: str) -> SqlError:
        return SqlError(msg, self.sql, self.cur.pos)

    # -- grammar --------------------------------------------------------------
    def parse(self) -> SelectStmt:
        self.expect("SELECT", "SELECT")
        distinct = bool(self.accept("DISTINCT"))
        items = self._select_list()
        self.expect("FROM", "FROM")
        tables, joins = self._from_clause()
        where: Optional[BoolExpr] = None
        if self.accept("WHERE"):
            where = self._bool_expr()
        group_by: Tuple[ColumnRef, ...] = ()
        if self.accept("GROUP"):
            self.expect("BY", "BY after GROUP")
            keys = [self._column()]
            while self.accept("COMMA"):
                keys.append(self._column())
            group_by = tuple(keys)
        having: Optional[BoolExpr] = None
        if self.cur.kind == "HAVING":
            if not group_by:
                raise self.error("HAVING requires GROUP BY")
            self.advance()
            self._agg_operands = True
            try:
                having = self._bool_expr()
            finally:
                self._agg_operands = False
        order_by, order_desc = None, False
        if self.accept("ORDER"):
            self.expect("BY", "BY after ORDER")
            if self.cur.kind == "COUNT":
                self.advance()
                self.expect("LPAREN", "'('")
                self.expect("STAR", "'*' inside COUNT")
                self.expect("RPAREN", "')'")
                order_by = CountStar()
            else:
                order_by = self._column()
            if self.accept("DESC"):
                order_desc = True
            else:
                self.accept("ASC")
        limit = None
        if self.accept("LIMIT"):
            limit = int(self.expect("INT", "integer LIMIT").value)
        self.accept("SEMI")
        self.expect("EOF", "end of query")
        return SelectStmt(
            items=items,
            distinct=distinct,
            tables=tables,
            joins=joins,
            where=where,
            group_by=group_by,
            order_by=order_by,
            order_desc=order_desc,
            limit=limit,
            having=having,
        )

    def _select_list(self) -> Tuple[SelectItem, ...]:
        if self.accept("STAR"):
            return ()
        items: List[SelectItem] = [self._select_item()]
        while self.accept("COMMA"):
            items.append(self._select_item())
        return tuple(items)

    def _select_item(self) -> SelectItem:
        if self.cur.kind == "COUNT":
            self.advance()
            self.expect("LPAREN", "'(' after COUNT")
            if self.accept("STAR"):
                self.expect("RPAREN", "')'")
                return CountStar(alias=self._opt_alias())
            if self.accept("DISTINCT"):
                col = self._column()
                self.expect("RPAREN", "')'")
                return CountDistinctItem(col, alias=self._opt_alias())
            raise self.error("COUNT supports only COUNT(*) and COUNT(DISTINCT col)")
        if self.cur.kind in ("SUM", "AVG", "MIN", "MAX"):
            cls = _AGG_ITEMS[self.advance().kind]
            self.expect("LPAREN", "'(' after aggregate")
            col = self._column()
            self.expect("RPAREN", "')'")
            return cls(col, alias=self._opt_alias())
        return self._column()

    def _opt_alias(self) -> Optional[str]:
        if self.accept("AS"):
            return self.expect("IDENT", "alias identifier").value
        return None

    def _column(self) -> ColumnRef:
        t = self.expect("IDENT", "column name")
        if self.accept("DOT"):
            c = self.expect("IDENT", "column name after '.'")
            return ColumnRef(t.value, c.value, t.pos)
        return ColumnRef(None, t.value, t.pos)

    def _table_ref(self) -> TableRef:
        t = self.expect("IDENT", "table name")
        alias = t.value
        if self.accept("AS"):
            alias = self.expect("IDENT", "table alias").value
        elif self.cur.kind == "IDENT":
            alias = self.advance().value
        return TableRef(t.value, alias, t.pos)

    def _from_clause(self) -> Tuple[Tuple[TableRef, ...], Tuple[JoinClause, ...]]:
        tables = [self._table_ref()]
        joins: List[JoinClause] = []
        while True:
            if self.accept("COMMA"):
                if joins:
                    raise self.error(
                        "cannot mix comma-FROM with explicit JOIN ... ON"
                    )
                tables.append(self._table_ref())
            elif self.accept("JOIN"):
                if len(tables) > 1:
                    raise self.error(
                        "cannot mix comma-FROM with explicit JOIN ... ON"
                    )
                ref = self._table_ref()
                self.expect("ON", "ON after JOIN table")
                joins.append(JoinClause(ref, self._conjunction()))
            else:
                break
        return tuple(tables), tuple(joins)

    def _conjunction(self) -> Tuple[Condition, ...]:
        """AND-only condition list (JOIN ... ON; see module docstring)."""
        conds = [self._condition()]
        while self.accept("AND"):
            if self.cur.kind == "LPAREN":
                raise self.error(
                    "parenthesized/OR conditions are not allowed in JOIN ON "
                    "(move them to WHERE)"
                )
            conds.append(self._condition())
        return tuple(conds)

    # -- boolean expressions (WHERE) ------------------------------------------
    def _bool_expr(self) -> BoolExpr:
        terms = [self._bool_and()]
        while self.accept("OR"):
            terms.append(self._bool_and())
        return _flatten(OrExpr, terms) if len(terms) > 1 else terms[0]

    def _bool_and(self) -> BoolExpr:
        terms = [self._bool_prim()]
        while self.accept("AND"):
            terms.append(self._bool_prim())
        return _flatten(AndExpr, terms) if len(terms) > 1 else terms[0]

    def _bool_prim(self) -> BoolExpr:
        if self.accept("LPAREN"):
            e = self._bool_expr()
            self.expect("RPAREN", "')'")
            return e
        return self._condition()

    def _condition(self) -> Condition:
        pos = self.cur.pos
        left = self._operand()
        if self.cur.kind not in _OPS:
            raise self.error(
                f"expected comparison operator, got {self.cur.value or 'end of input'!r}"
            )
        op = _OPS[self.advance().kind]
        right = self._operand()
        if isinstance(left, int):
            if isinstance(right, int):
                raise SqlError(
                    "condition must reference at least one column", self.sql, pos
                )
            left, right, op = right, left, _FLIP[op]
        return Condition(left, op, right, pos)

    def _operand(self) -> Union[ColumnRef, int]:
        if self.cur.kind == "INT":
            return int(self.advance().value)
        if self._agg_operands and self.cur.kind in _AGG_ITEMS:
            kind = self.advance().kind
            self.expect("LPAREN", f"'(' after {kind}")
            if kind == "COUNT":
                self.expect("STAR", "'*' inside COUNT (HAVING supports COUNT(*) only)")
                self.expect("RPAREN", "')'")
                return CountStar()
            col = self._column()
            self.expect("RPAREN", "')'")
            return _AGG_ITEMS[kind](col)
        return self._column()


def _flatten(cls, terms: List[BoolExpr]) -> BoolExpr:
    flat: List[BoolExpr] = []
    for t in terms:
        if isinstance(t, cls):
            flat.extend(t.terms)
        else:
            flat.append(t)
    return cls(tuple(flat))


def parse(sql: str) -> SelectStmt:
    """Parse one SELECT statement into a :class:`SelectStmt` AST."""
    return _Parser(sql).parse()
