"""Oblivious Filter over a predicate tree (AND / OR / leaf).

ANDs the predicate tree's result into the validity column; the output has
the same public size as the input (only a downstream Resizer may trim it).
A port of ``repro.ops.filter``: leaf i (DFS order) uses PRF tag 400+i, the
g-th combining gate folds (430, g) for AND / (470, g) for OR, and the final
AND into ``valid`` folds 449.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

from ..core.circuits import and_bit, eq, eq_public, gt_public, le_public, lt, lt_public, or_bit
from ..core.prf import PRFSetup
from ..core.sharing import BShare
from .table import SecretTable

__all__ = [
    "Predicate",
    "And",
    "Or",
    "Pred",
    "normalize_pred",
    "pred_leaves",
    "render_pred",
    "oblivious_filter",
]


@dataclasses.dataclass(frozen=True)
class Predicate:
    """column OP value — value is a public constant or another column name
    prefixed with ``col:``."""

    column: str
    op: str  # eq | lt | le | gt
    value: Union[int, str]

    def evaluate(self, table: SecretTable, prf: PRFSetup, tag: int) -> BShare:
        x = table.bshare_col(self.column, prf)
        p = prf.fold(tag)
        if isinstance(self.value, str) and self.value.startswith("col:"):
            y = table.bshare_col(self.value[4:], prf)
            if self.op == "eq":
                return eq(x, y, p)
            if self.op == "lt":
                return lt(x, y, p)
            if self.op == "le":
                return lt(y, x, p).xor_public(1)  # NOT (y < x)
            raise ValueError(self.op)
        c = int(self.value)
        if self.op == "eq":
            return eq_public(x, c, p)
        if self.op == "lt":
            return lt_public(x, c, p)
        if self.op == "le":
            return le_public(x, c, p)
        if self.op == "gt":
            return gt_public(x, c, p)
        raise ValueError(f"unknown predicate op {self.op}")


@dataclasses.dataclass(frozen=True)
class And:
    """Conjunction of predicate subtrees (flattened, >= 2 terms)."""

    terms: Tuple["Pred", ...]


@dataclasses.dataclass(frozen=True)
class Or:
    """Disjunction of predicate subtrees (flattened, >= 2 terms)."""

    terms: Tuple["Pred", ...]


Pred = Union[Predicate, And, Or]


def normalize_pred(pred) -> Pred:
    """Canonical tree: sequences become conjunctions, single-term And/Or
    collapse, nested same-type combiners flatten."""
    if isinstance(pred, Predicate):
        return pred
    if isinstance(pred, (And, Or)):
        kind = type(pred)
        flat: list = []
        for t in pred.terms:
            t = normalize_pred(t)
            if isinstance(t, kind):
                flat.extend(t.terms)
            else:
                flat.append(t)
        if len(flat) == 1:
            return flat[0]
        return kind(tuple(flat))
    if isinstance(pred, Sequence) and not isinstance(pred, (str, bytes)):
        return normalize_pred(And(tuple(pred)))
    raise TypeError(f"cannot normalize predicate {pred!r}")


def pred_leaves(pred: Pred) -> Tuple[Predicate, ...]:
    """Leaf predicates in DFS order."""
    if isinstance(pred, Predicate):
        return (pred,)
    out: list = []
    for t in pred.terms:
        out.extend(pred_leaves(t))
    return tuple(out)


def render_pred(pred: Pred, fmt=None) -> str:
    """SQL-precedence rendering (Or subtrees are parenthesized inside And).
    ``fmt(leaf)`` renders a leaf; the default ``"col op value"`` is the
    Filter's describe() label, the SQL renderer passes its own."""
    if fmt is None:
        fmt = lambda p: f"{p.column} {p.op} {p.value}"
    if isinstance(pred, Predicate):
        return fmt(pred)
    if isinstance(pred, And):
        return " AND ".join(
            f"({render_pred(t, fmt)})" if isinstance(t, Or) else render_pred(t, fmt) for t in pred.terms
        )
    if isinstance(pred, Or):
        return " OR ".join(render_pred(t, fmt) for t in pred.terms)
    raise TypeError(f"cannot render predicate {pred!r}")


def _eval_tree(pred: Pred, table: SecretTable, prf: PRFSetup, state: dict) -> BShare:
    if isinstance(pred, Predicate):
        i = state["leaf"]
        state["leaf"] += 1
        return pred.evaluate(table, prf, 400 + i)
    acc = None
    for t in pred.terms:
        b = _eval_tree(t, table, prf, state)
        if acc is None:
            acc = b
            continue
        g = state["gate"]
        state["gate"] += 1
        if isinstance(pred, And):
            acc = and_bit(acc, b, prf.fold(430).fold(g))
        else:
            acc = or_bit(acc, b, prf.fold(470).fold(g))
    return acc


def oblivious_filter(table: SecretTable, predicates, prf: PRFSetup) -> SecretTable:
    """valid' = valid AND eval(tree). Output size == input size."""
    tree = normalize_pred(predicates)
    if isinstance(tree, And) and not tree.terms:
        return table
    acc = _eval_tree(tree, table, prf, {"leaf": 0, "gate": 0})
    if acc is None:
        return table
    return SecretTable(dict(table.cols), and_bit(table.valid, acc, prf.fold(449)))
