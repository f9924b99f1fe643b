"""Terminal aggregates: COUNT(*), COUNT(DISTINCT col), SUM(col), AVG(col),
MIN(col) and MAX(col), a port of ``repro.ops.aggregate``.

These produce 1-row tables. Additions are local under arithmetic sharing, so
after a bit2a / b2a conversion (2 rounds each) the reduction is free. AVG is
the (sum, count) pair: the division happens after the reveal. MIN / MAX are
a sort head: invalid rows sink past the extremum under ORDER BY's sentinel,
so the head row is the answer, and is itself invalid when no true row
exists (an empty selection reveals no row).
"""
from __future__ import annotations

import torch

from ..core.circuits import b2a, bit2a
from ..core.prf import PRFSetup
from ..core.sharing import AShare, const_b, mul
from .distinct import oblivious_distinct
from .orderby import oblivious_orderby
from .table import SecretTable

__all__ = ["count_valid", "count_distinct", "sum_column", "avg_column", "min_column", "max_column"]


def _one_row(cols: dict, device) -> SecretTable:
    """A 1-row table of the given columns with a public valid bit of 1."""
    return SecretTable(cols, const_b(torch.ones(1, dtype=torch.int32, device=device), device))


def _total(x: AShare) -> AShare:
    """The local sum over rows as a 1-row column."""
    return x.sum(axis=0).map_shares(lambda s: s[:, None])


def count_valid(table: SecretTable, prf: PRFSetup, name: str = "cnt") -> SecretTable:
    """COUNT(*) over true rows -> 1-row table with an arithmetic count."""
    bits = bit2a(table.valid, prf.fold(701))
    return _one_row({name: _total(bits)}, table.device)


def count_distinct(table: SecretTable, col: str, prf: PRFSetup, name: str = "cnt") -> SecretTable:
    """COUNT(DISTINCT col) over true rows: Distinct, then COUNT(*)."""
    d = oblivious_distinct(table, col, prf)
    return count_valid(d, prf, name)


def sum_column(table: SecretTable, col: str, prf: PRFSetup, name: str = "sum") -> SecretTable:
    """SUM(col) over true rows: mask by validity (1 mult), then a local sum."""
    vals = b2a(table.bshare_col(col, prf), prf.fold(711))
    bits = bit2a(table.valid, prf.fold(712))
    masked = mul(vals, bits, prf.fold(713))
    return _one_row({name: _total(masked)}, table.device)


def avg_column(table: SecretTable, col: str, prf: PRFSetup, name: str = "avg") -> SecretTable:
    """AVG(col) over true rows -> 1-row table of ``{name}_sum`` and
    ``{name}_cnt`` arithmetic shares (divided after the reveal)."""
    vals = b2a(table.bshare_col(col, prf), prf.fold(721))
    bits = bit2a(table.valid, prf.fold(722))
    masked = mul(vals, bits, prf.fold(723))
    return _one_row({f"{name}_sum": _total(masked), f"{name}_cnt": _total(bits)}, table.device)


def _extreme_column(table: SecretTable, col: str, prf: PRFSetup, name: str, descending: bool) -> SecretTable:
    """Sort head: a slim one-column ORDER BY with LIMIT 1. The head row's
    valid bit says whether the selection was non-empty."""
    slim = SecretTable({col: table.cols[col]}, table.valid)
    out = oblivious_orderby(slim, col, prf, descending=descending, limit=1)
    return SecretTable({name: out.cols[col]}, out.valid)


def min_column(table: SecretTable, col: str, prf: PRFSetup, name: str = "min") -> SecretTable:
    """MIN(col) over true rows -> 1-row table with a boolean-share word."""
    return _extreme_column(table, col, prf, name, descending=False)


def max_column(table: SecretTable, col: str, prf: PRFSetup, name: str = "max") -> SecretTable:
    """MAX(col) over true rows -> 1-row table with a boolean-share word."""
    return _extreme_column(table, col, prf, name, descending=True)
