"""Oblivious ORDER BY (+ optional LIMIT), a port of ``repro.ops.orderby``.

Sorts by a column; invalid rows are keyed to a sentinel so that they sink to
the end: 0xFFFFFFFE ascending, 0 descending (tag 681). LIMIT k is a public
head slice of the sorted table, after its padding to a power of two: it
reveals nothing beyond the public k. The sort key doubles as the output
column, which moves to the end of the column order.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.prf import PRFSetup
from ..core.sharing import BShare, select
from ..core.sort import bitonic_sort_narrow
from .groupby import SENTINEL, pad_pow2
from .table import SecretTable

__all__ = ["oblivious_orderby"]


def oblivious_orderby(
    table: SecretTable,
    col: str,
    prf: PRFSetup,
    descending: bool = False,
    limit: Optional[int] = None,
) -> SecretTable:
    table = pad_pow2(table)
    keyb = table.bshare_col(col, prf)
    vmask = table.valid.lsb_mask()
    sentinel = BShare(torch.zeros_like(keyb.shares))
    if not descending:
        sentinel = sentinel.xor_public(SENTINEL)
    sort_key = select(vmask, keyb, sentinel, prf.fold(681))

    cols = {"__sk": sort_key, "__valid": table.valid}
    for k in table.cols:
        if k != col:
            cols[k] = table.bshare_col(k, prf)
    cols = bitonic_sort_narrow(cols, "__sk", prf, descending=descending)
    valid = cols.pop("__valid")
    # the sort key doubles as the (masked) column value for valid rows
    out_cols = dict(cols)
    out_cols[col] = out_cols.pop("__sk")

    out = SecretTable(out_cols, valid)
    if limit is not None and limit < out.n:
        out = out.gather_rows(torch.arange(limit, device=out.device))
    return out
