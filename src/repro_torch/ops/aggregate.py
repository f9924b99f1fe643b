"""Terminal aggregates: COUNT(*) and COUNT(DISTINCT col).

These produce 1-row tables. Additions are local under arithmetic sharing, so
after a bit2a conversion (2 rounds) the reduction is free. A port of
``repro.ops.aggregate``'s counts; SUM, AVG, MIN and MAX are not ported yet.
"""
from __future__ import annotations

import torch

from ..core.circuits import bit2a
from ..core.prf import PRFSetup
from ..core.sharing import const_b
from .distinct import oblivious_distinct
from .table import SecretTable

__all__ = ["count_valid", "count_distinct"]


def count_valid(table: SecretTable, prf: PRFSetup, name: str = "cnt") -> SecretTable:
    """COUNT(*) over true rows -> 1-row table with an arithmetic count."""
    bits = bit2a(table.valid, prf.fold(701))
    total = bits.sum(axis=0)
    one = total.map_shares(lambda s: s[:, None])
    device = table.device
    return SecretTable({name: one}, const_b(torch.ones(1, dtype=torch.int32, device=device), device))


def count_distinct(table: SecretTable, col: str, prf: PRFSetup, name: str = "cnt") -> SecretTable:
    """COUNT(DISTINCT col) over true rows: Distinct, then COUNT(*)."""
    d = oblivious_distinct(table, col, prf)
    return count_valid(d, prf, name)
