"""The sort-based helpers Distinct needs from ``repro.ops.groupby``:
power-of-two padding, segment starts, and the invalid-row sort sentinel.
(The group-by aggregates themselves are not ported yet.)"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..core.circuits import and_bit, eq
from ..core.prf import PRFSetup
from ..core.sharing import BShare
from .table import SecretTable

__all__ = ["SENTINEL", "pad_pow2", "segment_starts"]

# Invalid rows sort last under this key (stored as int32 it reads -2; the
# sort compares unsigned). Group keys must be < 0xFFFFFFFE.
SENTINEL = 0xFFFFFFFE


def pad_pow2(table: SecretTable) -> SecretTable:
    """Pad to a power-of-two row count (bitonic networks require it) with
    all-zero-share rows (value 0, valid 0)."""
    n = table.n
    if n & (n - 1) == 0:
        return table
    return table.pad_rows(1 << n.bit_length())


def _shift_down(col: BShare) -> BShare:
    """Row i gets row i-1's shares; row 0 gets zero shares."""
    s = col.shares
    return BShare(torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], dim=1))


def segment_starts(key: Union[BShare, Sequence[BShare]], valid: BShare, prf: PRFSetup) -> BShare:
    """start_i = valid_i AND (i == 0 OR key_i != key_{i-1}); composite keys
    compare equal iff every column does."""
    keys: List[BShare] = [key] if isinstance(key, BShare) else list(key)
    e = eq(keys[0], _shift_down(keys[0]), prf.fold(601))
    for i, k in enumerate(keys[1:]):
        ei = eq(k, _shift_down(k), prf.fold(603).fold(2 * i))
        e = and_bit(e, ei, prf.fold(603).fold(2 * i + 1))
    # row 0 always starts a segment: force e_0 = 0 with a public mask
    n = keys[0].shape[0]
    m = torch.ones(n, dtype=torch.int32, device=e.device)
    m[0] = 0
    e = e.and_public(m)
    return and_bit(valid, e.xor_public(1), prf.fold(602))
