"""Oblivious DISTINCT: sort by the column, keep the first row of each run."""
from __future__ import annotations

from ..core.prf import PRFSetup
from ..core.sharing import BShare, select
from ..core.sort import bitonic_sort_narrow
from .groupby import SENTINEL, pad_pow2, segment_starts
from .table import SecretTable

__all__ = ["oblivious_distinct"]


def oblivious_distinct(table: SecretTable, col: str, prf: PRFSetup) -> SecretTable:
    """valid' marks exactly one row per distinct value of ``col`` among valid
    rows. Output size == input size (fully oblivious)."""
    table = pad_pow2(table)
    keyb = table.bshare_col(col, prf)
    vmask = table.valid.lsb_mask()
    sentinel = BShare(keyb.shares.new_zeros(keyb.shares.shape)).xor_public(SENTINEL)
    sort_key = select(vmask, keyb, sentinel, prf.fold(671))

    cols = {"__sk": sort_key, "__valid": table.valid}
    cols.update({k: table.bshare_col(k, prf) for k in table.cols})
    cols = bitonic_sort_narrow(cols, "__sk", prf)
    valid = cols.pop("__valid")
    cols.pop("__sk")

    first = segment_starts(cols[col], valid, prf)
    return SecretTable(cols, first)
