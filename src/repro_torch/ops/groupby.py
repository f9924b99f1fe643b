"""Oblivious GroupBy with COUNT, SUM and AVG aggregates (single or composite
key), and the sort-based helpers Distinct shares with it.

Pipeline, as ``repro.ops.groupby``:

1. Sort keys that send invalid rows to the end (``valid ? key : SENTINEL``,
   one AND per key column; tag 651, extra keys ``651.fold(i)``).
2. Bitonic-sort the table by them (composite keys compare
   lexicographically inside each compare-exchange).
3. Mark segment starts (tags 601-603).
4. Segmented Kogge-Stone prefix sum in arithmetic sharing: two ring
   multiplications a level (tags 620+lvl and 640+lvl).
5. Mark each group's last row as its representative (661/662); it carries
   the aggregate, every other row stays as an invalid filler (output size ==
   input size).

Group keys must be < 0xFFFFFFFE (the sentinel).
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch

from ..core.circuits import and_bit, b2a, bit2a, eq, or_bit
from ..core.prf import PRFSetup
from ..core.sharing import AShare, BShare, mul, select
from ..core.sort import bitonic_sort_narrow
from .table import SecretTable

__all__ = [
    "SENTINEL",
    "oblivious_groupby_count",
    "oblivious_groupby_sum",
    "oblivious_groupby_avg",
    "pad_pow2",
    "segment_starts",
    "segmented_count",
    "segmented_reduce",
]

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


def _edge_fill(col: BShare, row: int, fill: int) -> BShare:
    """XOR the public ``fill`` into one row (a no-op for 0)."""
    if not fill:
        return col
    c = torch.zeros(col.shape, dtype=torch.int32, device=col.device)
    c[row].fill_(fill)  # a fill, not a host-to-device copy: capturable
    return col.xor_public(c)


def _shift_down(col: BShare, fill: int = 0) -> BShare:
    """Row i gets row i-1's shares; row 0 gets ``fill`` (public constant)."""
    s = col.shares
    return _edge_fill(BShare(torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], dim=1)), 0, fill)


def _shift_up(col: BShare, fill: int = 0) -> BShare:
    """Row i gets row i+1's shares; the last row gets ``fill``."""
    s = col.shares
    return _edge_fill(BShare(torch.cat([s[:, 1:], torch.zeros_like(s[:, :1])], dim=1)), -1, fill)


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
    m[0].fill_(0)
    e = e.and_public(m)
    return and_bit(valid, e.xor_public(1), prf.fold(602))


def _shift_a(x: AShare, d: int, fill: int) -> AShare:
    """Rows shift down by ``d``; the first ``d`` rows get the public
    ``fill``, which share 0 absorbs."""
    s = x.shares
    shifted = torch.cat([torch.zeros_like(s[:, :d]), s[:, :-d]], dim=1)
    fills = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    fills[:d].fill_(fill)
    return AShare(shifted).add_public(fills)


def segmented_reduce(vals: AShare, f: AShare, prf: PRFSetup) -> AShare:
    """Segmented inclusive prefix sum of arithmetic ``vals``.

    Kogge-Stone over (V, F) o (Vl, Fl) = (V + Vl * (1 - F), F OR Fl): log2(N)
    levels of 2 ring multiplications. ``f`` is the arithmetic {0,1}
    segment-start flag; it may have a trailing dim of 1 against ``vals``'
    lanes, so a (sum, count) pair reduces in one scan.
    """
    n = vals.shape[0]
    d = 1
    lvl = 0
    while d < n:
        vl = _shift_a(vals, d, 0)
        fl = _shift_a(f, d, 1)  # out-of-range neighbours act as boundaries
        keep = -f + 1  # (1 - F): local
        vals = vals + mul(vl, keep, prf.fold(620 + lvl))
        fmul = mul(f, fl, prf.fold(640 + lvl))
        f = f + fl - fmul  # OR
        d *= 2
        lvl += 1
    return vals


def segmented_count(valid: BShare, start: BShare, prf: PRFSetup) -> AShare:
    """Segmented inclusive prefix sum of the valid bits (count within group)."""
    v = bit2a(valid, prf.fold(611))
    f = bit2a(start, prf.fold(612))
    return segmented_reduce(v, f, prf)


def _masked_sort_keys(table: SecretTable, key_cols: Sequence[str], prf: PRFSetup):
    """``valid ? key : SENTINEL`` per key column, so invalid rows sink to the
    sorted suffix. Returns the sort-key columns and their names in key
    order (key 0 under tag 651, key i under ``651.fold(i)``)."""
    vmask = table.valid.lsb_mask()
    cols: dict = {}
    for i, kc in enumerate(key_cols):
        keyb = table.bshare_col(kc, prf)
        sentinel = BShare(torch.zeros_like(keyb.shares)).xor_public(SENTINEL)
        p = prf.fold(651) if i == 0 else prf.fold(651).fold(i)
        cols["__sk" if i == 0 else f"__sk{i}"] = select(vmask, keyb, sentinel, p)
    return cols, list(cols)


def _representatives(valid: BShare, start: BShare, prf: PRFSetup) -> BShare:
    """Mark the last row of each valid segment (it carries the aggregate)."""
    nxt_start = _shift_up(start, fill=1)
    not_nxt_valid = _shift_up(valid, fill=0).xor_public(1)
    boundary = or_bit(nxt_start.and_public(1), not_nxt_valid.and_public(1), prf.fold(661))
    return and_bit(valid, boundary, prf.fold(662))


def _keys(key_col: Union[str, Sequence[str]]) -> List[str]:
    return [key_col] if isinstance(key_col, str) else list(key_col)


def oblivious_groupby_count(
    table: SecretTable,
    key_col: Union[str, Sequence[str]],
    prf: PRFSetup,
    count_name: str = "cnt",
) -> SecretTable:
    """GROUP BY ``key_col`` with COUNT(*): the masked keys and the valid bit
    ride the network; the masked keys double as the output key columns
    (equal to the raw keys on every valid row)."""
    key_cols = _keys(key_col)
    table = pad_pow2(table)
    cols, sort_names = _masked_sort_keys(table, key_cols, prf)
    cols["__valid"] = table.valid
    cols = bitonic_sort_narrow(cols, sort_names, prf)
    valid = cols.pop("__valid")
    keys_sorted = [cols[name] for name in sort_names]

    start = segment_starts(keys_sorted, valid, prf)
    cnt = segmented_count(valid, start, prf)
    rep = _representatives(valid, start, prf)
    out_cols: dict = dict(zip(key_cols, keys_sorted))
    out_cols[count_name] = cnt
    return SecretTable(out_cols, rep)


def _groupby_agg(table: SecretTable, key_col, val_col: str, prf: PRFSetup, with_count: bool):
    """The sort and segmented scan of GROUP BY SUM / AVG: (sorted key columns
    by name, the per-row aggregate AShares, the representative bits)."""
    key_cols = _keys(key_col)
    table = pad_pow2(table)
    cols, sort_names = _masked_sort_keys(table, key_cols, prf)
    cols["__valid"] = table.valid
    cols["__val"] = table.bshare_col(val_col, prf)
    cols = bitonic_sort_narrow(cols, sort_names, prf)
    valid = cols.pop("__valid")
    val_b = cols.pop("__val")
    keys_sorted = [cols[name] for name in sort_names]

    start = segment_starts(keys_sorted, valid, prf)
    va = b2a(val_b, prf.fold(663))
    vbit = bit2a(valid, prf.fold(664))
    masked = mul(va, vbit, prf.fold(665))  # invalid rows contribute 0
    f = bit2a(start, prf.fold(612))
    if with_count:
        # (sum, count) reduce in one scan: a 2-wide lane, f broadcast over it
        pair = AShare(torch.stack([masked.shares, vbit.shares], dim=2))
        agg = segmented_reduce(pair, AShare(f.shares[..., None]), prf.fold(617))
        aggs = [AShare(agg.shares[:, :, 0]), AShare(agg.shares[:, :, 1])]
    else:
        aggs = [segmented_reduce(masked, f, prf.fold(617))]
    rep = _representatives(valid, start, prf)
    return dict(zip(key_cols, keys_sorted)), aggs, rep


def oblivious_groupby_sum(
    table: SecretTable,
    key_col: Union[str, Sequence[str]],
    val_col: str,
    prf: PRFSetup,
    name: str = "sum",
) -> SecretTable:
    out_cols, (total,), rep = _groupby_agg(table, key_col, val_col, prf, False)
    out_cols[name] = total
    return SecretTable(out_cols, rep)


def oblivious_groupby_avg(
    table: SecretTable,
    key_col: Union[str, Sequence[str]],
    val_col: str,
    prf: PRFSetup,
    name: str = "avg",
) -> SecretTable:
    """Per-group (sum, count) pair; the division happens after the reveal
    (as the scalar AVG)."""
    out_cols, (total, cnt), rep = _groupby_agg(table, key_col, val_col, prf, True)
    out_cols[f"{name}_sum"] = total
    out_cols[f"{name}_cnt"] = cnt
    return SecretTable(out_cols, rep)
