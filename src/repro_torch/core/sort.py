"""Oblivious bitonic sorting network over secret-shared tables.

A bitonic network on N = 2^m rows has m(m+1)/2 compare-exchange stages; each
costs one oblivious ``lt`` over N lanes plus one batched AND-select over all
columns. A port of ``repro.core.sort`` (fold tags 7k+j, 9000+31k+7j, 686 and
the lexicographic combine tags are the reference's).

The stage's conditional swap is ``own ^ and_(m, own ^ other)``. On the
fused circuit path it runs as one ``bitonic_swap`` launch over all columns
(``kernels/bitonic_stage``), with alpha drawn from the select's fold at the
shape ``and_`` draws it and the same ledger entry, so its shares and costs
equal the gate-by-gate path's ``rss_gate`` select bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Union

import torch

from ..kernels import fusion_enabled
from ..kernels.bitonic_stage import stage_swap
from .circuits import and_bit, eq, lt, or_bit
from .ledger import fused_scope, log_comm
from .prf import PRFSetup, zero_share_unpooled
from .sharing import AShare, BShare, and_, const_b

__all__ = ["bitonic_sort", "bitonic_sort_narrow", "bitonic_stages", "sort_valid_first"]

Share = Union[AShare, BShare]


def bitonic_stages(n: int):
    """Yield (k, j) for the standard iterative bitonic network on n = 2^m."""
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


def _lex_lt(his: List[BShare], los: List[BShare], prf: PRFSetup) -> BShare:
    """Lexicographic ``his < los`` over parallel key columns:
    lt_0 OR (eq_0 AND lt_1) OR (eq_0 AND eq_1 AND lt_2) ..."""
    if len(his) == 1:
        return lt(his[0], los[0], prf.fold(0))
    h = BShare(torch.stack([c.shares for c in his], dim=1))  # (3, K, n)
    lo = BShare(torch.stack([c.shares for c in los], dim=1))
    lts = lt(h, lo, prf.fold(0))
    eqs = eq(BShare(h.shares[:, :-1]), BShare(lo.shares[:, :-1]), prf.fold(6))
    res = BShare(lts.shares[:, 0])
    ties = None
    for i in range(1, len(his)):
        p = prf.fold(i)
        e = BShare(eqs.shares[:, i - 1])
        ties = e if ties is None else and_bit(ties, e, p.fold(2))
        res = or_bit(res, and_bit(ties, BShare(lts.shares[:, i]), p.fold(4)), p.fold(5))
    return res


def _stage(
    cols: Dict[str, BShare],
    key_cols: Sequence[str],
    k: int,
    j: int,
    prf: PRFSetup,
    descending: bool,
) -> Dict[str, BShare]:
    keyb = cols[key_cols[0]]
    n, device = keyb.shape[0], keyb.device
    idx = torch.arange(n, device=device)
    partner = idx ^ j
    is_lo = idx < partner  # public lane predicate
    asc = (idx & k) == 0  # public direction per pair (bit k equal for both)
    if descending:
        asc = ~asc

    def lo_hi(col: BShare):
        b = col.shares.index_select(1, partner)  # partner value
        return BShare(torch.where(is_lo, col.shares, b)), BShare(torch.where(is_lo, b, col.shares))

    los, his = zip(*(lo_hi(cols[kc]) for kc in key_cols))
    # swap decision, identical at both lanes of the pair (ties don't swap)
    p = prf.fold(7 * k + j)
    s = lt(his[0], los[0], p) if len(key_cols) == 1 else _lex_lt(list(his), list(los), p)
    # descending pairs invert the decision (local XOR with a public bit)
    s = s.xor_public((~asc).to(torch.int32))
    mask = s.lsb_mask()

    # conditional swap of every column in one batched AND
    names = list(cols)
    own = torch.stack([cols[nm].shares for nm in names], dim=1)  # (3, C, n)
    other = own.index_select(2, partner)
    p_sel = prf.fold(9000 + 31 * k + 7 * j)
    if fusion_enabled():
        # and_'s draw at the broadcast (C, n) shape, and its ledger entry
        alpha = zero_share_unpooled(p_sel, own.shape[1:], device, xor=True)
        log_comm("and", 1, own[0].numel() * keyb.ring.bytes)
        new = stage_swap(mask.shares, own, other, alpha)
    else:
        m3 = BShare(mask.shares[:, None, :].expand(own.shape))
        new = own ^ and_(m3, BShare(own ^ other), p_sel).shares
    return {nm: BShare(new[:, i]) for i, nm in enumerate(names)}


def bitonic_sort(
    cols: Dict[str, BShare],
    key_col: Union[str, Sequence[str]],
    prf: PRFSetup,
    descending: bool = False,
) -> Dict[str, BShare]:
    """Sort all columns by ``key_col`` (32-bit unsigned order) — one column
    name or a sequence compared lexicographically. N must be a power of two."""
    key_cols = [key_col] if isinstance(key_col, str) else list(key_col)
    n = next(iter(cols.values())).shape[0]
    if n & (n - 1):
        raise ValueError(f"bitonic_sort requires power-of-two rows, got {n}")
    m = int(math.log2(n))
    n_stages = m * (m + 1) // 2
    # per-stage rounds: 6 (lt, all key columns in parallel) + 2 combining
    # levels per extra key (tie-AND + OR) + 1 select
    rounds_per_stage = 7 + 2 * (len(key_cols) - 1)
    with fused_scope("bitonic_sort", rounds=rounds_per_stage * n_stages):
        for k, j in bitonic_stages(n):
            cols = _stage(cols, key_cols, k, j, prf, descending)
    return cols


def bitonic_sort_narrow(
    cols: Dict[str, Share],
    key_col: Union[str, Sequence[str]],
    prf: PRFSetup,
    descending: bool = False,
) -> Dict[str, Share]:
    """``bitonic_sort`` with payload narrowing: only the key columns plus a
    shared row-index column ride the network; the payload is gathered once
    post-sort by the sorted index via ``apply_secret_perm``. Below two
    payload columns the full-payload network runs instead (same output)."""
    key_cols = [key_col] if isinstance(key_col, str) else list(key_col)
    payload = {n_: c for n_, c in cols.items() if n_ not in key_cols}
    if len(payload) < 2:
        return bitonic_sort(cols, key_col, prf, descending)
    from .shuffle import apply_secret_perm

    first = next(iter(cols.values()))
    n, device = first.shape[0], first.device
    if "__idx" in cols:
        raise ValueError("__idx is reserved by bitonic_sort_narrow")
    net = {kc: cols[kc] for kc in key_cols}
    net["__idx"] = const_b(torch.arange(n, dtype=torch.int32, device=device), device)
    net = bitonic_sort(net, key_cols, prf, descending)
    idx = net.pop("__idx")
    moved = apply_secret_perm(payload, idx, prf.fold(686))
    return {n_: (net[n_] if n_ in net else moved[n_]) for n_ in cols}


def sort_valid_first(cols: Dict[str, BShare], valid_col: str, prf: PRFSetup) -> Dict[str, BShare]:
    """Shrinkwrap's pre-cut sort: true tuples (valid = 1) to the front, by a
    descending sort on the single-bit valid column (the network is not
    stable, so equal keys keep no particular order, as in Shrinkwrap)."""
    return bitonic_sort_narrow(cols, valid_col, prf, descending=True)
