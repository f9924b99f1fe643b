"""Oblivious equi-join (Cartesian product), lazy-materializing.

The result has the product's public size N1 x N2: row r = (i, j) with
``valid = valid1[i] AND valid2[j] AND (key1[i] == key2[j])``. Only ``valid``
is computed at the product size, tile by tile (``prf.fold(500).fold(t0 //
tile)`` per tile), gathering the base key / valid columns through the public
product-layout index maps; payload columns stay :class:`LazyGather` views
until the next Resizer keeps S rows. The ledger logs one product-wide circuit
(tiles share rounds). ``lazy=False`` keeps the expand-everything path, the
paper's baseline for the lazy one: every payload column is expanded to
N1 x N2 rows before any trim, and ``valid`` is one product-wide circuit; its
ledger equals the lazy path's. A port of ``repro.ops.join``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import current_config
from ..core.circuits import and_bit, eq, le
from ..core.ledger import fused_scope
from ..core.prf import PRFSetup
from ..core.sharing import BShare
from .table import LazyGather, SecretTable

__all__ = ["oblivious_join"]


def _disambiguate(cols: dict, name: str) -> str:
    out_name = name
    suffix = 0
    while out_name in cols:
        suffix += 1
        out_name = f"r{suffix}.{name}"
    return out_name


def _as_lazy(col, idx: torch.Tensor) -> LazyGather:
    """View ``col`` through the product index map; composes if ``col`` is
    itself a lazy view (join-after-join)."""
    if isinstance(col, LazyGather):
        return LazyGather(col.base, col.index[idx])
    return LazyGather(col, idx)


def oblivious_join(
    left: SecretTable,
    right: SecretTable,
    on: Tuple[str, str],
    prf: PRFSetup,
    theta: Optional[Tuple[str, str, str]] = None,
    lazy: bool = True,
    tile: Optional[int] = None,
) -> SecretTable:
    """Equi-join ``left.on[0] == right.on[1]``; output size = n1 * n2.

    ``theta``: optional extra condition (left_col, op, right_col) with op in
    {"le", "eq"}. ``tile``: product-grid rows per valid-computation tile of
    the lazy path, default ``RuntimeConfig.join_tile``.
    """
    if not lazy:
        return _eager_join(left, right, on, prf, theta)
    n1, n2 = left.n, right.n
    total = n1 * n2
    tile = max(1, tile if tile is not None else current_config().join_tile)
    lk, rk = on
    device = left.device

    # Public product layout: row r = (i * n2 + j).
    li = torch.arange(n1, device=device).repeat_interleave(n2)
    ri = torch.arange(n2, device=device).repeat(n1)

    lkey = left.bshare_col(lk, prf)
    rkey = right.bshare_col(rk, prf)
    lvalid, rvalid = left.valid, right.valid
    tl = tr = None
    if theta is not None:
        tcol_l, top, tcol_r = theta
        if top not in ("le", "eq"):
            raise ValueError(f"unsupported theta op {top}")
        tl = left.bshare_col(tcol_l, prf)
        tr = right.bshare_col(tcol_r, prf)

    levels = lkey.ring.bits.bit_length() - 1
    rounds = levels + 2  # eq + AND(valid1, valid2) + AND(match)
    if theta is not None:
        rounds += (1 + levels if top == "le" else levels) + 1

    valid_tiles = []
    with fused_scope("join_valid", rounds=rounds):
        for t0 in range(0, total, tile):
            lit, rit = li[t0:t0 + tile], ri[t0:t0 + tile]
            p = prf.fold(500).fold(t0 // tile)  # fresh randomness per tile
            match = eq(lkey.take(lit), rkey.take(rit), p.fold(501))
            both = and_bit(lvalid.take(lit), rvalid.take(rit), p.fold(502))
            v = and_bit(both, match, p.fold(503))
            if theta is not None:
                xl, xr = tl.take(lit), tr.take(rit)
                extra = le(xl, xr, p.fold(504)) if top == "le" else eq(xl, xr, p.fold(504))
                v = and_bit(v, extra, p.fold(505))
            valid_tiles.append(v)
    if not valid_tiles:
        valid = BShare(torch.zeros((3, 0), dtype=torch.int32, device=device))
    elif len(valid_tiles) == 1:
        valid = valid_tiles[0]
    else:
        valid = BShare.concat(valid_tiles)

    cols: dict = {}
    for name, col in left.cols.items():
        cols[name] = _as_lazy(col, li)
    for name, col in right.cols.items():
        cols[_disambiguate(cols, name)] = _as_lazy(col, ri)
    return SecretTable(cols, valid)


def _eager_join(
    left: SecretTable,
    right: SecretTable,
    on: Tuple[str, str],
    prf: PRFSetup,
    theta: Optional[Tuple[str, str, str]] = None,
) -> SecretTable:
    """The expand-everything join: every payload column is materialized at
    the full N1 x N2 size before any trim."""
    n1, n2 = left.n, right.n
    lk, rk = on

    # row r = (i * n2 + j)
    def expand_left(col):
        return col.map_shares(lambda s: s.repeat_interleave(n2, dim=1))

    def expand_right(col):
        return col.map_shares(lambda s: s.repeat((1, n1) + (1,) * (s.dim() - 2)))

    cols = {}
    for name in left.cols:
        cols[name] = expand_left(left.col(name))
    for name in right.cols:
        cols[_disambiguate(cols, name)] = expand_right(right.col(name))

    lkey = expand_left(left.bshare_col(lk, prf))
    rkey = expand_right(right.bshare_col(rk, prf))
    match = eq(lkey, rkey, prf.fold(501))
    both = and_bit(expand_left(left.valid), expand_right(right.valid), prf.fold(502))
    valid = and_bit(both, match, prf.fold(503))

    if theta is not None:
        tcol_l, op, tcol_r = theta
        xl = expand_left(left.bshare_col(tcol_l, prf))
        xr = expand_right(right.bshare_col(tcol_r, prf))
        if op == "le":
            extra = le(xl, xr, prf.fold(504))
        elif op == "eq":
            extra = eq(xl, xr, prf.fold(504))
        else:
            raise ValueError(f"unsupported theta op {op}")
        valid = and_bit(valid, extra, prf.fold(505))
    return SecretTable(cols, valid)
