"""Oblivious sort-merge equi-join: a port of ``repro.ops.join_sortmerge``.

The product join compares every (i, j) pair: N1 x N2 secure equalities,
however selective the join. This operator tags both inputs with an origin
bit, sorts the union by ``(key, origin)`` with the bitonic network
(``bitonic_swap`` stages, ``ks_prefix`` / ``and_fold`` compares), and then
propagates each build row's payload to the probe rows of its key segment
with a Kogge-Stone segmented copy-last scan (log2 N levels of three
``rss_gate`` ANDs and one select). Build rows sort first in a segment
(origin 0 < 1)::

    [ ...  k k k | k' k' ... ]      key segments (boundaries: one eq with
      b b  p p p   b  p            the row above); b = build, p = probe

Output copy r marks a probe row valid iff its segment holds at least r + 1
valid build rows; ``fanout``, a public bound on the build side's valid rows
per key (catalog metadata), bounds the copies, so the output has
``fanout * pow2(N1 + N2)`` rows instead of ``N1 * N2``. After a trim the
result equals the product join's, provided ``fanout`` really bounds the
build side's multiplicity.

Only ``(key, origin, row index)`` ride the network; the payload and the
valid bit move once by the sorted index (``apply_secret_perm``, through the
``shuffle_gather`` hops). Fold tags (520, then 1-13 and the scan's
``9.fold(4 * level + k)``), draw shapes and ledger entries are the
reference's, so shares and tallies are bit-identical to it. Where the
reference broadcasts a share to the ``fanout`` copies, the port
materializes the copies (``_bcast``): every kernel wrapper gets dense
operands.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.circuits import a2b, and_bit, eq, eq_public, le
from ..core.ledger import fused_scope
from ..core.prf import PRFSetup
from ..core.sharing import BShare, and_, const_b, select
from ..core.shuffle import apply_secret_perm
from ..core.sort import bitonic_sort
from .groupby import _shift_down, segmented_count
from .join import _disambiguate
from .table import SecretTable

__all__ = ["oblivious_join_sortmerge"]


def _pow2_ceil(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _union_col(col: BShare, before: int, n: int) -> BShare:
    """Place ``col`` at row offset ``before`` of an n-row union column; every
    other row is a zero sharing (value 0, never valid)."""
    s = col.shares
    pad = lambda rows: torch.zeros((3, rows) + tuple(s.shape[2:]), dtype=s.dtype, device=s.device)
    return BShare(torch.cat([pad(before), s, pad(n - before - s.shape[1])], dim=1))


def _rows(col: BShare, d: int, fill: int) -> BShare:
    """Shift the scan state down by ``d`` along the union-row axis (axis 1 of
    a (copies, n, ...) share); rows shifted in read the public ``fill``,
    which share 0 absorbs."""
    s = col.shares
    out = BShare(torch.cat([torch.zeros_like(s[:, :, :d]), s[:, :, :-d]], dim=2))
    if not fill:
        return out
    fills = torch.zeros(col.shape, dtype=torch.int32, device=col.device)
    fills[:, :d].fill_(fill)  # a fill, not a host-to-device copy: capturable
    return out.xor_public(fills)


def _bcast(col: BShare, copies: int) -> BShare:
    """(n, ...) -> (copies, n, ...): a public replication, materialized."""
    s = col.shares
    return BShare(s[:, None].expand((3, copies) + tuple(s.shape[1:])).contiguous())


def _empty_like(left: SecretTable, right: SecretTable) -> SecretTable:
    z = torch.zeros((3, 0), dtype=torch.int32, device=left.device)
    cols: Dict[str, BShare] = {name: BShare(z) for name in left.cols}
    for name in right.cols:
        cols[_disambiguate(cols, name)] = BShare(z)
    return SecretTable(cols, BShare(z))


def oblivious_join_sortmerge(
    left: SecretTable,
    right: SecretTable,
    on: Tuple[str, str],
    prf: PRFSetup,
    theta: Optional[Tuple[str, str, str]] = None,
    fanout: int = 1,
    build: str = "left",
) -> SecretTable:
    """Equi-join ``left.on[0] == right.on[1]`` by a union sort and a
    segmented scan; output size = fanout * pow2(n1 + n2).

    ``build`` names the side whose rows are propagated (``"left"`` /
    ``"right"``); ``fanout`` must bound its valid rows per key. ``theta`` is
    the product join's optional (left_col, op, right_col), op in
    {"le", "eq"}.
    """
    if build not in ("left", "right"):
        raise ValueError(f"build side must be 'left' or 'right', got {build!r}")
    if fanout < 1:
        raise ValueError(f"fanout must be >= 1, got {fanout}")
    if left.n == 0 or right.n == 0:
        return _empty_like(left, right)

    p = prf.fold(520)
    if build == "left":
        btab, ptab, bkey, pkey = left, right, on[0], on[1]
    else:
        btab, ptab, bkey, pkey = right, left, on[1], on[0]
    nb, nprobe = btab.n, ptab.n
    n = _pow2_ceil(nb + nprobe)
    device = left.device

    # ---- union: build rows, then probe rows, then padding -------------------
    ukey = BShare.concat([btab.bshare_col(bkey, p), ptab.bshare_col(pkey, p)]).pad_rows(n)
    origin = torch.zeros(n, dtype=torch.int32, device=device)
    origin[nb:nb + nprobe].fill_(1)
    uvalid = BShare.concat([btab.valid, ptab.valid]).pad_rows(n)

    payload: Dict[str, BShare] = {"__valid": uvalid}
    bnames, pnames = list(btab.cols), list(ptab.cols)
    for name in bnames:
        payload[f"b.{name}"] = _union_col(btab.bshare_col(name, p), 0, n)
    for name in pnames:
        payload[f"p.{name}"] = _union_col(ptab.bshare_col(name, p), nb, n)

    # ---- sort the narrow network (key, origin, row index) -------------------
    net = {
        "__key": ukey,
        "__orig": const_b(origin, device),
        "__idx": const_b(torch.arange(n, dtype=torch.int32, device=device), device),
    }
    net = bitonic_sort(net, ["__key", "__orig"], p.fold(1))
    moved = apply_secret_perm(payload, net["__idx"], p.fold(2))
    key_s, orig_s = net["__key"], net["__orig"]
    valid_s = moved["__valid"]

    # ---- segment boundaries and build-row markers ---------------------------
    e = eq(key_s, _shift_down(key_s), p.fold(3))
    first = torch.ones(n, dtype=torch.int32, device=device)
    first[0].fill_(0)
    bnd = e.and_public(first).xor_public(1)  # row 0 always starts a segment
    defined = and_bit(orig_s.xor_public(1), valid_s, p.fold(4))

    if fanout > 1:
        # each valid build row's 1-based rank in its segment, one-hot over
        # the copies by one batched public equality
        rank_b = a2b(segmented_count(defined, bnd, p.fold(5)), p.fold(6))
        wanted = torch.arange(1, fanout + 1, dtype=torch.int32, device=device)[:, None].expand(fanout, n)
        hit = eq_public(_bcast(rank_b, fanout), wanted, p.fold(7))
        g = and_bit(_bcast(defined, fanout), hit, p.fold(8))
    else:
        g = defined.reshape(1, n)

    # ---- segmented copy-last propagation of the build payload ---------------
    wb = max(len(bnames), 1)
    if bnames:
        pack = BShare.stack([moved[f"b.{c}"] for c in bnames], axis=1)  # (n, Wb)
    else:
        pack = const_b(torch.zeros((n, 1), dtype=torch.int32, device=device), device)
    v = _bcast(pack, fanout)  # (fanout, n, Wb)
    f = _bcast(bnd, fanout)  # (fanout, n)
    levels = max(n.bit_length() - 1, 0)
    ps = p.fold(9)
    with fused_scope("sortmerge_scan", rounds=3 * levels):
        d, lvl = 1, 0
        while d < n:
            gl, vl, fl = _rows(g, d, 0), _rows(v, d, 0), _rows(f, d, 1)
            nf = f.xor_public(1)
            u = and_(g.xor_public(1), nf, ps.fold(4 * lvl))
            # f | fl shares u's round (independent ANDs)
            f = and_(nf, fl.xor_public(1), ps.fold(4 * lvl + 1)).xor_public(1)
            t = and_(u, gl, ps.fold(4 * lvl + 2))
            tm = t.lsb_mask().map_shares(lambda s: s[..., None].expand(s.shape + (wb,)))
            v = select(tm, vl, v, ps.fold(4 * lvl + 3))
            g = g ^ t  # t is disjoint from g (t requires g = 0)
            d *= 2
            lvl += 1

    # ---- output validity ----------------------------------------------------
    ov = and_bit(orig_s, valid_s, p.fold(10))  # a probe row holding a true tuple
    out_valid = and_bit(_bcast(ov, fanout), g, p.fold(11))
    if theta is not None:
        tcol_l, top, tcol_r = theta
        if top not in ("le", "eq"):
            raise ValueError(f"unsupported theta op {top}")
        if build == "left":
            xl = BShare(v.shares[..., bnames.index(tcol_l)])
            xr = _bcast(moved[f"p.{tcol_r}"], fanout)
        else:
            xl = _bcast(moved[f"p.{tcol_l}"], fanout)
            xr = BShare(v.shares[..., bnames.index(tcol_r)])
        extra = le(xl, xr, p.fold(12)) if top == "le" else eq(xl, xr, p.fold(12))
        out_valid = and_bit(out_valid, extra, p.fold(13))

    # ---- assemble: the fanout copies stacked row-major ----------------------
    def flat(s: torch.Tensor) -> BShare:  # (3, fanout, n, ...) -> (3, fanout * n, ...)
        return BShare(s.reshape((3, fanout * n) + tuple(s.shape[3:])))

    build_out = {name: flat(v.shares[..., i]) for i, name in enumerate(bnames)}
    probe_out = {name: flat(_bcast(moved[f"p.{name}"], fanout).shares) for name in pnames}
    lcols, rcols = (build_out, probe_out) if build == "left" else (probe_out, build_out)
    cols: Dict[str, BShare] = {name: lcols[name] for name in left.cols}
    for name in right.cols:
        cols[_disambiguate(cols, name)] = rcols[name]
    return SecretTable(cols, flat(out_valid.shares))
