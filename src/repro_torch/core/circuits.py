"""Boolean circuits over XOR-replicated shares (a port of ``repro.core.circuits``).

Two execution paths, as in the reference. With fusion on
(:func:`repro_torch.kernels.fusion_enabled`, ``RuntimeConfig.fuse_circuits``,
the default) the gate loops go through the single-launch fused kernels:
``and_fold`` for the equality AND tree, ``ks_prefix`` for every Kogge-Stone
prefix (``lt``, ``lt_public``, ``ks_add``), ``a2b_kernel`` for the whole
arithmetic -> boolean conversion and ``bit2a_kernel`` for the bit injection.
With fusion off every interactive gate goes through :func:`.sharing.and_` /
:func:`.sharing.mul` (the ``rss_gate`` kernel on a CUDA tensor), one launch
per level. The fused wrappers draw each level's zero sharing from the same
PRF fold (7, 11, 21, 22, 31, 32, 100+d, 200+d and d for the equality tree)
and log the same ledger entries as the gate-by-gate path, so shares and
(rounds, bytes/party) are bit-identical across the two paths and to the
reference; only the launch count and the memory traffic change. The
generate AND of ``lt`` and the gates of ``and_bit`` / ``or_bit`` stay
``rss_gate`` launches on both paths.

==============  ========================  ==========================
circuit         rounds                    AND-words / lane
==============  ========================  ==========================
eq / eq_public  log2 k            (5)     log2 k            (5)
lt / le         1 + log2 k        (6)     1 + 2 log2 k      (11)
lt_public       log2 k            (5)     2 log2 k          (10)
ks_add          1 + log2 k        (6)     1 + 2 log2 k      (11)
bit2a           2                         2 (ring mults)
b2a             2 (parallel bits)         2k
a2b             2 ks_add          (12)    2 + 4 log2 k      (22)
==============  ========================  ==========================
"""
from __future__ import annotations

import torch

from ..kernels import fusion_enabled
from ..kernels.a2b_fused import a2b_fused, bit2a_fused
from ..kernels.ks_prefix import and_fold_fused, ks_levels_fused
from .ledger import fused_scope
from .prf import PRFSetup
from .sharing import AShare, BShare, and_, mul

__all__ = [
    "eq",
    "eq_public",
    "lt",
    "le",
    "lt_public",
    "le_public",
    "gt_public",
    "ks_add",
    "bit2a",
    "b2a",
    "a2b",
    "and_bit",
    "or_bit",
]


def _and_pair(a1: BShare, b1: BShare, a2: BShare, b2: BShare, prf: PRFSetup):
    """Two independent ANDs evaluated in a single communication round."""
    x = BShare(torch.stack([a1.shares, a2.shares], dim=1))
    y = BShare(torch.stack([b1.shares, b2.shares], dim=1))
    z = and_(x, y, prf)
    return BShare(z.shares[:, 0]), BShare(z.shares[:, 1])


# -----------------------------------------------------------------------------
# Equality
# -----------------------------------------------------------------------------

def _and_reduce_bits(v: BShare, prf: PRFSetup, width: int) -> BShare:
    """AND all ``width`` bits of each lane into the LSB (log2(width) rounds):
    one fused launch, or one AND per level."""
    if fusion_enabled():
        return and_fold_fused(v, prf, width).and_public(1)
    d = width // 2
    while d >= 1:
        v = and_(v, v >> d, prf.fold_unpooled(d))
        d //= 2
    return v.and_public(1)


def eq(x: BShare, y: BShare, prf: PRFSetup, width: int | None = None) -> BShare:
    """x == y -> single-bit BShare in the LSB: a log2(k)-deep AND tree."""
    width = width or x.ring.bits
    with fused_scope("eq", rounds=width.bit_length() - 1):
        return _and_reduce_bits(~(x ^ y), prf, width)


def eq_public(x: BShare, c, prf: PRFSetup, width: int | None = None) -> BShare:
    width = width or x.ring.bits
    with fused_scope("eq", rounds=width.bit_length() - 1):
        return _and_reduce_bits(~(x.xor_public(c)), prf, width)


# -----------------------------------------------------------------------------
# Comparison: unsigned borrow-lookahead (Kogge-Stone prefix)
# -----------------------------------------------------------------------------

def _ks_levels(g: BShare, p: BShare, prf: PRFSetup, width: int, fold_base: int) -> BShare:
    """All Kogge-Stone levels of the (g, p) prefix recurrence; returns the
    final g. One fused launch, or one batched AND pair per level."""
    if fusion_enabled():
        return ks_levels_fused(g, p, prf, width, fold_base)
    d = 1
    while d < width:
        pg, pp = _and_pair(p, g << d, p, p << d, prf.fold_unpooled(fold_base + d))
        g = g ^ pg
        p = pp
        d *= 2
    return g


def lt(x: BShare, y: BShare, prf: PRFSetup, width: int | None = None) -> BShare:
    """Unsigned x < y -> single-bit BShare (borrow-out of x - y)."""
    width = width or x.ring.bits
    levels = width.bit_length() - 1
    with fused_scope("lt", rounds=1 + levels):
        g = and_(~x, y, prf.fold(7))  # borrow generate: x_j=0, y_j=1
        p = ~(x ^ y)  # borrow propagate: x_j == y_j (local)
        b = _ks_levels(g, p, prf, width, fold_base=100)
        return (b >> (width - 1)).and_public(1)


def lt_public(x: BShare, c: int, prf: PRFSetup, width: int | None = None) -> BShare:
    """x < c with public c: the generate AND becomes local (saves a round)."""
    width = width or x.ring.bits
    levels = width.bit_length() - 1
    c = c & x.ring.mask
    with fused_scope("lt", rounds=levels):
        g = (~x).and_public(c)
        p = ~(x.xor_public(c))
        b = _ks_levels(g, p, prf, width, fold_base=100)
        return (b >> (width - 1)).and_public(1)


def le(x: BShare, y: BShare, prf: PRFSetup, width: int | None = None) -> BShare:
    """x <= y  ==  not (y < x)."""
    return _not_bit(lt(y, x, prf, width))


def le_public(x: BShare, c: int, prf: PRFSetup, width: int | None = None) -> BShare:
    """x <= c (public c)  ==  x < c+1."""
    return lt_public(x, (c + 1) & x.ring.mask, prf, width)


def gt_public(x: BShare, c: int, prf: PRFSetup, width: int | None = None) -> BShare:
    """x > c (public c) == not(x < c+1)."""
    return _not_bit(lt_public(x, (c + 1) & x.ring.mask, prf, width))


def _not_bit(b: BShare) -> BShare:
    """Negate a single-bit share (flip only the LSB)."""
    return b.xor_public(1)


def and_bit(a: BShare, b: BShare, prf: PRFSetup) -> BShare:
    return and_(a, b, prf)


def or_bit(a: BShare, b: BShare, prf: PRFSetup) -> BShare:
    return _not_bit(and_(_not_bit(a), _not_bit(b), prf))


# -----------------------------------------------------------------------------
# Kogge–Stone adder (boolean addition; used by a2b)
# -----------------------------------------------------------------------------

def ks_add(x: BShare, y: BShare, prf: PRFSetup, width: int | None = None) -> BShare:
    width = width or x.ring.bits
    levels = width.bit_length() - 1
    with fused_scope("ks_add", rounds=1 + levels):
        g = and_(x, y, prf.fold(11))
        p = x ^ y
        g = _ks_levels(g, p, prf, width, fold_base=200)
        return x ^ y ^ (g << 1)


# -----------------------------------------------------------------------------
# Share conversions
# -----------------------------------------------------------------------------

def _trivial(words: torch.Tensor, slot: int) -> torch.Tensor:
    """Share triple (0,..,v,..,0) with v at ``slot`` — locally constructible
    by the two parties that hold that share leg."""
    z = torch.zeros((3,) + tuple(words.shape), dtype=words.dtype, device=words.device)
    z[slot] = words
    return z


def bit2a(b: BShare, prf: PRFSetup) -> AShare:
    """Single-bit XOR sharing -> arithmetic sharing of {0,1}: XOR emulated
    twice as u ^ v = u + v - 2uv. Two ring multiplications, 2 rounds."""
    with fused_scope("bit2a", rounds=2):
        if fusion_enabled():
            return bit2a_fused(b, prf)
        bits = b.shares & 1
        a0, a1, a2 = (AShare(_trivial(bits[i], i)) for i in range(3))
        t = a0 + a1 - mul(a0, a1, prf.fold(21)).mul_public(2)
        return t + a2 - mul(t, a2, prf.fold(22)).mul_public(2)


def b2a(x: BShare, prf: PRFSetup, width: int | None = None) -> AShare:
    """Full-word boolean -> arithmetic via parallel per-bit injection: all
    ``width`` bit2a instances run in the same 2 rounds (bit planes as a
    trailing lane axis), and the weighted recombination is local."""
    width = width or x.ring.bits
    with fused_scope("b2a", rounds=2):
        planes = BShare(torch.stack([(x.shares >> j) & 1 for j in range(width)], dim=-1))
        bits_a = bit2a(planes, prf)
        ring = x.ring
        # 2^j as ring words (2^31 / 2^63 wrap to the storage type's minimum),
        # made on the device: no host-to-device copy inside a captured graph
        weights = torch.bitwise_left_shift(
            torch.ones(width, dtype=ring.dtype, device=x.device),
            torch.arange(width, dtype=ring.dtype, device=x.device),
        )
        # products wrap in the storage type; an int64 sum wraps mod 2^64, and
        # the sum of width int32 words cannot overflow it
        total = torch.sum(bits_a.shares * weights, dim=-1, dtype=torch.int64)
        return AShare(total.to(ring.dtype))


def a2b(x: AShare, prf: PRFSetup, width: int | None = None) -> BShare:
    """Arithmetic -> boolean: boolean-share each arithmetic leg trivially,
    then two Kogge-Stone additions (2 * (1 + log2 k) rounds). One fused
    launch, or 2 * (1 + log2 k) gate launches."""
    width = width or x.ring.bits
    with fused_scope("a2b", rounds=2 * (1 + width.bit_length() - 1)):
        if fusion_enabled():
            return a2b_fused(x, prf, width)
        legs = [BShare(_trivial(x.shares[i], i)) for i in range(3)]
        s = ks_add(legs[0], legs[1], prf.fold(31), width)
        return ks_add(s, legs[2], prf.fold(32), width)
