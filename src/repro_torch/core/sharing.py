"""3-party replicated secret sharing (RSS) over Z_{2^k} in PyTorch.

A secret ``x`` is the canonical share triple ``(s0, s1, s2)`` in a leading
axis of size 3, with ``x = s0 + s1 + s2`` (:class:`AShare`) or
``x = s0 ^ s1 ^ s2`` (:class:`BShare`), as ``repro.core.sharing``. Shares are
int32 tensors (ring-32, the default) or int64 tensors (ring-64, from
``share_a`` / ``share_b(..., ring=RING64)``); the dtype names the ring (see
:mod:`.ring`). Every protocol runs the same message pattern as the
reference and logs the same ledger entries, ``ring.bytes`` a lane.

``mul`` / ``and_`` — the only interactive gates — broadcast their operands,
draw the zero sharing at the broadcast shape, and go through the
``rss_gate`` kernel wrapper: the kernel on a CUDA tensor, its plain version
on a CPU tensor.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from ..kernels.rss_gate import gate
from . import threefry
from .ledger import log_comm
from .prf import PRFSetup, rand_replicated, widen, zero_share_add, zero_share_unpooled, zero_share_xor
from .ring import RING32, Ring, from_numpy, ring_of, srl

__all__ = [
    "AShare",
    "BShare",
    "share_a",
    "share_b",
    "reveal_a",
    "reveal_b",
    "mul",
    "and_",
    "or_",
    "select",
    "const_a",
    "const_b",
    "zeros_a",
    "zeros_b",
    "rand_ashare",
    "rand_bshare",
    "rand_replicated",
    "zero_share_add",
    "zero_share_xor",
    "NUM_PARTIES",
]

NUM_PARTIES = 3


def _as_ring(c, device, ring: Ring):
    """A public constant as ``ring`` words: a Python int wraps mod 2^k to a
    scalar of the storage type; arrays and tensors become tensors of the
    storage dtype on ``device`` (int32 words widen as unsigned words)."""
    if isinstance(c, int):
        return ring.word(c)
    if isinstance(c, torch.Tensor):
        if c.dtype == torch.int32 and ring.bits == 64:
            return c.to(device=device, dtype=torch.int64) & 0xFFFFFFFF
        return c.to(device=device, dtype=ring.dtype)
    return from_numpy(c, device, ring)


@dataclasses.dataclass
class _ShareBase:
    shares: torch.Tensor  # (3, *shape) int32 (ring-32) or int64 (ring-64)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.shares.shape[1:])

    @property
    def size(self) -> int:
        s = 1
        for d in self.shape:
            s *= d
        return s

    @property
    def ring(self) -> Ring:
        return ring_of(self.shares)

    @property
    def device(self) -> torch.device:
        return self.shares.device

    def map_shares(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """Apply a share-local (linear / structural) transform to all shares."""
        return type(self)(fn(self.shares))

    def reshape(self, *shape):
        """Local re-layout of every share to ``shape``."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.map_shares(lambda s: s.reshape((3,) + tuple(shape)))

    def take(self, indices: torch.Tensor, axis: int = 0):
        return self.map_shares(lambda s: s.index_select(axis + 1, indices))

    @classmethod
    def concat(cls, parts: Sequence["_ShareBase"], axis: int = 0):
        return cls(torch.cat([p.shares for p in parts], dim=axis + 1))

    @classmethod
    def stack(cls, parts: Sequence["_ShareBase"], axis: int = 0):
        return cls(torch.stack([p.shares for p in parts], dim=axis + 1))

    def pad_rows(self, n_rows: int):
        """Pad axis 0 (rows) up to ``n_rows`` with zero shares (a valid
        sharing of 0; callers pair this with a shared valid column)."""
        cur = self.shape[0]
        if n_rows == cur:
            return self
        pad = torch.zeros(
            (3, n_rows - cur) + self.shape[1:], dtype=self.shares.dtype, device=self.device
        )
        return self.map_shares(lambda s: torch.cat([s, pad], dim=1))


class AShare(_ShareBase):
    """Additive replicated sharing: value = s0 + s1 + s2 mod 2^k."""

    def __add__(self, other):
        if isinstance(other, AShare):
            return AShare(self.shares + other.shares)
        return self.add_public(other)

    def __sub__(self, other):
        if isinstance(other, AShare):
            return AShare(self.shares - other.shares)
        c = _as_ring(other, self.device, self.ring)
        return self.add_public(self.ring.word(-c) if isinstance(c, int) else -c)

    def __neg__(self):
        return AShare(-self.shares)

    def add_public(self, c) -> "AShare":
        """Add a public constant: by convention share 0 absorbs it."""
        out = self.shares.clone()
        out[0] += _as_ring(c, self.device, self.ring)
        return AShare(out)

    def mul_public(self, c) -> "AShare":
        return AShare(self.shares * _as_ring(c, self.device, self.ring))

    def sum(self, axis=0) -> "AShare":
        """Local reduction (additions are free under additive sharing; an
        int64 sum wraps mod 2^64)."""
        dtype = self.shares.dtype
        return AShare(torch.sum(self.shares, dim=axis + 1, dtype=torch.int64).to(dtype))

    def cumsum(self, axis=0) -> "AShare":
        return AShare(torch.cumsum(self.shares, dim=axis + 1).to(self.shares.dtype))


class BShare(_ShareBase):
    """XOR replicated sharing over k-bit words: value = s0 ^ s1 ^ s2."""

    def __xor__(self, other):
        if isinstance(other, BShare):
            return BShare(self.shares ^ other.shares)
        return self.xor_public(other)

    def xor_public(self, c) -> "BShare":
        out = self.shares.clone()
        out[0] ^= _as_ring(c, self.device, self.ring)
        return BShare(out)

    def __invert__(self) -> "BShare":
        return self.xor_public(self.ring.mask)

    def __lshift__(self, n: int) -> "BShare":
        return BShare(self.shares << n)

    def __rshift__(self, n: int) -> "BShare":
        """Logical shift of each share (the unsigned ring's ``>>``)."""
        return BShare(srl(self.shares, n))

    def and_public(self, c) -> "BShare":
        return BShare(self.shares & _as_ring(c, self.device, self.ring))

    def lsb_mask(self) -> "BShare":
        """Replicate the LSB of each lane across all k bit positions (local:
        each share's LSB extends independently)."""
        return BShare(-(self.shares & 1))


# -----------------------------------------------------------------------------
# Share / reveal
# -----------------------------------------------------------------------------


# pytree nodes: the engine's batched pass stacks and vmaps tables leaf by leaf
pytree.register_dataclass(AShare)
pytree.register_dataclass(BShare)

def _share_legs(x, key: torch.Tensor, device, ring: Ring) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    # the two random legs are 32-bit draws, zero-extended on ring-64 as the
    # reference draws them: their high halves are zero
    x = from_numpy(x, device, ring)
    k0, k1 = threefry.split(key)
    shape = tuple(x.shape)
    return x, widen(threefry.bits(k0, shape, device), ring), widen(threefry.bits(k1, shape, device), ring)


def share_a(x, key: torch.Tensor, device, ring: Ring = RING32) -> AShare:
    """Data-owner arithmetic sharing of plaintext ``x`` (numpy, wrapped into
    ``ring``)."""
    x, s0, s1 = _share_legs(x, key, device, ring)
    return AShare(torch.stack([s0, s1, x - s0 - s1]))


def share_b(x, key: torch.Tensor, device, ring: Ring = RING32) -> BShare:
    """Data-owner boolean (XOR) sharing of plaintext ``x`` (numpy, wrapped
    into ``ring``)."""
    x, s0, s1 = _share_legs(x, key, device, ring)
    return BShare(torch.stack([s0, s1, x ^ s0 ^ s1]))


def reveal_a(x: AShare) -> torch.Tensor:
    """Open an arithmetic sharing (1 round; each party sends one share)."""
    log_comm("reveal", 1, x.size * x.ring.bytes, payload=x.shares)
    return x.shares[0] + x.shares[1] + x.shares[2]


def reveal_b(x: BShare) -> torch.Tensor:
    log_comm("reveal", 1, x.size * x.ring.bytes, payload=x.shares)
    return x.shares[0] ^ x.shares[1] ^ x.shares[2]


# -----------------------------------------------------------------------------
# Multiplication / AND — the only interactive gates (1 round each)
# -----------------------------------------------------------------------------

def _gate(x: _ShareBase, y: _ShareBase, prf: PRFSetup, boolean: bool) -> torch.Tensor:
    # broadcast BEFORE the gate: it flattens lanes, so mismatched operand
    # shapes would misalign; alpha is drawn at the broadcast shape
    xs, ys = torch.broadcast_tensors(x.shares, y.shares)
    xs, ys = xs.contiguous(), ys.contiguous()
    alpha = zero_share_unpooled(prf, xs.shape[1:], xs.device, boolean, x.ring)
    return gate(xs, ys, alpha, boolean)


def mul(x: AShare, y: AShare, prf: PRFSetup) -> AShare:
    """Secret x secret multiply: 1 round, one ring element per party per lane
    (local cross terms + PRF zero share, then the resharing hop)."""
    z = _gate(x, y, prf, boolean=False)
    log_comm("mul", 1, x.size * x.ring.bytes, payload=z)
    return AShare(z)


def and_(x: BShare, y: BShare, prf: PRFSetup) -> BShare:
    """Secret AND (bitwise over k-bit lanes): 1 round, k bits per lane/party."""
    z = _gate(x, y, prf, boolean=True)
    log_comm("and", 1, x.size * x.ring.bytes, payload=z)
    return BShare(z)


def or_(x: BShare, y: BShare, prf: PRFSetup) -> BShare:
    """x OR y = ~(~x AND ~y) — one interactive AND."""
    return ~and_(~x, ~y, prf)


def select(cond_mask: BShare, x: BShare, y: BShare, prf: PRFSetup) -> BShare:
    """cond ? x : y, with ``cond_mask`` a full-width mask (see lsb_mask)."""
    return y ^ and_(cond_mask, x ^ y, prf)


def rand_ashare(prf: PRFSetup, shape, device, ring: Ring = RING32) -> AShare:
    """A fresh random arithmetic sharing (no communication)."""
    return AShare(rand_replicated(prf, shape, device, ring))


def rand_bshare(prf: PRFSetup, shape, device, ring: Ring = RING32) -> BShare:
    """A fresh random boolean sharing (no communication)."""
    return BShare(rand_replicated(prf, shape, device, ring))


def zeros_a(shape, device, ring: Ring = RING32) -> AShare:
    return AShare(torch.zeros((3,) + tuple(shape), dtype=ring.dtype, device=device))


def zeros_b(shape, device, ring: Ring = RING32) -> BShare:
    return BShare(torch.zeros((3,) + tuple(shape), dtype=ring.dtype, device=device))


def const_a(value, shape, device, ring: Ring = RING32) -> AShare:
    """Trivial (public-constant) arithmetic sharing of ``value`` (an int,
    numpy array or tensor) broadcast to ``shape``: share 0 carries it."""
    return zeros_a(shape, device, ring).add_public(value)


def const_b(value: torch.Tensor, device) -> BShare:
    """Trivial (public-constant) boolean sharing: share 0 carries it."""
    z = torch.zeros((3,) + tuple(value.shape), dtype=torch.int32, device=device)
    return BShare(z).xor_public(value)
