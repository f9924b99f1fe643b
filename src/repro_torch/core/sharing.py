"""3-party replicated secret sharing (RSS) over Z_{2^32} in PyTorch.

A secret ``x`` is the canonical share triple ``(s0, s1, s2)`` in a leading
axis of size 3, with ``x = s0 + s1 + s2`` (:class:`AShare`) or
``x = s0 ^ s1 ^ s2`` (:class:`BShare`), as ``repro.core.sharing``. Shares are
int32 tensors (ring words; see :mod:`.ring`). Every protocol runs the same
message pattern as the reference and logs the same ledger entries.

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
from .prf import PRFSetup, zero_share_unpooled
from .ring import RING32, Ring, from_numpy, s32, srl

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
    "const_b",
]


def _as_ring(c, device):
    """A public constant as ring words: a Python int wraps to an int32
    scalar; arrays and tensors become int32 tensors on ``device``."""
    if isinstance(c, int):
        return s32(c)
    if isinstance(c, torch.Tensor):
        return c.to(device=device, dtype=torch.int32)
    return from_numpy(c, device)


@dataclasses.dataclass
class _ShareBase:
    shares: torch.Tensor  # (3, *shape) int32

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
        return RING32

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
            (3, n_rows - cur) + self.shape[1:], dtype=torch.int32, device=self.device
        )
        return self.map_shares(lambda s: torch.cat([s, pad], dim=1))


class AShare(_ShareBase):
    """Additive replicated sharing: value = s0 + s1 + s2 mod 2^32."""

    def __add__(self, other):
        if isinstance(other, AShare):
            return AShare(self.shares + other.shares)
        return self.add_public(other)

    def __sub__(self, other):
        if isinstance(other, AShare):
            return AShare(self.shares - other.shares)
        c = _as_ring(other, self.device)
        return self.add_public(s32(-c) if isinstance(c, int) else -c)

    def __neg__(self):
        return AShare(-self.shares)

    def add_public(self, c) -> "AShare":
        """Add a public constant: by convention share 0 absorbs it."""
        out = self.shares.clone()
        out[0] += _as_ring(c, self.device)
        return AShare(out)

    def mul_public(self, c) -> "AShare":
        return AShare(self.shares * _as_ring(c, self.device))

    def sum(self, axis=0) -> "AShare":
        """Local reduction (additions are free under additive sharing)."""
        return AShare(torch.sum(self.shares, dim=axis + 1, dtype=torch.int64).to(torch.int32))

    def cumsum(self, axis=0) -> "AShare":
        return AShare(torch.cumsum(self.shares, dim=axis + 1).to(torch.int32))


class BShare(_ShareBase):
    """XOR replicated sharing over 32-bit words: value = s0 ^ s1 ^ s2."""

    def __xor__(self, other):
        if isinstance(other, BShare):
            return BShare(self.shares ^ other.shares)
        return self.xor_public(other)

    def xor_public(self, c) -> "BShare":
        out = self.shares.clone()
        out[0] ^= _as_ring(c, self.device)
        return BShare(out)

    def __invert__(self) -> "BShare":
        return self.xor_public(self.ring.mask)

    def __lshift__(self, n: int) -> "BShare":
        return BShare(self.shares << n)

    def __rshift__(self, n: int) -> "BShare":
        """Logical shift of each share (the unsigned ring's ``>>``)."""
        return BShare(srl(self.shares, n))

    def and_public(self, c) -> "BShare":
        return BShare(self.shares & _as_ring(c, self.device))

    def lsb_mask(self) -> "BShare":
        """Replicate the LSB of each lane across all 32 bit positions (local:
        each share's LSB extends independently)."""
        return BShare(-(self.shares & 1))


# -----------------------------------------------------------------------------
# Share / reveal
# -----------------------------------------------------------------------------


# pytree nodes: the engine's batched pass stacks and vmaps tables leaf by leaf
pytree.register_dataclass(AShare)
pytree.register_dataclass(BShare)

def _share_legs(x, key: torch.Tensor, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x = from_numpy(x, device)
    k0, k1 = threefry.split(key)
    return x, threefry.bits(k0, tuple(x.shape), device), threefry.bits(k1, tuple(x.shape), device)


def share_a(x, key: torch.Tensor, device) -> AShare:
    """Data-owner arithmetic sharing of plaintext ``x`` (numpy, uint32)."""
    x, s0, s1 = _share_legs(x, key, device)
    return AShare(torch.stack([s0, s1, x - s0 - s1]))


def share_b(x, key: torch.Tensor, device) -> BShare:
    """Data-owner boolean (XOR) sharing of plaintext ``x`` (numpy, uint32)."""
    x, s0, s1 = _share_legs(x, key, device)
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
    alpha = zero_share_unpooled(prf, xs.shape[1:], xs.device, xor=boolean)
    return gate(xs, ys, alpha, boolean)


def mul(x: AShare, y: AShare, prf: PRFSetup) -> AShare:
    """Secret x secret multiply: 1 round, one ring element per party per lane
    (local cross terms + PRF zero share, then the resharing hop)."""
    z = _gate(x, y, prf, boolean=False)
    log_comm("mul", 1, x.size * x.ring.bytes, payload=z)
    return AShare(z)


def and_(x: BShare, y: BShare, prf: PRFSetup) -> BShare:
    """Secret AND (bitwise over 32-bit lanes): 1 round, 32 bits per lane/party."""
    z = _gate(x, y, prf, boolean=True)
    log_comm("and", 1, x.size * x.ring.bytes, payload=z)
    return BShare(z)


def or_(x: BShare, y: BShare, prf: PRFSetup) -> BShare:
    """x OR y = ~(~x AND ~y) — one interactive AND."""
    return ~and_(~x, ~y, prf)


def select(cond_mask: BShare, x: BShare, y: BShare, prf: PRFSetup) -> BShare:
    """cond ? x : y, with ``cond_mask`` a full-width mask (see lsb_mask)."""
    return y ^ and_(cond_mask, x ^ y, prf)


def const_b(value: torch.Tensor, device) -> BShare:
    """Trivial (public-constant) boolean sharing: share 0 carries it."""
    z = torch.zeros((3,) + tuple(value.shape), dtype=torch.int32, device=device)
    return BShare(z).xor_public(value)
