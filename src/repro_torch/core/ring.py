"""The rings Z_{2^32} and Z_{2^64} on ``int32`` / ``int64`` storage.

PyTorch has no ``+`` or shifts for ``uint32`` / ``uint64`` on the CPU, so ring
words are stored as the signed type of the same width: addition,
subtraction and multiplication wrap mod 2^k exactly as the unsigned ring
does, and XOR / AND / left shift act on the same bit pattern. Right shifts
differ on signed storage and are done here by hand (:func:`srl`, masked); an
unsigned order is the signed order after flipping the top bit (bit 31 or
63, as ``threefry.permutation`` sorts its keys). The storage dtype names
the ring (:func:`ring_of`), as the reference's ``uint32`` / ``uint64`` do.

Public entry and exit points take and return numpy ``uint32`` / ``uint64``
(:func:`from_numpy` / :func:`to_numpy`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Ring",
    "RING32",
    "RING64",
    "MASK32",
    "default_ring",
    "ring_of",
    "ring_named",
    "s32",
    "s64",
    "srl",
    "from_numpy",
    "to_numpy",
]

MASK32 = 0xFFFFFFFF
_SIGN = 1 << 31


@dataclasses.dataclass(frozen=True)
class Ring:
    """Z_{2^bits}, for 32 and 64 bits."""

    bits: int = 32

    @property
    def mask(self) -> int:
        return (1 << self.bits) - 1

    @property
    def bytes(self) -> int:
        return self.bits // 8

    @property
    def dtype(self) -> torch.dtype:
        """The storage dtype: int32 or int64."""
        return torch.int32 if self.bits == 32 else torch.int64

    @property
    def np_dtype(self):
        return np.uint32 if self.bits == 32 else np.uint64

    @property
    def dtype_name(self) -> str:
        """The reference's name of its ring dtype (``uint32`` / ``uint64``)."""
        return "uint32" if self.bits == 32 else "uint64"

    def word(self, value: int) -> int:
        """A Python int wrapped mod 2^bits into the storage type's range."""
        return s32(value) if self.bits == 32 else s64(value)


RING32 = Ring(32)
RING64 = Ring(64)


def default_ring() -> Ring:
    """The ring a sharing takes unless asked for another: ring-32."""
    return RING32


def ring_of(x: torch.Tensor) -> Ring:
    """The ring whose words ``x`` stores (by its dtype, as the reference
    tells ``uint32`` from ``uint64``)."""
    return RING64 if x.dtype == torch.int64 else RING32


def ring_named(name: str) -> Ring:
    """The ring of a reference dtype name (``"uint32"`` / ``"uint64"``)."""
    if name not in ("uint32", "uint64"):
        raise ValueError(f"no ring stores {name!r}")
    return RING64 if name == "uint64" else RING32


def s32(value: int) -> int:
    """A Python int wrapped mod 2^32 into int32's range (the storage value)."""
    value &= MASK32
    return value - (1 << 32) if value & _SIGN else value


def s64(value: int) -> int:
    """A Python int wrapped mod 2^64 into int64's range (the storage value)."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >> 63 else value


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32- or int64-stored ring words."""
    bits = 64 if x.dtype == torch.int64 else 32
    if n == 0:
        return x
    if n >= bits:
        return torch.zeros_like(x)
    return (x >> n) & ((1 << (bits - n)) - 1)


def from_numpy(x, device, ring: Ring = RING32) -> torch.Tensor:
    """numpy (u)int array -> ``ring``'s words on ``device`` (wrapping mod
    2^bits; ``uint64`` is viewed as ``int64``)."""
    arr = np.ascontiguousarray(np.asarray(x).astype(ring.np_dtype))
    signed = np.int32 if ring.bits == 32 else np.int64
    return torch.from_numpy(arr.view(signed)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """Ring words -> numpy ``uint32`` (int32 storage) or ``uint64`` (int64)."""
    arr = x.detach().to("cpu").contiguous().numpy()
    return arr.view(np.uint64 if x.dtype == torch.int64 else np.uint32)
