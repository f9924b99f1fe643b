"""The ring Z_{2^32} on ``int32`` storage.

PyTorch has no ``+`` or shifts for ``uint32`` on the CPU, so ring words are
stored as ``int32``: addition, subtraction and multiplication wrap mod 2^32
exactly as the unsigned ring does, and XOR / AND / left shift act on the same
bit pattern. Right shifts differ on signed storage and are done here by hand
(:func:`srl`, masked); an unsigned order is the signed order after flipping
bit 31 (as ``threefry.permutation`` sorts its keys).

Public entry and exit points take and return numpy ``uint32``
(:func:`from_numpy` / :func:`to_numpy`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Ring",
    "RING32",
    "MASK32",
    "s32",
    "srl",
    "from_numpy",
    "to_numpy",
]

MASK32 = 0xFFFFFFFF
_SIGN = 1 << 31


@dataclasses.dataclass(frozen=True)
class Ring:
    """Z_{2^bits}; only ring-32 is ported."""

    bits: int = 32

    @property
    def mask(self) -> int:
        return (1 << self.bits) - 1

    @property
    def bytes(self) -> int:
        return self.bits // 8


RING32 = Ring(32)


def s32(value: int) -> int:
    """A Python int wrapped mod 2^32 into int32's range (the storage value)."""
    value &= MASK32
    return value - (1 << 32) if value & _SIGN else value


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32-stored ring words."""
    if n == 0:
        return x
    if n >= 32:
        return torch.zeros_like(x)
    return (x >> n) & ((1 << (32 - n)) - 1)


def from_numpy(x, device) -> torch.Tensor:
    """numpy (u)int array -> int32 ring words on ``device`` (wrapping)."""
    arr = np.ascontiguousarray(np.asarray(x).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """int32 ring words -> numpy uint32 on the host."""
    return x.detach().to("cpu").contiguous().numpy().view(np.uint32)
