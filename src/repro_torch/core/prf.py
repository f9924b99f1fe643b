"""Correlated randomness for 3-party replicated secret sharing.

Each adjacent pair of parties (P_i, P_{i+1}) holds a PRF key ``k_i``; every
use site folds in a fresh counter. From the three keys the parties derive,
without interaction, zero sharings (``alpha_i = F(k_i) - F(k_{i-1})`` or the
XOR form) and replicated random values. See ``repro.core.prf``; the draws
here are bit-identical to it (:mod:`.threefry`).

``pair_keys`` is a (3, 2) int32 tensor on the CPU: key derivation is a few
words of host arithmetic, and only the draws run on the shares' device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import threefry

__all__ = ["PRFSetup", "setup_prf", "zero_share_add", "zero_share_xor", "rand_replicated"]


@dataclasses.dataclass
class PRFSetup:
    """Three pairwise PRF keys: pair_keys[i] is shared by parties i and i+1."""

    pair_keys: torch.Tensor  # (3, 2) int32 raw threefry keys, on the CPU

    def fold(self, tag: int) -> "PRFSetup":
        """Derive fresh per-use keys (the PRF counter)."""
        return PRFSetup(torch.stack([threefry.fold_in(k, tag) for k in self.pair_keys]))

    def draw(self, shape: Tuple[int, ...], device) -> torch.Tensor:
        """F(k_i, .) for each pair key -> (3, *shape) int32 ring words."""
        shape = tuple(shape)
        out = torch.empty((3,) + shape, dtype=torch.int32, device=device)
        for i, k in enumerate(self.pair_keys):
            out[i] = threefry.bits(k, shape, device)
        return out

    def draw_uniform(self, shape: Tuple[int, ...], device) -> torch.Tensor:
        """Per-pair-key uniform [0,1) floats -> (3, *shape) float32."""
        return torch.stack(
            [threefry.uniform(k, tuple(shape), device=device) for k in self.pair_keys]
        )


def setup_prf(key: torch.Tensor) -> PRFSetup:
    """One-time key agreement between the three adjacent party pairs."""
    return PRFSetup(threefry.split(key, 3))


def _zero_share(prf: PRFSetup, shape, device, xor: bool) -> torch.Tensor:
    f = prf.draw(tuple(shape), device)
    g = torch.roll(f, 1, dims=0)
    return f ^ g if xor else f - g


def zero_share_add(prf: PRFSetup, shape, device) -> torch.Tensor:
    """(3, *shape) additive sharing of zero: alpha_i = F(k_i) - F(k_{i-1})."""
    return _zero_share(prf, shape, device, xor=False)


def zero_share_xor(prf: PRFSetup, shape, device) -> torch.Tensor:
    """(3, *shape) XOR sharing of zero: alpha_i = F(k_i) ^ F(k_{i-1})."""
    return _zero_share(prf, shape, device, xor=True)


def rand_replicated(prf: PRFSetup, shape, device) -> torch.Tensor:
    """(3, *shape) canonical shares of a fresh random ring element (no comm)."""
    return prf.draw(tuple(shape), device)
