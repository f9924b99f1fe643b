"""Correlated randomness for 3-party replicated secret sharing.

Each adjacent pair of parties (P_i, P_{i+1}) holds a PRF key ``k_i``; every
use site folds in a fresh counter. From the three keys the parties derive,
without interaction, zero sharings (``alpha_i = F(k_i) - F(k_{i-1})`` or the
XOR form) and replicated random values. See ``repro.core.prf``; the draws
here are bit-identical to it (:mod:`.threefry`).

``pair_keys`` is a (3, 2) int32 tensor on the CPU: key derivation is a few
words of host arithmetic, and only the draws run on the shares' device.

Folds, draws and zero sharings go through the ambient material source
(:mod:`.material`) when one is installed, with the reference's op names and
args, so a pool keyed by content serves either package. The derivations the
reference makes inside its jitted gate helpers (a gate's zero sharing, the
per-level folds of the equality tree and the Kogge-Stone adder) never reach
its source; their counterparts here (:meth:`PRFSetup.fold_unpooled`,
:func:`zero_share_unpooled`) skip it too.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from . import material, threefry

__all__ = [
    "PRFSetup",
    "setup_prf",
    "zero_share_add",
    "zero_share_xor",
    "zero_share_unpooled",
    "rand_replicated",
]


@dataclasses.dataclass
class PRFSetup:
    """Three pairwise PRF keys: pair_keys[i] is shared by parties i and i+1."""

    pair_keys: torch.Tensor  # (3, 2) int32 raw threefry keys, on the CPU

    def fold(self, tag: int) -> "PRFSetup":
        """Derive fresh per-use keys (the PRF counter)."""
        src = material.active_if_concrete(self.pair_keys)
        if src is None:
            return PRFSetup(_fold_keys(self.pair_keys, tag))
        return PRFSetup(
            src.fetch("fold", self.pair_keys, (int(tag),), lambda: _fold_keys(self.pair_keys, tag))
        )

    def fold_unpooled(self, tag: int) -> "PRFSetup":
        """:meth:`fold` without the material source (a circuit level's fold)."""
        return PRFSetup(_fold_keys(self.pair_keys, tag))

    def draw(self, shape: Tuple[int, ...], device) -> torch.Tensor:
        """F(k_i, .) for each pair key -> (3, *shape) int32 ring words."""
        shape = tuple(int(s) for s in shape)
        src = material.active_if_concrete(self.pair_keys)
        if src is None:
            return _draw_bits(self.pair_keys, shape, device)
        return src.fetch(
            "draw", self.pair_keys, (shape, _RING_DTYPE), lambda: _draw_bits(self.pair_keys, shape, device)
        )

    def draw_uniform(self, shape: Tuple[int, ...], device) -> torch.Tensor:
        """Per-pair-key uniform [0,1) floats -> (3, *shape) float32."""
        shape = tuple(int(s) for s in shape)
        src = material.active_if_concrete(self.pair_keys)
        if src is None:
            return _draw_uniform(self.pair_keys, shape, device)
        return src.fetch(
            "uniform", self.pair_keys, (shape,), lambda: _draw_uniform(self.pair_keys, shape, device)
        )


# the reference names the ring's dtype in its draw args: uint32 words
_RING_DTYPE = "uint32"


def _fold_keys(pair_keys: torch.Tensor, tag: int) -> torch.Tensor:
    return torch.stack([threefry.fold_in(k, tag) for k in pair_keys])


def _draw_bits(pair_keys: torch.Tensor, shape: Tuple[int, ...], device) -> torch.Tensor:
    out = torch.empty((3,) + shape, dtype=torch.int32, device=device)
    for i, k in enumerate(pair_keys):
        out[i] = threefry.bits(k, shape, device)
    return out


def _draw_uniform(pair_keys: torch.Tensor, shape: Tuple[int, ...], device) -> torch.Tensor:
    return torch.stack([threefry.uniform(k, shape, device=device) for k in pair_keys])


def setup_prf(key: torch.Tensor) -> PRFSetup:
    """One-time key agreement between the three adjacent party pairs."""
    return PRFSetup(threefry.split(key, 3))


def zero_share_unpooled(prf: PRFSetup, shape, device, xor: bool) -> torch.Tensor:
    """A zero sharing without the material source (a gate's alpha)."""
    f = _draw_bits(prf.pair_keys, tuple(int(s) for s in shape), device)
    g = torch.roll(f, 1, dims=0)
    return f ^ g if xor else f - g


def _zero_share(prf: PRFSetup, shape, device, xor: bool) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    src = material.active_if_concrete(prf.pair_keys)
    if src is None:
        return zero_share_unpooled(prf, shape, device, xor)
    return src.fetch(
        "zero_xor" if xor else "zero_add", prf.pair_keys, (shape, _RING_DTYPE),
        lambda: zero_share_unpooled(prf, shape, device, xor),
    )


def zero_share_add(prf: PRFSetup, shape, device) -> torch.Tensor:
    """(3, *shape) additive sharing of zero: alpha_i = F(k_i) - F(k_{i-1})."""
    return _zero_share(prf, shape, device, xor=False)


def zero_share_xor(prf: PRFSetup, shape, device) -> torch.Tensor:
    """(3, *shape) XOR sharing of zero: alpha_i = F(k_i) ^ F(k_{i-1})."""
    return _zero_share(prf, shape, device, xor=True)


def rand_replicated(prf: PRFSetup, shape, device) -> torch.Tensor:
    """(3, *shape) canonical shares of a fresh random ring element (no comm)."""
    return prf.draw(tuple(shape), device)
