"""State crossing over from the JAX package, as numpy arrays.

The reference hands its share triples and PRF pair keys over as numpy
``uint32`` (ring-64 shares, under ``jax_enable_x64``, as ``uint64``); these
turn them into the port's tensors (int32 or int64 ring words on a device;
keys as (2,) / (3, 2) int32 CPU tensors). Only numpy goes in — this module
imports neither jax nor the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .config import resolve_device
from .core.prf import PRFSetup
from .core.ring import RING32, RING64, from_numpy
from .core.sharing import BShare
from .ops.table import SecretTable

__all__ = ["key_from_numpy", "prf_from_numpy", "tables_from_numpy"]


def key_from_numpy(key) -> torch.Tensor:
    """A raw threefry key (uint32 words) -> the port's int32 CPU tensor."""
    return from_numpy(np.asarray(key, dtype=np.uint32), "cpu")


def prf_from_numpy(pair_keys) -> PRFSetup:
    """(3, 2) uint32 PRF pair keys -> :class:`PRFSetup`."""
    keys = key_from_numpy(pair_keys)
    if tuple(keys.shape) != (3, 2):
        raise ValueError(f"pair keys must be (3, 2), got {tuple(keys.shape)}")
    return PRFSetup(keys)


def tables_from_numpy(
    shares_by_table: Dict[str, Tuple[Dict[str, np.ndarray], np.ndarray]], device=None
) -> Dict[str, SecretTable]:
    """``{table: ({column: (3, n) uint32 XOR shares}, (3, n) valid shares)}``
    -> ``{table: SecretTable}`` on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``). ``uint64`` columns carry over
    as ring-64 shares."""
    device = resolve_device(device)

    def share(s) -> BShare:
        s = np.asarray(s)
        return BShare(from_numpy(s, device, RING64 if s.dtype == np.uint64 else RING32))

    out = {}
    for name, (cols, valid) in shares_by_table.items():
        out[name] = SecretTable({c: share(s) for c, s in cols.items()}, share(valid))
    return out
