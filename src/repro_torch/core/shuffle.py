"""Secure multi-party shuffle (MPS) — permutation-composition protocol.

The global permutation is ``pi = pi_2 ∘ pi_1 ∘ pi_0``, ``pi_j`` derived from
pair key ``j`` and so known to exactly two parties; after each hop the third
party receives freshly re-randomized shares. 3 rounds; each hop moves the
whole table once. See ``repro.core.shuffle``: permutations, re-randomization
tags (5000 / 5500 + 17·hop + column) and ledger entries are the same.

Each hop's row gather of a column's three share planes is one
``shuffle_gather`` launch on a CUDA tensor (the plain gather on the CPU).
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..kernels.shuffle_gather import shuffle_gather
from . import threefry
from .ledger import fused_scope, log_comm
from .prf import PRFSetup, zero_share_add, zero_share_xor
from .sharing import AShare, BShare, reveal_b

__all__ = [
    "secure_shuffle",
    "inverse_shuffle",
    "apply_secret_perm",
    "composed_permutation",
    "HOPS",
]

HOPS = 3

Share = Union[AShare, BShare]


def _hop_perm(prf: PRFSetup, hop: int, n: int, device) -> torch.Tensor:
    """Permutation for hop ``hop`` — derived from pair key ``hop``, i.e. known
    to parties hop and hop+1 only."""
    return threefry.permutation(prf.fold(1000 + hop).pair_keys[hop], n, device)


def composed_permutation(prf: PRFSetup, n: int, device) -> torch.Tensor:
    """The (secret) composed permutation — for the simulation's trim-side
    linkage of lazy payload and for tests only."""
    pi = torch.arange(n, dtype=torch.int64, device=device)
    for hop in range(HOPS):
        pi = pi[_hop_perm(prf, hop, n, device)]
    return pi


def _gather_rows(col: Share, perm: torch.Tensor) -> Share:
    """One hop's row move of a column: its (3, N, ...) shares as three
    (N, C) planes gathered by ``perm`` in one kernel launch."""
    s = col.shares
    planes = s.reshape(3, s.shape[1], -1).contiguous()
    return type(col)(shuffle_gather(planes, perm).reshape(s.shape))


def _rerandomize(col: Share, prf: PRFSetup, tag: int) -> Share:
    p = prf.fold(tag)
    if isinstance(col, AShare):
        return AShare(col.shares + zero_share_add(p, col.shape, col.device))
    return BShare(col.shares ^ zero_share_xor(p, col.shape, col.device))


def _row_bytes(cols: Dict[str, Share]) -> int:
    return sum(c.ring.bytes * (c.size // max(c.shape[0], 1)) for c in cols.values())


def secure_shuffle(cols: Dict[str, Share], prf: PRFSetup) -> Dict[str, Share]:
    """Shuffle all columns of a table with one hidden common permutation."""
    if not cols:
        return cols
    first = next(iter(cols.values()))
    n, device = first.shape[0], first.device
    row_bytes = _row_bytes(cols)
    with fused_scope("shuffle", rounds=HOPS):
        out = dict(cols)
        for hop in range(HOPS):
            perm = _hop_perm(prf, hop, n, device)
            out = {
                name: _rerandomize(_gather_rows(col, perm), prf, 5000 + 17 * hop + idx)
                for idx, (name, col) in enumerate(out.items())
            }
            # one resharing hop: the pi_j-ignorant party receives fresh shares
            log_comm("shuffle_hop", 1, n * row_bytes)
    return out


def inverse_shuffle(cols: Dict[str, Share], prf: PRFSetup) -> Dict[str, Share]:
    """Undo ``secure_shuffle(cols, prf)``: the hop permutations inverted, in
    reverse order, with their own re-randomization tags."""
    if not cols:
        return cols
    first = next(iter(cols.values()))
    n, device = first.shape[0], first.device
    row_bytes = _row_bytes(cols)
    with fused_scope("shuffle", rounds=HOPS):
        out = dict(cols)
        for hop in reversed(range(HOPS)):
            perm = torch.argsort(_hop_perm(prf, hop, n, device))
            out = {
                name: _rerandomize(_gather_rows(col, perm), prf, 5500 + 17 * hop + idx)
                for idx, (name, col) in enumerate(out.items())
            }
            log_comm("shuffle_hop", 1, n * row_bytes)
    return out


def apply_secret_perm(cols: Dict[str, Share], pi: BShare, prf: PRFSetup) -> Dict[str, Share]:
    """Gather rows of ``cols`` by a secret-shared permutation: out_i = cols_{pi(i)}.

    Shuffle-and-reveal: shuffle ``pi`` by a hidden sigma, open
    ``r = pi ∘ sigma`` (uniformly random, so it leaks nothing about ``pi``),
    gather the payload by the public ``r``, then inverse-shuffle to peel sigma
    off. Only sound when ``pi`` is a true permutation of 0..n-1.
    """
    shuffled = secure_shuffle({"__pi": pi}, prf)
    r = reveal_b(shuffled["__pi"]).to(torch.int64) & 0xFFFFFFFF
    moved = {name: col.take(r, axis=0) for name, col in cols.items()}
    return inverse_shuffle(moved, prf)
