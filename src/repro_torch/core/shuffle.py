"""Secure multi-party shuffle (MPS) — permutation-composition protocol.

The global permutation is ``pi = pi_2 ∘ pi_1 ∘ pi_0``, ``pi_j`` derived from
pair key ``j`` and so known to exactly two parties; after each hop the third
party receives freshly re-randomized shares. 3 rounds; each hop moves the
whole table once. See ``repro.core.shuffle``: permutations, re-randomization
tags (5000 / 5500 + 17·hop + column) and ledger entries are the same.

Each hop moves every column's three share planes by one index in one
``gather_hop`` call (on a CUDA tensor one launch, or with a plane above
22 MiB a plan and two passes; the plain gather on the CPU); each column is
then re-randomized with its own tag. The inverse hop's index is the hop
permutation inverted by a scatter.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from ..kernels.shuffle_gather import gather_hop
from . import material, threefry
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
    sub = prf.fold(1000 + hop)

    def compute() -> torch.Tensor:
        if sub.device_keys:
            return threefry.permutation_dev(sub.pair_keys[hop], n)
        return threefry.permutation(sub.pair_keys[hop], n, device)

    src = material.active_if_concrete(sub.pair_keys)
    if src is None:
        return compute()
    return src.fetch("perm", sub.pair_keys, (int(hop), int(n)), compute)


def composed_permutation(prf: PRFSetup, n: int, device) -> torch.Tensor:
    """The (secret) composed permutation — for the simulation's trim-side
    linkage of lazy payload and for tests only."""
    pi = torch.arange(n, dtype=torch.int64, device=device)
    for hop in range(HOPS):
        pi = pi[_hop_perm(prf, hop, n, device)]
    return pi


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation, by one scatter: ``inv[perm] = arange``
    (the same as ``argsort(perm)``, without the sort)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


def _hop(cols: Dict[str, Share], perm: torch.Tensor, prf: PRFSetup, tag: int) -> Dict[str, Share]:
    """One hop of a table: every column's (3, N, ...) shares as (3, N, W)
    planes, gathered by ``perm`` in one ``gather_hop`` call, then column i
    re-randomized with tag ``tag + i``. Each gathered column is dropped as
    soon as its re-randomized copy exists."""
    planes = [c.shares.reshape(3, c.shares.shape[1], -1) for c in cols.values()]
    moved = gather_hop(planes, perm)
    out = {}
    for idx, (name, c) in enumerate(cols.items()):
        out[name] = _rerandomize(type(c)(moved[idx].reshape(c.shares.shape)), prf, tag + idx)
        moved[idx] = None
    return out


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
            out = _hop(out, _hop_perm(prf, hop, n, device), prf, 5000 + 17 * hop)
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
            out = _hop(out, _inverse(_hop_perm(prf, hop, n, device)), prf, 5500 + 17 * hop)
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
