"""The Resizer operator (rho) — the paper's core contribution (§4).

Noise generation -> noise addition (mark eta filler tuples in a secret column
k beside the true-tuple column c) -> secure shuffle -> reveal-and-trim (open
k, keep rows with k = 1; the only disclosure is the noisy size S = T + eta).
A port of ``repro.core.resizer``: parallel (coin toss, both coin modes) and
sequential (prefix count + one comparison) addition, bucketing (the
config's multiple, or the engine's ``bucket_fn``), the lazy payload trim,
and Shrinkwrap's sort&cut baseline (``use_sort``).

Lazy payload: :class:`~repro_torch.ops.table.LazyGather` columns (the lazy
join's views) skip the physical shuffle; only the S kept rows are gathered
from the base tables and re-randomized. Their shuffle traffic is still
ledgered (``shuffle_deferred_payload``), as in the reference.

Sort&cut (``ResizerConfig(use_sort=True)``, the paper's Shrinkwrap
baseline): instead of the shuffle, a bitonic sort on the keep bit
(descending) brings the kept rows to the front, so revealing the sorted k
discloses only S. Lazy columns are materialised, the table is padded to a
power of two (pad rows keep = 0), only the keep bit and a row index ride
the network, and the payload moves once by the sorted index; the reveal
and ``info["n"]`` count the padded rows.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.table import LazyGather, SecretTable
from . import threefry
from .circuits import a2b, bit2a, lt_public, or_bit
from .ledger import log_comm
from .noise import NoiseStrategy, NoTrim
from .prf import PRFSetup
from .sharing import AShare, BShare
from .shuffle import HOPS, _rerandomize, composed_permutation, secure_shuffle

__all__ = ["ResizerConfig", "Resizer", "oracle_true_count"]

FP_BITS = 16  # fixed-point fraction bits for the coin toss
FP_ONE = 1 << FP_BITS


def oracle_true_count(table: SecretTable) -> int:
    """Plaintext T — simulation oracle only (the paper's runtime clip
    eta <- min(eta, N - T), and tests); never enters the protocol view."""
    v = table.valid.shares
    return int(((v[0] ^ v[1] ^ v[2]) & 1).sum())


@dataclasses.dataclass
class ResizerConfig:
    noise: NoiseStrategy
    addition: str = "parallel"  # "parallel" | "sequential"
    coin_mode: str = "corrected"  # "corrected" | "paper"
    bucket: int = 1  # round the trimmed size up to a multiple of this
    paper_round_model: bool = False  # ledger sequential Alg.1 as N rounds
    use_sort: bool = False  # Shrinkwrap "sort&cut" baseline: bitonic sort on
    # the keep bit instead of the secure shuffle (O(log^2 N) rounds vs O(1))

    def describe(self) -> str:
        tag = "sortcut" if self.use_sort else self.addition
        return f"rho({self.noise.name},{tag})"


class Resizer:
    """Stateless executor for one Resizer instance; see module docstring."""

    def __init__(self, cfg: ResizerConfig):
        self.cfg = cfg

    def _coins_parallel(self, n: int, p: float, prf: PRFSetup, key: torch.Tensor, device) -> BShare:
        """Secret-shared Bernoulli coins from three private fixed-point
        uniforms (trivial arithmetic sharings; the sum is local), then one
        a2b and one comparison per tuple."""
        draws = threefry.bits(key, (3, n), device) & (FP_ONE - 1)
        legs = torch.zeros((3, 3, n), dtype=torch.int32, device=device)
        for i in range(3):
            legs[i, i] = draws[i]
        total = AShare(legs[0]) + AShare(legs[1]) + AShare(legs[2])
        sum_b = a2b(total, prf.fold(801), width=FP_BITS + 2)
        if self.cfg.coin_mode == "corrected":
            # frac(sum) is uniform on [0,1): an exact Bernoulli(p)
            frac = sum_b.and_public(FP_ONE - 1)
            return lt_public(frac, int(round(p * FP_ONE)), prf.fold(802), width=FP_BITS)
        if self.cfg.coin_mode == "paper":
            # Algorithm 2 verbatim: sum of 3 uniforms vs 3p (Irwin-Hall bias)
            return lt_public(sum_b, int(round(3 * p * FP_ONE)), prf.fold(802), width=FP_BITS + 2)
        raise ValueError(self.cfg.coin_mode)

    def _mark_parallel(self, table: SecretTable, p: float, prf: PRFSetup, key: torch.Tensor) -> BShare:
        coin = self._coins_parallel(table.n, p, prf, key, table.valid.device)
        return or_bit(table.valid, coin, prf.fold(803))

    def _mark_sequential(self, table: SecretTable, eta: int, prf: PRFSetup) -> BShare:
        """Alg. 1 semantics: keep the first eta fillers (by position), via a
        bit2a prefix count and one vectorized comparison against the budget."""
        c = table.valid
        fa = bit2a(c.xor_public(1), prf.fold(811))
        cum_b = a2b(fa.cumsum(axis=0), prf.fold(812))
        within = lt_public(cum_b, eta + 1, prf.fold(813))  # cum <= eta
        k = or_bit(c, within, prf.fold(814))
        if self.cfg.paper_round_model:
            # MP-SPDZ's unbatchable secure counter: N dependent rounds
            log_comm("seq_round_model_extra", table.n, 0)
        return k

    def __call__(
        self,
        table: SecretTable,
        prf: PRFSetup,
        key: torch.Tensor,
        bucket_fn: Optional[Callable[[int], int]] = None,
    ) -> Tuple[SecretTable, Dict]:
        cfg = self.cfg
        n = table.n
        t = oracle_true_count(table)
        if isinstance(cfg.noise, NoTrim):
            return table, {"n": n, "t": t, "s": n, "skipped": True}

        k_noise, _ = threefry.split(key)

        # 1-2. noise generation + addition
        if cfg.addition == "parallel":
            p = cfg.noise.sample_p(k_noise, n, t)
            k_col = self._mark_parallel(table, p, prf, k_noise)
            info_noise = {"p": p}
        elif cfg.addition == "sequential":
            eta = int(np.clip(cfg.noise.sample_eta(k_noise, n, t), 0, max(n - t, 0)))
            k_col = self._mark_sequential(table, eta, prf)
            info_noise = {"eta": eta}
        else:
            raise ValueError(cfg.addition)

        # 3. break linkage: the secure shuffle, or sort&cut's bitonic sort
        #    on the keep bit. BShare-backed lazy (join-view) columns skip the
        #    physical shuffle (their traffic is still ledgered below); sort&cut
        #    materialises them.
        lazy_cols = {
            name: c
            for name, c in table.cols.items()
            if isinstance(c, LazyGather) and isinstance(c.base, BShare) and not cfg.use_sort
        }
        cols = {"__k": k_col, "__valid": table.valid}
        cols.update(
            {name: table.bshare_col(name, prf) for name in table.cols if name not in lazy_cols}
        )
        if cfg.use_sort:
            shuffled, n = _sort_and_cut(cols, prf)
        else:
            shuffled = secure_shuffle(cols, prf.fold(821))
        if lazy_cols:
            lazy_row_bytes = sum(
                c.ring.bytes * (c.size // max(c.shape[0], 1)) for c in lazy_cols.values()
            )
            log_comm("shuffle_deferred_payload", 0, HOPS * n * lazy_row_bytes)
        k_col = shuffled.pop("__k")
        valid = shuffled.pop("__valid")

        # 4. reveal-and-trim: open k (the only disclosure), drop k=0 rows
        k_open = (k_col.shares[0] ^ k_col.shares[1] ^ k_col.shares[2]) & 1
        log_comm("reveal_k", 1, n * k_col.ring.bytes, payload=k_col.shares)
        keep = torch.nonzero(k_open).flatten()
        s = int(keep.shape[0])

        s_padded = s
        if bucket_fn is not None:
            s_padded = max(bucket_fn(s), s)
        elif cfg.bucket > 1:
            s_padded = ((s + cfg.bucket - 1) // cfg.bucket) * cfg.bucket
        s_padded = min(max(s_padded, 1), n)

        out = SecretTable(dict(shuffled), valid).gather_rows(keep)
        if lazy_cols:
            # map the kept (shuffled) positions back through the composed
            # permutation to product rows, gather exactly S rows from each
            # base table, and re-randomize (the payload's resharing)
            orig_rows = composed_permutation(prf.fold(821), n, keep.device)[keep]
            for i, (name, lc) in enumerate(lazy_cols.items()):
                out.cols[name] = _rerandomize(lc.gather(orig_rows), prf.fold(823), 860 + i)
        if s_padded > s:
            out = out.pad_rows(s_padded)

        info = {"n": n, "t": t, "s": s, "s_padded": s_padded, **info_noise}
        return out, info


def _sort_and_cut(cols: Dict[str, BShare], prf: PRFSetup) -> Tuple[Dict[str, BShare], int]:
    """Shrinkwrap's cut order: pad to a power of two (pad rows keep = 0,
    valid = 0), then sort descending on the keep bit, so the kept rows come
    first; only the keep bit and a row index ride the network, the payload
    moves once after it. Returns the sorted columns and the padded rows."""
    from ..ops.groupby import pad_pow2
    from .sort import bitonic_sort_narrow

    payload = {name: c for name, c in cols.items() if name not in ("__k", "__valid")}
    padded = pad_pow2(SecretTable(payload, cols["__valid"]))
    sorted_cols = {"__k": cols["__k"].pad_rows(padded.n), "__valid": padded.valid}
    sorted_cols.update(padded.cols)
    return bitonic_sort_narrow(sorted_cols, "__k", prf.fold(821), descending=True), padded.n
