"""Noise-generation strategies for the Resizer (§4.3).

A strategy answers ``sample_eta(key, N, T)`` (filler count for the
sequential design) and ``sample_p(key, N, T)`` (coin probability for the
parallel design; strategies other than Beta derive p = clip(eta/(N-T), 0, 1)).
Keys are (2,) threefry keys (:mod:`.threefry`). ``TruncatedLaplace`` and
``UniformNoise`` draw through ``threefry.uniform`` and so match
``repro.core.noise`` exactly; ``BetaNoise`` samples its own value (see its
docstring).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import threefry

__all__ = ["NoiseStrategy", "TruncatedLaplace", "BetaNoise", "UniformNoise", "NoTrim"]


def _uniform_scalar(key: torch.Tensor, lo: float, hi: float) -> float:
    return float(threefry.uniform(key, (), minval=lo, maxval=hi))


class NoiseStrategy:
    name: str = "base"

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        raise NotImplementedError

    def sample_p(self, key: torch.Tensor, n: int, t: int) -> float:
        """Success probability for the parallel (Binomial) design."""
        free = max(n - t, 1)
        eta = self.sample_eta(key, n, t)
        return float(np.clip(eta / free, 0.0, 1.0))


@dataclasses.dataclass
class TruncatedLaplace(NoiseStrategy):
    """Lap(mu, b) truncated to [0, inf), b = sensitivity / eps,
    mu = -b * ln(2 * delta) (Shrinkwrap's calibration)."""

    eps: float = 0.5
    delta: float = 0.00005
    sensitivity: float = 1.0
    name: str = "tlap"

    @property
    def b(self) -> float:
        return self.sensitivity / self.eps

    @property
    def mu(self) -> float:
        return -self.b * math.log(2.0 * self.delta)

    def _cdf0(self) -> float:
        return 0.5 * math.exp(-self.mu / self.b)

    def _inv_cdf(self, u: float) -> float:
        if u <= 0.5:
            return self.mu + self.b * math.log(2.0 * u)
        return self.mu - self.b * math.log(2.0 * (1.0 - u))

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        u = _uniform_scalar(key, self._cdf0(), 1.0)
        return int(np.clip(round(self._inv_cdf(u)), 0, max(n - t, 0)))


@dataclasses.dataclass
class BetaNoise(NoiseStrategy):
    """p ~ Beta(alpha, beta) (Beta-Binomial with the parallel design).

    ``repro`` draws p with ``jax.random.beta``, whose rejection sampler is
    not practical to reproduce bit for bit. The port seeds a numpy
    ``Generator`` from 64 bits of the key (``threefry.bits``) and draws
    ``beta(alpha, beta)`` from it: the same distribution and a deterministic
    function of the key, but not the reference's value.
    """

    alpha: float = 2.0
    beta: float = 6.0
    name: str = "beta"

    def sample_p(self, key: torch.Tensor, n: int, t: int) -> float:
        words = threefry.bits(key, (2,), "cpu").tolist()
        seed = ((words[0] & 0xFFFFFFFF) << 32) | (words[1] & 0xFFFFFFFF)
        return float(np.random.default_rng(seed).beta(self.alpha, self.beta))

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        # scaled-Beta variant for the sequential design (§4.3)
        return int(round(self.sample_p(key, n, t) * max(n - t, 0)))


@dataclasses.dataclass
class UniformNoise(NoiseStrategy):
    lo_frac: float = 0.0
    hi_frac: float = 1.0
    name: str = "uniform"

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        free = max(n - t, 0)
        return int(_uniform_scalar(key, self.lo_frac * free, self.hi_frac * free))


@dataclasses.dataclass
class NoTrim(NoiseStrategy):
    """Keep everything: the Resizer degenerates to a no-op (fully oblivious)."""

    name: str = "notrim"

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        return max(n - t, 0)
