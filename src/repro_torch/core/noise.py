"""Noise-generation strategies for the Resizer (§4.3).

A strategy answers ``sample_eta(key, N, T)`` (filler count for the
sequential design) and ``sample_p(key, N, T)`` (coin probability for the
parallel design; strategies other than Beta derive p = clip(eta/(N-T), 0, 1)),
and gives the moments of eta (``mean``, ``var``, ``var_parallel``) that the
cost model reads. Keys are (2,) threefry keys (:mod:`.threefry`).
``TruncatedLaplace`` and ``UniformNoise`` draw through ``threefry.uniform``
and ``BetaNoise`` through :mod:`.xla_beta` (JAX's Beta sampler with XLA
CPU's float32 arithmetic), so all three match ``repro.core.noise`` exactly.
The moments are host math, equal to the reference's float for float.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import threefry, xla_beta

__all__ = [
    "NoiseStrategy",
    "TruncatedLaplace",
    "BetaNoise",
    "UniformNoise",
    "ConstantNoise",
    "RevealNoise",
    "NoTrim",
]


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

    def mean(self, n: int, t: int) -> float:
        raise NotImplementedError

    def var(self, n: int, t: int) -> float:
        raise NotImplementedError

    def var_parallel(self, n: int, t: int) -> float:
        """Var(S) under the parallel coin-toss design, S = T + Binomial(N - T,
        eta/(N - T)): E[eta] - E[eta^2]/(N - T) + Var(eta)."""
        free = max(n - t, 1)
        m, v = self.mean(n, t), self.var(n, t)
        e2 = v + m * m
        return max(m - e2 / free + v, 0.0)


@dataclasses.dataclass
class TruncatedLaplace(NoiseStrategy):
    """Lap(mu, b) truncated to [0, inf), b = sensitivity / eps,
    mu = -b * ln(2 * delta) (Shrinkwrap's calibration)."""

    eps: float = 0.5
    delta: float = 0.00005
    sensitivity: float = 1.0
    name: str = "tlap"
    # the grid integration runs once per instance (the cost model asks often)
    _moments_cache: Optional[Tuple[float, float]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

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

    def _moments(self) -> Tuple[float, float]:
        """Mean and variance of the truncated distribution (trapezoid rule
        on the reference's 200,001-point grid)."""
        if self._moments_cache is None:
            xs = np.linspace(0.0, self.mu + 40.0 * self.b, 200001)
            pdf = np.exp(-np.abs(xs - self.mu) / self.b) / (2.0 * self.b)
            pdf /= np.trapezoid(pdf, xs)
            m = float(np.trapezoid(xs * pdf, xs))
            v = float(np.trapezoid((xs - m) ** 2 * pdf, xs))
            self._moments_cache = (m, v)
        return self._moments_cache

    def mean(self, n: int, t: int) -> float:
        return self._moments()[0]

    def var(self, n: int, t: int) -> float:
        return self._moments()[1]


@dataclasses.dataclass
class BetaNoise(NoiseStrategy):
    """p ~ Beta(alpha, beta) (Beta-Binomial with the parallel design),
    drawn as ``jax.random.beta(key, alpha, beta)`` draws it (:mod:`.xla_beta`)."""

    alpha: float = 2.0
    beta: float = 6.0
    name: str = "beta"

    def sample_p(self, key: torch.Tensor, n: int, t: int) -> float:
        return xla_beta.beta(threefry.key_words(key), self.alpha, self.beta)

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        # scaled-Beta variant for the sequential design (§4.3)
        return int(round(self.sample_p(key, n, t) * max(n - t, 0)))

    def mean(self, n: int, t: int) -> float:
        return self.alpha / (self.alpha + self.beta) * max(n - t, 0)

    def var(self, n: int, t: int) -> float:
        a, b = self.alpha, self.beta
        free = max(n - t, 0)
        return a * b / ((a + b) ** 2 * (a + b + 1)) * free**2

    def var_parallel(self, n: int, t: int) -> float:
        # Beta-Binomial(N - T, alpha, beta) in closed form
        a, b, free = self.alpha, self.beta, max(n - t, 0)
        if free == 0:
            return 0.0
        return free * a * b * (a + b + free) / ((a + b) ** 2 * (a + b + 1))


@dataclasses.dataclass
class UniformNoise(NoiseStrategy):
    lo_frac: float = 0.0
    hi_frac: float = 1.0
    name: str = "uniform"

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        free = max(n - t, 0)
        return int(_uniform_scalar(key, self.lo_frac * free, self.hi_frac * free))

    def mean(self, n: int, t: int) -> float:
        return 0.5 * (self.lo_frac + self.hi_frac) * max(n - t, 0)

    def var(self, n: int, t: int) -> float:
        return ((self.hi_frac - self.lo_frac) * max(n - t, 0)) ** 2 / 12.0


@dataclasses.dataclass
class ConstantNoise(NoiseStrategy):
    """Deterministic filler count, a fraction of N (zero variance)."""

    frac: float = 0.1
    name: str = "const"

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        return int(np.clip(round(self.frac * n), 0, max(n - t, 0)))

    def mean(self, n: int, t: int) -> float:
        return min(self.frac * n, max(n - t, 0))

    def var(self, n: int, t: int) -> float:
        return 0.0


@dataclasses.dataclass
class RevealNoise(NoiseStrategy):
    """eta = 0: trim away every filler (SecretFlow-SCQL's disclosure)."""

    name: str = "reveal"

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        return 0

    def mean(self, n: int, t: int) -> float:
        return 0.0

    def var(self, n: int, t: int) -> float:
        return 0.0


@dataclasses.dataclass
class NoTrim(NoiseStrategy):
    """Keep everything: the Resizer degenerates to a no-op (fully oblivious)."""

    name: str = "notrim"

    def sample_eta(self, key: torch.Tensor, n: int, t: int) -> int:
        return max(n - t, 0)

    def mean(self, n: int, t: int) -> float:
        return max(n - t, 0)

    def var(self, n: int, t: int) -> float:
        return 0.0
