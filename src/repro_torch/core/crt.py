"""Cardinality Recovery Threshold (CRT), the paper's security metric (§3.3).

CRT is the number r of equivalent repetitions of an operator an attacker
must observe to estimate the true intermediate size T within +-err at
confidence alpha, given observations S_k = T + eta_k with eta_k i.i.d. from
a known distribution:

    r >= z_{alpha/2}^2 * sigma_S^2 / err^2          (Eq. 1)

sigma_S^2 is Var(eta) under sequential addition and, under parallel
addition, E[eta] - E[eta^2]/(N-T) + Var(eta) (the noise strategies'
``var`` / ``var_parallel``). A port of ``repro.core.crt``.

``z_score`` is ``jax.scipy.special.ndtri`` in float32 as jax 0.9.0 computes
it on the CPU, bit for bit: the accountant's budget is ``floor(crt_rounds)``,
so one ulp of z can move a budget by one observation. JAX evaluates the
Cephes rational approximations op by op (each ``jnp`` operation rounds to
float32 on its own), its ``polyval`` is a jitted scan whose multiply-add XLA
contracts into one fused multiply-add, and its ``log`` is XLA CPU's Cephes
polynomial; :mod:`.xla_beta` supplies those float32 primitives.
``torch.special.ndtri`` and scipy's float64 ``ndtri`` rounded to float32
give other values at some confidences (0.95, 0.99, 0.8), so neither is used.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from . import threefry
from .noise import NoiseStrategy
from .xla_beta import _f, _fma, log32

__all__ = ["z_score", "crt_rounds", "sigma_s2", "attacker_estimate", "ndtri32"]

# Cephes ndtri coefficients (as jax.scipy.special's _ndtri), rounded to float32
_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
       1.39312609387279679503E1, -1.23916583867381258016E0)
_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
       -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
       1.59056225126211695515E1, -1.18331621121330003142E0)
_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
       4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
       -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4)
_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
       1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
       -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
       1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
       3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9)
_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
       2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
       2.89247864745380683936E-6, 6.79019408009981274425E-9)
_P0, _Q0, _P1, _Q1, _P2, _Q2 = (tuple(_f(c) for c in cs) for cs in (_P0, _Q0, _P1, _Q1, _P2, _Q2))
_EXP_M2 = _f(math.exp(-2.0))
_ONE_MINUS_EXP_M2 = _f(1.0 - math.exp(-2.0))
_NEG_EXPM1_M2 = _f(-math.expm1(-2.0))
_NEG_SQRT_2PI = _f(-math.sqrt(2.0 * math.pi))


def _polyval(coeffs, x: float) -> float:
    """``jnp.polyval`` in float32: Horner steps ``y * x + c``, each one fused
    multiply-add."""
    y = 0.0
    for c in coeffs:
        y = _fma(y, x, c)
    return y


def ndtri32(p: float) -> float:
    """``jax.scipy.special.ndtri(p)`` for a float32 ``p``, as a Python float.
    Every branch is evaluated, as ``jnp.where`` evaluates them."""
    p = _f(p)
    mcp = _f(1.0 - p) if p > _NEG_EXPM1_M2 else p
    if mcp == 0.0:
        mcp = 0.5
    # p > exp(-2): x / sqrt(2 pi) = w + w^3 P0(w^2) / Q0(w^2)
    w = _f(mcp - 0.5)
    ww = _f(w * w)
    ratio = _f(_polyval(_P0, ww) / _polyval(_Q0, ww))
    big = _f(_f(w + _f(_f(w * ww) * ratio)) * _NEG_SQRT_2PI)
    # p <= exp(-2): x = z - log(z)/z - (1/z) P(1/z) / Q(1/z), z = sqrt(-2 log p)
    z = _f(math.sqrt(_f(-2.0 * log32(mcp))))
    first = _f(z - _f(log32(z) / z))
    iz = _f(1.0 / z)
    if mcp > _EXP_M2:
        x = big
    elif z >= 8.0:
        x = _f(first - _f(_f(_polyval(_P2, iz) / _polyval(_Q2, iz)) / z))
    else:
        x = _f(first - _f(_f(_polyval(_P1, iz) / _polyval(_Q1, iz)) / z))
    if not p > _ONE_MINUS_EXP_M2:
        x = -x
    if p == 0.0:
        return -math.inf
    if p == 1.0:
        return math.inf
    return x


def z_score(confidence: float = 0.999) -> float:
    """Two-sided z for the given confidence level (e.g. 0.999 -> 3.291):
    ``ndtri(0.5 + confidence / 2)`` in float32, as the reference computes it."""
    return float(ndtri32(0.5 + confidence / 2.0))


def sigma_s2(noise: NoiseStrategy, addition: str, n: int, t: int) -> float:
    if addition == "sequential":
        return noise.var(n, t)
    if addition == "parallel":
        return noise.var_parallel(n, t)
    raise ValueError(addition)


def crt_rounds(
    noise: NoiseStrategy,
    addition: str,
    n: int,
    t: int,
    err: float = 1.0,
    confidence: float = 0.999,
) -> float:
    """Equation (1). err=1 reproduces the paper's 21.66 * sigma^2 bound."""
    z = z_score(confidence)
    return max(z * z * sigma_s2(noise, addition, n, t) / (err * err), 1.0)


def attacker_estimate(
    noise: NoiseStrategy,
    addition: str,
    n: int,
    t: int,
    rounds: int,
    key: torch.Tensor,
) -> Dict[str, float]:
    """Monte-Carlo §3.3 attacker: observe ``rounds`` noisy sizes, average, and
    subtract the (known) noise mean. Returns the estimate and its error.
    ``key`` is a (2,) threefry key; the parallel design's binomial is drawn
    by numpy seeded with the key's one uint32 ``bits`` word, as in the
    reference."""
    keys = threefry.split(key, rounds)
    obs = np.empty(rounds)
    for i, k in enumerate(keys):
        if addition == "sequential":
            eta = noise.sample_eta(k, n, t)
            obs[i] = t + min(eta, n - t)
        else:
            p = noise.sample_p(k, n, t)
            seed = int(threefry.bits(k, (), "cpu")) & 0xFFFFFFFF
            draw = np.random.default_rng(seed)
            obs[i] = t + draw.binomial(max(n - t, 0), min(max(p, 0.0), 1.0))
    t_hat = obs.mean() - noise.mean(n, t)  # E[Binomial] = E[eta] for both designs
    return {
        "t_hat": float(t_hat),
        "abs_err": float(abs(t_hat - t)),
        "mean_s": float(obs.mean()),
        "sigma_s_emp": float(obs.std(ddof=1)) if rounds > 1 else 0.0,
    }
