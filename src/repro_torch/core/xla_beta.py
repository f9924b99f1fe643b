"""``jax.random.beta(key, a, b)`` for one float32 sample, bit for bit as
jax 0.9.0 computes it on the CPU.

The Resizer's ``BetaNoise`` reveals a size drawn from Beta(alpha, beta), so
the port must draw the very float32 the reference draws. JAX samples Beta
from two log-gamma draws (``_beta``), each a log-space Marsaglia-Tsang loop
(``_gamma_one``, lowered with ``use_vmap=True``) whose normals come from
``sqrt(2) * erf_inv(u)``. Every float32 operation of that path is
reproduced here on the host with XLA CPU's own arithmetic:

* ``log``, ``log1p`` and ``exp`` are XLA's Cephes-style polynomials;
* ``rsqrt`` is the x86 ``rsqrtps`` estimate (the reciprocal square root of
  the bucket midpoint of the top ten mantissa bits, rounded to twelve
  bits) refined by two Newton steps;
* ``erf_inv`` is XLA's float32 expansion (Giles' coefficients);
* a multiply feeding a single add is one fused multiply-add, as LLVM
  contracts it on a CPU with FMA, and results below 2^-126 flush to zero.

Key splits and uniform bits come from :mod:`.threefry`'s hash. Everything
here is scalar Python arithmetic: a float32 operation is computed in
float64, which is exact for a product of two float32 values, and rounded
once (:func:`_fma` rounds to odd first, so its one rounding is exact too).
"""
from __future__ import annotations

import math
import struct
from typing import Tuple

from .ring import MASK32
from .threefry import _hash

__all__ = ["beta", "exp32", "log32", "log1p32", "rsqrt32", "erf_inv32"]

Key = Tuple[int, int]

_PACK_F = struct.Struct("<f")
_PACK_D = struct.Struct("<d")
_PACK_I = struct.Struct("<I")
_PACK_Q = struct.Struct("<q")
_TINY = 2.0**-126


def _f(x: float) -> float:
    """Round to float32, flushing results below 2^-126 to a signed zero."""
    try:
        r = _PACK_F.unpack(_PACK_F.pack(x))[0]
    except OverflowError:  # rounds past the largest float32
        return math.copysign(math.inf, x)
    if r != 0.0 and abs(r) < _TINY:
        return math.copysign(0.0, r)
    return r


def _bits(x: float) -> int:
    return _PACK_I.unpack(_PACK_F.pack(x))[0]


def _from_bits(b: int) -> float:
    return _PACK_F.unpack(_PACK_I.pack(b & MASK32))[0]


def _fma(a: float, b: float, c: float) -> float:
    """float32 fma(a, b, c) with one rounding: the product is exact in
    float64, TwoSum gives the sum's error, and a sum that is inexact is
    rounded to odd before the float32 rounding (which then rounds once)."""
    p = a * b
    s = p + c
    if math.isinf(s) or s != s:
        return _f(s)
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0.0 and not _PACK_Q.unpack(_PACK_D.pack(s))[0] & 1:
        s = math.nextafter(s, math.inf if err > 0 else -math.inf)
    return _f(s)


# ---------------------------------------------------------------------------
# XLA CPU's float32 elementary functions
# ---------------------------------------------------------------------------

_EXP_P = tuple(
    _f(v)
    for v in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
              4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
)
_LOG2EF = _f(1.44269504088896341)
_EXP_C1 = _f(0.693359375)
_EXP_C2 = _f(-2.12194440e-4)


def exp32(x: float) -> float:
    """XLA CPU's float32 ``exp`` (Cephes: n = round(x / ln 2), a degree-5
    polynomial of the remainder, times 2^n; n = -127 gives 0)."""
    if x != x:
        return x
    x = min(max(x, _f(-87.8)), _f(88.8))
    n = float(math.floor(_fma(x, _LOG2EF, 0.5)))
    n = min(max(n, -127.0), 127.0)
    a = _fma(-_EXP_C1, n, x)
    a = _fma(-_EXP_C2, n, a)
    z = _fma(a, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        z = _fma(z, a, p)
    z = _fma(z, _f(a * a), a)
    z = _f(1.0 + z)
    if n == -127.0:
        return 0.0
    return _f(z * 2.0 ** int(n))


_LOG_P = tuple(
    _f(v)
    for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
              -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
              2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
)
_SQRTHF = _f(0.707106781186547524)
_LOG_Q1 = _f(-2.12194440e-4)
_LOG_Q2 = _f(0.693359375)


def log32(x: float) -> float:
    """XLA CPU's float32 ``log`` (Cephes: exponent and mantissa in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial). Subnormals read as 0."""
    if x != x:
        return math.nan
    if abs(x) < _TINY:  # zero, or a subnormal read as zero
        return -math.inf
    if x < 0.0:
        return math.nan
    if math.isinf(x):
        return math.inf
    b = _bits(x)
    e = float((b >> 23) - 0x7F + 1)
    t = _from_bits((b & 0x807FFFFF) | 0x3F000000)  # mantissa in [0.5, 1)
    if t < _SQRTHF:
        e -= 1.0
        t = _f(_f(t - 1.0) + t)
    else:
        t = _f(t - 1.0)
    x2 = _f(t * t)
    x3 = _f(x2 * t)
    p = _LOG_P
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _f(_LOG_Q1 * e))
    t = _f(t - _f(0.5 * x2))
    t = _f(t + y)
    return _fma(_LOG_Q2, e, t)


_LOG1P_DEN = tuple(
    _f(v)
    for v in (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
)
_LOG1P_NUM = tuple(
    _f(v)
    for v in (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
)
_LOG1P_SMALL = _f(0.41421356237309504880)


def _horner(coeffs, x: float) -> float:
    r = 0.0
    for c in coeffs:
        r = _fma(r, x, c)
    return r


def log1p32(x: float) -> float:
    """XLA's float32 ``log1p``: a Cephes rational function below
    sqrt(2) - 1 in magnitude, ``log(1 + x)`` above."""
    if x != x:
        return x
    if abs(x) < _TINY:
        x = math.copysign(0.0, x)
    if abs(x) >= _LOG1P_SMALL:
        return log32(_f(x + 1.0))
    x2 = _f(x * x)
    q = _f(_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x))
    s = _f(_f(x * x2) * q)
    s = _f(_f(-0.5 * x2) + s)
    return _f(x + s)


def _rsqrt_estimate(x: float) -> float:
    """x86 ``rsqrtps`` on a positive normal float32: 1/sqrt of the midpoint
    of the input's bucket (exponent parity and top ten mantissa bits),
    rounded to twelve mantissa bits."""
    b = _bits(x)
    e = (b >> 23) - 127
    par = e & 1
    k = (e - par) // 2
    mid = (1.0 + (((b >> 13) & 1023) + 0.5) / 1024.0) * (2.0 if par else 1.0)
    r = round(8192.0 / math.sqrt(mid)) / 8192.0
    return _f(r * 2.0**-k)


def rsqrt32(x: float) -> float:
    """XLA CPU's float32 ``rsqrt``: the ``rsqrtps`` estimate and two Newton
    steps, y += (-y/2) * (x*y*y - 1). Only positive normals are refined."""
    if not (_TINY <= x < math.inf):
        raise ValueError(f"rsqrt32 takes a positive normal float32, got {x}")
    y = _rsqrt_estimate(x)
    for _ in range(2):
        t = _fma(_f(x * y), y, -1.0)
        y = _fma(_f(y * -0.5), t, y)
    return y


_ERFINV_LT5 = tuple(
    _f(v)
    for v in (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
)
_ERFINV_GE5 = tuple(
    _f(v)
    for v in (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)
)


def erf_inv32(x: float) -> float:
    """XLA's float32 ``erf_inv`` (Giles): w = -log1p(-x*x), then a degree-8
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x."""
    if abs(x) == 1.0:
        return x * math.inf
    w = -log1p32(_f(x * -x))
    if w < 5.0:
        coeffs, w = _ERFINV_LT5, _f(w - 2.5)
    else:
        coeffs, w = _ERFINV_GE5, _f(_f(math.sqrt(w)) - 3.0)
    p = coeffs[0]
    for c in coeffs[1:]:
        p = _fma(p, w, c)
    return _f(p * x)


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

_ONE_THIRD = _f(1.0 / 3.0)
_SQUEEZE = _f(0.0331)
_SQRT2 = _f(math.sqrt(2.0))
_NORMAL_LO = _from_bits(0xBF7FFFFF)  # nextafter(-1, 0) in float32


def _split(key: Key, num: int):
    return [_hash(key[0], key[1], 0, i) for i in range(num)]


def _unit(key: Key) -> float:
    """A uniform float in [0, 1) from the key's 32 random bits."""
    b1, b2 = _hash(key[0], key[1], 0, 0)
    return _from_bits((((b1 ^ b2) & MASK32) >> 9) | 0x3F800000) - 1.0


def _normal(key: Key) -> float:
    u = max(_NORMAL_LO, _f(_unit(key) * 2.0 + _NORMAL_LO))
    return _f(erf_inv32(u) * _SQRT2)


def _loggamma(key: Key, alpha: float) -> float:
    """``_gamma_one(key, alpha, log_space=True)``."""
    boost = alpha >= 1.0
    d = _f((alpha if boost else _f(alpha + 1.0)) - _ONE_THIRD)
    c = _f(_ONE_THIRD * rsqrt32(d))
    key, subkey = _split(key, 2)
    big_x, v_cubed, u = 0.0, 1.0, 2.0
    while u >= _fma(-_f(big_x * big_x), _SQUEEZE, 1.0) and log32(u) >= _f(
        _f(big_x * 0.5) + _f(d * _f(_f(1.0 - v_cubed) + log32(v_cubed)))
    ):
        key, x_key, u_key = _split(key, 3)
        x, v = 0.0, -1.0
        while v <= 0.0:
            x_key, sub = _split(x_key, 2)
            x = _normal(sub)
            v = _fma(x, c, 1.0)
        big_x = _f(x * x)
        v_cubed = _f(_f(v * v) * v)
        u = _unit(u_key)
    log_samples = log1p32(-_unit(subkey))
    if boost or log_samples == 0.0:
        log_boost = 0.0
    else:
        log_boost = _f(log_samples * _f(1.0 / alpha))
    return _f(_f(log32(d) + log32(v_cubed)) + log_boost)


def beta(key: Key, a: float, b: float) -> float:
    """``float(jax.random.beta(key, a, b))`` for a raw threefry key given as
    two uint32 words."""
    a, b = _f(a), _f(b)
    key_a, key_b = _split(key, 2)
    lga = _loggamma(_split(key_a, 1)[0], a)
    lgb = _loggamma(_split(key_b, 1)[0], b)
    top = max(lga, lgb)
    ga = exp32(_f(lga - top))
    gb = exp32(_f(lgb - top))
    return _f(ga / _f(ga + gb))
