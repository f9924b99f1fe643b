"""Threefry-2x32 in PyTorch, bit-exact to ``jax.random`` (jax 0.9.0 with
``jax_threefry_partitionable=True``).

Shares, ledgers and the Resizer's revealed sizes all derive from the PRF, so
the port carries its own copy of JAX's generator:

* a key is a ``(2,)`` int32 tensor on the CPU (a raw threefry key, the bit
  pattern of JAX's ``uint32`` key data). Key derivation (``PRNGKey``,
  ``fold_in``, ``split``) hashes a handful of words, so it runs as plain
  Python integer arithmetic and never touches the device;
* draws (``bits``, ``uniform``, ``permutation``, and ``bits_each`` /
  ``uniform_each`` for several keys at once) run on the ``device`` they are
  asked for, with the key's two words entering as scalars — no host to
  device copy, so nothing synchronises the stream. On the card a draw is one
  launch of the ``threefry_bits`` kernel (:mod:`repro_torch.kernels.threefry`)
  for all its keys; on the CPU it runs :func:`_hash` on tensors, the
  kernel's plain version.

The device-key path (``fold_in_dev``, ``split_dev``, ``bits_dev``,
``uniform_dev``, ``permutation_dev``) takes keys as ``(..., 2)`` int32
tensors on any device and hashes them there (folds and splits with tensor
operations, draws with ``threefry_bits`` reading the keys on the card), the
key words broadcast over the leading axes: nothing reads a key on the host,
so a captured CUDA graph whose key tensor is refilled before each replay
draws with the new keys. Both paths give the same words for every key and
tag.

Partitionable layout: element ``i`` of a draw of ``shape`` hashes the 64-bit
counter ``i`` (row-major) split as ``(hi, lo)`` 32-bit words; ``bits`` is the
XOR of the two output words, ``split(key, n)[i]`` is the output pair itself,
and ``fold_in(key, d)`` hashes the single pair ``(0, d)``.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from .ring import MASK32, s32

__all__ = [
    "PRNGKey",
    "fold_in",
    "split",
    "bits",
    "bits_each",
    "uniform",
    "uniform_each",
    "permutation",
    "key_words",
    "make_key",
    "fold_in_dev",
    "split_dev",
    "bits_dev",
    "uniform_dev",
    "permutation_dev",
]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_INT32_MIN = -(1 << 31)

Word = Union[int, torch.Tensor]


def make_key(hi: int, lo: int) -> torch.Tensor:
    return torch.tensor([s32(hi), s32(lo)], dtype=torch.int32)


def key_words(key: torch.Tensor) -> Tuple[int, int]:
    """The two uint32 words of a (2,) key, as Python ints."""
    k = key.tolist()
    return k[0] & MASK32, k[1] & MASK32


def _hash(k1: Word, k2: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32, 20 rounds. Every word is a uint32 Python int or an
    int32 tensor (which wraps mod 2^32 like uint32); tensors broadcast. With
    any tensor among them the result is a pair of tensors."""
    if any(isinstance(w, torch.Tensor) for w in (k1, k2, x0, x1)):

        def add(a, b):
            if isinstance(a, int) and isinstance(b, int):
                return s32(a + b)
            return (s32(a) if isinstance(a, int) else a) + (s32(b) if isinstance(b, int) else b)

        def rotl(x, r):
            return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))

        def xor(a, b):
            return (s32(a) if isinstance(a, int) else a) ^ (s32(b) if isinstance(b, int) else b)

    else:

        def add(a, b):
            return (a + b) & MASK32

        def rotl(x, r):
            return ((x << r) | (x >> (32 - r))) & MASK32

        def xor(a, b):
            return a ^ b

    ks = (k1, k2, xor(xor(k1, k2), _PARITY))
    x0 = add(x0, ks[0])
    x1 = add(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = add(x0, x1)
            x1 = rotl(x1, r) ^ x0
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(x1, add(ks[(i + 2) % 3], i + 1))
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(seed >> 32, seed & mask)``.
    Seeds inside int32's range are 32-bit in JAX, so their high word is 0."""
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & MASK32
    return make_key(hi, seed & MASK32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    k1, k2 = key_words(key)
    return make_key(*_hash(k1, k2, 0, int(data) & MASK32))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (num, 2) keys."""
    k1, k2 = key_words(key)
    out = [_hash(k1, k2, 0, i) for i in range(num)]
    return torch.tensor([[s32(a), s32(b)] for a, b in out], dtype=torch.int32).reshape(
        num, 2
    )


def _numel(shape: Tuple[int, ...]) -> int:
    numel = math.prod(shape)
    if numel >= 1 << 31:
        raise ValueError(f"draw of {numel} words exceeds the int32 counter range")
    return numel


def bits_each(keys: torch.Tensor, shape: Tuple[int, ...], device) -> torch.Tensor:
    """:func:`bits` of every key of an ``(R, 2)`` key tensor on the CPU ->
    ``(R, *shape)``: one ``threefry_bits`` launch on the card (the plain
    version on the CPU; an empty tensor on ``meta``, where a draw's shape is
    all there is)."""
    from ..kernels.threefry import draw

    shape = tuple(int(s) for s in shape)
    return draw(keys, _numel(shape), device).reshape((keys.shape[0],) + shape)


def bits(key: torch.Tensor, shape: Tuple[int, ...], device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int32 words on ``device``."""
    return bits_each(key.reshape(1, 2), shape, device)[0]


def _unit_floats(b: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``jax.random.uniform``'s floats from its 32-bit words ``b``: the top
    23 bits become the mantissa of a float in [1, 2), minus one, then
    ``floats * (maxval - minval) + minval``.

    XLA's CPU backend contracts that scaling into a fused multiply-add, so
    it is computed as one here: the float32 product is exact in float64 and
    the sum rounds once there before the float32 cast. (That double rounding
    can differ from a true FMA only when the float64 sum lies exactly on a
    float32 halfway point.) The bounds enter as Python scalars of their
    float32 values (``maxval - minval`` rounded in float32), so no tensor is
    copied from the host."""
    mant = ((b >> 9) & ((1 << 23) - 1)) | 0x3F800000
    floats = mant.view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    scaled = floats.double() * span + lo
    return torch.clamp(scaled.float(), min=lo)


def uniform(
    key: torch.Tensor,
    shape: Tuple[int, ...] = (),
    minval: float = 0.0,
    maxval: float = 1.0,
    device="cpu",
) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` (see
    :func:`_unit_floats`)."""
    return _unit_floats(bits(key, shape, device), minval, maxval)


def uniform_each(keys: torch.Tensor, shape: Tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    """:func:`uniform` in [0, 1) of every key of an ``(R, 2)`` key tensor on
    the CPU -> ``(R, *shape)`` float32."""
    return _unit_floats(bits_each(keys, shape, device), 0.0, 1.0)


def permutation(key: torch.Tensor, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as an int64 index tensor.

    JAX's sort-based shuffle: ``ceil(3 ln n / ln(2^32 - 1))`` rounds, each a
    ``split``, 32-bit sort keys and a *stable* key-value sort (ties among
    32-bit keys are common at millions of rows, and stability decides them).
    Unsigned order on int32 storage is signed order after flipping bit 31.
    """
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = bits(sub, (n,), device) ^ _INT32_MIN
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x


# -----------------------------------------------------------------------------
# The device-key path: keys as (..., 2) int32 tensors, hashed where they lie
# -----------------------------------------------------------------------------


def fold_in_dev(keys: torch.Tensor, data: int) -> torch.Tensor:
    """:func:`fold_in` of every key of a ``(..., 2)`` key tensor, as tensor
    operations on its device."""
    x0, x1 = _hash(keys[..., 0], keys[..., 1], 0, int(data) & MASK32)
    return torch.stack([x0, x1], dim=-1)


def split_dev(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """:func:`split` of a ``(2,)`` key tensor -> ``(num, 2)`` on its device."""
    ctr = torch.arange(num, dtype=torch.int32, device=key.device)
    x0, x1 = _hash(key[0], key[1], torch.zeros_like(ctr), ctr)
    return torch.stack([x0, x1], dim=-1)


def bits_dev(keys: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """:func:`bits` of every key of a ``(..., 2)`` key tensor -> ``(...,
    *shape)`` int32 words on the keys' device."""
    from ..kernels.threefry import draw

    shape = tuple(int(s) for s in shape)
    flat = keys.reshape(-1, 2).contiguous()
    return draw(flat, _numel(shape), keys.device).reshape(tuple(keys.shape[:-1]) + shape)


def uniform_dev(
    keys: torch.Tensor, shape: Tuple[int, ...] = (), minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """:func:`uniform` of every key of a ``(..., 2)`` key tensor."""
    return _unit_floats(bits_dev(keys, shape), minval, maxval)


def permutation_dev(key: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`permutation` of a ``(2,)`` key tensor, on its device."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    for _ in range(rounds):
        key, sub = split_dev(key)
        sort_keys = bits_dev(sub, (n,)) ^ _INT32_MIN
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x
