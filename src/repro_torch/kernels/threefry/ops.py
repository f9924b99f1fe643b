"""threefry_bits: the PRF's draws, every key's words in one launch (CUDA
kernel + plain version).

The reference draws its randomness with ``jax.random.bits``
(``repro/core/prf.py:51``), which XLA lowers to elementwise code; it has no
Pallas kernel. In plain PyTorch a draw is about 150 elementwise operations
(:func:`repro_torch.core.threefry._hash` on tensors), each a launch over the
whole draw, so the draws dominate both the host's launch work and the
card's time in large sorts. The CUDA source is ``kernels/csrc/threefry.cu``,
which notes its operation bound and design.
"""
from __future__ import annotations

import ctypes

import torch

from ...core.threefry import _hash
from .. import check_launch, library, record_launch, require_contiguous

__all__ = ["draw", "draw_plain"]

MAX_HOST_KEYS = 4  # keys one launch takes by value


def draw_plain(keys: torch.Tensor, n: int, device) -> torch.Tensor:
    """The draws in plain PyTorch: row r hashes the counters ``(0, i)``, i
    < n, under key r and XORs the two output words."""
    lo = torch.arange(n, dtype=torch.int32, device=device)
    k = keys.to(device=device)
    b1, b2 = _hash(k[:, :1], k[:, 1:], torch.zeros_like(lo), lo)
    return b1 ^ b2


def draw(keys: torch.Tensor, n: int, device) -> torch.Tensor:
    """``jax.random.bits(key_r, (n,), uint32)`` of every row of ``keys`` ->
    (R, n) int32 words on ``device``.

    ``keys``: (R, 2) int32 raw threefry keys, on the CPU (host keys: their
    words enter the kernel as arguments) or on ``device`` (device keys: the
    kernel reads them there, so a replayed CUDA graph draws with whatever
    they hold then). ``device`` ``cuda`` launches the kernel, ``cpu`` runs
    :func:`draw_plain`, ``meta`` gives an empty tensor of the shape (a draw's
    shape is all there is); any other device raises.
    """
    device = torch.device(device)
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"threefry_bits needs (R, 2) int32 keys, got {tuple(keys.shape)} {keys.dtype}")
    if not 0 <= n < 1 << 31:
        raise ValueError(f"draw of {n} words exceeds the int32 counter range")
    if device.type == "cpu":
        return draw_plain(keys, n, device)
    if device.type == "meta":
        return torch.empty((keys.shape[0], n), dtype=torch.int32, device=device)
    if device.type != "cuda":
        raise ValueError(f"threefry_bits runs on cuda, cpu or meta, not {device}")
    return _launch(keys, n, device)


def _launch(keys: torch.Tensor, n: int, device) -> torch.Tensor:
    """One launch for device keys; one per MAX_HOST_KEYS host keys."""
    out = torch.empty((keys.shape[0], n), dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = library()
    if keys.device.type == "cpu":
        words = keys.flatten().tolist()
        for r0 in range(0, keys.shape[0], MAX_HOST_KEYS):
            chunk = words[2 * r0:2 * (r0 + MAX_HOST_KEYS)]
            err = lib.threefry_bits_launch((ctypes.c_int * len(chunk))(*chunk), len(chunk) // 2, None, n,
                                           out[r0].data_ptr(), stream)
            check_launch("threefry_bits", err)
            record_launch("threefry_bits")
        return out
    if keys.device != out.device:
        raise ValueError(f"threefry_bits keys lie on {keys.device}, the draw on {out.device}")
    require_contiguous("threefry_bits", keys)
    err = lib.threefry_bits_launch(None, keys.shape[0], keys.data_ptr(), n, out.data_ptr(), stream)
    check_launch("threefry_bits", err)
    record_launch("threefry_bits")
    return out
