"""a2b / bit2a: the share conversions in one launch each (CUDA kernels,
plain versions, protocol wrappers).

Replace the Pallas TPU kernels ``repro/kernels/a2b_fused/a2b_fused.py:78``
(``a2b_kernel``) and ``:101`` (``bit2a_kernel``); wrappers ``ops.py:34`` /
``:74``, oracles ``ref.py``. The CUDA source is
``kernels/csrc/a2b_fused.cu``, which notes its byte bound and design.

:func:`a2b_fused` and :func:`bit2a_fused` are what ``core/circuits.py``
calls when fusion is on. Randomness and ledger parity with the gate-by-gate
path are exact, as in ``ks_prefix/ops.py``: ``a2b`` packs its alpha words
per adder as ``[init, lvl0 pg, lvl0 pp, ...]`` from ``prf.fold(31)`` and
``prf.fold(32)`` (init gate ``fold(11)``, level d ``fold(200 + d)``), and
logs the two ``ks_add`` scopes the gate-by-gate path logs; ``bit2a`` draws
additive zero sharings from ``fold(21)`` and ``fold(22)``. Ring-32 (int32)
operands launch the 32-bit builds, ring-64 (int64) ones the 64-bit builds,
counted as ``a2b_fused_u64`` / ``bit2a_fused_u64``.
"""
from __future__ import annotations

from typing import List

import torch

from .. import c_shifts, check_lanes, check_launch, fold_lanes, launch_entry, record_launch, require_contiguous
from ...core.ledger import fused_scope, log_comm
from ...core.prf import PRFSetup, zero_share_unpooled
from ...core.ring import ring_of
from ...core.sharing import AShare, BShare
from ..ks_prefix.ops import ks_prefix_plain, ks_shifts
from ..rss_gate import gate_plain

__all__ = [
    "a2b_plain",
    "bit2a_plain",
    "a2b_kernel",
    "bit2a_kernel",
    "a2b_fused",
    "bit2a_fused",
]


def _trivial_legs(xs: torch.Tensor):
    """The triples (x_0, 0, 0), (0, x_1, 0), (0, 0, x_2) of a (3, N) share
    triple — locally constructible, no communication."""
    legs = []
    for i in range(3):
        leg = torch.zeros_like(xs)
        leg[i] = xs[i]
        legs.append(leg)
    return legs


def _ks_add_plain(x: torch.Tensor, y: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    """One Kogge-Stone adder; ``alphas``: (3, 1 + 2L, N)."""
    g = gate_plain(x, y, alphas[:, 0], True)
    g = ks_prefix_plain(g, x ^ y, alphas[:, 1:], shifts)
    return x ^ y ^ (g << 1)


def a2b_plain(xs: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    """The conversion in plain PyTorch; ``xs``: (3, N) arithmetic shares,
    ``alphas``: (3, 2(1 + 2L), N)."""
    l0, l1, l2 = _trivial_legs(xs)
    words = 1 + 2 * len(shifts)
    s = _ks_add_plain(l0, l1, alphas[:, :words], shifts)
    return _ks_add_plain(s, l2, alphas[:, words:], shifts)


def bit2a_plain(bs: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """The bit injection in plain PyTorch; ``bs``: (3, N) boolean shares
    (LSB used), ``alphas``: (3, 2, N) additive. Wraps mod 2^32 or 2^64."""
    a0, a1, a2 = _trivial_legs(bs & 1)
    t = a0 + a1 - 2 * gate_plain(a0, a1, alphas[:, 0], False)
    return t + a2 - 2 * gate_plain(t, a2, alphas[:, 1], False)


def a2b_kernel(xs: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    """The whole arithmetic -> boolean conversion in one launch.

    ``xs``: (3, N); ``alphas``: (3, 2(1 + 2 len(shifts)), N), all int32
    (ring-32) or all int64 (ring-64); ``shifts``: at most 8 shifts in
    [0, 31] (ring-32) or [0, 63] (ring-64). A CUDA tensor launches the
    kernel (under ``vmap``, once for all slots; N = 0 takes the plain path
    and launches nothing), a CPU tensor runs :func:`a2b_plain`; any other
    device, dtype, shape or layout raises.
    """
    check_lanes("a2b", [xs], alphas, 2 * (1 + 2 * len(shifts)))
    c_shifts(shifts, 8 * xs.element_size())
    if xs.device.type == "cpu":
        return a2b_plain(xs, alphas, shifts)
    return _a2b_op(xs, alphas, [int(d) for d in shifts])


def _a2b_launch(xs: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    n = xs.shape[1]
    if xs.device.type == "cpu" or n == 0:
        return a2b_plain(xs, alphas, shifts)
    require_contiguous("a2b", xs, alphas)
    out = torch.empty_like(xs)
    entry, build = launch_entry("a2b", xs)
    err = entry(
        xs.data_ptr(), alphas.data_ptr(), out.data_ptr(), n, c_shifts(shifts, 8 * xs.element_size()), len(shifts),
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    check_launch("a2b" + build, err)
    record_launch("a2b_fused" + build)
    return out


@torch.library.custom_op("repro_torch::a2b_fused", mutates_args=())
def _a2b_op(xs: torch.Tensor, alphas: torch.Tensor, shifts: List[int]) -> torch.Tensor:
    return _a2b_launch(xs, alphas, shifts)


@_a2b_op.register_fake
def _(xs, alphas, shifts):
    return torch.empty_like(xs)


def _a2b_batch_rule(info, in_dims, xs, alphas, shifts):
    k = info.batch_size
    xs, alphas = (fold_lanes(t, d, k) for t, d in zip((xs, alphas), in_dims[:2]))
    return _a2b_launch(xs, alphas, shifts).unflatten(-1, (k, -1)), 1


_a2b_op.register_vmap(_a2b_batch_rule)


def bit2a_kernel(bs: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """Both dependent ring products of the bit injection in one launch.

    ``bs``: (3, N) (LSB used); ``alphas``: (3, 2, N) additive zero
    sharings. Rings, devices, checks, ``vmap`` and N = 0 as
    :func:`a2b_kernel`; a CPU tensor runs :func:`bit2a_plain`.
    """
    check_lanes("bit2a", [bs], alphas, 2)
    if bs.device.type == "cpu":
        return bit2a_plain(bs, alphas)
    return _bit2a_op(bs, alphas)


def _bit2a_launch(bs: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    n = bs.shape[1]
    if bs.device.type == "cpu" or n == 0:
        return bit2a_plain(bs, alphas)
    require_contiguous("bit2a", bs, alphas)
    out = torch.empty_like(bs)
    entry, build = launch_entry("bit2a", bs)
    err = entry(
        bs.data_ptr(), alphas.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(bs.device).cuda_stream,
    )
    check_launch("bit2a" + build, err)
    record_launch("bit2a_fused" + build)
    return out


@torch.library.custom_op("repro_torch::bit2a_fused", mutates_args=())
def _bit2a_op(bs: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    return _bit2a_launch(bs, alphas)


@_bit2a_op.register_fake
def _(bs, alphas):
    return torch.empty_like(bs)


def _bit2a_batch_rule(info, in_dims, bs, alphas):
    k = info.batch_size
    bs, alphas = (fold_lanes(t, d, k) for t, d in zip((bs, alphas), in_dims))
    return _bit2a_launch(bs, alphas).unflatten(-1, (k, -1)), 1


_bit2a_op.register_vmap(_bit2a_batch_rule)


def _ks_add_alphas(prf: PRFSetup, shape, shifts, out: torch.Tensor) -> None:
    """Fill ``out`` (3, 1 + 2L, lanes) with one adder's alpha words in
    kernel order [init, lvl0 pg, lvl0 pp, ...]: the gate-by-gate ``ks_add``'s
    folds (init gate ``fold(11)``, level d ``fold(200 + d)``)."""
    device, ring = out.device, ring_of(out)
    out[:, 0] = zero_share_unpooled(prf.fold(11), shape, device, True, ring).reshape(3, -1)
    for lvl, d in enumerate(shifts):
        out[:, 1 + 2 * lvl:3 + 2 * lvl] = zero_share_unpooled(
            prf.fold_unpooled(200 + d), (2,) + shape, device, True, ring
        ).reshape(3, 2, -1)


def a2b_fused(x: AShare, prf: PRFSetup, width: int) -> BShare:
    """Arithmetic -> boolean in one launch (the gate-by-gate path takes
    2(1 + L) gate launches): trivial leg sharing and two chained adders."""
    shape, lanes, ring = x.shape, x.size, x.ring
    shifts = ks_shifts(width)
    levels = width.bit_length() - 1  # the ledger's round count, as ks_add's
    words = 1 + 2 * len(shifts)
    alphas = torch.empty((3, 2 * words, lanes), dtype=ring.dtype, device=x.device)
    _ks_add_alphas(prf.fold(31), shape, shifts, alphas[:, :words])
    _ks_add_alphas(prf.fold(32), shape, shifts, alphas[:, words:])
    out = a2b_kernel(x.shares.reshape(3, -1).contiguous(), alphas, shifts)
    # the ledger of the two gate-by-gate ks_add calls
    for _ in range(2):
        with fused_scope("ks_add", rounds=1 + levels):
            log_comm("and", 1, lanes * ring.bytes)
            for _d in shifts:
                log_comm("and", 1, 2 * lanes * ring.bytes)
    return BShare(out.reshape((3,) + shape))


def bit2a_fused(b: BShare, prf: PRFSetup) -> AShare:
    """Both ring products of the bit injection in one launch (the
    gate-by-gate path takes two ``rss_gate`` launches)."""
    shape, lanes, ring = b.shape, b.size, b.ring
    alphas = torch.empty((3, 2, lanes), dtype=ring.dtype, device=b.device)
    alphas[:, 0] = zero_share_unpooled(prf.fold(21), shape, b.device, False, ring).reshape(3, -1)
    alphas[:, 1] = zero_share_unpooled(prf.fold(22), shape, b.device, False, ring).reshape(3, -1)
    out = bit2a_kernel(b.shares.reshape(3, -1).contiguous(), alphas)
    for _ in range(2):
        log_comm("mul", 1, lanes * b.ring.bytes)
    return AShare(out.reshape((3,) + shape))
