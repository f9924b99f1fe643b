"""ks_prefix / and_fold: a whole Kogge-Stone prefix, and the equality AND
tree, in one launch each (CUDA kernels, plain versions, protocol wrappers).

Replace the Pallas TPU kernels ``repro/kernels/ks_prefix/ks_prefix.py:83``
(``ks_prefix``) and ``:111`` (``and_fold``); wrappers ``ops.py:42`` /
``:78``, oracles ``ref.py``. The CUDA source is ``kernels/csrc/ks_prefix.cu``
(with the level loop in ``ks_levels.cuh``), which notes its byte bound and
design.

:func:`ks_levels_fused` and :func:`and_fold_fused` are what
``core/circuits.py`` calls when fusion is on. They own what the raw kernels
do not, as the reference's wrappers do:

* randomness parity — each level's zero sharing comes from the same PRF fold
  as on the gate-by-gate path (``prf.fold(fold_base + d)`` at ``(2,) +
  lane_shape`` for the two ANDs of a Kogge-Stone level, ``prf.fold(d)`` for
  a fold level), so both paths give the same shares;
* ledger parity — each level logs the ``("and", 1 round, bytes)`` entry the
  gate-by-gate ``and_`` would have logged;
* shape plumbing — lanes of any shape are flattened in order (``reshape(3,
  -1)``), with no padding: the kernel masks its own tail.

Ring-32 (int32) operands launch the 32-bit builds, ring-64 (int64) ones the
64-bit builds (shifts up to 63, six levels at width 64), counted as
``ks_prefix_u64`` / ``and_fold_u64``.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .. import c_shifts, check_lanes, check_launch, fold_lanes, launch_entry, record_launch, require_contiguous
from ...core.ledger import log_comm
from ...core.prf import PRFSetup, zero_share_unpooled
from ...core.ring import srl
from ...core.sharing import BShare
from ..rss_gate import gate_plain

__all__ = [
    "ks_shifts",
    "fold_shifts",
    "ks_prefix_plain",
    "and_fold_plain",
    "ks_prefix",
    "and_fold",
    "ks_levels_fused",
    "and_fold_fused",
]


def ks_shifts(width: int) -> Tuple[int, ...]:
    """Doubling shifts of the Kogge-Stone loop (d = 1, 2, ... < width), as
    ``circuits._ks_levels`` runs them, also for widths that are not a power
    of two (18 -> 1, 2, 4, 8, 16)."""
    shifts = []
    d = 1
    while d < width:
        shifts.append(d)
        d *= 2
    return tuple(shifts)


def fold_shifts(width: int) -> Tuple[int, ...]:
    """Halving shifts of the equality AND tree (d = width // 2, ..., 1), as
    ``circuits._and_reduce_bits`` runs them (18 -> 9, 4, 2, 1)."""
    shifts = []
    d = width // 2
    while d >= 1:
        shifts.append(d)
        d //= 2
    return tuple(shifts)


def ks_prefix_plain(g: torch.Tensor, p: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    """All Kogge-Stone levels in plain PyTorch; ``g``, ``p``: (3, N),
    ``alphas``: (3, 2L, N). Returns the final ``g``."""
    for lvl, d in enumerate(shifts):
        pg = gate_plain(p, g << d, alphas[:, 2 * lvl], True)
        pp = gate_plain(p, p << d, alphas[:, 2 * lvl + 1], True)
        g = g ^ pg
        p = pp
    return g


def and_fold_plain(v: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    """The equality AND tree in plain PyTorch; ``v``: (3, N), ``alphas``:
    (3, L, N). ``>>`` is the ring's logical shift. The conjunction lands in
    the LSB; the caller masks it."""
    for lvl, d in enumerate(shifts):
        v = gate_plain(v, srl(v, d), alphas[:, lvl], True)
    return v


def ks_prefix(g: torch.Tensor, p: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    """Every Kogge-Stone level in one launch.

    ``g``, ``p``: (3, N); ``alphas``: (3, 2 * len(shifts), N), all int32
    (ring-32) or all int64 (ring-64); ``shifts``: at most 8 shifts in
    [0, 31] (ring-32) or [0, 63] (ring-64). A CUDA tensor launches the
    kernel (under ``vmap``, once for all slots; N = 0 takes the plain path
    and launches nothing), a CPU tensor runs :func:`ks_prefix_plain`; any
    other device, dtype, shape or layout raises.
    """
    check_lanes("ks_prefix", [g, p], alphas, 2 * len(shifts))
    c_shifts(shifts, 8 * g.element_size())
    if g.device.type == "cpu":
        return ks_prefix_plain(g, p, alphas, shifts)
    return _ks_prefix_op(g, p, alphas, [int(d) for d in shifts])


def _ks_prefix_launch(g: torch.Tensor, p: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    n = g.shape[1]
    if g.device.type == "cpu" or n == 0:
        return ks_prefix_plain(g, p, alphas, shifts)
    require_contiguous("ks_prefix", g, p, alphas)
    out = torch.empty_like(g)
    entry, build = launch_entry("ks_prefix", g)
    err = entry(
        g.data_ptr(), p.data_ptr(), alphas.data_ptr(), out.data_ptr(), n,
        c_shifts(shifts, 8 * g.element_size()), len(shifts), torch.cuda.current_stream(g.device).cuda_stream,
    )
    check_launch("ks_prefix" + build, err)
    record_launch("ks_prefix" + build)
    return out


@torch.library.custom_op("repro_torch::ks_prefix", mutates_args=())
def _ks_prefix_op(g: torch.Tensor, p: torch.Tensor, alphas: torch.Tensor, shifts: List[int]) -> torch.Tensor:
    return _ks_prefix_launch(g, p, alphas, shifts)


@_ks_prefix_op.register_fake
def _(g, p, alphas, shifts):
    return torch.empty_like(g)


def _ks_prefix_batch_rule(info, in_dims, g, p, alphas, shifts):
    k = info.batch_size
    g, p, alphas = (fold_lanes(t, d, k) for t, d in zip((g, p, alphas), in_dims[:3]))
    return _ks_prefix_launch(g, p, alphas, shifts).unflatten(-1, (k, -1)), 1


_ks_prefix_op.register_vmap(_ks_prefix_batch_rule)


def and_fold(v: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    """The equality AND tree in one launch.

    ``v``: (3, N); ``alphas``: (3, len(shifts), N); rings, devices, checks,
    ``vmap`` and N = 0 as :func:`ks_prefix`; a CPU tensor runs
    :func:`and_fold_plain`.
    """
    check_lanes("and_fold", [v], alphas, len(shifts))
    c_shifts(shifts, 8 * v.element_size())
    if v.device.type == "cpu":
        return and_fold_plain(v, alphas, shifts)
    return _and_fold_op(v, alphas, [int(d) for d in shifts])


def _and_fold_launch(v: torch.Tensor, alphas: torch.Tensor, shifts) -> torch.Tensor:
    n = v.shape[1]
    if v.device.type == "cpu" or n == 0:
        return and_fold_plain(v, alphas, shifts)
    require_contiguous("and_fold", v, alphas)
    out = torch.empty_like(v)
    entry, build = launch_entry("and_fold", v)
    err = entry(
        v.data_ptr(), alphas.data_ptr(), out.data_ptr(), n, c_shifts(shifts, 8 * v.element_size()), len(shifts),
        torch.cuda.current_stream(v.device).cuda_stream,
    )
    check_launch("and_fold" + build, err)
    record_launch("and_fold" + build)
    return out


@torch.library.custom_op("repro_torch::and_fold", mutates_args=())
def _and_fold_op(v: torch.Tensor, alphas: torch.Tensor, shifts: List[int]) -> torch.Tensor:
    return _and_fold_launch(v, alphas, shifts)


@_and_fold_op.register_fake
def _(v, alphas, shifts):
    return torch.empty_like(v)


def _and_fold_batch_rule(info, in_dims, v, alphas, shifts):
    k = info.batch_size
    v, alphas = (fold_lanes(t, d, k) for t, d in zip((v, alphas), in_dims[:2]))
    return _and_fold_launch(v, alphas, shifts).unflatten(-1, (k, -1)), 1


_and_fold_op.register_vmap(_and_fold_batch_rule)


def _lanes(x: BShare) -> torch.Tensor:
    return x.shares.reshape(3, -1).contiguous()


def ks_levels_fused(g: BShare, p: BShare, prf: PRFSetup, width: int, fold_base: int) -> BShare:
    """All Kogge-Stone levels of ``circuits._ks_levels`` in one launch."""
    shape, lanes, device = g.shape, g.size, g.device
    shifts = ks_shifts(width)
    # one (2, *shape) XOR zero sharing per level, as the gate-by-gate
    # _and_pair draws it: word 2l for the pg gate, 2l + 1 for pp
    ring = g.ring
    alphas = torch.empty((3, 2 * len(shifts), lanes), dtype=ring.dtype, device=device)
    for lvl, d in enumerate(shifts):
        alphas[:, 2 * lvl:2 * lvl + 2] = zero_share_unpooled(
            prf.fold_unpooled(fold_base + d), (2,) + shape, device, True, ring
        ).reshape(3, 2, -1)
    out = ks_prefix(_lanes(g), _lanes(p), alphas, shifts)
    for _ in shifts:
        log_comm("and", 1, 2 * lanes * g.ring.bytes)
    return BShare(out.reshape((3,) + shape))


def and_fold_fused(v: BShare, prf: PRFSetup, width: int) -> BShare:
    """The equality AND tree of ``circuits._and_reduce_bits`` in one launch
    (the caller still masks the LSB)."""
    shape, lanes, device = v.shape, v.size, v.device
    shifts = fold_shifts(width)
    ring = v.ring
    alphas = torch.empty((3, len(shifts), lanes), dtype=ring.dtype, device=device)
    for lvl, d in enumerate(shifts):
        alphas[:, lvl] = zero_share_unpooled(prf.fold_unpooled(d), shape, device, True, ring).reshape(3, -1)
    out = and_fold(_lanes(v), alphas, shifts)
    for _ in shifts:
        log_comm("and", 1, lanes * v.ring.bytes)
    return BShare(out.reshape((3,) + shape))
