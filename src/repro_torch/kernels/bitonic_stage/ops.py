"""bitonic_swap: one bitonic sort stage's conditional swap over all columns
(CUDA kernel + plain version).

Replaces the Pallas TPU kernel
``repro/kernels/bitonic_stage/bitonic_stage.py:41`` (``bitonic_swap``;
wrapper ``ops.py:10``, oracle ``ref.py:7``); the CUDA source is
``kernels/csrc/bitonic_swap.cu``, which notes its byte bound and design. The
TPU wrapper pads the lanes to its block; the CUDA kernel masks the ragged
edge itself.

``core/sort.py`` calls :func:`stage_swap` in every stage of the fused path,
with alpha drawn from the fold and at the shape at which ``and_`` draws it,
so the shares equal the gate-by-gate select's.
"""
from __future__ import annotations

import torch

from .. import check_launch, fold_lanes, library, record_launch, require_contiguous

__all__ = ["stage_swap", "stage_swap_plain"]


def stage_swap_plain(mask: torch.Tensor, own: torch.Tensor, other: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The stage select in plain PyTorch: ``own ^ ((m & d) ^ (m & dn) ^
    (mn & d) ^ alpha)`` with ``d = own ^ other``, the mask broadcast over the
    columns and ``·n`` the roll by -1 on the share axis."""
    m = mask[:, None, :]
    d = own ^ other
    mn = torch.roll(m, -1, dims=0)
    dn = torch.roll(d, -1, dims=0)
    return own ^ ((m & d) ^ (m & dn) ^ (mn & d) ^ alpha)


def stage_swap(mask: torch.Tensor, own: torch.Tensor, other: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``own`` with every column's lane conditionally replaced by its partner
    lane ``other`` where the XOR-shared full-width ``mask`` is set.

    ``mask``: (3, N); ``own``, ``other``, ``alpha``: (3, C, N); all int32 on
    one device. A CUDA tensor launches the kernel (under ``vmap``, once for
    all slots), a CPU tensor runs :func:`stage_swap_plain`; any other
    device, dtype, shape or layout raises.
    """
    if own.dim() != 3 or own.shape[0] != 3 or other.shape != own.shape or alpha.shape != own.shape or tuple(
        mask.shape
    ) != (3, own.shape[2]):
        raise ValueError(
            f"bitonic_swap needs a (3, N) mask and (3, C, N) own/other/alpha, got "
            f"{tuple(mask.shape)}, {tuple(own.shape)}, {tuple(other.shape)}, {tuple(alpha.shape)}"
        )
    if any(t.dtype != torch.int32 for t in (mask, own, other, alpha)):
        raise TypeError(
            f"bitonic_swap needs int32 (ring-32) words, got {[t.dtype for t in (mask, own, other, alpha)]}; "
            f"no path sorts ring-64 shares, so it has no 64-bit build (ROADMAP.md, Queue 1, step 5)"
        )
    if not (mask.device == own.device == other.device == alpha.device):
        raise ValueError("bitonic_swap operands lie on different devices")
    if own.device.type == "cpu":
        return stage_swap_plain(mask, own, other, alpha)
    if own.device.type not in ("cuda", "meta"):
        raise ValueError(f"bitonic_swap runs on cuda, cpu or meta, not {own.device}")
    return _stage_swap_op(mask, own, other, alpha)


def _launch(mask: torch.Tensor, own: torch.Tensor, other: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    if own.device.type == "cpu":
        return stage_swap_plain(mask, own, other, alpha)
    require_contiguous("bitonic_swap", mask, own, other, alpha)
    out = torch.empty_like(own)
    _, c, n = own.shape
    if out.numel() == 0:
        return out
    err = library().bitonic_swap_launch(
        mask.data_ptr(), own.data_ptr(), other.data_ptr(), alpha.data_ptr(), out.data_ptr(),
        c, n, torch.cuda.current_stream(own.device).cuda_stream,
    )
    check_launch("bitonic_swap", err)
    record_launch("bitonic_swap")
    return out


@torch.library.custom_op("repro_torch::bitonic_swap", mutates_args=())
def _stage_swap_op(mask: torch.Tensor, own: torch.Tensor, other: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return _launch(mask, own, other, alpha)


@_stage_swap_op.register_fake
def _(mask, own, other, alpha):
    return torch.empty_like(own)


def _stage_swap_batch_rule(info, in_dims, mask, own, other, alpha):
    """K slots in one launch: each operand's batch axis joins its lanes."""
    k = info.batch_size
    mask, own, other, alpha = (fold_lanes(t, d, k) for t, d in zip((mask, own, other, alpha), in_dims))
    return _launch(mask, own, other, alpha).unflatten(-1, (k, -1)), 2


_stage_swap_op.register_vmap(_stage_swap_batch_rule)
