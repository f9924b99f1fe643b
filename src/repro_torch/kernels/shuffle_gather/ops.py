"""shuffle_gather: the secure-shuffle row gather (CUDA kernel + plain version).

Replaces the Pallas TPU kernel ``repro/kernels/shuffle_gather/
shuffle_gather.py:33`` (wrapper ``ops.py:16``, oracle ``ref.py:7``). The TPU
kernel gathers one ``(N, C)`` share plane per launch and falls back to XLA
above 8 MiB of VMEM; here one launch gathers every plane, for any N. The CUDA
source is ``kernels/csrc/shuffle_gather.cu``.
"""
from __future__ import annotations

import torch

from .. import check_launch, library, record_launch

__all__ = ["shuffle_gather", "shuffle_gather_plain"]


def shuffle_gather_plain(planes: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[p, r, c] = planes[p, perm[r], c]`` in plain PyTorch — per plane,
    the reference ``gather_rows(table, perm)``: the row index broadcast over
    planes and columns, then an elementwise gather. A row whose index lies
    outside ``[0, N)`` comes out as zeros, as in the kernel."""
    p, n, c = planes.shape
    inside = (perm >= 0) & (perm < n)
    rows = torch.gather(planes, 1, torch.where(inside, perm, 0).view(1, n, 1).expand(p, n, c))
    return torch.where(inside.view(1, n, 1), rows, 0)


def shuffle_gather(planes: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gather rows of every share plane by one permutation.

    ``planes``: ``(P, N, C)`` int32; ``perm``: ``(N,)`` int64, a permutation
    of ``[0, N)``. An entry outside ``[0, N)`` is not checked: its row comes
    out as zeros on either device. A CUDA tensor launches the kernel, a CPU
    tensor runs :func:`shuffle_gather_plain`; any other device, dtype, shape
    or layout raises.
    """
    if planes.dim() != 3 or perm.dim() != 1 or perm.shape[0] != planes.shape[1]:
        raise ValueError(
            f"shuffle_gather needs (P, N, C) planes and an (N,) perm, got "
            f"{tuple(planes.shape)} and {tuple(perm.shape)}"
        )
    if planes.dtype != torch.int32 or perm.dtype != torch.int64:
        raise TypeError(f"shuffle_gather needs int32 planes and an int64 perm, got {planes.dtype}, {perm.dtype}")
    if planes.device != perm.device:
        raise ValueError("shuffle_gather operands lie on different devices")
    if planes.device.type == "cpu":
        return shuffle_gather_plain(planes, perm)
    if planes.device.type != "cuda":
        raise ValueError(f"shuffle_gather runs on cuda or cpu, not {planes.device}")
    if not (planes.is_contiguous() and perm.is_contiguous()):
        raise ValueError("shuffle_gather needs contiguous operands")
    p, n, c = planes.shape
    out = torch.empty_like(planes)
    if p * n * c == 0:
        return out
    err = library().shuffle_gather_launch(
        planes.data_ptr(), perm.data_ptr(), out.data_ptr(), p, n, c,
        torch.cuda.current_stream(planes.device).cuda_stream,
    )
    check_launch("shuffle_gather", err)
    record_launch("shuffle_gather")
    return out
