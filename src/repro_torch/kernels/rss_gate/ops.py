"""rss_gate: the 1-round RSS mul / AND gate (CUDA kernel + plain version).

Replaces the Pallas TPU kernel ``repro/kernels/rss_gate/rss_gate.py:43``
(wrapper ``ops.py:14``, oracle ``ref.py:7``); the CUDA source is
``kernels/csrc/rss_gate.cu``, which notes its byte bound and design. Ring-32
(int32) operands launch its 32-bit build, ring-64 (int64) ones its 64-bit
build, counted as ``rss_gate_u64``.
"""
from __future__ import annotations

import torch

from .. import batch_to, check_launch, launch_entry, record_launch, require_contiguous

__all__ = ["gate", "gate_plain"]


def gate_plain(xs: torch.Tensor, ys: torch.Tensor, alpha: torch.Tensor, boolean: bool) -> torch.Tensor:
    """The gate in plain PyTorch: cross terms over the share axis (axis 0,
    rolled by one) plus the zero sharing."""
    xn = torch.roll(xs, -1, dims=0)
    yn = torch.roll(ys, -1, dims=0)
    if boolean:
        return (xs & ys) ^ (xs & yn) ^ (xn & ys) ^ alpha
    return xs * ys + xs * yn + xn * ys + alpha


def gate(xs: torch.Tensor, ys: torch.Tensor, alpha: torch.Tensor, boolean: bool) -> torch.Tensor:
    """``z_i = cross(x_i, x_{i+1}, y_i, y_{i+1}) (+|^) alpha_i`` per lane.

    ``xs``, ``ys``, ``alpha``: share triples of one shape ``(3, ...)`` and
    one ring (int32 or int64 words)
    (the caller broadcasts operands first; lanes are flattened). A CUDA tensor
    launches the kernel (under ``vmap``, once for all slots), a CPU tensor
    runs :func:`gate_plain`; any other device, dtype, shape or layout
    raises.
    """
    if not (xs.shape == ys.shape == alpha.shape) or xs.dim() < 1 or xs.shape[0] != 3:
        raise ValueError(
            f"rss_gate needs three (3, ...) operands of one shape, got "
            f"{tuple(xs.shape)}, {tuple(ys.shape)}, {tuple(alpha.shape)}"
        )
    if not (xs.dtype == ys.dtype == alpha.dtype) or xs.dtype not in (torch.int32, torch.int64):
        raise TypeError(
            f"rss_gate needs int32 or int64 ring words of one ring, got {xs.dtype}, {ys.dtype}, {alpha.dtype}"
        )
    if not (xs.device == ys.device == alpha.device):
        raise ValueError("rss_gate operands lie on different devices")
    if xs.device.type == "cpu":
        return gate_plain(xs, ys, alpha, boolean)
    if xs.device.type not in ("cuda", "meta"):
        raise ValueError(f"rss_gate runs on cuda, cpu or meta, not {xs.device}")
    return _gate_op(xs, ys, alpha, boolean)


def _launch(xs: torch.Tensor, ys: torch.Tensor, alpha: torch.Tensor, boolean: bool) -> torch.Tensor:
    """One kernel launch over every lane (the plain version for a CPU
    tensor, so the batch rule also runs on the CPU)."""
    if xs.device.type == "cpu":
        return gate_plain(xs, ys, alpha, boolean)
    require_contiguous("rss_gate", xs, ys, alpha)
    out = torch.empty_like(xs)
    n = xs[0].numel()
    if n == 0:
        return out
    entry, build = launch_entry("rss_gate", xs)
    err = entry(
        xs.data_ptr(), ys.data_ptr(), alpha.data_ptr(), out.data_ptr(), n,
        int(boolean), torch.cuda.current_stream(xs.device).cuda_stream,
    )
    check_launch("rss_gate" + build, err)
    record_launch("rss_gate" + build)
    return out


@torch.library.custom_op("repro_torch::rss_gate", mutates_args=())
def _gate_op(xs: torch.Tensor, ys: torch.Tensor, alpha: torch.Tensor, boolean: bool) -> torch.Tensor:
    return _launch(xs, ys, alpha, boolean)


@_gate_op.register_fake
def _(xs, ys, alpha, boolean):
    return torch.empty_like(xs)


def _gate_batch_rule(info, in_dims, xs, ys, alpha, boolean):
    """K slots in one launch: the batch axis joins the lanes (the gate is
    lane-wise), behind the share axis."""
    k = info.batch_size
    xs, ys, alpha = (batch_to(t, d, k, 1) for t, d in zip((xs, ys, alpha), in_dims[:3]))
    return _launch(xs, ys, alpha, boolean), 1


_gate_op.register_vmap(_gate_batch_rule)
