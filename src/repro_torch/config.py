"""Execution knobs and device resolution.

The join's valid-computation tile, the circuit-fusion switch and the
physical join algorithm (``join_algo``, read by the SQL compiler's
algorithm selection) come over from ``repro.config``; the port parses no
environment variables, so callers pass the config. There is no kernel
switch: the tensor's device decides (a CUDA tensor goes through the
kernels, a CPU tensor through their plain versions). ``fuse_circuits``
picks between the fused circuit kernels (the default, as in the reference)
and the gate-by-gate path; the two give bit-identical shares and ledgers.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["RuntimeConfig", "DEFAULT_JOIN_TILE", "resolve_device"]

DEFAULT_JOIN_TILE = 1 << 16


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    join_tile: int = DEFAULT_JOIN_TILE  # product-grid rows per valid tile
    fuse_circuits: bool = True  # single-launch fused circuit kernels
    join_algo: str = "auto"  # physical join selection: auto|product|sortmerge

    def __post_init__(self):
        if self.join_algo not in ("auto", "product", "sortmerge"):
            raise ValueError(
                f"join algo mode {self.join_algo!r} (expected auto|product|sortmerge)"
            )
        if self.join_tile < 1:
            raise ValueError(f"join_tile must be >= 1, got {self.join_tile}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller asks
    otherwise. Raises when a CUDA device is asked for (explicitly or by
    default) and none is present — the port never drops to the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
