"""RuntimeConfig: the execution knobs, and device resolution.

A port of ``repro.config``. The join's valid-computation tile, the
circuit-fusion switch and the physical join algorithm (``join_algo``, read
by the SQL compiler's algorithm selection) come over. ``fuse_circuits``
picks between the fused circuit kernels (the default, as in the reference)
and the gate-by-gate path; the two give bit-identical shares and ledgers.

The reference's ``use_pallas`` switch (``REPRO_USE_PALLAS``) has no
counterpart: the tensor's device picks the kernel (a CUDA tensor goes
through the CUDA kernels, a CPU tensor through their plain versions).

Resolution order, from strongest to weakest:

1. block-scoped thread-local overrides
   (:func:`repro_torch.kernels.override_fusion`);
2. an explicit ``RuntimeConfig`` passed to the ``Engine``, ``compile_query``
   or the ``AnalyticsService``; the engine applies it with
   :func:`use_config` for the duration of an execution;
3. the environment fallback: :func:`current_config` parses
   ``REPRO_FUSE_CIRCUITS=0`` (``fuse_circuits=False``),
   ``REPRO_JOIN_TILE=<int>`` and ``REPRO_JOIN_ALGO=<auto|product|sortmerge>``
   (cached; re-parsed only when the raw values change). This module is the
   port's only reader of the environment.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Iterator, Mapping, Optional, Tuple

import torch

__all__ = [
    "RuntimeConfig",
    "DEFAULT_JOIN_TILE",
    "current_config",
    "use_config",
    "resolve_device",
]

DEFAULT_JOIN_TILE = 1 << 16

_ENV_VARS = ("REPRO_FUSE_CIRCUITS", "REPRO_JOIN_TILE", "REPRO_JOIN_ALGO")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution-strategy knobs for one engine. Frozen: use
    :func:`dataclasses.replace` to derive variants."""

    join_tile: int = DEFAULT_JOIN_TILE  # product-grid rows per valid tile
    fuse_circuits: bool = True  # single-launch fused circuit kernels
    join_algo: str = "auto"  # physical join selection: auto|product|sortmerge

    def __post_init__(self):
        if self.join_algo not in ("auto", "product", "sortmerge"):
            raise ValueError(
                f"join algo mode {self.join_algo!r} (expected auto|product|sortmerge)"
            )
        if self.join_tile < 1:
            raise ValueError(f"REPRO_JOIN_TILE must be >= 1, got {self.join_tile}")

    @classmethod
    def from_env(cls, env: Optional[Mapping[str, str]] = None) -> "RuntimeConfig":
        """Parse the ``REPRO_*`` fallback variables."""
        env = os.environ if env is None else env
        raw_tile = env.get("REPRO_JOIN_TILE", "")
        if raw_tile:
            try:
                tile = int(raw_tile)
            except ValueError as e:
                raise ValueError(
                    f"REPRO_JOIN_TILE must be an integer, got {raw_tile!r}"
                ) from e
        else:
            tile = DEFAULT_JOIN_TILE
        return cls(
            join_tile=tile,
            fuse_circuits=env.get("REPRO_FUSE_CIRCUITS", "1") == "1",
            join_algo=env.get("REPRO_JOIN_ALGO") or "auto",
        )

    # -- wire form --------------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "RuntimeConfig":
        """Keys this config does not have (the reference's ``use_pallas``)
        are dropped."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


_cache: Tuple[Optional[Tuple], Optional[RuntimeConfig]] = (None, None)
_STATE = threading.local()


def current_config() -> RuntimeConfig:
    """The config in effect on this thread: the innermost :func:`use_config`
    when one is active, else the environment fallback (cached until one of
    the ``REPRO_*`` raw values changes)."""
    global _cache
    stack = getattr(_STATE, "stack", None)
    if stack:
        return stack[-1]
    raw = tuple(os.environ.get(v) for v in _ENV_VARS)
    cached_raw, cached_cfg = _cache
    if raw != cached_raw or cached_cfg is None:
        cached_cfg = RuntimeConfig.from_env()
        _cache = (raw, cached_cfg)
    return cached_cfg


@contextlib.contextmanager
def use_config(cfg: Optional[RuntimeConfig]) -> Iterator[None]:
    """Thread-locally pin :func:`current_config` to ``cfg`` for the block;
    ``None`` is a no-op (the environment fallback stays in effect)."""
    if cfg is None:
        yield
        return
    stack = getattr(_STATE, "stack", None)
    if stack is None:
        stack = _STATE.stack = []
    stack.append(cfg)
    try:
        yield
    finally:
        stack.pop()


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
