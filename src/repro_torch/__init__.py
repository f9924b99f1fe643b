"""PyTorch/CUDA port of the Reflex MPC query engine.

Mirrors ``repro``'s layout (``core/``, ``kernels/``, ``ops/``, ``plan/``,
``engine/``, ``data/``) and keeps its names. Shares are ``int32`` tensors
holding ring-32 words (two's-complement addition wraps exactly like
``uint32``). Entry points take ``device=`` and default to ``"cuda"``; they
raise when no card is present unless the caller asked for ``"cpu"``.

On a CUDA tensor every secret gate and every shuffle hop runs through the
hand-written kernels in :mod:`repro_torch.kernels`; on a CPU tensor the
kernels' plain PyTorch versions compute the same words.
"""
from .config import RuntimeConfig, resolve_device

__all__ = ["RuntimeConfig", "resolve_device"]
