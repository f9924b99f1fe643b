"""Ambient correlated-randomness material source (offline/online split).

Every piece of correlated randomness the port consumes is a pure function of
(pair-key content, derivation op, static args): PRF folds, replicated draws,
zero sharings and shuffle-hop permutations all derive deterministically from
a :class:`~repro_torch.core.prf.PRFSetup`. A material source is a cache in
front of those derivations: ``fetch(op, pair_keys, args, compute)`` serves a
precomputed value or falls through to ``compute()``, the exact on-demand
derivation, so pooled and on-demand streams are bit-identical by
construction. A port of ``repro.core.material``.

The active source is thread-local, installed by :func:`material_scope`
around an engine execution; the call sites in ``core/prf.py`` and
``core/shuffle.py`` consult it through :func:`active_if_concrete`, which
steps aside when an input is wrapped by a ``torch.func`` transform, and
inside :func:`compiled_scope`, while the engine's per-operator cache makes
or replays an entry (the reference's jit traces see tracers there, so its
pool is bypassed too). Under the engine's batched ``vmap`` the pair keys
are closed over, not batched, so they stay concrete and batched executions
consult the pool as serial ones do.

Content addressing: a fetch key is ``(op, pair-key bytes, args)``, the
bytes of the keys' uint32 words as the reference takes them, so one pool
can serve either package.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "MaterialSource",
    "active_source",
    "active_if_concrete",
    "material_scope",
    "compiled_scope",
    "content_key",
]

_STATE = threading.local()


class MaterialSource:
    """Interface a correlated-randomness cache implements.

    ``fetch`` must return a value bit-identical to ``compute()``; the only
    freedom is when that value was computed. Implementations expose monotone
    ``hits`` / ``misses`` counters so the engine can attribute them per node.
    """

    hits: int = 0
    misses: int = 0

    def fetch(
        self,
        op: str,
        pair_keys: torch.Tensor,
        args: Tuple[Any, ...],
        compute: Callable[[], torch.Tensor],
    ) -> torch.Tensor:
        raise NotImplementedError


def active_source() -> Optional[MaterialSource]:
    """The source installed by the innermost :func:`material_scope`, or None."""
    return getattr(_STATE, "source", None)


def _wrapped(x) -> bool:
    return isinstance(x, torch.Tensor) and torch._C._functorch.is_functorch_wrapped_tensor(x)


def active_if_concrete(*tensors) -> Optional[MaterialSource]:
    """The active source, unless an input is wrapped by a ``torch.func``
    transform (its value is not a concrete key) or a cache entry of the
    engine is being made or replayed (:func:`compiled_scope`)."""
    src = getattr(_STATE, "source", None)
    if src is None or getattr(_STATE, "compiled", False):
        return None
    if any(_wrapped(t) for t in tensors):
        return None
    return src


@contextlib.contextmanager
def material_scope(source: Optional[MaterialSource]):
    """Install ``source`` as the ambient material source for this thread."""
    prev = getattr(_STATE, "source", None)
    _STATE.source = source
    try:
        yield source
    finally:
        _STATE.source = prev


@contextlib.contextmanager
def compiled_scope():
    """Bypass the active source on this thread: the protocol body runs for a
    compiled cache entry, whose randomness derives from its key inputs."""
    prev = getattr(_STATE, "compiled", False)
    _STATE.compiled = True
    try:
        yield
    finally:
        _STATE.compiled = prev


def content_key(op: str, pair_keys, args: Tuple[Any, ...]) -> tuple:
    """Canonical content-addressed key for one derivation event."""
    if isinstance(pair_keys, torch.Tensor):
        pair_keys = pair_keys.detach().cpu().numpy()
    arr = np.asarray(pair_keys)
    if arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return (op, arr.tobytes(), args)
