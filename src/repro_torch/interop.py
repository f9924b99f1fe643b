"""State crossing over from the JAX package, as numpy arrays.

The reference hands its share triples and PRF pair keys over as numpy
``uint32`` (ring-64 shares, under ``jax_enable_x64``, as ``uint64``); these
turn them into the port's tensors (int32 or int64 ring words on a device;
keys as (2,) / (3, 2) int32 CPU tensors). The LM side's parameter and
cache trees (nested dicts of numpy arrays, as ``jax.device_get`` gives
them) cross with :func:`params_from_numpy` / :func:`caches_from_numpy` and
back with :func:`params_to_numpy` / :func:`caches_to_numpy`; AdamW's state
(``{"m", "v", "count"}``) with :func:`opt_state_from_numpy` /
:func:`opt_state_to_numpy`. Only numpy goes
in — this module imports neither jax nor the reference.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .config import resolve_device
from .core.prf import PRFSetup
from .core.ring import RING32, RING64, from_numpy
from .core.sharing import BShare
from .models.lm import tree_map
from .ops.table import SecretTable

__all__ = [
    "key_from_numpy",
    "prf_from_numpy",
    "tables_from_numpy",
    "params_from_numpy",
    "caches_from_numpy",
    "params_to_numpy",
    "caches_to_numpy",
    "opt_state_from_numpy",
    "opt_state_to_numpy",
]


def key_from_numpy(key) -> torch.Tensor:
    """A raw threefry key (uint32 words) -> the port's int32 CPU tensor."""
    return from_numpy(np.asarray(key, dtype=np.uint32), "cpu")


def prf_from_numpy(pair_keys) -> PRFSetup:
    """(3, 2) uint32 PRF pair keys -> :class:`PRFSetup`."""
    keys = key_from_numpy(pair_keys)
    if tuple(keys.shape) != (3, 2):
        raise ValueError(f"pair keys must be (3, 2), got {tuple(keys.shape)}")
    return PRFSetup(keys)


def tables_from_numpy(
    shares_by_table: Dict[str, Tuple[Dict[str, np.ndarray], np.ndarray]], device=None
) -> Dict[str, SecretTable]:
    """``{table: ({column: (3, n) uint32 XOR shares}, (3, n) valid shares)}``
    -> ``{table: SecretTable}`` on ``device`` (default ``"cuda"``; raises
    without a card unless ``device="cpu"``). ``uint64`` columns carry over
    as ring-64 shares."""
    device = resolve_device(device)

    def share(s) -> BShare:
        s = np.asarray(s)
        return BShare(from_numpy(s, device, RING64 if s.dtype == np.uint64 else RING32))

    out = {}
    for name, (cols, valid) in shares_by_table.items():
        out[name] = SecretTable({c: share(s) for c, s in cols.items()}, share(valid))
    return out


def _tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits across
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, as JAX uses it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Dict, device=None) -> Dict:
    """The reference's parameter tree (nested dicts of numpy arrays, paths,
    shapes and dtypes kept) -> the port's, on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``)."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor_from_numpy(a, device), tree)


def caches_from_numpy(tree: Dict, device=None) -> Dict:
    """The reference's decode caches (group-stacked, ``idx`` int32 per
    group; int8 values and bfloat16 scales under ``kv_quant``) -> the port's."""
    device = resolve_device(device)
    return tree_map(lambda a: _tensor_from_numpy(a, device), tree)


def params_to_numpy(tree: Dict) -> Dict:
    """The port's parameter tree -> nested dicts of numpy arrays."""
    return tree_map(_tensor_to_numpy, tree)


def caches_to_numpy(tree: Dict) -> Dict:
    """The port's decode caches -> nested dicts of numpy arrays (bfloat16
    as ``ml_dtypes.bfloat16``, the dtype JAX hands out)."""
    return tree_map(_tensor_to_numpy, tree)


def opt_state_from_numpy(state: Dict, device=None) -> Dict:
    """The reference's AdamW state (f32 moment trees, a 0-dim int32
    ``count``) -> the port's, on ``device`` (default ``"cuda"``)."""
    return params_from_numpy(state, device)


def opt_state_to_numpy(state: Dict) -> Dict:
    """The port's AdamW state -> nested dicts of numpy arrays."""
    return params_to_numpy(state)
