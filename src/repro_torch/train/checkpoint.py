"""Fault-tolerant checkpointing: a port of ``repro.train.checkpoint`` with
the same on-disk layout, so either package restores the other's
checkpoints.

* **atomic**: arrays and manifest are written to ``step_N.tmp/`` and the
  directory is renamed into place; a crash mid-save never corrupts the
  latest checkpoint.
* **async**: :meth:`Checkpointer.save_async` copies the state to host memory
  now and writes it in a background thread, overlapping I/O with the next
  training steps.
* **keep-last-k** garbage collection.
* **layout**: ``step_{:08d}/arrays.npz`` holds the leaves keyed ``"0"`` ..
  ``"n-1"`` in JAX's flatten order of the state without its ``meta`` (dict
  keys sorted), and ``manifest.json`` the step, a description of the tree,
  the leaf count and ``meta``. Arrays are stored whole (a DTensor leaf is
  gathered first); :meth:`restore` puts them on the template's devices (or
  on ``device``), dtypes kept, or, given ``shardings``, lays each out on
  the current mesh (elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..interop import _tensor_from_numpy, _tensor_to_numpy
from ..models.lm import tree_items, tree_unflatten
from ..sharding import replicated

__all__ = ["Checkpointer", "tree_description"]


def tree_description(tree) -> str:
    """The structure of a nested dict with leaves as ``*``, written as JAX
    writes a dict treedef (``PyTreeDef({'a': *, 'b': {'c': *}})``)."""

    def walk(node) -> str:
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in sorted(node)) + "}"
        return "*"

    return f"PyTreeDef({walk(tree)})"


def _host_leaves(tree: Dict) -> List[np.ndarray]:
    """The leaves in JAX's order as numpy arrays of their own (one copy, also
    of a CPU tensor, so later writes to the tensor do not reach them); a
    DTensor leaf is gathered whole, so every rank of its mesh must call."""
    return [_tensor_to_numpy(replicated(t.detach()).to("cpu", copy=True)) if isinstance(t, torch.Tensor)
            else np.array(t) for _, t in tree_items(tree)]


def _step_dirs(directory: str) -> List[int]:
    return sorted(
        int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_") and not d.endswith(".tmp")
    )


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def latest_step(self) -> Optional[int]:
        steps = _step_dirs(self.dir)
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state: Dict) -> None:
        """Synchronous atomic save. ``state`` is a nested dict of tensors (or
        numpy arrays) plus JSON-able values under the ``"meta"`` key; it is
        not modified."""
        meta = state.get("meta", {})
        arrays = {k: v for k, v in state.items() if k != "meta"}
        leaves = _host_leaves(arrays)
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **{str(i): a for i, a in enumerate(leaves)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "treedef": tree_description(arrays), "n_leaves": len(leaves), "meta": meta}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def save_async(self, step: int, state: Dict) -> None:
        """Copy the state to host memory now (device-to-host, blocking), write
        it in a background thread."""
        arrays = {k: v for k, v in state.items() if k != "meta"}
        snapshot = tree_unflatten(arrays, _host_leaves(arrays))
        snapshot["meta"] = dict(state.get("meta", {}))
        self.wait()
        self._thread = threading.Thread(target=self.save, args=(step, snapshot))
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = _step_dirs(self.dir)
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: Optional[int], like: Dict, device=None,
                shardings: Optional[Dict] = None) -> Tuple[int, Dict]:
        """Restore into the structure of ``like`` (a template tree; ``step``
        None: the latest). Each array goes to ``device`` if given, else to
        its template leaf's device; a template leaf on ``meta`` (or not a
        tensor) means the default device, ``"cuda"``, which raises without a
        card. Dtypes are the stored ones.

        ``shardings``: a tree matching ``like`` (without ``meta``) of
        ``repro_torch.sharding.NamedSharding`` on the *current* mesh; each
        array becomes a DTensor laid out by it (elastic restore: the mesh
        need not be the one that saved). Every rank of the mesh must call."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        arrays = {k: v for k, v in like.items() if k != "meta"}
        template = list(tree_items(arrays))
        if manifest["n_leaves"] != len(template):
            raise ValueError(
                f"checkpoint step {step} holds {manifest['n_leaves']} arrays, the template {len(template)}"
            )
        if shardings is not None:
            from torch.distributed.tensor import distribute_tensor

            layouts = [sh for _, sh in tree_items({k: v for k, v in shardings.items() if k != "meta"})]
            if len(layouts) != len(template):
                raise ValueError(f"{len(layouts)} shardings for {len(template)} arrays")
        forced = None if device is None else resolve_device(device)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            loaded = []
            for i, (path, t) in enumerate(template):
                a = data[str(i)]
                if isinstance(t, torch.Tensor) and tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"checkpoint step {step}: {path} is {a.shape}, the template {tuple(t.shape)}")
                if shardings is not None:
                    sh = layouts[i]
                    loaded.append(distribute_tensor(_tensor_from_numpy(a, torch.device("cpu")), sh.mesh,
                                                    sh.placements()))
                    continue
                on_template = isinstance(t, torch.Tensor) and t.device.type != "meta"
                loaded.append(_tensor_from_numpy(a, forced or (t.device if on_template else resolve_device())))
        out = tree_unflatten(arrays, loaded)
        out["meta"] = manifest.get("meta", {})
        return step, out

