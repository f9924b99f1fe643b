"""Production meshes on ``torch.distributed``.

A port of ``repro.launch.mesh``: the same shapes and axis names, built with
``init_device_mesh`` over the process group the caller opened. Nothing
happens on import; :func:`fake_process_group` opens the group the dry-run
uses, the counterpart of the reference forcing 512 host placeholder devices.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Tuple

__all__ = ["PRODUCTION_MESHES", "make_production_mesh", "mesh_chips", "make_mesh", "fake_process_group"]

# (shape, axis names), single-pod and multi-pod
PRODUCTION_MESHES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the default process group, which
    must hold exactly ``prod(shape)`` ranks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks but the process group has {have} — "
            "open one of that size first (fake_process_group for the dry-run)"
        )
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")."""
    shape, names = PRODUCTION_MESHES[multi_pod]
    return make_mesh(shape, names, device_type)


def mesh_chips(mesh) -> int:
    return math.prod(mesh.shape)


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A process group of ``world_size`` ranks in this one process, this
    process being rank 0, that runs no collective (PyTorch's ``fake``
    backend): a mesh over it shards tensors, and DTensor issues its
    collectives, without any peer. Destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
