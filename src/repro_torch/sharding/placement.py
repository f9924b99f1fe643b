"""Spec trees onto DTensors: placing, gathering and constraining.

The torch side of :mod:`repro_torch.sharding.rules`, the counterpart of the
reference's ``NamedSharding`` / ``device_put`` / ``with_sharding_constraint``.
``torch.distributed.tensor`` is imported where it is used, so a program that
never shards never loads it.
"""
from __future__ import annotations

import contextlib
import functools
import sys
from typing import Callable, Dict, NamedTuple

import torch

from .rules import P, spec_tree_map, to_placements

__all__ = [
    "NamedSharding",
    "named",
    "is_sharded",
    "distribute_tree",
    "einsum",
    "gather_tree",
    "with_sharding_constraint",
    "reduce_partial",
    "replicated",
    "reshape",
    "sharded_region",
]


class NamedSharding(NamedTuple):
    """A spec on a ``DeviceMesh``."""

    mesh: object
    spec: P

    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def named(mesh, spec_tree: Dict) -> Dict:
    """A tree of :class:`NamedSharding` over ``mesh``, shaped like ``spec_tree``."""
    return spec_tree_map(lambda _path, spec: NamedSharding(mesh, spec), spec_tree)


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor if no program
    has yet)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def distribute_tree(tree: Dict, spec_tree: Dict, mesh) -> Dict:
    """Every leaf of ``tree`` as a DTensor on ``mesh`` laid out by its spec
    (``distribute_tensor``: each rank passes the whole tensor and keeps its
    shard; a replicated leaf is broadcast from rank 0)."""
    from torch.distributed.tensor import distribute_tensor

    return spec_tree_map(lambda _path, t, spec: distribute_tensor(t, mesh, to_placements(spec, mesh)),
                         tree, spec_tree)


def gather_tree(tree: Dict) -> Dict:
    """Every DTensor leaf of ``tree`` as the whole tensor on each rank (an
    all-gather or all-reduce where it is sharded or partial); other leaves
    as they are."""
    return spec_tree_map(lambda _path, t: replicated(t), tree)


def replicated(x):
    """``x`` replicated on every mesh dimension, as the whole local tensor
    (a plain tensor passes through)."""
    return x.full_tensor() if is_sharded(x) else x


@functools.cache
def _register_strategies() -> None:
    """Sharding strategies for the ops of the models' backward that some
    PyTorch releases' DTensor leaves without one.

    * ``log_sigmoid_backward`` (the mLSTM / sLSTM forget gates) is
      elementwise, so any layout its operands share is its own; its
      ``buffer`` operand is empty on CUDA and then stays replicated.
    * ``flip`` (``cumsum``'s backward, the mLSTM's forget-gate prefix) keeps
      any sharding of an axis it does not reverse.
    """
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.log_sigmoid_backward.default)
    def _log_sigmoid_backward(grad_output, self, buffer):
        full = buffer.ndim == self.ndim and buffer.shape == self.shape
        out = [([Replicate()], [Replicate(), Replicate(), Replicate()])]
        for d in range(self.ndim):
            out.append(([Shard(d)], [Shard(d), Shard(d), Shard(d) if full else Replicate()]))
        return out

    @register_sharding(torch.ops.aten.flip.default)
    def _flip(self, dims):
        flipped = {d % self.ndim for d in dims}
        out = [([Replicate()], [Replicate(), None])]
        for d in range(self.ndim):
            if d not in flipped:
                out.append(([Shard(d)], [Shard(d), None]))
        return out


class _GradIn(torch.autograd.Function):
    """Identity forward; backward redistributes the gradient to the given
    placements."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.placements), None


def reduce_partial(x):
    """A DTensor ``x`` with its pending (``Partial``) reductions done, its
    other placements kept; anything else as it is. A vocab-sharded
    embedding lookup leaves a masked partial sum that DTensor can reduce
    only once, so it is reduced where it is made, before its many uses; its
    gradient is made whole on those mesh axes before it reaches the mask
    (DTensor cannot turn a partial gradient into a masked one)."""
    if not is_sharded(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    whole = [Replicate() if p.is_partial() else p for p in x.placements]
    return _GradIn.apply(x.redistribute(x.device_mesh, whole), whole)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``. Where DTensor cannot carry ``x``'s sharding
    through the reshape (a sharded axis split into factors its mesh extent
    does not divide: 32 query heads over 16 devices viewed as 8 KV groups of
    4), the axes the reshape changes are gathered first, as XLA's SPMD
    partitioner replicates where a reshape breaks a sharding."""
    try:
        return x.reshape(*shape)
    except RuntimeError:  # DTensor's sharding propagation refused the view
        if not is_sharded(x):
            raise
    from torch.distributed.tensor import Replicate

    old = tuple(x.shape)
    lead = 0
    while lead < min(len(old), len(shape)) and old[lead] == shape[lead]:
        lead += 1
    trail = 0
    while trail < min(len(old), len(shape)) - lead and old[-1 - trail] == shape[-1 - trail]:
        trail += 1
    changed = range(lead, len(old) - trail)
    placements = [Replicate() if p.is_shard() and p.dim in changed else p for p in x.placements]
    return x.redistribute(x.device_mesh, placements).reshape(*shape)


def _gathered(x, uneven_only: bool):
    """A DTensor ``x`` with its shards gathered (only those of axes its
    mesh extent does not divide, with ``uneven_only``)."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh

    def keep(i, p):
        if not p.is_shard():
            return True
        return uneven_only and x.shape[p.dim] % mesh.size(i) == 0

    placements = [p if keep(i, p) else Replicate() for i, p in enumerate(x.placements)]
    return x if placements == list(x.placements) else x.redistribute(mesh, placements)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``. DTensor runs an einsum as permutes, flattening
    views and a batched matmul, and refuses a view that would flatten an
    unevenly sharded axis or split one across mesh axes; there the operands'
    uneven shards, then all their shards, are gathered first (as XLA's SPMD
    partitioner replicates an operand it cannot partition)."""
    try:
        return torch.einsum(equation, *operands)
    except RuntimeError:  # DTensor's sharding propagation refused a view
        if not any(is_sharded(o) for o in operands):
            raise
    try:
        return torch.einsum(equation, *(_gathered(o, uneven_only=True) for o in operands))
    except RuntimeError:
        return torch.einsum(equation, *(_gathered(o, uneven_only=False) for o in operands))


def sharded_region(sharded: bool):
    """``implicit_replication()`` when a step runs over DTensors (the plain
    tensors it builds inside, positions and masks, count as replicated),
    else nothing."""
    if not sharded:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    _register_strategies()
    return implicit_replication()


def with_sharding_constraint(x: torch.Tensor, make_spec: Callable) -> torch.Tensor:
    """A DTensor ``x`` redistributed to ``make_spec(x.device_mesh)``; a plain
    tensor, or a spec naming an axis the mesh lacks, leaves ``x`` as it is
    (the reference's constraint outside a mesh)."""
    if not is_sharded(x):
        return x
    mesh = x.device_mesh
    try:
        placements = to_placements(make_spec(mesh), mesh)
    except ValueError:
        return x
    return x.redistribute(mesh, placements)
