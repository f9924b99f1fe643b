"""Spec trees onto DTensors: placing, gathering and constraining, and the
regions the models run outside DTensor's propagation: a core on local
shards (:func:`run_local`) and the multi-pod mesh's merged-batch view
(:func:`on_merged_batch`).

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

from .rules import P, data_axes, spec_tree_map, to_placements

__all__ = [
    "NamedSharding",
    "named",
    "batch_spans_axes",
    "is_sharded",
    "on_merged_batch",
    "distribute_tree",
    "einsum",
    "gather_tree",
    "with_sharding_constraint",
    "reduce_partial",
    "replicated",
    "reshape",
    "reshape_whole",
    "run_local",
    "sharded_region",
    "Shards",
    "WHOLE",
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


def reshape_whole(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``, for a DTensor with the axes the reshape
    changes gathered first and its gradient gathered the same way before it
    flows back through the view: DTensor cannot view a feature axis split
    over more devices than heads back into (heads, features)."""
    if not is_sharded(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Replicate

    changed = [i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b] or [len(shape) - 1]
    first = changed[0]
    placements = [Replicate() if p.is_shard() and p.dim >= first else p for p in x.placements]
    out = x.redistribute(x.device_mesh, placements).reshape(*shape)
    return _GradIn.apply(out, list(out.placements))


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
    partitioner replicates an operand it cannot partition). On a mesh whose
    batch spans two axes it runs on the mesh's view with them merged
    (:func:`on_merged_batch`), so its flattening views never merge the batch
    with an axis split over a third mesh dimension."""
    mesh = next((o.device_mesh for o in operands if is_sharded(o)), None)
    if mesh is not None and batch_spans_axes(mesh):
        return on_merged_batch(_einsum, equation, *operands)
    return _einsum(equation, *operands)


def _einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    try:
        return torch.einsum(equation, *operands)
    except RuntimeError:  # DTensor's sharding propagation refused a view
        if not any(is_sharded(o) for o in operands):
            raise
    try:
        return torch.einsum(equation, *(_gathered(o, uneven_only=True) for o in operands))
    except RuntimeError:
        return torch.einsum(equation, *(_gathered(o, uneven_only=False) for o in operands))


class Shards:
    """Where each named axis of a :func:`run_local` region is split: the
    local function reads the global start and size of its shard of an axis
    (``span``) and sums a product whose contraction axis is split
    (``psum``). On plain tensors every axis is whole and ``psum`` is the
    identity."""

    def __init__(self, mesh=None, modes=(), sizes=None, contracted=frozenset()):
        self.mesh = mesh
        self.modes = tuple(modes)  # per mesh dimension: the axis names split over it, "" for none
        self.sizes = dict(sizes or {})
        self.contracted = contracted

    def span(self, axis: str, local: int):
        """(global start, global size) of this device's ``local`` entries of ``axis``."""
        if self.mesh is None:
            return 0, local
        index = 0
        for i, mode in enumerate(self.modes):
            if axis in mode:
                index = index * self.mesh.size(i) + self.mesh.get_local_rank(i)
        return index * local, self.sizes.get(axis, local)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the mesh dimensions that split a contracted
        axis (an all-reduce, and an all-reduce of its gradient in backward:
        the local gradients downstream are partial there too)."""
        dims = [i for i, mode in enumerate(self.modes) if mode and set(mode) <= self.contracted]
        if not dims:
            return t
        from torch.distributed.tensor import DTensor, Partial, Replicate

        whole = [Replicate()] * self.mesh.ndim
        part = [Partial() if i in dims else Replicate() for i in range(self.mesh.ndim)]
        d = DTensor.from_local(t, self.mesh, part, run_check=False)
        return d.redistribute(self.mesh, whole).to_local(grad_placements=part)

    def gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """``t`` with its shards of ``axis`` (tensor dimension ``dim``)
        gathered: an all-gather over the mesh dimensions that split it."""
        dims = [i for i, mode in enumerate(self.modes) if axis in mode]
        if not dims:
            return t
        from torch.distributed.tensor import DTensor, Replicate, Shard

        part = [Shard(dim) if i in dims else Replicate() for i in range(self.mesh.ndim)]
        d = DTensor.from_local(t, self.mesh, part, run_check=False)
        return d.redistribute(self.mesh, [Replicate()] * self.mesh.ndim).to_local()


WHOLE = Shards()  # every axis whole: plain tensors, or DTensors left to DTensor


def _move_cost(now, want, nbytes: int, extent: int) -> int:
    """Bytes a device moves to take one mesh dimension from ``now`` to
    ``want`` (a local chunk is free)."""
    if now == want:
        return 0
    if now.is_partial():
        return nbytes
    if now.is_replicate():
        return 0
    return nbytes * (extent - 1) if want.is_replicate() else nbytes


def run_local(fn: Callable, operands, axes, out_axes, modes, judge: Callable = None, contracted=frozenset()):
    """``fn(shards, *operands)`` on each device's local shards.

    ``axes`` names every operand's axes (one string an axis, an operand
    ``None`` is passed through) and ``out_axes`` each output's. Where no
    operand is a DTensor, ``fn`` runs on the operands as they are. On a mesh,
    each mesh dimension takes one of ``modes`` (a set of axis names split
    together over it, in order of preference) or none: the mode that moves
    the fewest bytes into place, ``judge(mode, sizes, split, extent)``
    returning (allowed, extra bytes) for what the mode costs inside ``fn``
    (an all-reduce of partial sums, for an axis in ``contracted``). Each
    operand is redistributed to its shards of the chosen modes and replicated
    elsewhere, ``fn`` runs on the local tensors, and its outputs become
    DTensors on those modes. DTensor's sharding propagation never sees the
    operations inside, so it never plans a layout for a view that merges
    axes split over different mesh dimensions.

    An operand that a chosen mode leaves whole while splitting another
    gets a partial gradient there, summed by DTensor in backward.
    """
    if not any(is_sharded(t) for t in operands):
        return fn(WHOLE, *operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(t for t in operands if is_sharded(t)).device_mesh
    ops = [t if t is None or is_sharded(t) else DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                                    run_check=False)
           for t in operands]
    sizes: Dict[str, int] = {}
    for t, names in zip(ops, axes):
        if t is not None:
            for name, n in zip(names, t.shape):
                sizes.setdefault(name, n)
    split = {name: 1 for name in sizes}  # product of the extents each axis is split over so far

    def target(names, mode):
        for j, name in enumerate(names):
            if name in mode:
                return Shard(j)
        return Replicate()

    chosen = []
    for i in range(mesh.ndim):
        n = mesh.size(i)
        best = ("", None)
        if n > 1:
            for rank, mode in enumerate(tuple(modes) + ("",)):
                if mode and not all(sizes[a] % (split[a] * n) == 0 for a in mode if a in sizes):
                    continue
                allowed, extra = judge(mode, sizes, split, n) if judge and mode else (True, 0)
                if not allowed:
                    continue
                cost = extra + sum(
                    _move_cost(t.placements[i], target(names, mode), _nbytes_local(t), n)
                    for t, names in zip(ops, axes) if t is not None)
                if best[1] is None or (cost, rank) < best[1]:
                    best = (mode, (cost, rank))
        mode = best[0]
        chosen.append(mode)
        for a in mode:
            if a in split:
                split[a] *= n

    def placements(names, grad=False):
        out = []
        for mode in chosen:
            p = target(names, mode)
            out.append(Partial() if grad and mode and p.is_replicate() else p)
        return out

    local = []
    for t, names in zip(ops, axes):
        if t is None:
            local.append(None)
            continue
        want = placements(names)
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        local.append(t.to_local(grad_placements=placements(names, grad=True)))
    shards = Shards(mesh, chosen, sizes, frozenset(contracted))
    outs = fn(shards, *local)
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    wrapped = tuple(o if o is None else DTensor.from_local(o, mesh, placements(names), run_check=False)
                    for o, names in zip(outs, out_axes))
    return wrapped[0] if single else wrapped


def _nbytes_local(t) -> int:
    """A DTensor's bytes a device, from its global size (no operation is
    dispatched)."""
    n = t.numel() * t.element_size()
    for i, p in enumerate(t.placements):
        if p.is_shard():
            n //= t.device_mesh.size(i)
    return n


def batch_spans_axes(mesh) -> bool:
    """Whether ``mesh`` splits the batch over more than one axis ("pod" and
    "data"). There DTensor's propagation plans the layout of every view
    that merges the batch with an axis split over a third mesh dimension
    through a strided shard, with a search that takes minutes an
    operation."""
    return len(data_axes(mesh)) > 1


def _flat_mesh(mesh):
    """``mesh`` with its batch axes merged into one ("pod_data"): the same ranks
    in the same order, so a tensor split over "pod" then "data" is split
    the same way over the merged axis. Made once a mesh and process group,
    and kept on the mesh."""
    import torch.distributed as dist

    group = dist.distributed_c10d._get_default_group()
    made = getattr(mesh, "_merged_batch", None)
    if made is None or made[0] is not group:  # a mesh object can outlive its group
        from torch.utils._python_dispatch import _disable_current_modes

        with _disable_current_modes():  # mesh bookkeeping, not a step's work: no mode sees it
            made = mesh._merged_batch = (group, _merge_batch_axes(mesh))
    return made[1]


def _merge_batch_axes(mesh):
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    dp = data_axes(mesh)
    if list(dp) != names[: len(dp)]:
        raise ValueError(f"mesh {names}: the batch axes must lead")
    rest = names[len(dp):]
    grid = mesh.mesh.reshape((-1,) + tuple(mesh.mesh.shape[len(dp):]))
    return DeviceMesh(mesh.device_type, grid, mesh_dim_names=("_".join(dp), *rest))


def _merge(placements, extents):
    """The placements on the merged batch axis (the batch axes' extents
    ``extents``), or None where the batch axes differ. An axis of extent 1
    holds the whole tensor whatever its placement, so it is left out."""
    from torch.distributed.tensor import Replicate

    n = len(extents)
    live = [p for p, e in zip(placements[:n], extents) if e > 1]
    if any(p != live[0] for p in live):
        return None
    return [live[0] if live else Replicate(), *placements[n:]]


def on_merged_batch(fn: Callable, *args):
    """``fn(*args)`` with every DTensor of ``args`` (and of the dicts among
    them) moved to ``mesh``'s view with its batch axes merged
    (:func:`_flat_mesh`), and every DTensor it returns moved back. Where the
    mesh has one batch axis, or no argument is a DTensor, ``fn(*args)``.

    DTensor's propagation then plans on a 2-D mesh, as on the single-pod
    mesh. A tensor laid out differently over "pod" and "data" is gathered
    on them first; the moves are views, and their gradients move back."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(args)
    mesh = next((t.device_mesh for t in leaves if is_sharded(t)), None)
    if mesh is None or not batch_spans_axes(mesh):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    flat = _flat_mesh(mesh)
    n_dp = len(data_axes(mesh))
    extents = list(mesh.shape)[:n_dp]

    def down(t):
        if not is_sharded(t):
            return t
        merged = _merge(list(t.placements), extents)
        if merged is None:
            t = t.redistribute(mesh, [Replicate()] * n_dp + list(t.placements[n_dp:]))
            merged = _merge(list(t.placements), extents)
        return DTensor.from_local(t.to_local(), flat, merged, run_check=False, shape=t.shape, stride=t.stride())

    def up(t):
        if not is_sharded(t):
            return t
        pl = list(t.placements)
        dp = [pl[0] if e > 1 else Replicate() for e in extents]
        return DTensor.from_local(t.to_local(), mesh, dp + pl[1:], run_check=False, shape=t.shape,
                                  stride=t.stride())

    out = fn(*tree_unflatten([down(t) for t in leaves], spec))
    leaves, spec = tree_flatten(out)
    return tree_unflatten([up(t) for t in leaves], spec)


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
