"""Logical-axis -> mesh-axis sharding rules (DP / TP / EP / SP).

A port of ``repro.sharding.rules``: the rule tables are the reference's,
verbatim, and every function is a pure function of parameter names, tensor
shapes and mesh extents, so its spec trees equal the reference's axis name
for axis name. A spec is a :class:`P`, one entry per tensor axis (``None``,
a mesh axis name, or a tuple of them); :func:`to_placements` turns it into
DTensor placements on a ``DeviceMesh``.

The production mesh is ("data", "model") single-pod or ("pod", "data",
"model") multi-pod; "pod" composes with "data" for batch (DP) sharding. The
mesh argument is anything that names its axes and their extents: a
``torch.distributed.device_mesh.DeviceMesh`` or a :class:`MeshShape`, which
needs no process group.

Parameter rules are name-based with divisibility-checked fallbacks: each
parameter name maps to a priority list of tensor axes (negative, counted from
the end so the stacked layer-group axis is transparent); the first axis
whose size divides the model-axis extent gets "model". This yields:

* TP     — attention heads / FFN hidden / vocab on "model"
* EP     — MoE expert axis on "model" when n_experts % model == 0
           (arctic 128e), else TP inside the expert FFN (mixtral 8e on a
           16-way model axis)
* DP     — batch axes on ("pod", "data")
* SP     — long-context KV cache sequence axis on "data" when batch < data
* ZeRO-1 — optimizer moments additionally sharded over "data" on the largest
           still-unsharded divisible axis
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

__all__ = [
    "P",
    "MeshShape",
    "axis_sizes",
    "make_param_specs",
    "zero1_specs",
    "batch_specs",
    "cache_specs",
    "data_axes",
    "spec_tree_map",
    "to_placements",
]


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``. As in JAX, a
    one-name tuple entry is that name and an empty one is ``None``."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e

        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


class MeshShape(NamedTuple):
    """Axis names and extents of a mesh, with no devices behind them."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: extent} of a :class:`MeshShape` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# parameter name -> tensor-axis priority (negative indices, end-anchored)
_RULES = {
    "embed": (-2,),
    "lm_head": (-1,),
    "w_q": (-2, -1),
    "w_k": (-2, -1),
    "w_v": (-2, -1),
    "w_o": (-3, -1),
    "w_uq": (-2, -1),
    "w_uk": (-2, -1),
    "w_uv": (-2, -1),
    "w_dq": (-1,),
    "w_dkv": (-1,),
    "w_kr": (),
    "router": (-1,),
    "w_gate": (-1,),  # mlp (D,F); moe handled by ndim below
    "w_up": (-1,),
    "w_down": (-2,),
    "w_gate_branch": (-1,),
    "w_x_branch": (-1,),
    "w_input_gate": (-1,),
    "w_rec_gate": (-1,),
    "w_out": (-2,),
    "conv_w": (),
    "lam_logit": (),
    "w_i": (),
    "w_f": (),
    "b_f": (),
    "w_z": (-2, -1),
    "r_z": (-1,),
    "r_i": (-1,),
    "r_f": (-1,),
    "r_o": (-1,),
    "scale": (),
}
_MOE_RULES = {  # (E, D, F) / (E, F, D): expert axis first, fallback TP
    "w_gate": (-3, -1),
    "w_up": (-3, -1),
    "w_down": (-3, -2),
}
_MLA_RANK_RULES = {  # shard the latent rank (contraction) axis instead of
    # per-head features: turns per-head feature shards into a single psum
    "w_uq": (-3,),
    "w_uk": (-3,),
    "w_uv": (-3,),
    "w_dq": (-1,),
    "w_dkv": (-1,),
}


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def _model_extent(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def _dp_extent(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in data_axes(mesh):
        out *= sizes[a]
    return out


def spec_tree_map(fn, tree: Dict, *rest: Dict, path: Tuple[str, ...] = ()) -> Dict:
    """``fn(path, leaf, *other_leaves)`` over nested dicts of one structure
    (``path``: the keys from the root)."""
    if isinstance(tree, dict):
        return {k: spec_tree_map(fn, tree[k], *(r[k] for r in rest), path=path + (k,)) for k in tree}
    return fn(path, tree, *rest)


def _leaf_name(path: Sequence[str]) -> str:
    for k in reversed(path):
        if not k.isdigit():
            return k
    return ""


def _first_divisible(shape, prio, m: int) -> P:
    axes: List = [None] * len(shape)
    for ax in prio:
        idx = len(shape) + ax
        if 0 <= idx < len(shape) and shape[idx] % m == 0 and shape[idx] >= m:
            axes[idx] = "model"
            break
    return P(*axes)


def make_param_specs(cfg, params_tree: Dict, mesh) -> Dict:
    """Spec tree matching the (group-stacked) params."""
    mla_rank = getattr(cfg, "mla_shard", "feature") == "rank"
    m = _model_extent(mesh)

    def spec(path, leaf):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        if mla_rank and name in _MLA_RANK_RULES:
            return _first_divisible(shape, _MLA_RANK_RULES[name], m)
        joined = "/".join(path)
        in_moe = "ffn" in joined and cfg.ffn_type == "moe" and "dense_residual" not in joined
        rules = _MOE_RULES if (in_moe and name in _MOE_RULES and len(shape) >= 3) else _RULES
        return _first_divisible(shape, rules.get(name, ()), m)

    return spec_tree_map(spec, params_tree)


def zero1_specs(param_specs: Dict, params_tree: Dict, mesh) -> Dict:
    """Optimizer-moment specs: params' specs + 'data' on the largest
    still-unsharded divisible axis (ZeRO-1 state sharding)."""
    d = axis_sizes(mesh).get("data", 1)

    def add_data(_path, spec: P, leaf):
        shape = tuple(leaf.shape)
        axes = list(spec) + [None] * (len(shape) - len(spec))
        best, best_size = None, 0
        for i, s in enumerate(shape):
            if axes[i] is None and s % d == 0 and s >= d and s > best_size:
                best, best_size = i, s
        if best is not None and best_size >= 2 * d:
            axes[best] = "data"
        return P(*axes)

    return spec_tree_map(add_data, param_specs, params_tree)


def batch_specs(cfg, batch_tree: Dict, mesh) -> Dict:
    """Batch inputs: leading batch axis over (pod, data) when divisible."""
    dp, dp_extent = data_axes(mesh), _dp_extent(mesh)

    def spec(_path, leaf):
        shape = tuple(leaf.shape)
        if shape and shape[0] % dp_extent == 0 and shape[0] >= dp_extent:
            return P(dp)
        return P()

    return spec_tree_map(spec, batch_tree)


def cache_specs(cfg, cache_tree: Dict, mesh) -> Dict:
    """KV / recurrent caches. Leading axis is the layer-group axis (never
    sharded); then (batch, seq/cap, heads, dh). Priority: batch -> DP;
    else cache sequence axis -> 'data' (SP for long-context, batch=1);
    heads/feature axis -> 'model' when divisible."""
    dp, dp_extent = data_axes(mesh), _dp_extent(mesh)
    m = _model_extent(mesh)
    data_extent = axis_sizes(mesh).get("data", 1)

    def spec(_path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) <= 1:  # (G,) scalars like idx
            return P()
        axes: List = [None] * len(shape)
        # axis 1 = batch
        if shape[1] % dp_extent == 0 and shape[1] >= dp_extent:
            axes[1] = dp
        elif len(shape) >= 3 and shape[2] % data_extent == 0 and shape[2] >= 4 * data_extent:
            axes[2] = "data"  # SP over the cache length
        # last axis / heads axis on model
        for i in range(len(shape) - 1, 1, -1):
            if axes[i] is None and shape[i] % m == 0 and shape[i] >= m:
                axes[i] = "model"
                break
        return P(*axes)

    return spec_tree_map(spec, cache_tree)


def to_placements(spec: P, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``), one per
    mesh dimension: ``Shard(i)`` where tensor axis ``i`` names that mesh
    axis, else ``Replicate()``. A tuple entry shards its axis over each named
    mesh axis; they must come in the mesh's order (major to minor, as in
    JAX). A mesh axis of extent 1 replicates: one shard is the whole tensor,
    and DTensor cannot squeeze or view an axis it holds sharded."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    sizes = list(mesh.shape)
    placements = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's order {tuple(names)}")
        for d in dims:
            if sizes[d] > 1:
                placements[d] = Shard(i)
    return placements
