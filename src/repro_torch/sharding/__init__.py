"""Sharding: the reference's rules (a port of ``repro.sharding``) and their
DTensor placement (``placement``)."""
from .rules import (  # noqa: F401
    MeshShape,
    P,
    axis_sizes,
    batch_specs,
    cache_specs,
    data_axes,
    make_param_specs,
    spec_tree_map,
    to_placements,
    zero1_specs,
)
from .placement import (  # noqa: F401
    NamedSharding,
    distribute_tree,
    einsum,
    gather_tree,
    is_sharded,
    named,
    reduce_partial,
    replicated,
    reshape,
    sharded_region,
    with_sharding_constraint,
)
