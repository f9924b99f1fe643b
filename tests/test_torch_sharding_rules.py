"""The port's sharding rules against ``repro.sharding``: the spec trees of
params (``mla_shard`` feature and rank), ZeRO-1 moments, batches and caches
equal the reference's axis name for axis name, for all ten architectures at
full size and the four shapes, on the (2, 4), (16, 16) and (2, 16, 16)
meshes. The reference runs on ``jax.sharding.AbstractMesh``, the port on its
``MeshShape`` over ``configs.shapes``' ``meta`` trees; neither needs a device.
``to_placements`` is checked on a fake process group in a child process."""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.configs.shapes import SHAPE_NAMES
from repro.configs.shapes import input_specs as ref_input_specs
from repro.models import abstract_params as ref_abstract_params
from repro.sharding import batch_specs as ref_batch_specs
from repro.sharding import cache_specs as ref_cache_specs
from repro.sharding import make_param_specs as ref_param_specs
from repro.sharding import zero1_specs as ref_zero1_specs
from repro_torch.configs import get_config
from repro_torch.configs.shapes import input_specs
from repro_torch.models import abstract_params
from repro_torch.models.lm import tree_items
from repro_torch.sharding import (
    MeshShape,
    P,
    batch_specs,
    cache_specs,
    data_axes,
    make_param_specs,
    zero1_specs,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
DECODE_SHAPES = [s for s in SHAPE_NAMES if s in ("decode_32k", "long_500k")]


def ref_tree(specs):
    """The reference's spec tree as nested dicts of entry tuples."""
    return jax.tree.map(tuple, specs, is_leaf=lambda x: isinstance(x, PartitionSpec))


def port_tree(specs):
    """The port's spec tree as nested dicts of entry tuples (every leaf a ``P``)."""
    if isinstance(specs, dict):
        return {k: port_tree(v) for k, v in specs.items()}
    assert isinstance(specs, P), specs
    return tuple(specs)


def meshes(name):
    shape, names = MESHES[name]
    return AbstractMesh(shape, names), MeshShape(names, shape)


@functools.cache
def ref_params(arch, mla):
    cfg = dataclasses.replace(ref_config(arch), mla_shard=mla)
    return cfg, ref_abstract_params(cfg)


@functools.cache
def port_params(arch, mla):
    cfg = dataclasses.replace(get_config(arch), mla_shard=mla)
    return cfg, abstract_params(cfg)


@functools.cache
def inputs(arch, shape):
    return ref_input_specs(ref_config(arch), shape), input_specs(get_config(arch), shape)


@pytest.mark.parametrize("mla", ["feature", "rank"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh, mla):
    jmesh, tmesh = meshes(mesh)
    (jcfg, jtree), (tcfg, ttree) = ref_params(arch, mla), port_params(arch, mla)
    assert port_tree(make_param_specs(tcfg, ttree, tmesh)) == ref_tree(ref_param_specs(jcfg, jtree, jmesh))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_specs_equal_the_reference(arch, mesh):
    jmesh, tmesh = meshes(mesh)
    (jcfg, jtree), (tcfg, ttree) = ref_params(arch, "feature"), port_params(arch, "feature")
    want = ref_zero1_specs(ref_param_specs(jcfg, jtree, jmesh), jtree, jmesh)
    got = zero1_specs(make_param_specs(tcfg, ttree, tmesh), ttree, tmesh)
    assert port_tree(got) == ref_tree(want)


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_specs_equal_the_reference(arch, mesh, shape):
    jmesh, tmesh = meshes(mesh)
    jin, tin = inputs(arch, shape)
    assert port_tree(batch_specs(None, tin["batch"], tmesh)) == ref_tree(ref_batch_specs(None, jin["batch"], jmesh))


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_reference(arch, mesh, shape):
    jmesh, tmesh = meshes(mesh)
    jin, tin = inputs(arch, shape)
    assert port_tree(cache_specs(None, tin["caches"], tmesh)) == ref_tree(ref_cache_specs(None, jin["caches"], jmesh))


def _check_divides(tree, specs, mesh):
    sizes = dict(zip(mesh.names, mesh.sizes))
    for (path, leaf), (_, spec) in zip(tree_items(tree), tree_items(specs)):
        assert len(spec) <= leaf.dim(), (path, spec)
        for i, ax in enumerate(spec):
            if ax is not None:
                ext = 1
                for a in ax if isinstance(ax, tuple) else (ax,):
                    ext *= sizes[a]
                assert leaf.shape[i] % ext == 0, (path, tuple(leaf.shape), spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_sharding_rules_divisibility(arch):
    """Every generated spec divides its tensor on a small mesh (the
    reference's ``test_param_sharding_rules_divisibility``)."""
    from repro_torch.models import init_caches

    mesh = MeshShape(("data", "model"), (2, 4))
    cfg, tree = port_params(arch, "feature")
    specs = make_param_specs(cfg, tree, mesh)
    _check_divides(tree, specs, mesh)
    _check_divides(tree, zero1_specs(specs, tree, mesh), mesh)
    caches = init_caches(cfg, 16, 128, device="meta")
    _check_divides(caches, cache_specs(cfg, caches, mesh), mesh)


def test_spec_type_reads_like_a_partition_spec():
    assert P(("data",), None, ()) == ("data", None, None)
    assert P(("pod", "data"), "model") == (("pod", "data"), "model")
    assert repr(P(("pod", "data"), None)) == "P(('pod', 'data'), None)"
    assert data_axes(MeshShape(("pod", "data", "model"), (2, 16, 16))) == ("pod", "data")
    assert data_axes(MeshShape(("model",), (4,))) == ()


PLACEMENTS = r"""
import json, torch
from torch.distributed.tensor import Replicate
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.sharding import P, axis_sizes, batch_specs, to_placements
out = {}
with fake_process_group(8):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    out["sizes"] = axis_sizes(mesh)
    cases = {"tuple": P(("pod", "data"), "model"), "one": P(None, "data"), "none": P()}
    out["placements"] = {k: [repr(p) for p in to_placements(s, mesh)] for k, s in cases.items()}
    for bad, spec in (("order", P(("data", "pod"))), ("missing", P("expert"))):
        try:
            to_placements(spec, mesh)
            out[bad] = "accepted"
        except ValueError:
            out[bad] = "ValueError"
    spec = batch_specs(None, {"tokens": torch.empty(8, 16, device="meta")}, mesh)["tokens"]
    out["batch_spec"] = list(spec)
    from torch.distributed.tensor import distribute_tensor
    t = distribute_tensor(torch.empty(8, 6, device="meta"), mesh, to_placements(P(("pod", "data"), "model"), mesh))
    out["local"] = list(t.to_local().shape)
with fake_process_group(8):
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.sharding import einsum, reshape
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    # 8 query heads over a 4-way axis viewed as 2 KV groups of 4: DTensor
    # refuses the split, the helper gathers the head axis first
    q = distribute_tensor(torch.empty(4, 16, 8, 32, device="meta"), mesh, to_placements(P("data", None, "model"), mesh))
    try:
        q.reshape(4, 16, 2, 4, 32)
        out["plain_reshape"] = "accepted"
    except RuntimeError:
        out["plain_reshape"] = "refused"
    g = reshape(q, 4, 16, 2, 4, 32)
    out["reshape"] = [list(g.shape), [repr(p) for p in g.placements]]
    # 6 capacity slots over a 4-way axis: an uneven shard einsum cannot flatten
    eo = DTensor.from_local(torch.empty(2, 2, 8, device="meta"), mesh, [Replicate(), Shard(1)], run_check=False,
                            shape=torch.Size([2, 6, 8]), stride=(48, 8, 1))
    comb = distribute_tensor(torch.empty(5, 2, 6, device="meta"), mesh, [Replicate(), Replicate()])
    y = einsum("ecd,tec->td", eo, comb)
    out["einsum"] = list(y.shape)
    a, b = torch.randn(3, 4), torch.randn(4, 5)
    out["plain_same"] = bool(torch.equal(einsum("ij,jk->ik", a, b), torch.einsum("ij,jk->ik", a, b)))
with fake_process_group(2):
    # an axis of extent 1 replicates: one shard is the whole tensor
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    out["extent_one"] = [repr(p) for p in to_placements(P("data", "model"), mesh)]
print("RESULT" + json.dumps(out))
"""


def test_to_placements_and_the_view_helpers():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", PLACEMENTS], env=env, capture_output=True, text=True, timeout=120)
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT")]
    assert line, res.stderr[-2000:]
    out = json.loads(line[0][len("RESULT"):])
    assert out["sizes"] == {"pod": 2, "data": 2, "model": 2}
    assert out["placements"] == {
        "tuple": ["Shard(dim=0)", "Shard(dim=0)", "Shard(dim=1)"],
        "one": ["Replicate()", "Shard(dim=1)", "Replicate()"],
        "none": ["Replicate()", "Replicate()", "Replicate()"],
    }
    assert out["order"] == out["missing"] == "ValueError"
    assert out["batch_spec"] == [["pod", "data"]]
    assert out["local"] == [2, 3]
    assert out["extent_one"] == ["Replicate()", "Shard(dim=1)"]
    assert out["plain_reshape"] == "refused"
    assert out["reshape"] == [[4, 16, 2, 4, 32], ["Shard(dim=0)", "Replicate()"]]
    assert out["einsum"] == [5, 8] and out["plain_same"]
