"""The port's public surface against the reference's: every public module
attribute of ``repro`` has its counterpart in ``repro_torch`` but for one
commented list; the packages' exports; the sharing layer's constructors
(the same words for the same PRF keys); the LM side's leftovers (the
serve step's ``apply_norm``, the roofline's HLO text parsers, the dry-run's
1-group / 2-group extrapolation)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import prf as jprf  # noqa: E402
from repro.core import sharing as jsharing  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch.core import ring as tring  # noqa: E402
from repro_torch.core import sharing as tsharing  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.interop import prf_from_numpy  # noqa: E402
from repro_torch.launch import roofline as troofline  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# Modules (and a typing name) that a module of ``repro`` only imports: they
# may be absent from any module of the port.
IMPORTS = {"jax", "jnp", "np", "functools", "OrderedDict", "Any"}

# The other public names of a module of ``repro`` that its namesake in
# ``repro_torch`` lacks. Nothing else may be absent, and every name here
# must still be.
ABSENT = {
    # the Pallas switch: the port has no interpret-mode kernel layer to turn
    # off (a CPU tensor runs the plain versions, a CUDA tensor the kernels)
    "kernels": {"kernels_enabled", "override_kernels"},
    "core.circuits": {"kernels_enabled", "log_comm"},  # log_comm: re-imported
    "core.sharing": {"kernels_enabled", "default_ring"},  # default_ring: re-imported
    "core.prf": {"default_ring"},  # re-imported
    "core.sort": {"active_ledger"},  # re-imported
    # imported from the reference's jax / jit stack and its own modules
    "launch.dryrun": {"NamedSharding", "P", "adamw_update", "loss_fn", "make_production_mesh",
                      "parse_collectives", "zero1_specs"},
    "sharding.rules": {"Mesh"},
    # the TPU's inter-chip link rate: the port's links are NVLink and
    # InfiniBand (NVLINK_BW, IB_BW, link_bandwidth)
    "launch.roofline": {"ICI_BW"},
    # the reference renders EXPERIMENTS.md; the port its own page (PAGE)
    "launch.render_experiments": {"EXP"},
}


SURFACE = r"""
import importlib, json, sys
from pathlib import Path
src = Path(sys.argv[1])

def modules(pkg):
    for p in sorted((src / pkg).rglob("*.py")):
        rel = p.relative_to(src / pkg).with_suffix("").parts
        if rel[-1] == "__init__":
            rel = rel[:-1]
        if rel[:1] == ("kernels",) and len(rel) > 1:  # a kernel's own modules
            continue
        yield ".".join(rel)

diff = {}
for rel in modules("repro"):
    ref = importlib.import_module("repro" + ("." + rel if rel else ""))
    port = importlib.import_module("repro_torch" + ("." + rel if rel else ""))
    public = lambda m: {n for n in vars(m) if not n.startswith("_")}
    diff[rel] = sorted(public(ref) - public(port))
print("SURFACE" + json.dumps(diff))
"""


def test_every_public_name_of_the_reference_has_its_counterpart():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", SURFACE, str(SRC)], env=env, capture_output=True, text=True,
                         timeout=300)
    line = [x for x in res.stdout.splitlines() if x.startswith("SURFACE")]
    assert line, res.stderr[-3000:]
    diff = json.loads(line[0][len("SURFACE"):])
    missing = {m: sorted(set(names) - IMPORTS - ABSENT.get(m, set())) for m, names in diff.items()}
    assert not {m: v for m, v in missing.items() if v}, missing
    # the list holds no name the port now has: a gap closed leaves it
    stale = {m: sorted(names - set(diff.get(m, ()))) for m, names in ABSENT.items()}
    assert not {m: v for m, v in stale.items() if v}, stale


@pytest.mark.parametrize("package,names", [
    ("ops", ["oblivious_filter", "oblivious_join", "oblivious_groupby_count", "oblivious_groupby_sum",
             "oblivious_groupby_avg", "oblivious_orderby", "oblivious_distinct", "count_valid",
             "count_distinct", "sum_column", "avg_column", "min_column", "max_column"]),
    ("plan", ["OperatorDef", "PlanSchema", "SchemaError", "infer_schema", "lookup", "register", "registered_ops"]),
    ("data", ["DIAG_HEART_DISEASE", "DOSAGE_325MG", "ICD9_CIRCULATORY", "ICD9_HEART_414", "MED_ASPIRIN"]),
])
def test_packages_export_the_references_names(package, names):
    import importlib

    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    for name in names:
        assert hasattr(ref, name)
        got = getattr(port, name)
        assert name in port.__all__
        if package == "data":
            assert got == getattr(ref, name)
        else:  # a re-export of an object its own module defines
            assert getattr(importlib.import_module(got.__module__), got.__name__) is got


def _prfs(seed):
    jp = jprf.setup_prf(jax.random.PRNGKey(seed))
    return jp, prf_from_numpy(np.asarray(jp.pair_keys))


@pytest.mark.parametrize("shape", [(5,), (3, 4)])
def test_random_constructors_give_the_references_words(shape):
    jp, tp = _prfs(12)
    for tag, (jfn, tfn) in enumerate([
        (jsharing.rand_ashare, tsharing.rand_ashare),
        (jsharing.rand_bshare, tsharing.rand_bshare),
    ]):
        want = np.asarray(jfn(jp.fold(tag), shape).shares)
        assert (to_numpy(tfn(tp.fold(tag), shape, "cpu").shares) == want).all()
    for tag, name in enumerate(("rand_replicated", "zero_share_add", "zero_share_xor"), start=10):
        want = np.asarray(getattr(jsharing, name)(jp.fold(tag), shape))
        assert (to_numpy(getattr(tsharing, name)(tp.fold(tag), shape, "cpu")) == want).all()


def test_public_constructors_give_the_references_words():
    assert tsharing.NUM_PARTIES == jsharing.NUM_PARTIES == 3
    assert tring.default_ring().bits == jsharing.default_ring().bits == 32
    for jz, tz in ((jsharing.zeros_a, tsharing.zeros_a), (jsharing.zeros_b, tsharing.zeros_b)):
        got = tz((2, 3), "cpu")
        assert type(got).__name__ == type(jz((2, 3))).__name__
        assert (to_numpy(got.shares) == np.asarray(jz((2, 3)).shares)).all()
    values = np.array([0, 1, 2**31, 2**32 - 1], dtype=np.uint32)
    for value, shape in ((7, (4,)), (-5, (2, 2)), (values, (4,))):
        want = np.asarray(jsharing.const_a(value, shape).shares)
        assert (to_numpy(tsharing.const_a(value, shape, "cpu").shares) == want).all()
    wide = tsharing.const_a(2**40 + 3, (2,), "cpu", ring=tring.RING64)
    assert to_numpy(wide.shares[0]).tolist() == [2**40 + 3] * 2


def test_serve_step_reexports_apply_norm():
    from repro_torch.models.layers import apply_norm
    from repro_torch.serve import serve_step

    assert serve_step.apply_norm is apply_norm


SHAPES = ["bf16[4,8]{1,0}", "f32[10]", "(bf16[2,2]{1,0}, s32[4])", "pred[8]", "token[]", "f8e4m3fn[3,3]", "q7[2]"]
HLO = """
HloModule test
ENTRY main {
  %p0 = bf16[64,128]{1,0} parameter(0)
  %ar = bf16[64,128]{1,0} all-reduce(%p0), replica_groups={}
  %ag = bf16[128,128]{1,0} all-gather(%ar), dimensions={0}
  %cp.1 = f32[32]{0} constant(0)
  %perm = f32[32]{0} collective-permute(%cp.1), source_target_pairs={{0,1}}
  %ags = (f32[4,32]{1,0}, f32[8,32]{1,0}) all-gather-start(f32[4,32]{1,0} %cp.1), dimensions={0}
  %agd = f32[8,32]{1,0} all-gather-done(%ags)
  %a2a = s32[16]{0} all-to-all(%x, %y), dimensions={0}
  ROOT %t = (bf16[128,128]{1,0}) tuple(%ag)
}
"""


@pytest.mark.parametrize("shape", SHAPES)
def test_shape_bytes_equals_the_reference(shape):
    assert troofline.shape_bytes(shape) == jroofline.shape_bytes(shape)


def test_parse_collectives_equals_the_reference():
    got, want = troofline.parse_collectives(HLO), jroofline.parse_collectives(HLO)
    assert got.bytes_by_kind == want.bytes_by_kind and got.count_by_kind == want.count_by_kind
    # the reference's own case (tests/test_launch.py)
    assert got.count_by_kind["all-gather"] == 2 and got.bytes_by_kind["all-reduce"] == 64 * 128 * 2
    assert got.bytes_by_kind["collective-permute"] == 32 * 4 and got.total_bytes == want.total_bytes


EXTRAPOLATE = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.launch.roofline import cost_analysis_of
shape = sys.argv[1]


def full(mesh, cfg):
    _, step, args = dryrun.build_cell("stablelm_1_6b", shape, mesh, cfg)
    c = dryrun.count_step(step, args)
    ca = cost_analysis_of(c)
    return {"flops": ca["flops"], "bytes": ca["bytes accessed"], "coll_bytes": c.collectives.total_bytes,
            "coll_by_kind": c.collectives.bytes_by_kind, "coll_counts": c.collectives.count_by_kind}


with fake_process_group(4):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg = dataclasses.asdict(get_config("stablelm_1_6b").reduced())
    cfg["n_layers"] = 5
    cold = full(mesh, cfg)  # the first count in the process
    ext = dryrun.extrapolated_costs("stablelm_1_6b", shape, mesh, cfg)
    c1 = dryrun._measure("stablelm_1_6b", shape, mesh, 1, cfg)
    c2 = dryrun._measure("stablelm_1_6b", shape, mesh, 2, cfg)
    warm = full(mesh, cfg)
print("RESULT" + json.dumps({"ext": ext, "cold": cold, "full": warm, "c1": c1, "c2": c2}))
"""


@pytest.fixture(scope="module", params=["prefill_32k", "decode_32k"])
def extrapolation(request):
    """A reduced stablelm cut to 5 layers on a fake (2, 2) mesh, counted in
    a process of its own: at full depth first (cold), then at 1 and 2
    pattern groups and extrapolated, then at full depth again (warm)."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", EXTRAPOLATE, request.param], env=env, capture_output=True,
                         text=True, timeout=600)
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT")]
    assert line, res.stderr[-3000:]
    return json.loads(line[0][len("RESULT"):])


def test_extrapolated_costs_equal_the_full_depth_count(extrapolation):
    """The 1-group / 2-group extrapolation equals the count of the step at
    its full 5 layers in FLOPs, bytes and collective bytes. The collective
    bytes and counts of each kind are linear in depth too, but the
    reference floors each fixed term at 0: where it is negative (the first
    layer issues fewer all-gathers or all-to-alls than each later one) the
    extrapolated figure exceeds the full one by exactly that term."""
    ext, full, c1, c2 = (extrapolation[k] for k in ("ext", "full", "c1", "c2"))
    assert full["flops"] > 0 and full["coll_bytes"] > 0
    for k in ("flops", "bytes", "coll_bytes"):
        assert ext[k] == full[k], k
    for key in ("coll_by_kind", "coll_counts"):
        for kind, n in full[key].items():
            a, b = c1[key][kind], c2[key][kind]
            assert n == (b - a) * 5 + (2 * a - b), (key, kind)  # linear in depth
            assert ext[key][kind] == n + max(b - 2 * a, 0), (key, kind)


def test_step_counter_counts_a_cell_the_same_cold_and_warm(extrapolation):
    """A cell's first count in a process equals its count after other
    counts: DTensor's sharding propagation, which runs operations on meta
    tensors the first time it meets a signature, is not counted."""
    assert extrapolation["cold"] == extrapolation["full"]
