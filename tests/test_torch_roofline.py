"""The port's roofline and dry-run (``repro_torch.launch``): the H100
formulas, ``model_flops_for`` / ``analytic_bytes_for`` against
``repro.launch.roofline``, the step counter's collectives and FLOP rule, a
mini dry-run on a fake (2, 4) mesh (the counterpart of
``tests/test_launch.py::test_small_mesh_dryrun_compiles``), the hillclimb's
variants and the page's rendering. The counter's cases run on a fake
process group in a child process under its own timeout."""
import functools
import json
import os
import subprocess
import sys

import pytest

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.configs.shapes import SHAPE_NAMES
from repro.launch.hillclimb import VARIANTS as REF_VARIANTS
from repro.launch.roofline import analytic_bytes_for as ref_analytic_bytes
from repro.launch.roofline import model_flops_for as ref_model_flops
from repro_torch.configs import get_config
from repro_torch.launch import render_experiments
from repro_torch.launch.hillclimb import VARIANTS
from repro_torch.launch.roofline import (
    HBM_BW,
    IB_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    CollectiveStats,
    Roofline,
    analytic_bytes_for,
    link_bandwidth,
    model_flops_for,
)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_h100_constants():
    assert PEAK_FLOPS == 989e12 and HBM_BW == 3.35e12
    assert NVLINK_BW == 450e9 and IB_BW == 50e9
    assert link_bandwidth(1) == link_bandwidth(8) == NVLINK_BW
    assert link_bandwidth(256) == link_bandwidth(512) == IB_BW


def test_roofline_terms_and_bottleneck():
    r = Roofline(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        hlo_flops=1e18, hlo_bytes=1e12, collective_bytes=1e15,
        collectives={}, collective_counts={}, model_flops=5e17,
    )
    assert r.t_compute == pytest.approx(1e18 / (256 * 989e12))
    assert r.t_memory == pytest.approx(1e12 / (256 * 3.35e12))
    assert r.t_collective == pytest.approx(1e15 / (256 * 50e9))
    assert r.bottleneck == "collective"
    assert 0 < r.roofline_fraction < 1
    assert r.useful_ratio == pytest.approx(0.5)
    row = r.row()
    for key in ("t_compute_s", "t_memory_s", "t_collective_s", "bottleneck", "useful_flops_ratio",
                "roofline_fraction", "collective_breakdown", "collective_counts", "bytes_per_device"):
        assert key in row


def test_roofline_within_one_node_uses_nvlink():
    r = Roofline(arch="x", shape="decode_32k", mesh="1x1", chips=1, hlo_flops=1e9, hlo_bytes=3.35e9,
                 collective_bytes=0.0, collectives={}, collective_counts={}, model_flops=1e9)
    assert r.t_memory == pytest.approx(1e-3)
    assert r.bottleneck == "memory" and r.t_collective == 0.0
    assert CollectiveStats({"all-gather": 3, "all-reduce": 4}, {}).total_bytes == 7


@pytest.fixture(scope="module")
def counted_once():
    """Both packages' parameter counts cached per config for this module
    (each count builds the full abstract tree)."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (type(ref_config(ARCH_IDS[0])), type(get_config(ARCH_IDS[0]))):
            for name in ("param_count", "active_param_count"):
                mp.setattr(cls, name, functools.cache(getattr(cls, name)))
        yield


@pytest.mark.parametrize("shape", SHAPE_NAMES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_and_analytic_bytes_equal_the_reference(counted_once, arch, shape):
    assert model_flops_for(get_config(arch), shape) == ref_model_flops(ref_config(arch), shape)
    assert analytic_bytes_for(get_config(arch), shape) == ref_analytic_bytes(ref_config(arch), shape)


def test_variants_are_the_references():
    assert list(VARIANTS) == list(REF_VARIANTS)
    assert VARIANTS == REF_VARIANTS


COUNTER = r"""
import dataclasses, json, torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.launch.roofline import StepCounter
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
out = {}
with fake_process_group(4):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    x = DTensor.from_local(torch.empty(8, 6, device="meta"), mesh, [Shard(0), Shard(1)], run_check=False)
    with StepCounter() as c:
        x.redistribute(mesh, [Replicate(), Shard(1)])          # all-gather over data
    out["gather"] = [c.collectives.bytes_by_kind, c.collectives.count_by_kind]
    y = DTensor.from_local(torch.empty(8, 12, device="meta"), mesh, [Shard(0), Replicate()], run_check=False)
    with StepCounter() as c:
        y.redistribute(mesh, [Shard(1), Replicate()])          # shard to shard over data: all-to-all
    out["a2a"] = [c.collectives.bytes_by_kind, c.collectives.count_by_kind]
    p = DTensor.from_local(torch.empty(8, 6, device="meta"), mesh, [Partial(), Replicate()], run_check=False)
    with StepCounter() as c:
        p.redistribute(mesh, [Replicate(), Replicate()])       # all-reduce
        p.redistribute(mesh, [Shard(0), Replicate()])          # reduce-scatter
    out["reduce"] = [c.collectives.bytes_by_kind, c.collectives.count_by_kind]
    # FLOPs are one device's work: a replicated matmul counts every device's copy
    a, b = torch.empty(64, 32, device="meta"), torch.empty(32, 16, device="meta")
    rep = [distribute_tensor(t, mesh, [Replicate(), Replicate()]) for t in (a, b)]
    shd = [distribute_tensor(a, mesh, [Shard(0), Shard(0)]), distribute_tensor(b, mesh, [Replicate(), Replicate()])]
    with StepCounter() as c:
        rep[0] @ rep[1]
    out["flops_replicated"] = c.flops
    with StepCounter() as c:
        shd[0] @ shd[1]
    out["flops_sharded"] = c.flops
    with StepCounter() as c:
        a @ b
    out["flops_plain"], out["bytes_plain"] = c.flops, c.bytes
with fake_process_group(8):
    # the mini dry-run: reduced stablelm, one train step on a fake 2x4 mesh
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    reduced = dataclasses.asdict(get_config("stablelm_1_6b").reduced())
    cfg, step, args = dryrun.build_cell("stablelm_1_6b", "train_4k", mesh, reduced)
    c = dryrun.count_step(step, args)
    out["mini"] = {"flops": c.flops, "bytes": c.bytes, "coll": c.collectives.total_bytes,
                   "counts": c.collectives.count_by_kind, "ops": c.ops}
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", COUNTER], env=env, capture_output=True, text=True, timeout=300)
    line = [x for x in res.stdout.splitlines() if x.startswith("RESULT")]
    assert line, res.stderr[-3000:]
    return json.loads(line[0][len("RESULT"):])


NONE = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}


def test_counter_records_an_all_gather_by_its_operand(counted):
    nbytes, counts = counted["gather"]
    assert counts == dict(NONE, **{"all-gather": 1})
    assert nbytes == dict(NONE, **{"all-gather": 8 * 6 * 4})  # one device's shard, f32


def test_counter_records_the_all_to_all_nccl_would_issue(counted):
    # the CPU group runs a shard-to-shard move as an all-gather and a chunk;
    # the counter records one all-to-all and no all-gather
    nbytes, counts = counted["a2a"]
    assert counts == dict(NONE, **{"all-to-all": 1})
    assert nbytes == dict(NONE, **{"all-to-all": 8 * 12 * 4})


def test_counter_records_reductions_by_kind(counted):
    nbytes, counts = counted["reduce"]
    assert counts == dict(NONE, **{"all-reduce": 1, "reduce-scatter": 1})
    assert nbytes == dict(NONE, **{"all-reduce": 8 * 6 * 4, "reduce-scatter": 8 * 6 * 4})


def test_flops_are_local_work(counted):
    assert counted["flops_plain"] == 2 * 64 * 32 * 16
    assert counted["flops_replicated"] == counted["flops_plain"]
    # times chips (4), the replicated matmul counts 4x what the sharded one does
    assert counted["flops_replicated"] == 4 * counted["flops_sharded"]
    assert counted["bytes_plain"] == (64 * 32 + 32 * 16 + 64 * 16) * 4


def test_small_mesh_dryrun_counts_flops_and_collectives(counted):
    mini = counted["mini"]
    assert mini["flops"] > 0 and mini["bytes"] > 0 and mini["ops"] > 0
    assert mini["coll"] > 0, "expected collectives from TP sharding"
    assert mini["counts"]["all-gather"] + mini["counts"]["all-reduce"] + mini["counts"]["reduce-scatter"] > 0


def _row(arch, shape, mesh, status="ok", **kw):
    row = {"arch": arch, "shape": shape, "mesh": mesh, "status": status}
    if status == "ok":
        row.update({"t_compute_s": 1e-2, "t_memory_s": 2e-2, "t_collective_s": 3e-3, "bottleneck": "memory",
                    "useful_flops_ratio": 0.75, "roofline_fraction": 0.125, "bytes_per_device": 2**31})
    row.update(kw)
    return row


def test_render_writes_the_page_and_renders_again(tmp_path):
    rows = [
        _row("stablelm_1_6b", "train_4k", "16x16"),
        _row("stablelm_1_6b", "long_500k", "16x16", status="skipped", reason="pure full attention"),
        _row("xlstm_1_3b", "prefill_32k", "2x16x16", status="error", error="RuntimeError: boom"),
    ]
    perf = tmp_path / "perf_torch_stablelm_1_6b_train_4k.json"
    perf.write_text(json.dumps([
        dict(_row("stablelm_1_6b", "train_4k", "16x16"), variant="baseline", hypothesis="base"),
        dict(_row("stablelm_1_6b", "train_4k", "16x16", roofline_fraction=0.25), variant="remat_off",
             hypothesis="no recompute"),
    ]))
    page = tmp_path / "ROOFLINE_TORCH.md"
    text = render_experiments.render(rows, [str(perf)], str(page))
    assert page.read_text() == text
    assert "bounds, not measurements" in text
    assert "| stablelm_1_6b | train_4k | 16x16 | 1.00e-02 | 2.00e-02 | 3.00e-03 | memory | 0.75 | 0.1250 | 2.00 |" in text
    assert "| stablelm_1_6b | long_500k | 16x16 | — | — | — | N/A |" in text
    assert "| xlstm_1_3b | prefill_32k | 2x16x16 | ERROR |" in text
    assert "`xlstm_1_3b/prefill_32k/2x16x16`: RuntimeError: boom" in text
    assert "| remat_off | no recompute |" in text and "+100.0% frac" in text
    for marker in render_experiments.TABLE + render_experiments.PERF:
        assert text.count(marker) == 1
    assert render_experiments.render(rows, [str(perf)], str(page)) == text
