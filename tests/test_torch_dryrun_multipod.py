"""The dry-run on the multi-pod mesh's shape, at reduced size: a fake
process group of 8 ranks and a (2, 2, 2) ("pod", "data", "model") mesh,
counted in two child processes side by side under their own timeout.

(a) The reduced minicpm3, mixtral and starcoder2 train steps run there,
    with the head layouts that failed at full size on 2 x 16 x 16 kept:
    minicpm3's heads not dividing the model extent (5 over 2, as 40 over
    16), mixtral's and starcoder2's KV groups (2 and 1 KV heads).
(b) One device's counted FLOPs of the reduced stablelm train step on
    (2, 2, 2) equal those on a (4, 2) ("data", "model") mesh.
(c) No graph-based redistribute plan (DTensor's Dijkstra search over
    placements, ``DTensorRedistributePlanner.find_min_cost_path``) is made
    while the attention core runs on (2, 2, 2); on (4, 2), where DTensor
    lays the core out, the same count sees its plans.
(d) A one-layer sLSTM's train step at 12 time steps, counted at walks of 4
    and 8 steps and extrapolated (``dryrun.count_step``), equals the full
    walk through DTensor in FLOPs, bytes, and collective bytes and counts by
    kind, with activation checkpointing on as in the full config.
"""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TIMEOUT = 300

WORKER = r"""
import dataclasses, json, math, sys
from torch.distributed.tensor import _redistribute
from repro_torch.configs import get_config
from repro_torch.configs.shapes import _token_batch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.models import abstract_params, attention
from repro_torch.sharding import batch_specs, distribute_tree
from repro_torch.train import AdamWConfig, adamw_init, make_train_step, place_train_state

POD = ((2, 2, 2), ("pod", "data", "model"))
FLAT = ((4, 2), ("data", "model"))
plans = {"core": 0}
depth = [0]
find = _redistribute.DTensorRedistributePlanner.find_min_cost_path


def counted(self, *a, **k):
    plans["core"] += depth[0] > 0
    return find(self, *a, **k)


_redistribute.DTensorRedistributePlanner.find_min_cost_path = counted
core = attention._core


def traced(*a, **k):
    depth[0] += 1
    try:
        return core(*a, **k)
    finally:
        depth[0] -= 1


attention._core = traced


def count(arch, mesh_def, overrides, seq=16, steps=None):
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    with fake_process_group(math.prod(mesh_def[0])):
        mesh = make_mesh(*mesh_def, device_type="cpu")
        b = _token_batch(cfg, 8, seq, True)
        p, o = place_train_state(cfg, abstract_params(cfg), adamw_init(abstract_params(cfg)), mesh)
        args = (p, o, distribute_tree(b, batch_specs(cfg, b, mesh), mesh))
        c = dryrun.count_step(make_train_step(cfg, AdamWConfig()), args, steps)
    return {"flops": c.flops, "bytes": c.bytes, "coll_bytes": c.collectives.bytes_by_kind,
            "coll_counts": c.collectives.count_by_kind}


out = {}
if sys.argv[1] == "0":
    out["minicpm3_4b"] = count("minicpm3_4b", POD, {"n_heads": 5, "n_kv_heads": 5, "n_layers": 1})
    out["mixtral_8x7b"] = count("mixtral_8x7b", POD, {"n_kv_heads": 2, "n_layers": 1})
    out["core_plans_pod"] = plans["core"]
else:
    out["starcoder2_15b"] = count("starcoder2_15b", POD, {"n_kv_heads": 1, "n_layers": 1})
    out["stablelm_pod"] = count("stablelm_1_6b", POD, {"n_layers": 1})
    out["core_plans_pod"] = plans["core"]
    out["stablelm_flat"] = count("stablelm_1_6b", FLAT, {"n_layers": 1})
    out["core_plans_flat"] = plans["core"] - out["core_plans_pod"]
    slstm = {"block_pattern": ("S",), "n_layers": 1, "remat": True}
    out["slstm_full"] = count("xlstm_1_3b", POD, slstm, seq=12)
    out["slstm_walked"] = count("xlstm_1_3b", POD, slstm, seq=12, steps=12)
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def counts():
    """Both halves' counts, each half a child process, the two run side by side."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(half)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for half in (0, 1)]
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            line = [x for x in stdout.splitlines() if x.startswith("RESULT")]
            assert line, stderr[-3000:]
            half = json.loads(line[0][len("RESULT"):])
            out["core_plans_pod"] = out.get("core_plans_pod", 0) + half.pop("core_plans_pod")
            out.update(half)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return out


@pytest.mark.parametrize("arch", ["minicpm3_4b", "mixtral_8x7b", "starcoder2_15b"])
def test_reduced_train_step_runs_on_the_multi_pod_mesh(counts, arch):
    c = counts[arch]
    assert c["flops"] > 0 and c["bytes"] > 0 and sum(c["coll_bytes"].values()) > 0


def test_multi_pod_flops_equal_the_single_axis_batch(counts):
    assert counts["stablelm_pod"]["flops"] == counts["stablelm_flat"]["flops"] > 0


def test_the_attention_core_makes_no_graph_based_plan(counts):
    assert counts["core_plans_flat"] > 0  # on (4, 2) DTensor lays the core out, and the count sees its plans
    assert counts["core_plans_pod"] == 0


@pytest.mark.parametrize("key", ["flops", "bytes", "coll_bytes", "coll_counts"])
def test_slstm_count_extrapolated_in_time_equals_the_full_walk(counts, key):
    full, walked = counts["slstm_full"][key], counts["slstm_walked"][key]
    assert full == walked
    assert full if key in ("flops", "bytes") else sum(full.values()) > 0
