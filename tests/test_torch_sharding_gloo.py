"""The sharded train step rehearsed on the CPU: four processes on ``gloo``
with a (2, 2) ("data", "model") mesh and a (2, 1, 2) ("pod", "data",
"model") mesh (``tests/torch_sharding_worker.py``,
one process per rank, joined through a ``FileStore`` in ``tmp_path``, so
pytest-xdist workers never share a port).

For reduced stablelm, mixtral, minicpm3 (``mla_shard="rank"``),
recurrentgemma and xlstm, the sharded loss, gradients (gathered whole) and
ZeRO-1 AdamW step equal the unsharded ones by the training rule: per leaf
1e-4 of max(1, max |value|), 5e-3 for recurrentgemma and xlstm.
``constrain_acts`` and ``attn_sp`` on give the result they give off, and an
unsharded checkpoint restores into the (2, 2) layout and back bit for bit.
"""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 4
ARCHS = ("stablelm_1_6b", "mixtral_8x7b", "minicpm3_4b", "recurrentgemma_9b", "xlstm_1_3b")
RECURRENT = ("recurrentgemma_9b", "xlstm_1_3b")
TIMEOUT = 300


def tol(arch: str) -> float:
    return 5e-3 if arch in RECURRENT else 1e-4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results, rank by rank."""
    tmp = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, os.path.join(HERE, "torch_sharding_worker.py"), str(r), str(WORLD),
                          str(tmp / "store"), str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(WORLD)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-3000:]}"
    out = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def test_the_ranks_built_one_mesh_and_agree(ranks):
    assert all(r["mesh"] == [["data", "model"], [2, 2]] for r in ranks)
    assert all(r == ranks[0] for r in ranks[1:])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_equal_unsharded(ranks, arch):
    r = ranks[0][arch]
    assert r["model_sharded"] and r["grad_layout_ok"]
    assert r["loss"] <= tol(arch) and r["ce"] <= tol(arch)
    assert r["grads"] <= tol(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_multi_pod_mesh_sharded_loss_and_grads_equal_unsharded(ranks, arch):
    """On (2, 1, 2) ("pod", "data", "model") the batch spans two mesh axes:
    the attention core runs on local shards, the einsums and the MoE layer
    on the mesh's view with its batch axes merged."""
    assert all(r["pod_mesh"] == [["pod", "data", "model"], [2, 1, 2]] for r in ranks)
    r = ranks[0][arch]["pod"]
    assert r["model_sharded"] and r["grad_layout_ok"]
    assert r["loss"] <= tol(arch) and r["ce"] <= tol(arch)
    assert r["grads"] <= tol(arch)


@pytest.mark.parametrize("arch", ("stablelm_1_6b", "xlstm_1_3b"))
def test_multi_pod_mesh_split_contraction_equals_unsharded(ranks, arch):
    """One head on (2, 1, 2): the core splits q.k's contraction over
    "model" and sums the scores."""
    r = ranks[0]["contraction"][arch]
    assert r["model_sharded"] and r["grad_layout_ok"]
    assert r["loss"] <= tol(arch) and r["ce"] <= tol(arch)
    assert r["grads"] <= tol(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_adamw_step_equals_unsharded(ranks, arch):
    r = ranks[0][arch]
    assert r["zero1_sharded"] and r["param_layout_kept"] and r["moment_layout_kept"] and r["count"]
    assert r["grad_norm"] <= tol(arch)
    assert r["params"] <= tol(arch) and r["moments"] <= tol(arch)


@pytest.mark.parametrize("arch", ("stablelm_1_6b", "minicpm3_4b"))
def test_activation_constraints_change_no_result(ranks, arch):
    r = ranks[0][arch]
    assert r["constrained_loss"] <= tol(arch) and r["constrained_grads"] <= tol(arch)


def test_checkpoint_restores_into_the_mesh_and_back(ranks):
    r = ranks[0]["checkpoint"]
    assert r["step"] == 3 and r["meta"] == {"step": 3}
    assert r["placed"] and r["sharded"]
    assert r["into_mesh_equal"] and r["back_equal"]
