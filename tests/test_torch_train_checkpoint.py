"""The port's ``Checkpointer`` (``repro_torch.train.checkpoint``): the
reference's checkpoint tests on the port (round trip and keep-k, no ``.tmp``
left, async saves, bitwise resume of the train step), the on-disk layout of
``repro.train.Checkpointer`` (leaves in JAX's flatten order, the manifest's
``treedef`` as JAX writes it) so that each package restores the other's
checkpoints with equal arrays and dtypes, and restore onto a device."""
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.train as jt  # noqa: E402
import repro_torch.train as tt  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.interop import opt_state_from_numpy  # noqa: E402
from repro_torch.models import abstract_params, init_params  # noqa: E402
from repro_torch.models.lm import tree_items, tree_map  # noqa: E402
from repro_torch.train.checkpoint import tree_description  # noqa: E402
from torch_lm_parity import configs, params  # noqa: E402


def _tiny(seed=0):
    _, cfg = configs("stablelm_1_6b")
    p = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    opt = tt.adamw_init(p)
    pipe = TokenPipeline(cfg.vocab_size, 16, 4, seed=7)
    step = tt.make_train_step(cfg, tt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    return cfg, p, opt, pipe, step


def _run(p, opt, pipe, step, start, n):
    for s in range(start, start + n):
        p, opt, m = step(p, opt, {k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()})
    return p, opt, m


def _equal_trees(a, b):
    la, lb = list(tree_items(a)), list(tree_items(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_checkpoint_roundtrip_and_gc(tmp_path):
    _, p, opt, _, _ = _tiny()
    ck = tt.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        ck.save(s, {"params": p, "opt": opt, "meta": {"x": s}})
    assert ck.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    step, state = ck.restore(None, {"params": p, "opt": opt, "meta": {}})
    assert step == 3 and state["meta"]["x"] == 3
    _equal_trees(state["params"], p)
    _equal_trees(state["opt"], opt)
    assert state["opt"]["count"].dtype == torch.int32


def test_resume_is_bitwise_identical(tmp_path):
    """interrupted-at-3 + resumed == uninterrupted 6 steps."""
    _, p0, o0, pipe, step = _tiny()
    pu, ou, _ = _run(p0, o0, pipe, step, 0, 6)
    pa, oa, _ = _run(p0, o0, pipe, step, 0, 3)
    ck = tt.Checkpointer(str(tmp_path))
    ck.save(3, {"params": pa, "opt": oa, "meta": {}})
    del pa, oa
    _, p1, o1, _, _ = _tiny(seed=5)  # a fresh template, other values
    s, st = ck.restore(None, {"params": p1, "opt": o1, "meta": {}})
    pb, ob, _ = _run(st["params"], st["opt"], pipe, step, s, 3)
    _equal_trees(pu, pb)
    _equal_trees(ou, ob)


def test_async_checkpoint(tmp_path):
    _, p, opt, _, _ = _tiny()
    ck = tt.Checkpointer(str(tmp_path))
    state = {"params": p, "opt": opt, "meta": {"a": 1}}
    embed = p["embed"].clone()
    ck.save_async(5, state)
    # the snapshot was taken: later writes to the tensors do not reach the file
    p["embed"].add_(1.0)
    ck.wait()
    assert ck.latest_step() == 5 and state["meta"] == {"a": 1}
    _, back = ck.restore(5, {"params": p, "opt": opt})
    assert torch.equal(back["params"]["embed"], embed)


def test_atomicity_no_tmp_left(tmp_path):
    _, p, opt, _, _ = _tiny()
    ck = tt.Checkpointer(str(tmp_path))
    state = {"params": p, "opt": opt, "meta": {"k": "v"}}
    ck.save(1, state)
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert state["meta"] == {"k": "v"}  # the caller's dict keeps its meta
    # a stale .tmp from a crash is neither listed nor in the way
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert ck.latest_step() == 1
    ck.save(9, state)
    assert ck.latest_step() == 9 and not (tmp_path / "step_00000009.tmp").exists()


def test_restore_refuses_another_structure(tmp_path):
    _, p, opt, _, _ = _tiny()
    ck = tt.Checkpointer(str(tmp_path))
    ck.save(1, {"params": p, "opt": opt})
    with pytest.raises(ValueError, match="template"):
        ck.restore(1, {"params": p})
    with pytest.raises(FileNotFoundError):
        tt.Checkpointer(str(tmp_path / "empty")).restore(None, {"params": p})


def test_restore_onto_a_device_and_onto_meta_templates(tmp_path):
    cfg, p, opt, _, _ = _tiny()
    ck = tt.Checkpointer(str(tmp_path))
    ck.save(4, {"params": p, "opt": opt})
    meta = {"params": abstract_params(cfg), "opt": tree_map(lambda t: t.to("meta"), opt)}
    _, st = ck.restore(4, meta, device="cpu")
    _equal_trees(st["params"], p)
    _equal_trees(st["opt"], opt)


def _jax_state(seed=0):
    jcfg, _ = configs("stablelm_1_6b")
    jp, _ = params(jcfg, seed)
    jo = jt.adamw_init(jp)
    # moments and count away from their zeros, so that every leaf carries data
    jo = {"m": jax.tree.map(lambda x: x + 0.25, jo["m"]), "v": jax.tree.map(lambda x: x + 0.5, jo["v"]),
          "count": jnp.asarray(7, jnp.int32)}
    return jp, jo


def test_the_layout_is_the_references(tmp_path):
    jp, jo = _jax_state()
    jt.Checkpointer(str(tmp_path / "ref")).save(2, {"params": jp, "opt": jo, "meta": {"m": 1}})
    _, tp = params(configs("stablelm_1_6b")[0], 0)
    tt.Checkpointer(str(tmp_path / "port")).save(2, {"params": tp, "opt": opt_state_from_numpy(jax.device_get(jo), "cpu"),
                                                     "meta": {"m": 1}})
    ref, port = (json.loads((tmp_path / d / "step_00000002" / "manifest.json").read_text()) for d in ("ref", "port"))
    assert port == ref  # step, n_leaves, meta, and the treedef string itself
    assert tree_description({"params": jp, "opt": jo}) == ref["treedef"]
    with np.load(tmp_path / "ref" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "port" / "step_00000002" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_the_reference_restores_a_port_checkpoint(tmp_path):
    cfg, p, opt, pipe, step = _tiny()
    p, opt, _ = _run(p, opt, pipe, step, 0, 2)
    tt.Checkpointer(str(tmp_path)).save(2, {"params": p, "opt": opt, "meta": {"arch": "stablelm"}})
    jp, jo = _jax_state(seed=3)
    s, st = jt.Checkpointer(str(tmp_path)).restore(None, {"params": jp, "opt": jo, "meta": {}})
    assert s == 2 and st["meta"] == {"arch": "stablelm"}
    want = dict(tree_items({"params": p, "opt": opt}))
    got = dict(tree_items(jax.device_get({"params": st["params"], "opt": st["opt"]})))
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        g = np.asarray(got[path])
        assert g.dtype == t.numpy().dtype and g.shape == tuple(t.shape), path
        np.testing.assert_array_equal(g, t.numpy(), err_msg=path)


def test_the_port_restores_a_reference_checkpoint(tmp_path):
    jp, jo = _jax_state(seed=2)
    jt.Checkpointer(str(tmp_path)).save(11, {"params": jp, "opt": jo, "meta": {"x": [1, 2]}})
    _, p, opt, _, _ = _tiny(seed=9)
    s, st = tt.Checkpointer(str(tmp_path)).restore(None, {"params": p, "opt": opt, "meta": {}})
    assert s == 11 and st["meta"] == {"x": [1, 2]}
    assert st["opt"]["count"].dtype == torch.int32 and int(st["opt"]["count"]) == 7
    want = dict(tree_items(jax.device_get({"params": jp, "opt": jo})))
    for path, t in tree_items({"params": st["params"], "opt": st["opt"]}):
        assert t.device.type == "cpu" and t.numpy().dtype == np.asarray(want[path]).dtype, path
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]), err_msg=path)
