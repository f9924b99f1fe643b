"""The port's AdamW (``repro_torch.train.optimizer``) against
``repro.train.optimizer``: the warmup+cosine schedule over steps 0-120
within one f32 ulp, one ``adamw_update`` from the same numpy params, grads
and state within ``rtol = 1e-6`` (``count`` exact), with and without
global-norm clipping; the reference's own tests on the port; and the update
leaves its inputs as they were."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.train.optimizer as jo  # noqa: E402
import repro_torch.train.optimizer as to  # noqa: E402
from repro_torch.interop import opt_state_from_numpy, opt_state_to_numpy, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models.lm import tree_items  # noqa: E402

SCHEDULES = [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-4, warmup_steps=20, total_steps=110),
    dict(lr=1e-3, warmup_steps=0, total_steps=50, min_lr_frac=0.0),
    dict(lr=2e-2, warmup_steps=100, total_steps=100),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_lr_schedule_equals_the_reference(kw):
    """Within one f32 ulp of the result, plus one ulp of ``cos`` carried
    through the formula: XLA's f32 cosine on the CPU (glibc's ``cosf``) and
    PyTorch's differ in the last bit for some arguments, and ``1 + cos``
    cancels near the end of the schedule, which magnifies that bit up to a
    few ulps of the result. Outside the cosine phase the two are equal."""
    cfg = to.AdamWConfig(**kw)
    for step in range(121):
        want = np.float32(jo.lr_schedule(jo.AdamWConfig(**kw), jnp.asarray(step, jnp.int32)))
        got = to.lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        got = np.float32(got.item())
        warm = min(step / max(cfg.warmup_steps, 1), 1.0)
        t = min(max((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0), 1.0)
        cos = np.float32(np.cos(np.pi * t))
        in_cosine = 0.0 < t < 1.0
        carried = 0.5 * (1 - cfg.min_lr_frac) * cfg.lr * warm * np.spacing(np.abs(cos)) if in_cosine else 0.0
        assert abs(float(got) - float(want)) <= np.spacing(np.abs(want)) + carried, (step, got, want)
        if not in_cosine:
            assert got == want, (step, got, want)


def _tree(rng, scale=1.0):
    return {
        "embed": (rng.standard_normal((16, 8)) * scale).astype(np.float32),
        "layers": {"0": {"w": (rng.standard_normal((2, 8, 8)) * scale).astype(np.float32)},
                   "10": {"w": (rng.standard_normal((2, 8)) * scale).astype(np.float32)},
                   "2": {"b": (rng.standard_normal((2,)) * scale).astype(np.float32)}},
    }


def _state(rng, count: int):
    return {"m": _tree(rng, 0.1), "v": jax.tree.map(np.abs, _tree(rng, 0.01)), "count": np.asarray(count, np.int32)}


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("count", [0, 7])
def test_adamw_update_equals_the_reference(grad_scale, count):
    rng = np.random.default_rng(count)
    params, grads, state = _tree(rng), _tree(rng, grad_scale), _state(rng, count)
    cfg = dict(lr=1e-3, warmup_steps=3, total_steps=40)
    jp, js, jm = jo.adamw_update(jo.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, grads),
                                 jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state))
    tp, ts, tm = to.adamw_update(to.AdamWConfig(**cfg), params_from_numpy(grads, "cpu"),
                                 params_from_numpy(params, "cpu"), opt_state_from_numpy(state, "cpu"))
    assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1.0)
    for name, j, t in (("params", jp, params_to_numpy(tp)), ("state", js, opt_state_to_numpy(ts)),
                       ("metrics", jm, {k: v.numpy() for k, v in tm.items()})):
        want, got = dict(tree_items(jax.device_get(j))), dict(tree_items(t))
        assert sorted(got) == sorted(want), name
        for path, w in want.items():
            w = np.asarray(w)
            assert got[path].dtype == w.dtype and got[path].shape == w.shape, (name, path)
            if path == "count":
                assert int(got[path]) == int(w) == count + 1
            else:
                np.testing.assert_allclose(got[path], w, rtol=1e-6, atol=0, err_msg=f"{name} {path}")


def test_adamw_init_is_f32_zeros_and_an_int32_count():
    params = {"a": torch.ones(3, 2, dtype=torch.bfloat16), "b": {"c": torch.ones(4)}}
    state = to.adamw_init(params)
    for _, t in tree_items({"m": state["m"], "v": state["v"]}):
        assert t.dtype == torch.float32 and not t.any()
    assert state["count"].dtype == torch.int32 and state["count"].shape == () and int(state["count"]) == 0
    assert state["m"]["a"].shape == (3, 2)


def test_adamw_update_leaves_its_inputs_alone():
    rng = np.random.default_rng(3)
    params, grads, state = (params_from_numpy(_tree(rng), "cpu"), params_from_numpy(_tree(rng), "cpu"),
                            opt_state_from_numpy(_state(rng, 2), "cpu"))
    before = [t.clone() for _, t in tree_items({"p": params, "g": grads, "s": state})]
    new_p, new_s, _ = to.adamw_update(to.AdamWConfig(), grads, params, state)
    after = [t for _, t in tree_items({"p": params, "g": grads, "s": state})]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert new_p["embed"].data_ptr() != params["embed"].data_ptr() and int(new_s["count"]) == 3


def test_lr_schedule():
    cfg = to.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(to.lr_schedule(cfg, torch.tensor(0))) == 0.0
    assert abs(float(to.lr_schedule(cfg, torch.tensor(10))) - 1.0) < 1e-6
    assert float(to.lr_schedule(cfg, torch.tensor(100))) == pytest.approx(0.1, rel=1e-3)


def test_adamw_decreases_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    state = to.adamw_init(params)
    cfg = to.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=1000)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, _ = to.adamw_update(cfg, grads, params, state)
    assert float(params["w"].abs().max()) < 0.1


def test_bf16_params_keep_their_dtype_and_f32_moments():
    params = {"w": torch.tensor([3.0, -2.0], dtype=torch.bfloat16)}
    new, state, _ = to.adamw_update(dataclasses.replace(to.AdamWConfig(), warmup_steps=0),
                                    {"w": torch.tensor([1.0, 1.0], dtype=torch.bfloat16)}, params, to.adamw_init(params))
    assert new["w"].dtype == torch.bfloat16 and state["m"]["w"].dtype == torch.float32
