"""The port's ``make_train_step`` against ``repro.train.make_train_step``:
three steps from JAX's parameters over the same ``TokenPipeline`` batches
(every metric, the parameters and the AdamW state after each step, by the
per-leaf rule of ``tests/test_torch_train_grads.py``; ``count`` exact);
``grad_accum=2`` against the reference's ``grad_accum=2`` and, as
``tests/test_train_infra.py`` holds the reference, against the large batch;
and the caller's parameters and state stay as they were."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import repro.train as jt  # noqa: E402
import repro_torch.train as tt  # noqa: E402
from repro.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.models.lm import tree_items  # noqa: E402
from torch_lm_parity import assert_close, assert_leaves_close, configs, params, to_jax, to_torch, tol  # noqa: E402

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _pipe(cfg, batch=4):
    return TokenPipeline(cfg.vocab_size, 16, batch, seed=7, d_model=cfg.d_model, mode=cfg.input_mode,
                         n_prefix=cfg.n_prefix)


def _metrics_close(jm, tm, tol_, what):
    assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm", "loss", "lr"]
    for k in jm:
        assert tm[k].dtype == torch.float32 and tm[k].shape == (), k
        assert_close(jm[k], tm[k], tol_ * max(1.0, abs(float(jm[k]))), f"{what} {k}")


# stablelm as the reference's own tests train it; mixtral for the MoE aux
# loss; paligemma for the image prefix ahead of the labels
@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mixtral_8x7b", "paligemma_3b"])
def test_three_steps_equal_the_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, 0)
    jo, to = jt.adamw_init(jp), tt.adamw_init(tp)
    jstep = jax.jit(jt.make_train_step(jcfg, jt.AdamWConfig(**OPT)))
    tstep = tt.make_train_step(tcfg, tt.AdamWConfig(**OPT))
    pipe = _pipe(jcfg)
    for s in range(3):
        b = pipe.batch_at(s)
        jp, jo, jm = jstep(jp, jo, to_jax(b))
        tp, to, tm = tstep(tp, to, to_torch(b))
        _metrics_close(jm, tm, tol(arch), f"step {s}")
        assert_leaves_close(jp, tp, tol(arch), f"params after step {s}")
        assert_leaves_close(jo, to, tol(arch), f"AdamW state after step {s}")
        assert int(to["count"]) == s + 1 and to["count"].dtype == torch.int32


def test_grad_accum_equals_the_reference_and_the_large_batch():
    jcfg, tcfg = configs("stablelm_1_6b")
    jp, tp = params(jcfg, 0)
    b = _pipe(jcfg).batch_at(0)
    opt = dict(lr=1e-3, warmup_steps=0, total_steps=50)
    tstate = tt.adamw_init(tp)
    big = tt.make_train_step(tcfg, tt.AdamWConfig(**opt), 1)(tp, tstate, to_torch(b))
    acc = tt.make_train_step(tcfg, tt.AdamWConfig(**opt), 2)(tp, tstate, to_torch(b))
    ref = jax.jit(jt.make_train_step(jcfg, jt.AdamWConfig(**opt), 2))(jp, jt.adamw_init(jp), to_jax(b))
    _metrics_close(ref[2], acc[2], tol("stablelm_1_6b"), "grad_accum=2")
    assert float(acc[2]["aux"]) == 0.0 and torch.equal(acc[2]["ce"], acc[2]["loss"])
    assert_leaves_close(ref[0], acc[0], tol("stablelm_1_6b"), "params, grad_accum=2")
    assert_leaves_close(ref[1], acc[1], tol("stablelm_1_6b"), "state, grad_accum=2")
    # the mean of the microbatches' means differs from the large batch's mean
    # only by how the masked positions weigh
    assert abs(float(big[2]["loss"]) - float(acc[2]["loss"])) < 5e-2
    for (path, a), (_, c) in zip(tree_items(big[0]), tree_items(acc[0])):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=5e-3, err_msg=path)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_the_callers_params_and_state_are_left_alone(grad_accum):
    jcfg, tcfg = configs("stablelm_1_6b")
    _, tp = params(jcfg, 0)
    state = tt.adamw_init(tp)
    before = [t.clone() for _, t in tree_items({"p": tp, "s": state})]
    new_p, new_s, _ = tt.make_train_step(tcfg, tt.AdamWConfig(**OPT), grad_accum)(
        tp, state, to_torch(_pipe(jcfg).batch_at(0)))
    after = [t for _, t in tree_items({"p": tp, "s": state})]
    assert all(torch.equal(a, b) and not b.requires_grad for a, b in zip(before, after))
    assert not any(t.requires_grad for _, t in tree_items({"p": new_p, "s": new_s}))
    assert int(new_s["count"]) == 1


def test_grad_accum_must_divide_the_batch():
    _, tcfg = configs("stablelm_1_6b")
    _, tp = params(configs("stablelm_1_6b")[0], 0)
    step = tt.make_train_step(tcfg, tt.AdamWConfig(**OPT), 3)
    with pytest.raises(ValueError, match="grad_accum=3"):
        step(tp, tt.adamw_init(tp), to_torch(_pipe(tcfg).batch_at(0)))
