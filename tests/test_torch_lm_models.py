"""The port's assembled LM (``repro_torch.models``) against ``repro.models``
for all ten reduced architectures, on JAX's parameters and numpy inputs:
``forward``'s logits and aux loss, and ``loss_fn`` (total, ce, aux) under
both ``ce_impl``; f32, ``rtol = atol = 1e-4`` (``5e-3`` for recurrentgemma
and xlstm). Then the bf16 compute path on two of them against the
reference's bf16 forward (``0.1`` on logits of order 3: the residual stream
is rounded to bf16 after every block, in both packages alike)."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.models as jm  # noqa: E402
import repro_torch.models as tm  # noqa: E402
from torch_lm_parity import (  # noqa: E402
    assert_close,
    batch,
    configs,
    params,
    to_jax,
    to_torch,
    tol,
)
from repro.configs import ARCH_IDS  # noqa: E402

BF16_TOL = 0.1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_and_loss_equal_the_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, 0)
    b = batch(jcfg, np.random.default_rng(1), s=24, labels=True)
    jb, tb = to_jax(b), to_torch(b)
    jl, jaux = jm.forward(jcfg, jp, jb)
    tl, taux = tm.forward(tcfg, tp, tb)
    assert tuple(tl.shape) == (2, 24, jcfg.vocab_size)
    assert_close(jl, tl, tol(arch), "logits")
    assert_close(jaux, taux, tol(arch), "aux")
    for ce in ("gather", "einsum"):
        jc, tc = dataclasses.replace(jcfg, ce_impl=ce), dataclasses.replace(tcfg, ce_impl=ce)
        jt, jparts = jm.loss_fn(jc, jp, jb)
        tt, tparts = tm.loss_fn(tc, tp, tb)
        assert_close(jt, tt, tol(arch), f"loss {ce}")
        for k in ("ce", "aux"):
            assert_close(jparts[k], tparts[k], tol(arch), f"{k} {ce}")


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mixtral_8x7b"])
def test_bf16_forward_equals_the_reference(arch):
    jcfg, tcfg = configs(arch, dtype="bfloat16")
    jp, tp = params(jcfg, 4)
    b = batch(jcfg, np.random.default_rng(5), s=24)
    jl, _ = jm.forward(jcfg, jp, to_jax(b))
    tl, _ = tm.forward(tcfg, tp, to_torch(b))
    assert_close(jl, tl, BF16_TOL, "bf16 logits")
