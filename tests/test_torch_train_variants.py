"""Gradients of the port's ``loss_fn`` against ``jax.value_and_grad`` of
``repro.models.loss_fn`` on the routes the ten default configs do not take,
by the per-leaf rule of ``tests/test_torch_train_grads.py``: both MoE
dispatch routes and the four capacity policies, the one-hot cross entropy,
the chunked online softmax (whose ``-inf`` masks leave whole chunks of a
sliding window empty, where backward must stay finite), the bf16 compute
path (f32 gradients of the f32 masters through the casts), and the xLSTM
with its input gates zeroed, where the sLSTM's normaliser floor ties
exactly at the first position and both libraries split the gradient."""
import copy

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models.lm import tree_items  # noqa: E402
from torch_lm_parity import (  # noqa: E402
    check_grads_against_reference,
    check_loss_and_grads,
    configs,
    params,
    tol,
)

BF16_TOL = 0.1  # bf16 compute: every matmul input rounded to 8 bits, in both packages alike

CASES = [
    ("mixtral_8x7b", dict(moe_impl="gather")),
    ("arctic_480b", dict(moe_impl="gather")),
    ("mixtral_8x7b", dict(capacity_policy="full")),
    ("mixtral_8x7b", dict(capacity_policy="reflex_tlap")),
    ("mixtral_8x7b", dict(capacity_policy="reflex_beta", moe_impl="gather")),
    ("stablelm_1_6b", dict(ce_impl="einsum")),
    ("paligemma_3b", dict(ce_impl="einsum")),
    ("mixtral_8x7b", dict(attn_impl="chunked", attn_chunk=8)),
    ("starcoder2_15b", dict(attn_impl="chunked", attn_chunk=8)),
    ("paligemma_3b", dict(attn_impl="chunked", attn_chunk=8)),
    ("minicpm3_4b", dict(attn_impl="chunked", attn_chunk=8)),
]


@pytest.mark.parametrize("arch,changes", CASES, ids=[f"{a}-{'-'.join(f'{k}={v}' for k, v in c.items())}" for a, c in CASES])
def test_grads_on_other_routes_equal_the_reference(arch, changes):
    check_loss_and_grads(arch, **changes)


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "mixtral_8x7b"])
def test_bf16_compute_gives_f32_grads_close_to_the_reference(arch):
    jcfg, tcfg = configs(arch, dtype="bfloat16")
    jp, tp = params(jcfg, 3)
    tg = check_grads_against_reference(jcfg, tcfg, jp, tp, BF16_TOL, seed=4)
    assert {t.dtype for _, t in tree_items(tg)} == {torch.float32}


def test_grads_at_the_slstm_floor_tie_equal_the_reference():
    jcfg, tcfg = configs("xlstm_1_3b")
    tree = copy.deepcopy(jax.device_get(params(jcfg, 0)[0]))
    for block in tree["layers"].values():
        for name in ("w_i", "r_i"):  # log i = 0: n_1 = max(i_1, exp(-m_1)) = max(1, 1)
            if name in block["mixer"]:
                block["mixer"][name] = np.zeros_like(block["mixer"][name])
    jp = jax.tree.map(jax.numpy.asarray, tree)
    check_grads_against_reference(jcfg, tcfg, jp, params_from_numpy(tree, "cpu"), tol("xlstm_1_3b"))
