"""The port's attention (``repro_torch.models.attention``) against
``repro.models.attention`` on the same parameters and numpy inputs, f32,
``rtol = atol = 1e-4``: every mode (full, swa, local, mla and paligemma's
prefix mask) dense and chunked, the cache ``return_cache`` builds, decode
against the cache with f32 and bf16 scores, the int8 ``kv_quant`` cache
(values and scales equal), and MLA decode past its capacity (the reference's
``dynamic_update_slice`` clamps the write to the last row)."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as ja  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from torch_lm_parity import TOL, assert_close, assert_tree_close, configs, to_jax, to_torch  # noqa: E402

# mode -> (architecture whose reduced config has it, changes)
MODES = {
    "full": ("stablelm_1_6b", {}),
    "swa": ("mixtral_8x7b", {}),
    "local": ("recurrentgemma_9b", {}),
    "mla": ("minicpm3_4b", {}),
    "prefix": ("paligemma_3b", {}),
    "gqa": ("phi3_medium_14b", {"n_kv_heads": 2}),
}
S = 40  # longer than the reduced windows (16): the ring keeps the tail


def _setup(mode, seed=0, **changes):
    arch, base = MODES[mode]
    jcfg, tcfg = configs(arch, **{**base, **changes})
    jp = ja.attn_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, to_torch(jax.device_get(jp))


def _x(rng, b, s, d):
    return rng.standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("impl", ["dense", "chunked"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_attn_apply_equals_the_reference(mode, impl):
    # chunks of 16 over 40 keys: two full chunks and a ragged one
    jcfg, tcfg, jp, tp = _setup(mode, attn_impl=impl, attn_chunk=16)
    rng = np.random.default_rng(1)
    x = _x(rng, 2, S, jcfg.d_model)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want_y, want_c = ja.attn_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), return_cache=True)
    got_y, got_c = ta.attn_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), return_cache=True)
    assert_close(want_y, got_y, TOL, mode)
    assert_tree_close(want_c, got_c, TOL, mode)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunked_equals_dense_in_the_port(mode):
    _, dense, _, tp = _setup(mode)
    chunked = dataclasses.replace(dense, attn_impl="chunked", attn_chunk=8)
    x = torch.from_numpy(_x(np.random.default_rng(2), 2, S, dense.d_model))
    pos = torch.arange(S, dtype=torch.int32).expand(2, S)
    a, _ = ta.attn_apply(tp, dense, x, pos)
    b, _ = ta.attn_apply(tp, chunked, x, pos)
    torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def _decode_both(jcfg, tcfg, jp, tp, steps, max_len, seed=3):
    rng = np.random.default_rng(seed)
    jc = ja.attn_init_cache(jcfg, 2, max_len, jnp.float32)
    tc = ta.attn_init_cache(tcfg, 2, max_len, torch.float32, "cpu")
    assert_tree_close(jc, tc, 0.0, "init")
    for t in range(steps):
        x = _x(rng, 2, 1, jcfg.d_model)
        jy, jc = ja.attn_decode(jp, jcfg, jnp.asarray(x), jc)
        ty, tc = ta.attn_decode(tp, tcfg, torch.from_numpy(x), tc)
        assert_close(jy, ty, TOL, f"step {t}")
    return jc, tc


@pytest.mark.parametrize("scores", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["full", "swa", "local", "mla", "gqa"])
def test_attn_decode_equals_the_reference(mode, scores):
    # 20 steps into a 24-row cache: the swa/local rings (16) wrap
    jcfg, tcfg, jp, tp = _setup(mode, decode_score_dtype=scores)
    jc, tc = _decode_both(jcfg, tcfg, jp, tp, steps=20, max_len=24)
    assert_tree_close(jc, tc, TOL, mode)
    assert int(tc["idx"]) == 20


@pytest.mark.parametrize("scores", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["full", "swa"])
def test_kv_quant_cache_equals_the_reference(mode, scores):
    jcfg, tcfg, jp, tp = _setup(mode, kv_quant=True, decode_score_dtype=scores)
    jc, tc = _decode_both(jcfg, tcfg, jp, tp, steps=20, max_len=24)
    assert tc["k"].dtype == torch.int8 and tc["k_scale"].dtype == torch.bfloat16
    # int8 values and bf16 scales bit for bit
    assert_tree_close(jc, tc, 0.0, "kv_quant")


def test_quantize_rounds_half_to_even_as_the_reference():
    # values exactly on .5 after scaling: amax 127 gives scale 1
    x = np.array([[[[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -127.0]]]], np.float32)
    jq, js = ja._quantize_kv(jnp.asarray(x))
    tq, ts = ta._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, 4, -127]
    assert_tree_close({"s": js}, {"s": ts}, 0.0)


def test_mla_decode_past_capacity_clamps_as_the_reference():
    # six steps into a four-row latent cache: steps 5 and 6 overwrite row 3
    jcfg, tcfg, jp, tp = _setup("mla")
    jc, tc = _decode_both(jcfg, tcfg, jp, tp, steps=6, max_len=4)
    assert_tree_close(jc, tc, TOL, "mla")
    assert int(tc["idx"]) == 6


def test_cache_from_prefill_then_decode_equals_the_reference():
    # the reference's own sequence (finding (a) aside, the port must follow it)
    for mode in ("full", "swa", "mla"):
        jcfg, tcfg, jp, tp = _setup(mode)
        rng = np.random.default_rng(4)
        x = _x(rng, 2, 20, jcfg.d_model)
        pos = np.broadcast_to(np.arange(20, dtype=np.int32), (2, 20)).copy()
        _, jc = ja.attn_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), return_cache=True)
        _, tc = ta.attn_apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), return_cache=True)
        for t in range(3):
            step = _x(rng, 2, 1, jcfg.d_model)
            jy, jc = ja.attn_decode(jp, jcfg, jnp.asarray(step), jc)
            ty, tc = ta.attn_decode(tp, tcfg, torch.from_numpy(step), tc)
            assert_close(jy, ty, TOL, f"{mode} step {t}")
        assert_tree_close(to_jax(jax.device_get(jc)), tc, TOL, mode)
