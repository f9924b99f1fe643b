"""The port's recurrent mixers (``repro_torch.models.recurrent``) against
``repro.models.recurrent`` on the same parameters and numpy inputs, f32:
RG-LRU, mLSTM and sLSTM, each mixer's forward (``apply``), the state its
prefill builds, and decode steps from that state and from an empty one,
within ``5e-3`` (the reference's own RG-LRU decode tolerance), and the log-depth scan against ``jax.lax.associative_scan``
at even and odd lengths (``1e-5``: it forms the same products in the same
order)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import recurrent as jr  # noqa: E402
from repro_torch.models import recurrent as tr  # noqa: E402
from torch_lm_parity import RECURRENT_TOL, assert_close, assert_tree_close, configs, to_torch  # noqa: E402

MIXERS = {
    "rglru": ("recurrentgemma_9b", jr.rglru_init, jr.rglru_apply, jr.rglru_init_cache, jr.rglru_decode,
              tr.rglru_apply, tr.rglru_init_cache, tr.rglru_decode),
    "mlstm": ("xlstm_1_3b", jr.mlstm_init, jr.mlstm_apply, jr.mlstm_init_cache, jr.mlstm_decode,
              tr.mlstm_apply, tr.mlstm_init_cache, tr.mlstm_decode),
    "slstm": ("xlstm_1_3b", jr.slstm_init, jr.slstm_apply, jr.slstm_init_cache, jr.slstm_decode,
              tr.slstm_apply, tr.slstm_init_cache, tr.slstm_decode),
}


@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_associative_scan_equals_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 5)).astype(np.float32)
    b = rng.standard_normal((2, n, 5)).astype(np.float32)

    def jcombine(left, right):
        return left[0] * right[0], left[1] * right[0] + right[1]

    def tcombine(left, right):
        return [left[0] * right[0], left[1] * right[0] + right[1]]

    want = jax.lax.associative_scan(jcombine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = tr.associative_scan(tcombine, [torch.from_numpy(a), torch.from_numpy(b)])
    for w, g in zip(want, got):
        assert_close(w, g, 1e-5)
    # and the recurrence it stands for, step by step
    h = np.zeros((2, 5), np.float32)
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(got[1][:, t].numpy(), h, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mixer", sorted(MIXERS))
def test_mixer_apply_prefill_and_decode_equal_the_reference(mixer):
    arch, init, japply, jinit_cache, jdecode, tapply, tinit_cache, tdecode = MIXERS[mixer]
    jcfg, tcfg = configs(arch)
    jp = init(jax.random.PRNGKey(0), jcfg)
    tp = to_torch(jax.device_get(jp))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 21, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(21, dtype=np.int32), (2, 21)).copy()
    jy, jc = japply(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), return_cache=True)
    ty, tc = tapply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos), return_cache=True)
    assert_close(jy, ty, RECURRENT_TOL, "apply")
    assert_tree_close(jc, tc, RECURRENT_TOL, "prefill state")
    # decode from the prefill state and from an empty one
    jc0 = jinit_cache(jcfg, 2, 32, jnp.float32)
    tc0 = tinit_cache(tcfg, 2, 32, torch.float32, "cpu")
    assert_tree_close(jc0, tc0, 0.0, "init")
    for t in range(6):
        step = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jc = jdecode(jp, jcfg, jnp.asarray(step), jc)
        ty, tc = tdecode(tp, tcfg, torch.from_numpy(step), tc)
        assert_close(jy, ty, RECURRENT_TOL, f"decode after prefill, step {t}")
        jy, jc0 = jdecode(jp, jcfg, jnp.asarray(step), jc0)
        ty, tc0 = tdecode(tp, tcfg, torch.from_numpy(step), tc0)
        assert_close(jy, ty, RECURRENT_TOL, f"decode from empty, step {t}")
    assert_tree_close(jc, tc, RECURRENT_TOL, "state after decode")
    assert_tree_close(jc0, tc0, RECURRENT_TOL, "state after decode from empty")
    assert int(tc["idx"]) == 27 and int(tc0["idx"]) == 6


@pytest.mark.parametrize("mixer", ["rglru", "slstm"])
def test_decode_equals_apply_in_the_port(mixer):
    # the recurrences the reference keeps consistent: step by step = the sequence
    arch, init, _, _, _, tapply, tinit_cache, tdecode = MIXERS[mixer]
    jcfg, tcfg = configs(arch)
    tp = to_torch(jax.device_get(init(jax.random.PRNGKey(2), jcfg)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 12, tcfg.d_model)).astype(np.float32))
    y, _ = tapply(tp, tcfg, x, torch.arange(12, dtype=torch.int32)[None])
    cache = tinit_cache(tcfg, 1, 16, torch.float32, "cpu")
    outs = []
    for t in range(12):
        yt, cache = tdecode(tp, tcfg, x[:, t : t + 1], cache)
        outs.append(yt)
    torch.testing.assert_close(torch.cat(outs, dim=1), y, rtol=RECURRENT_TOL, atol=RECURRENT_TOL)
