"""The port's serving path (``repro_torch.serve``, ``models.init_caches`` and
``decode_step``) against ``repro``'s for all ten reduced architectures, on
JAX's parameters and numpy inputs, f32, ``rtol = atol = 1e-4`` (``5e-3``
for recurrentgemma and xlstm): ``init_caches``, eight ``decode_step``s
(logits each step, caches after), ``prefill``'s logits and caches, and both
step factories; ``BucketedBatcher``'s lots, ids and padding for a seeded
submit sequence (and its refusal of a request past the last bucket)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import repro.models as jm  # noqa: E402
import repro.serve as js  # noqa: E402
import repro_torch.models as tm  # noqa: E402
import repro_torch.serve as ts  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from torch_lm_parity import (  # noqa: E402
    assert_close,
    assert_tree_close,
    batch,
    configs,
    params,
    step_input,
    to_jax,
    to_torch,
    tol,
)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_steps_equal_the_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, 0)
    jc, tc = jm.init_caches(jcfg, 2, 12), tm.init_caches(tcfg, 2, 12, device="cpu")
    assert_tree_close(jc, tc, 0.0, "init_caches")
    rng = np.random.default_rng(2)
    jstep, tstep = js.make_serve_step(jcfg), ts.make_serve_step(tcfg)
    for t in range(8):
        b = step_input(jcfg, rng)
        jl, jc = jstep(jp, jc, to_jax(b))
        if t % 2:
            tl, tc = tstep(tp, tc, to_torch(b))
        else:
            tl, tc = tm.decode_step(tcfg, tp, tc, to_torch(b))
        assert tuple(tl.shape) == (2, 1, jcfg.vocab_size)
        assert_close(jl, tl, tol(arch), f"step {t}")
    assert_tree_close(jc, tc, tol(arch), "caches after 8 steps")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_prefill_step_equal_the_reference(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, 0)
    b = batch(jcfg, np.random.default_rng(3), s=20)
    jl, jc = js.prefill(jcfg, jp, to_jax(b))
    tl, tc = ts.prefill(tcfg, tp, to_torch(b))
    assert tuple(tl.shape) == (2, 1, jcfg.vocab_size)
    assert_close(jl, tl, tol(arch), "prefill logits")
    assert_tree_close(jc, tc, tol(arch), "prefill caches")
    # the reference's prefill step is forward's last position, which its
    # prefill's logits equal (to 4e-7 on the CPU)
    assert_close(jl, ts.make_prefill_step(tcfg)(tp, to_torch(b)), tol(arch), "prefill step")


def test_bucketed_batcher_equals_the_reference():
    from repro.serve.batching import BucketedBatcher as JB
    from repro.serve.batching import next_bucket as jnext
    from repro_torch.serve import BucketedBatcher as TB
    from repro_torch.serve import next_bucket as tnext

    rng = np.random.default_rng(4)
    buckets = (16, 32, 64)
    assert [tnext(n, buckets) for n in range(0, 80)] == [jnext(n, buckets) for n in range(0, 80)]
    jb, tb = JB(len_buckets=buckets, batch_buckets=(1, 2, 4), pad_id=7), TB(len_buckets=buckets, batch_buckets=(1, 2, 4), pad_id=7)
    assert tb.next_batch() == ({}, [])
    for _ in range(11):
        toks = rng.integers(0, 100, rng.integers(1, 65)).astype(np.int32)
        assert tb.submit(toks) == jb.submit(toks)
    lots = 0
    while jb.n_pending:
        want, want_ids = jb.next_batch(max_batch=3)
        got, got_ids = tb.next_batch(max_batch=3)
        assert got_ids == want_ids and sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        lots += 1
    assert tb.n_pending == 0 and lots >= 4


def test_bucketed_batcher_refuses_a_request_past_the_last_bucket_as_the_reference():
    # the reference pads to the last bucket and cannot fit a longer request
    from repro.serve.batching import BucketedBatcher as JB
    from repro_torch.serve import BucketedBatcher as TB

    for batcher in (JB(len_buckets=(16, 32)), TB(len_buckets=(16, 32))):
        batcher.submit(np.arange(33, dtype=np.int32))
        with pytest.raises(ValueError):
            batcher.next_batch()
