"""The port's ``TokenPipeline`` (``repro_torch.data.pipeline``) against
``repro.data.pipeline``'s: every batch equal bit for bit (keys, shapes,
dtypes, values) over seeds, steps and data-parallel ranks, in the
``tokens`` and ``embeddings`` modes and with an image prefix; and the
reference's own pipeline test on the port."""
import numpy as np
import pytest

pytest.importorskip("jax")
hypothesis = pytest.importorskip("hypothesis")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402


def _same_batches(kw: dict, step: int):
    want, got = RefPipeline(**kw).batch_at(step), TokenPipeline(**kw).batch_at(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@settings(max_examples=40, deadline=None)
@given(
    seed=st.integers(0, 2**31 - 1),
    step=st.integers(0, 10**6),
    dp=st.sampled_from([(0, 1), (0, 2), (1, 2), (3, 4)]),
    mode=st.sampled_from(["tokens", "embeddings", "prefix"]),
    vocab=st.integers(2, 50_000),
    seq=st.integers(5, 40),
)
def test_batches_equal_the_reference_bit_for_bit(seed, step, dp, mode, vocab, seq):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=4 * dp[1], seed=seed, dp_rank=dp[0], dp_size=dp[1])
    if mode != "tokens":
        kw.update(mode="embeddings", d_model=8, n_prefix=4 if mode == "prefix" else 0)
    _same_batches(kw, step)


def test_pipeline_deterministic_and_sharded():
    p = TokenPipeline(vocab_size=100, seq_len=16, global_batch=8, seed=3)
    b1, b2 = p.batch_at(5), p.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(p.batch_at(6)["tokens"], b1["tokens"])
    s0 = TokenPipeline(100, 16, 8, seed=3, dp_rank=0, dp_size=2).batch_at(5)
    s1 = TokenPipeline(100, 16, 8, seed=3, dp_rank=1, dp_size=2).batch_at(5)
    assert s0["tokens"].shape[0] == 4
    assert not np.array_equal(s0["tokens"], s1["tokens"])
    assert (b1["labels"][:, -1] == -1).all()
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])


def test_uneven_dp_split_is_refused():
    with pytest.raises(ValueError, match="dp_size"):
        TokenPipeline(100, 16, 6, dp_size=4).batch_at(0)
