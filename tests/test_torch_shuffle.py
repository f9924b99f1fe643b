"""The secure shuffle, its inverse and the secret-permutation gather: the same
shares carried over from repro with ``interop`` give the same output shares
and ledger entries in the port (exact)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import ledger as jledger  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core import sharing as js  # noqa: E402
from repro.core import shuffle as jsh  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import sharing as ts  # noqa: E402
from repro_torch.core import shuffle as tsh  # noqa: E402
from repro_torch.core.ring import from_numpy, to_numpy  # noqa: E402
from repro_torch.interop import prf_from_numpy  # noqa: E402


def _entries(led):
    return [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


def _cols(n, seed):
    """A mixed table: two BShare columns (one 2-wide) and one AShare column,
    on both sides from the same shares."""
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    jcols = {
        "a": js.share_b(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), k1),
        "wide": js.share_b(rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32), k2),
        "sum": js.share_a(rng.integers(0, 1000, n).astype(np.uint32), k3),
    }
    tcols = {
        name: type_(from_numpy(np.asarray(c.shares), "cpu"))
        for (name, c), type_ in zip(jcols.items(), (ts.BShare, ts.BShare, ts.AShare))
    }
    return jcols, tcols


def _prfs(seed):
    jp = jprf.setup_prf(jax.random.PRNGKey(seed))
    return jp, prf_from_numpy(np.asarray(jp.pair_keys))


def _assert_same(jcols, tcols):
    assert list(jcols) == list(tcols)
    for name in jcols:
        assert type(jcols[name]).__name__ == type(tcols[name]).__name__
        assert (np.asarray(jcols[name].shares) == to_numpy(tcols[name].shares)).all(), name


@pytest.mark.parametrize("n", [1, 17, 300])
def test_composed_permutation(n):
    jp, tp = _prfs(n)
    want = np.asarray(jsh.composed_permutation(jp, n))
    assert (tsh.composed_permutation(tp, n, "cpu").numpy() == want).all()


@pytest.mark.parametrize("n", [1, 17, 300])
def test_secure_and_inverse_shuffle(n):
    jcols, tcols = _cols(n, seed=n)
    jp, tp = _prfs(7)
    with jledger.CommLedger() as jl:
        jout = jsh.secure_shuffle(jcols, jp)
        jback = jsh.inverse_shuffle(jout, jp.fold(1))
    with tledger.CommLedger() as tl:
        tout = tsh.secure_shuffle(tcols, tp)
        tback = tsh.inverse_shuffle(tout, tp.fold(1))
    _assert_same(jout, tout)
    _assert_same(jback, tback)
    assert _entries(jl) == _entries(tl)
    # the inverse under the same prf restores the values
    restored = tsh.inverse_shuffle(tout, tp)
    for name, col in tcols.items():
        reveal = ts.reveal_a if isinstance(col, ts.AShare) else ts.reveal_b
        assert (to_numpy(reveal(restored[name])) == to_numpy(reveal(col))).all()


@pytest.mark.parametrize("n", [2, 64])
def test_apply_secret_perm(n):
    jcols, tcols = _cols(n, seed=100 + n)
    pi = np.random.default_rng(n).permutation(n).astype(np.uint32)
    jpi = js.share_b(pi, jax.random.PRNGKey(5))
    tpi = ts.BShare(from_numpy(np.asarray(jpi.shares), "cpu"))
    jp, tp = _prfs(11)
    with jledger.CommLedger() as jl:
        jout = jsh.apply_secret_perm(jcols, jpi, jp)
    with tledger.CommLedger() as tl:
        tout = tsh.apply_secret_perm(tcols, tpi, tp)
    _assert_same(jout, tout)
    assert _entries(jl) == _entries(tl)
    a = to_numpy(ts.reveal_b(tout["a"]))
    assert (a == to_numpy(ts.reveal_b(tcols["a"]))[pi]).all()


def test_empty_table_is_a_no_op():
    assert tsh.secure_shuffle({}, _prfs(0)[1]) == {}
    assert tsh.inverse_shuffle({}, _prfs(0)[1]) == {}
