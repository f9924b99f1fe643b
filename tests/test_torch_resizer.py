"""The Resizer on the same SecretTable carried over from repro with
``interop``: output shares, ledger entries, the revealed size S (and the rest
of the info dict) and the kept rows equal repro's, under both additions, both
coin modes, bucketing and the lazy join payload (exact)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import ledger as jledger  # noqa: E402
from repro.core import noise as jnoise  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core.resizer import Resizer as JResizer  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.ops.join import oblivious_join as jjoin  # noqa: E402
from repro.ops.table import SecretTable as JTable  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core.resizer import Resizer as TResizer  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.interop import key_from_numpy, prf_from_numpy, tables_from_numpy  # noqa: E402
from repro_torch.ops.join import oblivious_join as tjoin  # noqa: E402

NOISES = {
    "uniform": (lambda m: m.UniformNoise(0.0, 0.5)),
    "tlap": (lambda m: m.TruncatedLaplace(eps=0.5, delta=5e-5)),
    "notrim": (lambda m: m.NoTrim()),
}


def _entries(led):
    return [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


def _table(n, seed, cols=("pid", "x")):
    rng = np.random.default_rng(seed)
    data = {c: rng.integers(0, 9, n).astype(np.uint32) for c in cols}
    valid = (rng.random(n) < 0.4).astype(np.uint32)
    jt = JTable.from_plaintext(data, jax.random.PRNGKey(seed), valid=valid)
    return jt


def _carry(jtables):
    """repro tables -> the port's, through numpy."""
    return tables_from_numpy(
        {
            name: ({c: np.asarray(v.shares) for c, v in t.cols.items()}, np.asarray(t.valid.shares))
            for name, t in jtables.items()
        },
        "cpu",
    )


def _run(jt, tt, cfg_kwargs, noise, key_seed=3):
    jp = jprf.setup_prf(jax.random.PRNGKey(50 + key_seed))
    tp = prf_from_numpy(np.asarray(jp.pair_keys))
    jkey = jax.random.PRNGKey(key_seed)
    tkey = key_from_numpy(np.asarray(jkey))
    with jledger.CommLedger() as jl:
        jout, jinfo = JResizer(JConfig(noise=NOISES[noise](jnoise), **cfg_kwargs))(jt, jp, jkey)
    with tledger.CommLedger() as tl:
        tout, tinfo = TResizer(TConfig(noise=NOISES[noise](tnoise), **cfg_kwargs))(tt, tp, tkey)
    assert _entries(jl) == _entries(tl)
    assert jinfo == tinfo
    assert list(jout.cols) == list(tout.cols)
    for name in jout.cols:
        assert (np.asarray(jout.col(name).shares) == to_numpy(tout.col(name).shares)).all(), name
    assert (np.asarray(jout.valid.shares) == to_numpy(tout.valid.shares)).all()
    jrows, trows = jout.reveal_true_rows(), tout.reveal_true_rows()
    for name in jrows:
        assert (np.asarray(jrows[name]) == trows[name]).all()
    return tinfo


CASES = [
    ("parallel", "corrected", "uniform", 1),
    ("parallel", "corrected", "tlap", 1),
    ("parallel", "paper", "uniform", 1),
    ("parallel", "corrected", "uniform", 8),
    ("sequential", "corrected", "uniform", 1),
    ("sequential", "corrected", "tlap", 4),
    ("parallel", "corrected", "notrim", 1),
]


@pytest.mark.parametrize("addition,coin_mode,noise,bucket", CASES)
def test_resizer_matches_reference(addition, coin_mode, noise, bucket):
    jt = _table(40, seed=1)
    tt = _carry({"t": jt})["t"]
    info = _run(jt, tt, {"addition": addition, "coin_mode": coin_mode, "bucket": bucket}, noise)
    assert info["t"] <= info["s"] <= info["n"] == 40


def test_resizer_over_the_lazy_join():
    # the join's payload stays a LazyGather view until the Resizer gathers
    # the S kept rows from the base tables
    jl_, jr_ = _table(9, seed=4, cols=("pid", "a")), _table(7, seed=5, cols=("pid", "b"))
    carried = _carry({"l": jl_, "r": jr_})
    jp = jprf.setup_prf(jax.random.PRNGKey(77))
    tp = prf_from_numpy(np.asarray(jp.pair_keys))
    jj = jjoin(jl_, jr_, ("pid", "pid"), jp, tile=16)
    tj = tjoin(carried["l"], carried["r"], ("pid", "pid"), tp, tile=16)
    assert (np.asarray(jj.valid.shares) == to_numpy(tj.valid.shares)).all()
    info = _run(jj, tj, {}, "uniform")
    assert info["n"] == 63


def test_beta_noise_is_a_deterministic_probability():
    from repro_torch.core import threefry

    beta = tnoise.BetaNoise(2, 6)
    key = threefry.PRNGKey(9)
    p = beta.sample_p(key, 100, 10)
    assert 0.0 <= p <= 1.0 and p == beta.sample_p(key, 100, 10)
    assert p != beta.sample_p(threefry.PRNGKey(10), 100, 10)
    assert 0 <= beta.sample_eta(key, 100, 10) <= 90
