"""The gate-by-gate circuits: shares and per-gate ledger entries equal
repro's (default config, which its own tests pin to the kernel path) at
widths 8 / 16 / 32."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import circuits as jc  # noqa: E402
from repro.core import ledger as jledger  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core import sharing as js  # noqa: E402
from repro_torch.core import circuits as tc  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import sharing as ts  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.interop import prf_from_numpy  # noqa: E402

N = 24


def _entries(led):
    return [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


def _inputs(width, seed):
    rng = np.random.default_rng(seed)
    hi = 2**width
    x = rng.integers(0, hi, N, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, hi, N, dtype=np.uint64).astype(np.uint32)
    y[:4] = x[:4]  # some equal lanes
    x[4], y[4] = hi - 1, 0  # extremes of the width
    x[5], y[5] = 0, hi - 1
    return x, y


def _run_both(fn_j, fn_t, width, seed=0, arith=False):
    x, y = _inputs(width, seed)
    jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    jk2, tk2 = jax.random.fold_in(jk, 1), threefry.fold_in(tk, 1)
    share_j = js.share_a if arith else js.share_b
    share_t = ts.share_a if arith else ts.share_b
    jx, jy = share_j(x, jk), share_j(y, jk2)
    tx, ty = share_t(x, tk, "cpu"), share_t(y, tk2, "cpu")
    jp = jprf.setup_prf(jax.random.PRNGKey(100 + seed))
    tp = prf_from_numpy(np.asarray(jp.pair_keys))
    with jledger.CommLedger() as jl:
        jout = fn_j(jx, jy, jp)
    with tledger.CommLedger() as tl:
        tout = fn_t(tx, ty, tp)
    assert (np.asarray(jout.shares) == to_numpy(tout.shares)).all()
    assert _entries(jl) == _entries(tl)
    reveal = ts.reveal_a if isinstance(tout, ts.AShare) else ts.reveal_b
    return x, y, to_numpy(reveal(tout))


WIDTHS = [8, 16, 32]


@pytest.mark.parametrize("width", WIDTHS)
def test_eq(width):
    x, y, got = _run_both(
        lambda a, b, p: jc.eq(a, b, p, width), lambda a, b, p: tc.eq(a, b, p, width), width
    )
    assert (got == (x == y)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_eq_public(width):
    x, _, got = _run_both(
        lambda a, b, p: jc.eq_public(a, 7, p, width),
        lambda a, b, p: tc.eq_public(a, 7, p, width),
        width,
    )
    assert (got == (x == 7)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_lt_and_le(width):
    x, y, got = _run_both(
        lambda a, b, p: jc.lt(a, b, p, width), lambda a, b, p: tc.lt(a, b, p, width), width
    )
    assert (got == (x < y)).all()
    x, y, got = _run_both(
        lambda a, b, p: jc.le(a, b, p, width), lambda a, b, p: tc.le(a, b, p, width), width, seed=1
    )
    assert (got == (x <= y)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_lt_public(width):
    c = (2**width) // 3
    x, _, got = _run_both(
        lambda a, b, p: jc.lt_public(a, c, p, width),
        lambda a, b, p: tc.lt_public(a, c, p, width),
        width,
    )
    assert (got == (x < c)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_ks_add(width):
    x, y, got = _run_both(
        lambda a, b, p: jc.ks_add(a, b, p, width), lambda a, b, p: tc.ks_add(a, b, p, width), width
    )
    mask = (1 << width) - 1
    assert ((got & mask) == ((x.astype(np.uint64) + y) & mask)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_a2b(width):
    x, _, got = _run_both(
        lambda a, b, p: jc.a2b(a, p, width),
        lambda a, b, p: tc.a2b(a, p, width),
        width,
        arith=True,
    )
    mask = (1 << width) - 1
    assert ((got & mask) == (x & mask)).all()


def test_bit2a_and_bit_gates():
    _, _, got = _run_both(
        lambda a, b, p: jc.bit2a(a.and_public(1), p),
        lambda a, b, p: tc.bit2a(a.and_public(1), p),
        32,
    )
    assert set(np.unique(got)) <= {0, 1}
    _run_both(
        lambda a, b, p: jc.or_bit(a.and_public(1), b.and_public(1), p),
        lambda a, b, p: tc.or_bit(a.and_public(1), b.and_public(1), p),
        32,
    )
    _run_both(
        lambda a, b, p: jc.gt_public(a, 1000, p), lambda a, b, p: tc.gt_public(a, 1000, p), 32
    )
