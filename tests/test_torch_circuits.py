"""The circuits on both paths: shares and per-gate ledger entries equal
repro's at widths 8 / 16 / 32, and the port's fused and gate-by-gate paths
equal each other.

Each test runs twice (fixture ``fused``). Fused: the port under
``override_fusion(True)`` against repro's fused kernels (``use_pallas`` and
``fuse_circuits`` on: its Pallas kernels in interpret mode). Gate by gate:
the port under ``override_fusion(False)`` against repro's default config
(its gate-by-gate path; its kernels off), which draws the same PRF folds and
logs the same entries as its fused path (``repro/core/circuits.py:23-30``)."""
import contextlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import circuits as jc  # noqa: E402
from repro.core import ledger as jledger  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core import sharing as js  # noqa: E402
from repro.kernels import override_fusion as joverride_fusion  # noqa: E402
from repro.kernels import override_kernels as joverride_kernels  # noqa: E402
from repro_torch.core import circuits as tc  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import sharing as ts  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.interop import prf_from_numpy  # noqa: E402
from repro_torch.kernels import override_fusion  # noqa: E402

N = 24


@pytest.fixture(params=[True, False], ids=["fused", "gates"])
def fused(request):
    return request.param


@contextlib.contextmanager
def _reference_path(fused):
    if fused:
        with joverride_kernels(True), joverride_fusion(True):
            yield
    else:
        yield


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


def _run_both(fused, fn_j, fn_t, width, seed=0, arith=False):
    x, y = _inputs(width, seed)
    jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    jk2, tk2 = jax.random.fold_in(jk, 1), threefry.fold_in(tk, 1)
    share_j = js.share_a if arith else js.share_b
    share_t = ts.share_a if arith else ts.share_b
    jx, jy = share_j(x, jk), share_j(y, jk2)
    tx, ty = share_t(x, tk, "cpu"), share_t(y, tk2, "cpu")
    jp = jprf.setup_prf(jax.random.PRNGKey(100 + seed))
    tp = prf_from_numpy(np.asarray(jp.pair_keys))
    with _reference_path(fused), jledger.CommLedger() as jl:
        jout = fn_j(jx, jy, jp)
    with override_fusion(fused), tledger.CommLedger() as tl:
        tout = fn_t(tx, ty, tp)
    assert (np.asarray(jout.shares) == to_numpy(tout.shares)).all()
    assert _entries(jl) == _entries(tl)
    # the port's other path: the same shares and ledger entries
    with override_fusion(not fused), tledger.CommLedger() as tl_other:
        other = fn_t(tx, ty, tp)
    assert (to_numpy(other.shares) == to_numpy(tout.shares)).all()
    assert _entries(tl_other) == _entries(tl)
    reveal = ts.reveal_a if isinstance(tout, ts.AShare) else ts.reveal_b
    return x, y, to_numpy(reveal(tout))


WIDTHS = [8, 16, 32]


@pytest.mark.parametrize("width", WIDTHS)
def test_eq(width, fused):
    x, y, got = _run_both(
        fused,
        lambda a, b, p: jc.eq(a, b, p, width), lambda a, b, p: tc.eq(a, b, p, width), width
    )
    assert (got == (x == y)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_eq_public(width, fused):
    x, _, got = _run_both(
        fused,
        lambda a, b, p: jc.eq_public(a, 7, p, width),
        lambda a, b, p: tc.eq_public(a, 7, p, width),
        width,
    )
    assert (got == (x == 7)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_lt_and_le(width, fused):
    x, y, got = _run_both(
        fused,
        lambda a, b, p: jc.lt(a, b, p, width), lambda a, b, p: tc.lt(a, b, p, width), width
    )
    assert (got == (x < y)).all()
    x, y, got = _run_both(
        fused,
        lambda a, b, p: jc.le(a, b, p, width), lambda a, b, p: tc.le(a, b, p, width), width, seed=1
    )
    assert (got == (x <= y)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_lt_public(width, fused):
    c = (2**width) // 3
    x, _, got = _run_both(
        fused,
        lambda a, b, p: jc.lt_public(a, c, p, width),
        lambda a, b, p: tc.lt_public(a, c, p, width),
        width,
    )
    assert (got == (x < c)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_ks_add(width, fused):
    x, y, got = _run_both(
        fused,
        lambda a, b, p: jc.ks_add(a, b, p, width), lambda a, b, p: tc.ks_add(a, b, p, width), width
    )
    mask = (1 << width) - 1
    assert ((got & mask) == ((x.astype(np.uint64) + y) & mask)).all()


@pytest.mark.parametrize("width", WIDTHS)
def test_a2b(width, fused):
    x, _, got = _run_both(
        fused,
        lambda a, b, p: jc.a2b(a, p, width),
        lambda a, b, p: tc.a2b(a, p, width),
        width,
        arith=True,
    )
    mask = (1 << width) - 1
    assert ((got & mask) == (x & mask)).all()


def test_bit2a_and_bit_gates(fused):
    _, _, got = _run_both(
        fused,
        lambda a, b, p: jc.bit2a(a.and_public(1), p),
        lambda a, b, p: tc.bit2a(a.and_public(1), p),
        32,
    )
    assert set(np.unique(got)) <= {0, 1}
    _run_both(
        fused,
        lambda a, b, p: jc.or_bit(a.and_public(1), b.and_public(1), p),
        lambda a, b, p: tc.or_bit(a.and_public(1), b.and_public(1), p),
        32,
    )
    _run_both(
        fused,
        lambda a, b, p: jc.gt_public(a, 1000, p), lambda a, b, p: tc.gt_public(a, 1000, p), 32
    )


@pytest.mark.parametrize("width", WIDTHS)
def test_b2a(width, fused):
    # bit planes as a trailing lane axis: bit2a on a (N, width) lane shape
    x, _, got = _run_both(
        fused,
        lambda a, b, p: jc.b2a(a, p, width),
        lambda a, b, p: tc.b2a(a, p, width),
        width,
    )
    mask = (1 << width) - 1
    assert (got == (x & mask)).all()
