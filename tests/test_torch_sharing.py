"""Sharing and the interactive gates: share triples and ledger entries equal
repro's for the same keys and inputs."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import ledger as jledger  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core import sharing as js  # noqa: E402
from repro.kernels import override_fusion, override_kernels  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import sharing as ts  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.interop import prf_from_numpy  # noqa: E402


def _entries(led):
    return [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


def _prfs(seed=3):
    jp = jprf.setup_prf(jax.random.PRNGKey(seed))
    return jp, prf_from_numpy(np.asarray(jp.pair_keys))


def _shared(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return x


@pytest.mark.parametrize("shape", [(1,), (17,), (4, 5), (0,)])
def test_share_and_reveal(shape):
    x = _shared(shape, 1)
    jk, tk = jax.random.PRNGKey(9), threefry.PRNGKey(9)
    jb, tb = js.share_b(x, jk), ts.share_b(x, tk, "cpu")
    ja, ta = js.share_a(x, jk), ts.share_a(x, tk, "cpu")
    assert (np.asarray(jb.shares) == to_numpy(tb.shares)).all()
    assert (np.asarray(ja.shares) == to_numpy(ta.shares)).all()
    with jledger.CommLedger() as jl, tledger.CommLedger() as tl:
        assert (np.asarray(js.reveal_b(jb)) == to_numpy(ts.reveal_b(tb))).all()
        assert (to_numpy(ts.reveal_a(ta)) == x).all()
        js.reveal_a(ja)
    assert _entries(jl) == _entries(tl)


@pytest.mark.parametrize("shape", [(1,), (33,), (3, 7)])
def test_mul_and_or_select(shape):
    jp, tp = _prfs()
    x, y = _shared(shape, 2), _shared(shape, 3)
    jk, tk = jax.random.PRNGKey(4), threefry.PRNGKey(4)
    jx, tx = js.share_b(x, jk), ts.share_b(x, tk, "cpu")
    jy, ty = js.share_b(y, jax.random.fold_in(jk, 1)), ts.share_b(y, threefry.fold_in(tk, 1), "cpu")
    jax_, tax = js.share_a(x, jk), ts.share_a(x, tk, "cpu")
    jay, tay = js.share_a(y, jax.random.fold_in(jk, 1)), ts.share_a(y, threefry.fold_in(tk, 1), "cpu")
    with jledger.CommLedger() as jl:
        j_out = [
            js.and_(jx, jy, jp.fold(1)),
            js.or_(jx, jy, jp.fold(2)),
            js.select(jx.lsb_mask(), jx, jy, jp.fold(3)),
            js.mul(jax_, jay, jp.fold(4)),
        ]
    with tledger.CommLedger() as tl:
        t_out = [
            ts.and_(tx, ty, tp.fold(1)),
            ts.or_(tx, ty, tp.fold(2)),
            ts.select(tx.lsb_mask(), tx, ty, tp.fold(3)),
            ts.mul(tax, tay, tp.fold(4)),
        ]
    for j, t in zip(j_out, t_out):
        assert (np.asarray(j.shares) == to_numpy(t.shares)).all()
    assert _entries(jl) == _entries(tl)
    assert (to_numpy(ts.reveal_a(t_out[3])) == (x * y).astype(np.uint32)).all()


def test_and_broadcast_operands_match_the_kernel_path():
    # repro's kernel path draws alpha at the broadcast shape (sharing.py:348);
    # the port always does. Pallas runs in interpret mode here.
    jp, tp = _prfs()
    x, y = _shared((6, 2), 5), _shared((6, 1), 6)
    jk, tk = jax.random.PRNGKey(8), threefry.PRNGKey(8)
    jx, tx = js.share_b(x, jk), ts.share_b(x, tk, "cpu")
    jy, ty = js.share_b(y, jk), ts.share_b(y, tk, "cpu")
    with override_kernels(True), override_fusion(False):
        want = js.and_(jx, jy, jp)
    got = ts.and_(tx, ty, tp)
    assert (np.asarray(want.shares) == to_numpy(got.shares)).all()


def test_local_ops():
    x = _shared((12,), 7)
    jk, tk = jax.random.PRNGKey(1), threefry.PRNGKey(1)
    jb, tb = js.share_b(x, jk), ts.share_b(x, tk, "cpu")
    ja, ta = js.share_a(x, jk), ts.share_a(x, tk, "cpu")
    pairs = [
        ((jb >> 31), (tb >> 31)),
        ((jb >> 7), (tb >> 7)),
        ((jb << 5), (tb << 5)),
        (~jb, ~tb),
        (jb.xor_public(0xDEADBEEF), tb.xor_public(0xDEADBEEF)),
        (jb.and_public(0x80000001), tb.and_public(0x80000001)),
        (jb.lsb_mask(), tb.lsb_mask()),
        (ja.add_public(0xFFFFFFFF), ta.add_public(0xFFFFFFFF)),
        (ja - 5, ta - 5),
        (-ja, -ta),
        (ja.mul_public(3), ta.mul_public(3)),
        (ja.cumsum(), ta.cumsum()),
        (jb.pad_rows(15), tb.pad_rows(15)),
    ]
    for j, t in pairs:
        assert (np.asarray(j.shares) == to_numpy(t.shares)).all()
