"""The port's fused circuit kernels (ks_prefix, and_fold, a2b, bit2a) on the
CPU: each plain version against repro's jnp oracle (``ref.py``) and its
Pallas kernel in interpret mode, and each protocol wrapper against repro's
(shares and ledger entries), on numpy-seeded inputs with exact equality.
On the card the kernels are held against these plain versions in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ledger as jledger  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core import sharing as js  # noqa: E402
from repro.kernels import override_fusion as joverride_fusion  # noqa: E402
from repro.kernels import override_kernels as joverride_kernels  # noqa: E402
from repro.kernels.a2b_fused import a2b_fused as ja2b_fused  # noqa: E402
from repro.kernels.a2b_fused import bit2a_fused as jbit2a_fused  # noqa: E402
from repro.kernels.a2b_fused.a2b_fused import a2b_kernel as ja2b_kernel  # noqa: E402
from repro.kernels.a2b_fused.a2b_fused import bit2a_kernel as jbit2a_kernel  # noqa: E402
from repro.kernels.a2b_fused.ref import a2b_ref, bit2a_ref  # noqa: E402
from repro.kernels.ks_prefix import and_fold_fused as jand_fold_fused  # noqa: E402
from repro.kernels.ks_prefix import ks_levels_fused as jks_levels_fused  # noqa: E402
from repro.kernels.ks_prefix.ks_prefix import and_fold as jand_fold  # noqa: E402
from repro.kernels.ks_prefix.ks_prefix import ks_prefix as jks_prefix  # noqa: E402
from repro.kernels.ks_prefix.ref import and_fold_ref, fold_shifts as jfold_shifts  # noqa: E402
from repro.kernels.ks_prefix.ref import ks_prefix_ref, ks_shifts as jks_shifts  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import sharing as ts  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ring import from_numpy, to_numpy  # noqa: E402
from repro_torch.interop import prf_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.a2b_fused import (  # noqa: E402
    a2b_fused,
    a2b_kernel,
    a2b_plain,
    bit2a_fused,
    bit2a_kernel,
    bit2a_plain,
)
from repro_torch.kernels.ks_prefix import (  # noqa: E402
    and_fold,
    and_fold_fused,
    and_fold_plain,
    fold_shifts,
    ks_levels_fused,
    ks_prefix,
    ks_prefix_plain,
    ks_shifts,
)

# words either side of the 2^31 wrap, and the ring's extremes
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)
WIDTHS = [32, 18, 16, 8]
LANES = [0, 1, 37, 300]  # empty, one lane, ragged, more than one block
BLOCK = 128  # the Pallas kernels' block here; inputs are padded to it


def _words(rng, shape):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    k = min(flat.size, EDGES.size)
    flat[:k] = EDGES[:k]
    return w


def _pallas(kernel, *arrays, **kw):
    """Run a Pallas kernel in interpret mode on arrays zero-padded along the
    lane axis to a multiple of BLOCK, and cut the result back to N lanes."""
    n = arrays[0].shape[-1]
    pad = (-n) % BLOCK
    padded = [jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)])) for a in arrays]
    return np.asarray(kernel(*padded, interpret=True, block=BLOCK, **kw))[..., :n]


def _t(a):
    return from_numpy(a, "cpu")


class _Elsewhere(torch.Tensor):
    """A tensor on a device the wrappers have no route for (neither cpu,
    cuda nor meta)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_shift_schedules_equal_the_reference():
    for width in range(1, 65):
        assert ks_shifts(width) == jks_shifts(width)
        assert fold_shifts(width) == jfold_shifts(width)
    assert ks_shifts(18) == (1, 2, 4, 8, 16) and fold_shifts(18) == (9, 4, 2, 1)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", LANES)
def test_ks_prefix_plain_equals_oracle_and_pallas(n, width):
    rng = np.random.default_rng(10 * n + width)
    shifts = ks_shifts(width)
    g, p = _words(rng, (3, n)), _words(rng, (3, n))
    al = _words(rng, (3, 2 * len(shifts), n))
    want = np.asarray(ks_prefix_ref(jnp.asarray(g), jnp.asarray(p), jnp.asarray(al), shifts))
    got = to_numpy(ks_prefix_plain(_t(g), _t(p), _t(al), shifts))
    assert (got == want).all()
    if n:
        assert (got == _pallas(jks_prefix, g, p, al, shifts=shifts)).all()
    reset_launch_counts()
    assert (to_numpy(ks_prefix(_t(g), _t(p), _t(al), shifts)) == want).all()
    assert launch_counts().get("ks_prefix", 0) == 0  # a CPU tensor never launches


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", LANES)
def test_and_fold_plain_equals_oracle_and_pallas(n, width):
    rng = np.random.default_rng(20 * n + width)
    shifts = fold_shifts(width)
    v = _words(rng, (3, n))
    al = _words(rng, (3, len(shifts), n))
    want = np.asarray(and_fold_ref(jnp.asarray(v), jnp.asarray(al), shifts))
    got = to_numpy(and_fold_plain(_t(v), _t(al), shifts))
    assert (got == want).all()
    if n:
        assert (got == _pallas(jand_fold, v, al, shifts=shifts)).all()
    reset_launch_counts()
    assert (to_numpy(and_fold(_t(v), _t(al), shifts)) == want).all()
    assert launch_counts().get("and_fold", 0) == 0


def test_and_fold_shifts_are_logical():
    # all-ones words: an arithmetic >> would smear the sign bit into the fold
    v = np.full((3, 4), 0xFFFFFFFF, np.uint32)
    v[:, 1] = 0x80000000
    al = np.zeros((3, 5, 4), np.uint32)
    shifts = fold_shifts(32)
    want = np.asarray(and_fold_ref(jnp.asarray(v), jnp.asarray(al), shifts))
    assert (to_numpy(and_fold_plain(_t(v), _t(al), shifts)) == want).all()


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", LANES)
def test_a2b_plain_equals_oracle_and_pallas(n, width):
    rng = np.random.default_rng(30 * n + width)
    shifts = ks_shifts(width)
    x = _words(rng, (3, n))
    al = _words(rng, (3, 2 * (1 + 2 * len(shifts)), n))
    want = np.asarray(a2b_ref(jnp.asarray(x), jnp.asarray(al), shifts))
    got = to_numpy(a2b_plain(_t(x), _t(al), shifts))
    assert (got == want).all()
    if n:
        assert (got == _pallas(ja2b_kernel, x, al, shifts=shifts)).all()
    reset_launch_counts()
    assert (to_numpy(a2b_kernel(_t(x), _t(al), shifts)) == want).all()
    assert launch_counts().get("a2b_fused", 0) == 0


@pytest.mark.parametrize("n", LANES)
def test_bit2a_plain_equals_oracle_and_pallas(n):
    rng = np.random.default_rng(40 + n)
    b = _words(rng, (3, n))
    al = _words(rng, (3, 2, n))
    want = np.asarray(bit2a_ref(jnp.asarray(b), jnp.asarray(al)))
    got = to_numpy(bit2a_plain(_t(b), _t(al)))
    assert (got == want).all()
    if n:
        assert (got == _pallas(jbit2a_kernel, b, al)).all()
    reset_launch_counts()
    assert (to_numpy(bit2a_kernel(_t(b), _t(al))) == want).all()
    assert launch_counts().get("bit2a_fused", 0) == 0


def _entries(led):
    return [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


def _both(j_fn, t_fn, shape, seed, arith=False):
    """Share one numpy input with both packages' keys, run repro's fused
    wrapper (Pallas in interpret mode) and the port's, and require equal
    shares and ledger entries."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    jshare, tshare = (js.share_a, ts.share_a) if arith else (js.share_b, ts.share_b)
    jx = jshare(x, jax.random.PRNGKey(seed))
    tx = tshare(x, threefry.PRNGKey(seed), "cpu")
    assert (np.asarray(jx.shares) == to_numpy(tx.shares)).all()
    jp = jprf.setup_prf(jax.random.PRNGKey(100 + seed))
    tp = prf_from_numpy(np.asarray(jp.pair_keys))
    with joverride_kernels(True), joverride_fusion(True), jledger.CommLedger() as jl:
        jout = j_fn(jx, jp)
    with tledger.CommLedger() as tl:
        tout = t_fn(tx, tp)
    assert tuple(tout.shares.shape) == tuple(jout.shares.shape)
    assert (np.asarray(jout.shares) == to_numpy(tout.shares)).all()
    assert _entries(jl) == _entries(tl)
    return x, tout


SHAPES = [(0,), (1,), (37,), (5, 7)]  # the last a 2-D lane shape


@pytest.mark.parametrize("width", [32, 18])
@pytest.mark.parametrize("shape", SHAPES)
def test_ks_levels_fused_equals_reference(shape, width):
    def j_fn(x, p):
        return jks_levels_fused(x, x << 1, p, width, 100)

    def t_fn(x, p):
        return ks_levels_fused(x, x << 1, p, width, 100)

    _both(j_fn, t_fn, shape, seed=width)


@pytest.mark.parametrize("width", [32, 18])
@pytest.mark.parametrize("shape", SHAPES)
def test_and_fold_fused_equals_reference(shape, width):
    _both(lambda x, p: jand_fold_fused(x, p, width), lambda x, p: and_fold_fused(x, p, width), shape, seed=1)


@pytest.mark.parametrize("width", [32, 18, 16])
@pytest.mark.parametrize("shape", SHAPES)
def test_a2b_fused_equals_reference(shape, width):
    x, out = _both(
        lambda x, p: ja2b_fused(x, p, width), lambda x, p: a2b_fused(x, p, width), shape, seed=2, arith=True
    )
    mask = (1 << width) - 1
    assert ((to_numpy(ts.reveal_b(out)) & mask) == (x & mask)).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_bit2a_fused_equals_reference(shape):
    x, out = _both(lambda x, p: jbit2a_fused(x, p), lambda x, p: bit2a_fused(x, p), shape, seed=3)
    assert (to_numpy(ts.reveal_a(out)) == (x & 1)).all()


def test_wrappers_raise_on_bad_input():
    x = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):  # alpha has the wrong number of words
        ks_prefix(x, x, torch.zeros((3, 3, 8), dtype=torch.int32), (1, 2))
    with pytest.raises(ValueError):  # operands of different lane counts
        and_fold(x, torch.zeros((3, 1, 4), dtype=torch.int32), (1,))
    with pytest.raises(ValueError):  # a shift outside [0, 31]
        and_fold(x, torch.zeros((3, 1, 8), dtype=torch.int32), (32,))
    with pytest.raises(ValueError):  # more than 8 levels
        ks_prefix(x, x, torch.zeros((3, 18, 8), dtype=torch.int32), tuple(range(1, 10)))
    with pytest.raises(TypeError):  # int64 words are ring-64: one ring for all operands
        bit2a_kernel(x.long(), torch.zeros((3, 2, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        bit2a_kernel(x.to(torch.int16), torch.zeros((3, 2, 8), dtype=torch.int16))
    with pytest.raises(ValueError):  # lanes not flattened
        a2b_kernel(x.view(3, 2, 4), torch.zeros((3, 22, 8), dtype=torch.int32), ks_shifts(32))
    with pytest.raises(ValueError):
        bit2a_kernel(x.as_subclass(_Elsewhere), torch.zeros((3, 2, 8), dtype=torch.int32).as_subclass(_Elsewhere))
    # meta (measure_comm) gives the output's shape and launches nothing
    reset_launch_counts()
    out = bit2a_kernel(x.to("meta"), torch.zeros((3, 2, 8), dtype=torch.int32, device="meta"))
    assert out.device.type == "meta" and out.shape == x.shape and not launch_counts()
