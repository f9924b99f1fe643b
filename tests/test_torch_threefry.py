"""The port's threefry and PRF against jax.random / repro.core.prf, bit for bit."""
import math

import numpy as np
import torch
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import prf as jprf  # noqa: E402
from repro.core.ring import RING32  # noqa: E402
from repro_torch.core import prf as tprf  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402

SEEDS = [0, 1, 7, 42, 11, 2**31 - 1, -1, 123456789]
TAGS = [0, 1, 5, 7, 31, 100, 501, 1000, 5017, 9000 + 31 * 64 + 7 * 32, 2**32 - 1]
SHAPES = [(), (7,), (3, 5), (2, 1000)]


def _np(key):
    return np.asarray(key, dtype=np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    assert (_np(jax.random.PRNGKey(seed)) == to_numpy(threefry.PRNGKey(seed))).all()


@pytest.mark.parametrize("seed", [0, 42, 123456789])
def test_fold_in_and_split(seed):
    jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    for tag in TAGS:
        assert (_np(jax.random.fold_in(jk, tag)) == to_numpy(threefry.fold_in(tk, tag))).all(), tag
    for num in (1, 2, 3, 7):
        assert (_np(jax.random.split(jk, num)) == to_numpy(threefry.split(tk, num))).all(), num


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 42])
def test_bits(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    a = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    b = to_numpy(threefry.bits(tk, shape, "cpu"))
    assert a.shape == b.shape and (a == b).all()


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.3, 17.5), (5e-05, 1.0), (0.0, 37.0)])
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform(shape, bounds):
    lo, hi = bounds
    for seed in (0, 42, 1001):
        jk, tk = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
        a = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        b = threefry.uniform(tk, shape, lo, hi).numpy()
        assert a.dtype == b.dtype == np.float32
        assert (a.view(np.uint32) == b.view(np.uint32)).all(), seed


@pytest.mark.parametrize("n", [0, 1, 2, 1000, 70000])
def test_permutation(n):
    for seed in (0, 42):
        a = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        b = threefry.permutation(threefry.PRNGKey(seed), n, "cpu").numpy()
        assert (a == b).all(), seed


def test_permutation_three_rounds_with_ties():
    """The regime of the Resize shuffles at full size: above about 2.6 M rows
    the shuffle takes 3 sort rounds, and ties among the 32-bit sort keys are
    common, so the stable order of equal keys decides the result."""
    n = 3_000_000
    assert math.ceil(3 * math.log(n) / math.log(2**32 - 1)) == 3
    jk = jax.random.PRNGKey(5)
    keys = np.asarray(jax.random.bits(jax.random.split(jk)[1], (n,), jnp.uint32))
    assert len(np.unique(keys)) < n  # the first round already has ties
    a = np.asarray(jax.random.permutation(jk, n))
    b = threefry.permutation(threefry.PRNGKey(5), n, "cpu").numpy()
    assert (a == b).all()


def test_setup_prf_fold_draw_and_zero_shares():
    jp = jprf.setup_prf(jax.random.PRNGKey(42))
    tp = tprf.setup_prf(threefry.PRNGKey(42))
    assert (_np(jp.pair_keys) == to_numpy(tp.pair_keys)).all()
    for tag in TAGS[:-1]:  # repro folds through a jitted int32 tag
        jf, tf = jp.fold(tag), tp.fold(tag)
        assert (_np(jf.pair_keys) == to_numpy(tf.pair_keys)).all(), tag
    for shape in [(5,), (2, 33), (3, 1, 4)]:
        f = jp.fold(77)
        t = tp.fold(77)
        assert (np.asarray(f.draw(shape, RING32)) == to_numpy(t.draw(shape, "cpu"))).all()
        assert (np.asarray(jprf.zero_share_add(f, shape)) == to_numpy(tprf.zero_share_add(t, shape, "cpu"))).all()
        assert (np.asarray(jprf.zero_share_xor(f, shape)) == to_numpy(tprf.zero_share_xor(t, shape, "cpu"))).all()
        ju = np.asarray(f.draw_uniform(shape))
        tu = t.draw_uniform(shape, "cpu").numpy()
        assert (ju.view(np.uint32) == tu.view(np.uint32)).all()


@pytest.mark.parametrize("n", [0, 1, 5, 1000])
@pytest.mark.parametrize("seeds", [(0,), (0, 42, 7), (1, 2, 3, 4, 5, 6)])
def test_threefry_kernel_wrapper_on_cpu_equals_jax(seeds, n):
    """The ``threefry_bits`` wrapper on the CPU (its plain version): row r
    is ``jax.random.bits`` of key r; ``bits_each`` and ``uniform_each``
    equal the per-key draws."""
    from repro_torch.kernels.threefry import draw

    keys = torch.stack([threefry.PRNGKey(s) for s in seeds])
    got = to_numpy(draw(keys, n, "cpu"))
    want = np.stack([np.asarray(jax.random.bits(jax.random.PRNGKey(s), (n,), jnp.uint32)) for s in seeds])
    assert got.shape == want.shape and (got == want).all()
    shape = (n, 2)
    each = threefry.bits_each(keys, shape, "cpu")
    assert torch.equal(each, torch.stack([threefry.bits(k, shape, "cpu") for k in keys]))
    uni = threefry.uniform_each(keys, shape, "cpu")
    assert torch.equal(uni, torch.stack([threefry.uniform(k, shape) for k in keys]))


def test_threefry_kernel_wrapper_routes_by_device():
    """``meta`` gives an empty draw of the shape, an unknown device and
    malformed keys raise, and device keys on the CPU equal host keys."""
    from repro_torch.kernels.threefry import draw

    keys = torch.stack([threefry.PRNGKey(s) for s in (3, 4, 5)])
    out = draw(keys, 17, "meta")
    assert out.is_meta and tuple(out.shape) == (3, 17) and out.dtype == torch.int32
    assert threefry.bits(keys[0], (4, 5), "meta").shape == (4, 5)
    with pytest.raises(ValueError, match="runs on cuda, cpu or meta"):
        draw(keys, 17, "xpu")
    with pytest.raises(ValueError, match="int32 keys"):
        draw(keys.to(torch.int64), 17, "cpu")
    with pytest.raises(ValueError, match="counter range"):
        draw(keys, 1 << 31, "meta")
    assert torch.equal(threefry.bits_dev(keys, (3, 4)), threefry.bits_each(keys, (3, 4), "cpu"))
