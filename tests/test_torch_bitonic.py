"""The bitonic stage select, ``bitonic_swap``: its plain version against the
JAX package's ``stage_swap`` (the Pallas kernel in interpret mode) and its
oracle ``bitonic_swap_ref`` at ragged and block-sized shapes, its swap and
keep semantics, and the port's bitonic sort, which runs it in every stage of
the fused path, against repro's sort on both circuit paths: shares and
ledger entries equal (exact: all values are ring words)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import ledger as jledger  # noqa: E402
from repro.core import sort as jsort  # noqa: E402
from repro.kernels.bitonic_stage.ops import stage_swap as jstage_swap  # noqa: E402
from repro.kernels.bitonic_stage.ref import bitonic_swap_ref  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import sort as tsort  # noqa: E402
from repro_torch.core.ring import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import launch_counts, override_fusion, reset_launch_counts  # noqa: E402
from repro_torch.kernels.bitonic_stage import stage_swap, stage_swap_plain  # noqa: E402
from test_torch_ops import _entries, _pair, _prfs, _same_shares  # noqa: E402


def _operands(n, c, seed):
    rng = np.random.default_rng(seed)
    mask = rng.integers(0, 2**32, (3, n), dtype=np.uint32)
    own, other, alpha = (rng.integers(0, 2**32, (3, c, n), dtype=np.uint32) for _ in range(3))
    return mask, own, other, alpha


def _port(*arrays):
    return [from_numpy(a, "cpu") for a in arrays]


@pytest.mark.parametrize("c", [1, 3, 9])
@pytest.mark.parametrize("n", [1, 3, 128, 257, 1024, 4099])
def test_stage_swap_plain_matches_pallas_and_ref(n, c):
    mask, own, other, alpha = _operands(n, c, seed=n * 10 + c)
    want = np.asarray(jstage_swap(*(jnp.asarray(a) for a in (mask, own, other, alpha)), use_kernel=True))
    ref = np.asarray(bitonic_swap_ref(mask, own, other, alpha))
    np.testing.assert_array_equal(want, ref)
    got = to_numpy(stage_swap_plain(*_port(mask, own, other, alpha)))
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the plain version for a CPU tensor and launches nothing
    reset_launch_counts()
    np.testing.assert_array_equal(to_numpy(stage_swap(*_port(mask, own, other, alpha))), want)
    assert launch_counts().get("bitonic_swap", 0) == 0


def test_stage_swap_semantics():
    """An all-ones mask swaps, an all-zero mask keeps (on zero alpha)."""
    _, own, other, _ = _operands(128, 2, seed=1)
    zeros = np.zeros_like(own)
    ones = np.zeros((3, 128), dtype=np.uint32)
    ones[0] = 0xFFFFFFFF
    value = lambda a: a[0] ^ a[1] ^ a[2]  # noqa: E731
    swapped = to_numpy(stage_swap(*_port(ones, own, other, zeros)))
    np.testing.assert_array_equal(value(swapped), value(other))
    kept = to_numpy(stage_swap(*_port(np.zeros_like(ones), own, other, zeros)))
    np.testing.assert_array_equal(value(kept), value(own))


def test_stage_swap_rejects_bad_operands():
    mask, own, other, alpha = _port(*_operands(8, 2, seed=2))
    with pytest.raises(ValueError):  # mask of another lane count
        stage_swap(mask[:, :4], own, other, alpha)
    with pytest.raises(ValueError):  # alpha of another shape
        stage_swap(mask, own, other, alpha[:, :1])
    with pytest.raises(TypeError):
        stage_swap(mask.long(), own.long(), other.long(), alpha.long())


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize(
    "keys,descending,narrow",
    [
        ("a", False, False),
        ("a", True, False),
        (("a", "b"), False, False),
        (("a", "b"), True, False),
        ("a", False, True),
        (("a", "b"), True, True),
    ],
)
def test_bitonic_sort_matches_reference_on_both_paths(keys, descending, narrow, fused):
    jt, tt = _pair(32, seed=12, cols=("a", "b", "c", "d"), hi=4)
    jcols, tcols = dict(jt.cols), dict(tt.cols)
    jp, tp = _prfs(13)
    jfn = jsort.bitonic_sort_narrow if narrow else jsort.bitonic_sort
    tfn = tsort.bitonic_sort_narrow if narrow else tsort.bitonic_sort
    with jledger.CommLedger() as jl:
        jout = jfn(jcols, keys, jp, descending=descending)
    with override_fusion(fused), tledger.CommLedger() as tl:
        tout = tfn(tcols, keys, tp, descending=descending)
    assert list(tout) == list(jout)
    for name in jcols:
        _same_shares(jout[name], tout[name])
    assert _entries(jl) == _entries(tl)
    value = lambda c: to_numpy(c.shares[0] ^ c.shares[1] ^ c.shares[2])  # noqa: E731
    names = [keys] if isinstance(keys, str) else list(keys)
    got = list(zip(*(value(tout[k]).tolist() for k in names)))
    assert got == sorted(got, reverse=descending)


def test_fused_and_gate_by_gate_sorts_are_identical():
    _, tt = _pair(64, seed=14, cols=("a", "b", "c"), hi=5)
    _, tp = _prfs(15)
    runs = []
    for fused in (True, False):
        with override_fusion(fused), tledger.CommLedger() as led:
            runs.append((tsort.bitonic_sort(dict(tt.cols), ("a", "b"), tp), _entries(led)))
    (fout, fled), (gout, gled) = runs
    assert fled == gled
    for name in fout:
        assert (to_numpy(fout[name].shares) == to_numpy(gout[name].shares)).all()
