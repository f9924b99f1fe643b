"""``measure_comm``: a protocol's communication tally without compute, the
port's counterpart of the reference's ``jax.eval_shape`` under a ledger.
For the calls the reference's own tests measure, the port's tally on
``meta`` tensors equals the reference's ``measure_comm`` and the tally of
the same call executed on the CPU, on both circuit paths."""
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import circuits as jc  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core import sharing as js  # noqa: E402
from repro.core import shuffle as jshuffle  # noqa: E402
from repro.core import sort as jsort  # noqa: E402
from repro.core.ledger import measure_comm as jmeasure  # noqa: E402
from repro_torch.core import circuits as tc  # noqa: E402
from repro_torch.core import sharing as ts  # noqa: E402
from repro_torch.core import shuffle as tshuffle  # noqa: E402
from repro_torch.core import sort as tsort  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ledger import CommLedger, measure_comm  # noqa: E402
from repro_torch.core.noise import ConstantNoise  # noqa: E402
from repro_torch.core.resizer import Resizer, ResizerConfig  # noqa: E402
from repro_torch.interop import key_from_numpy, prf_from_numpy  # noqa: E402
from repro_torch.kernels import launch_counts, override_fusion, reset_launch_counts  # noqa: E402
from repro_torch.ops import SecretTable  # noqa: E402

JPRF = jprf.setup_prf(jax.random.PRNGKey(3))
TPRF = prf_from_numpy(np.asarray(JPRF.pair_keys))


def _shares(kind, n, seed):
    """The same sharing of ``n`` seeded words in both packages."""
    x = np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    k = jax.random.PRNGKey(seed)
    share = js.share_a if kind == "a" else js.share_b
    tshare = ts.share_a if kind == "a" else ts.share_b
    return share(x, k), tshare(x, key_from_numpy(np.asarray(k)), "cpu")


def _cols(n, seed):
    (ja, ta), (jb, tb) = _shares("b", n, seed), _shares("b", n, seed + 1)
    return {"k": ja, "v": jb}, {"k": ta, "v": tb}


# name -> (reference call, port call, args by seed): the calls of the
# reference's tests/test_sharing.py:90, test_circuits.py:77-91,
# test_fused_circuits.py:145 and test_shuffle_sort.py:48, and a sort
CASES = {
    "mul": (lambda a: js.mul(a, a, JPRF), lambda a: ts.mul(a, a, TPRF), lambda: [_shares("a", 64, 1)]),
    "eq": (lambda a, b: jc.eq(a, b, JPRF), lambda a, b: tc.eq(a, b, TPRF),
           lambda: [_shares("b", 32, 2), _shares("b", 32, 3)]),
    "lt": (lambda a, b: jc.lt(a, b, JPRF), lambda a, b: tc.lt(a, b, TPRF),
           lambda: [_shares("b", 32, 2), _shares("b", 32, 3)]),
    "lt16": (lambda a, b: jc.lt(a, b, JPRF, width=16), lambda a, b: tc.lt(a, b, TPRF, width=16),
             lambda: [_shares("b", 32, 2), _shares("b", 32, 3)]),
    "lt_public": (lambda a: jc.lt_public(a, 5, JPRF), lambda a: tc.lt_public(a, 5, TPRF),
                  lambda: [_shares("b", 32, 2)]),
    "ks_add": (lambda a, b: jc.ks_add(a, b, JPRF), lambda a, b: tc.ks_add(a, b, TPRF),
               lambda: [_shares("b", 32, 2), _shares("b", 32, 3)]),
    "b2a": (lambda a: jc.b2a(a, JPRF), lambda a: tc.b2a(a, TPRF), lambda: [_shares("b", 32, 2)]),
    "a2b": (lambda a: jc.a2b(a, JPRF), lambda a: tc.a2b(a, TPRF), lambda: [_shares("a", 32, 4)]),
    "a2b18": (lambda a: jc.a2b(a, JPRF, width=18), lambda a: tc.a2b(a, TPRF, width=18),
              lambda: [_shares("a", 32, 4)]),
    "bit2a": (lambda a: jc.bit2a(a, JPRF), lambda a: tc.bit2a(a, TPRF), lambda: [_shares("b", 32, 2)]),
    "eq_public": (lambda a: jc.eq_public(a, 3, JPRF), lambda a: tc.eq_public(a, 3, TPRF),
                  lambda: [_shares("b", 128, 6)]),
    "secure_shuffle": (lambda c: jshuffle.secure_shuffle(c, JPRF), lambda c: tshuffle.secure_shuffle(c, TPRF),
                       lambda: [_cols(64, 7)]),
    "bitonic_sort": (lambda c: jsort.bitonic_sort(c, "k", JPRF), lambda c: tsort.bitonic_sort(c, "k", TPRF),
                     lambda: [_cols(16, 8)]),
}


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "gates"])
@pytest.mark.parametrize("name", list(CASES))
def test_measure_comm_equals_the_reference_and_the_executed_ledger(name, fuse):
    jfn, tfn, build = CASES[name]
    pairs = build()
    jargs, targs = [p[0] for p in pairs], [p[1] for p in pairs]
    want = jmeasure(jfn, *jargs)
    with override_fusion(fuse):
        got = measure_comm(tfn, *targs)
        with CommLedger() as led:
            tfn(*targs)
    assert got == want == led.tally()


def test_measure_comm_computes_nothing_at_full_width():
    """2^24 lanes on both circuit paths, as the card's phase runs them: on
    ``meta`` the tally comes without a draw, a launch or an allocation, so
    it takes well under a second here, and it scales from a small run's."""
    small = ts.share_b(np.arange(64, dtype=np.uint32), threefry.PRNGKey(1), "cpu")
    big = ts.BShare(torch.empty((3, 1 << 24), dtype=torch.int32, device="meta"))
    for fuse in (True, False):
        with override_fusion(fuse):
            reset_launch_counts()
            t0 = time.perf_counter()
            wide = measure_comm(lambda a, b: tc.lt(a, b, TPRF), big, big)
            assert time.perf_counter() - t0 < 5.0
            assert not launch_counts()
            narrow = measure_comm(lambda a, b: tc.lt(a, b, TPRF), small, small)
        assert wide == {"rounds": narrow["rounds"], "bytes_per_party": narrow["bytes_per_party"] << 18}


def test_measure_comm_maps_tables_and_leaves_the_prf_on_the_host():
    data = {"a": np.arange(16, dtype=np.uint32), "b": np.arange(16, dtype=np.uint32) % 3}
    table = SecretTable.from_plaintext(data, threefry.PRNGKey(2), device="cpu")
    seen = []

    def fn(t, prf):
        seen.append((t.valid.shares.device.type, t.cols["a"].shares.device.type, prf.pair_keys.device.type))
        return tc.eq(t.cols["a"], t.cols["b"], prf)

    got = measure_comm(fn, table, TPRF)
    assert seen == [("meta", "meta", "cpu")]
    with CommLedger() as led:
        fn(table, TPRF)
    assert got == led.tally()


def test_a_host_read_raises_a_clear_error():
    """A Resizer reveals its keep bits and reads S on the host: nothing a
    ``meta`` tensor holds, as ``jax.eval_shape`` refuses a concrete read."""
    table = SecretTable.from_plaintext({"a": np.arange(8, dtype=np.uint32)}, threefry.PRNGKey(2), device="cpu")
    resize = Resizer(ResizerConfig(noise=ConstantNoise(0.5)))
    with pytest.raises(RuntimeError, match="reads a value on the host"):
        measure_comm(lambda t: resize(t, TPRF, threefry.PRNGKey(4)), table)


@pytest.mark.parametrize("read", ["item", "tolist", "cpu", "numpy", "nonzero"])
def test_each_host_read_raises_a_clear_error(read):
    """Each way of reading a value, and only those, is reported as a host
    read."""
    def fn(x):
        x = x.shares.sum()
        return {"item": lambda: x.item(), "tolist": x.tolist, "cpu": x.cpu, "numpy": x.numpy,
                "nonzero": lambda: x.reshape(1).nonzero()}[read]()

    table = SecretTable.from_plaintext({"a": np.arange(8, dtype=np.uint32)}, threefry.PRNGKey(2), device="cpu")
    with pytest.raises(RuntimeError, match="reads a value on the host"):
        measure_comm(fn, table.cols["a"])


def test_other_errors_pass_through_unchanged():
    """A fault on the meta route that is not a host read (here a shape
    error whose message names meta tensors) is not reported as one."""
    def fn(x):
        raise RuntimeError("the fake kernel for meta tensors rejects shape (3, 7)")

    with pytest.raises(RuntimeError, match="^the fake kernel for meta tensors rejects shape"):
        measure_comm(fn, torch.zeros(3, 7))
