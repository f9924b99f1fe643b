"""The port's plain rss_gate / shuffle_gather against repro's oracles and its
Pallas kernels in interpret mode, on numpy-seeded inputs (exact equality).
The kernels themselves, on the card, are held against these plain versions
in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rss_gate.ops import gate as jgate  # noqa: E402
from repro.kernels.rss_gate.ref import rss_gate_ref  # noqa: E402
from repro.kernels.shuffle_gather.ops import gather_rows as jgather_rows  # noqa: E402
from repro.kernels.shuffle_gather.ref import shuffle_gather_ref  # noqa: E402
from repro_torch.core.ring import from_numpy, to_numpy  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.rss_gate import gate, gate_plain  # noqa: E402
from repro_torch.kernels.shuffle_gather import shuffle_gather, shuffle_gather_plain  # noqa: E402

# words either side of the 2^31 wrap, and the ring's extremes
EDGES = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _words(rng, shape):
    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    k = min(flat.size, EDGES.size)
    flat[:k] = EDGES[:k]
    return w


@pytest.mark.parametrize("boolean", [True, False])
@pytest.mark.parametrize("n", [0, 1, 127, 2049])
def test_rss_gate_plain_equals_oracle_and_pallas(n, boolean):
    rng = np.random.default_rng(1000 + n)
    x, y, a = (_words(rng, (3, n)) for _ in range(3))
    want = np.asarray(rss_gate_ref(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a), boolean))
    pallas = np.asarray(jgate(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a), boolean=boolean))
    tx, ty, ta = (from_numpy(v, "cpu") for v in (x, y, a))
    got = to_numpy(gate_plain(tx, ty, ta, boolean))
    assert (got == want).all() and (got == pallas).all()
    reset_launch_counts()
    assert (to_numpy(gate(tx, ty, ta, boolean)) == want).all()
    assert launch_counts().get("rss_gate", 0) == 0  # a CPU tensor never launches


@pytest.mark.parametrize("boolean", [True, False])
def test_rss_gate_broadcast_operands(boolean):
    # the port broadcasts before flattening lanes, as repro's wrapper does
    rng = np.random.default_rng(5)
    x = _words(rng, (3, 9, 2))
    y = _words(rng, (3, 9, 1))
    a = _words(rng, (3, 9, 2))
    want = np.asarray(jgate(jnp.asarray(x), jnp.asarray(y), jnp.asarray(a), boolean=boolean))
    tx, ty = torch.broadcast_tensors(from_numpy(x, "cpu"), from_numpy(y, "cpu"))
    got = gate(tx.contiguous(), ty.contiguous(), from_numpy(a, "cpu"), boolean)
    assert (to_numpy(got) == want).all()


@pytest.mark.parametrize("n,c", [(1, 1), (257, 3), (2049, 1), (300, 2)])
def test_shuffle_gather_plain_equals_oracle_and_pallas(n, c):
    rng = np.random.default_rng(n * 10 + c)
    planes = _words(rng, (3, n, c))
    perm = rng.permutation(n)
    tplanes = from_numpy(planes, "cpu")
    tperm = torch.from_numpy(perm)
    got = to_numpy(shuffle_gather_plain(tplanes, tperm))
    reset_launch_counts()
    via_wrapper = to_numpy(shuffle_gather(tplanes, tperm))
    assert launch_counts().get("shuffle_gather", 0) == 0
    for p in range(3):
        table = jnp.asarray(planes[p])
        jperm = jnp.asarray(perm.astype(np.int32))
        want = np.asarray(shuffle_gather_ref(table, jperm))
        assert (got[p] == want).all() and (via_wrapper[p] == want).all()
        assert (got[p] == np.asarray(jgather_rows(table, jperm))).all()


class _Elsewhere(torch.Tensor):
    """A tensor on a device the wrappers have no route for (neither cpu,
    cuda nor meta)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_shuffle_gather_out_of_range_rows_read_zero():
    # the kernel's contract for a malformed index, which the plain version
    # (the CPU path) shares: the row comes out as zeros, nothing raises
    rng = np.random.default_rng(11)
    planes = from_numpy(_words(rng, (3, 9, 2)), "cpu")
    perm = torch.from_numpy(rng.permutation(9))
    perm[[2, 5, 7]] = torch.tensor([-1, 9, 2**40])
    got = shuffle_gather(planes, perm)
    inside = (perm >= 0) & (perm < 9)
    assert (got[:, ~inside] == 0).all()
    assert torch.equal(got[:, inside], planes[:, perm[inside]])


def test_wrappers_check_their_inputs():
    x = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        gate(x, x[:, :4], x, True)
    with pytest.raises(ValueError):
        gate(x[:2], x[:2], x[:2], True)
    with pytest.raises(TypeError):  # int64 words are ring-64: one ring for all three
        gate(x.long(), x, x.long(), True)
    with pytest.raises(TypeError):
        gate(x.to(torch.int16), x.to(torch.int16), x.to(torch.int16), True)
    with pytest.raises(ValueError):
        gate(*(x.as_subclass(_Elsewhere),) * 3, True)
    # meta (measure_comm) gives the output's shape and launches nothing
    reset_launch_counts()
    out = gate(x.to("meta"), x.to("meta"), x.to("meta"), True)
    assert out.device.type == "meta" and out.shape == x.shape and not launch_counts()
    with pytest.raises(TypeError):
        shuffle_gather(x.view(3, 8, 1), torch.arange(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        shuffle_gather(x.view(3, 8, 1), torch.arange(7))
