"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.rss_gate import gate, gate_plain
from repro_torch.kernels.shuffle_gather import shuffle_gather, shuffle_gather_plain

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, shape, device):
    return torch.from_numpy(
        rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32)
    ).to(device)


@pytest.mark.parametrize("boolean", [True, False])
@pytest.mark.parametrize("n", [0, 1, 127, 2049, 65536])
def test_rss_gate_kernel_equals_plain(cuda, boolean, n):
    rng = np.random.default_rng(n)
    x, y, a = (_words(rng, (3, n), cuda) for _ in range(3))
    reset_launch_counts()
    got = gate(x, y, a, boolean)
    torch.cuda.synchronize()
    assert torch.equal(got, gate_plain(x, y, a, boolean))
    assert launch_counts().get("rss_gate", 0) == (1 if n else 0)


def test_rss_gate_kernel_unaligned_planes(cuda):
    # a view one word into its storage: the kernel must take the scalar path
    rng = np.random.default_rng(3)
    base = _words(rng, (3 * 1025 + 1,), cuda)
    x = base[1:].view(3, 1025)
    y = _words(rng, (3, 1025), cuda)
    a = _words(rng, (3, 1025), cuda)
    assert torch.equal(gate(x, y, a, True), gate_plain(x, y, a, True))


@pytest.mark.parametrize("p,n,c", [(3, 1, 1), (3, 257, 3), (1, 1000, 2), (3, 100_000, 1)])
def test_shuffle_gather_kernel_equals_plain(cuda, p, n, c):
    rng = np.random.default_rng(n)
    planes = _words(rng, (p, n, c), cuda)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    reset_launch_counts()
    got = shuffle_gather(planes, perm)
    torch.cuda.synchronize()
    assert torch.equal(got, shuffle_gather_plain(planes, perm))
    assert launch_counts().get("shuffle_gather", 0) == 1


def test_shuffle_gather_kernel_out_of_range_rows_equal_plain(cuda):
    # an index outside [0, N) reads as zeros in the kernel and its plain version
    rng = np.random.default_rng(12)
    planes = _words(rng, (3, 1000, 2), cuda)
    perm = torch.from_numpy(rng.permutation(1000)).to(cuda)
    perm[[0, 500, 999]] = torch.tensor([-1, 1000, 2**40], device=cuda)
    got = shuffle_gather(planes, perm)
    assert torch.equal(got, shuffle_gather_plain(planes, perm))
    assert (got[:, [0, 500, 999]] == 0).all()


def test_wrappers_raise_on_bad_input(cuda):
    x = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        gate(x, x[:, :4], x, True)
    with pytest.raises(TypeError):
        gate(x.long(), x.long(), x.long(), True)
    with pytest.raises(ValueError):
        gate(x.t().contiguous().t(), x, x, True)
    with pytest.raises(TypeError):
        shuffle_gather(x.view(3, 8, 1), torch.arange(8, device=cuda, dtype=torch.int32))
