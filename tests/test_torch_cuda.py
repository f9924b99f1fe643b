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
from repro_torch.kernels.a2b_fused import a2b_kernel, a2b_plain, bit2a_kernel, bit2a_plain
from repro_torch.kernels.bitonic_stage import stage_swap, stage_swap_plain
from repro_torch.kernels.ks_prefix import (
    and_fold,
    and_fold_plain,
    fold_shifts,
    ks_prefix,
    ks_prefix_plain,
    ks_shifts,
)
from repro_torch.kernels.rss_gate import gate, gate_plain
from repro_torch.kernels.shuffle_gather import (
    gather_direct,
    gather_hop,
    gather_plan,
    gather_plan_plain,
    gather_two_pass,
    shuffle_gather,
    shuffle_gather_plain,
)

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


# fused kernels: N = 0 takes the plain path and launches nothing; 1 and 4097
# (ragged) take the scalar path, 4096 the 16-byte path
FUSED_LANES = [0, 1, 4096, 4097]


@pytest.mark.parametrize("width", [32, 18, 16])
@pytest.mark.parametrize("n", FUSED_LANES)
def test_ks_prefix_kernel_equals_plain(cuda, n, width):
    rng = np.random.default_rng(n + width)
    shifts = ks_shifts(width)
    g, p = _words(rng, (3, n), cuda), _words(rng, (3, n), cuda)
    al = _words(rng, (3, 2 * len(shifts), n), cuda)
    reset_launch_counts()
    got = ks_prefix(g, p, al, shifts)
    torch.cuda.synchronize()
    assert torch.equal(got, ks_prefix_plain(g, p, al, shifts))
    assert launch_counts().get("ks_prefix", 0) == (1 if n else 0)


@pytest.mark.parametrize("width", [32, 18])
@pytest.mark.parametrize("n", FUSED_LANES)
def test_and_fold_kernel_equals_plain(cuda, n, width):
    rng = np.random.default_rng(n + 7 * width)
    shifts = fold_shifts(width)
    v = _words(rng, (3, n), cuda)
    al = _words(rng, (3, len(shifts), n), cuda)
    reset_launch_counts()
    got = and_fold(v, al, shifts)
    torch.cuda.synchronize()
    assert torch.equal(got, and_fold_plain(v, al, shifts))
    assert launch_counts().get("and_fold", 0) == (1 if n else 0)


@pytest.mark.parametrize("width", [32, 18, 16])
@pytest.mark.parametrize("n", FUSED_LANES)
def test_a2b_kernel_equals_plain(cuda, n, width):
    rng = np.random.default_rng(n + 11 * width)
    shifts = ks_shifts(width)
    x = _words(rng, (3, n), cuda)
    al = _words(rng, (3, 2 * (1 + 2 * len(shifts)), n), cuda)
    reset_launch_counts()
    got = a2b_kernel(x, al, shifts)
    torch.cuda.synchronize()
    assert torch.equal(got, a2b_plain(x, al, shifts))
    assert launch_counts().get("a2b_fused", 0) == (1 if n else 0)


@pytest.mark.parametrize("n", FUSED_LANES)
def test_bit2a_kernel_equals_plain(cuda, n):
    rng = np.random.default_rng(n + 3)
    b = _words(rng, (3, n), cuda)
    al = _words(rng, (3, 2, n), cuda)
    reset_launch_counts()
    got = bit2a_kernel(b, al)
    torch.cuda.synchronize()
    assert torch.equal(got, bit2a_plain(b, al))
    assert launch_counts().get("bit2a_fused", 0) == (1 if n else 0)


def test_fused_kernels_unaligned_planes(cuda):
    # views one word into their storage: the kernels must take the scalar path
    rng = np.random.default_rng(5)
    n = 1024
    shifts = ks_shifts(32)
    x = _words(rng, (3 * n + 1,), cuda)[1:].view(3, n)
    y = _words(rng, (3, n), cuda)
    al = _words(rng, (3 * 10 * n + 1,), cuda)[1:].view(3, 10, n)
    assert torch.equal(ks_prefix(x, y, al, shifts), ks_prefix_plain(x, y, al, shifts))
    al = _words(rng, (3 * 22 * n + 1,), cuda)[1:].view(3, 22, n)
    assert torch.equal(a2b_kernel(x, al, shifts), a2b_plain(x, al, shifts))
    al = _words(rng, (3 * 2 * n + 1,), cuda)[1:].view(3, 2, n)
    assert torch.equal(bit2a_kernel(x, al), bit2a_plain(x, al))
    al = _words(rng, (3 * 5 * n + 1,), cuda)[1:].view(3, 5, n)
    assert torch.equal(and_fold(x, al, fold_shifts(32)), and_fold_plain(x, al, fold_shifts(32)))


def test_fused_wrappers_raise_on_bad_input(cuda):
    x = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # non-contiguous operand
        ks_prefix(x.t().contiguous().t(), x, torch.zeros((3, 2, 8), dtype=torch.int32, device=cuda), (1,))
    with pytest.raises(ValueError):  # operands on two devices
        bit2a_kernel(x, torch.zeros((3, 2, 8), dtype=torch.int32))
    with pytest.raises(TypeError):
        and_fold(x.long(), torch.zeros((3, 1, 8), dtype=torch.int64, device=cuda), (1,))


@pytest.mark.parametrize("c", [1, 3, 9])
@pytest.mark.parametrize("n", [1, 3, 128, 257, 1024, 4099])
def test_bitonic_swap_kernel_equals_plain(cuda, n, c):
    rng = np.random.default_rng(n * 10 + c)
    mask = _words(rng, (3, n), cuda)
    own, other, alpha = (_words(rng, (3, c, n), cuda) for _ in range(3))
    reset_launch_counts()
    got = stage_swap(mask, own, other, alpha)
    torch.cuda.synchronize()
    assert torch.equal(got, stage_swap_plain(mask, own, other, alpha))
    assert launch_counts().get("bitonic_swap", 0) == 1


def test_bitonic_swap_kernel_unaligned_planes(cuda):
    # views one word into their storage: the kernel must take the scalar path
    rng = np.random.default_rng(6)
    n, c = 1024, 3
    mask = _words(rng, (3 * n + 1,), cuda)[1:].view(3, n)
    own = _words(rng, (3 * c * n + 1,), cuda)[1:].view(3, c, n)
    other = _words(rng, (3, c, n), cuda)
    alpha = _words(rng, (3 * c * n + 1,), cuda)[1:].view(3, c, n)
    assert torch.equal(stage_swap(mask, own, other, alpha), stage_swap_plain(mask, own, other, alpha))
    with pytest.raises(ValueError):  # non-contiguous operand
        stage_swap(mask, own.transpose(1, 2).contiguous().transpose(1, 2), other, alpha)


def test_sort_on_cuda_equals_cpu(cuda):
    # a 2^12-row, two-key sort with payload narrowing, fused and gate by gate
    from repro_torch.core import threefry
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.sharing import BShare
    from repro_torch.core.sort import bitonic_sort_narrow
    from repro_torch.kernels import override_fusion

    rng = np.random.default_rng(7)
    n = 1 << 12
    cols = {name: _words(rng, (3, n), "cpu") for name in ("a", "b", "c", "d")}
    cols["a"] &= 7
    prf = setup_prf(threefry.PRNGKey(8))
    want = bitonic_sort_narrow({k: BShare(v) for k, v in cols.items()}, ("a", "b"), prf)
    for fused in (True, False):
        reset_launch_counts()
        with override_fusion(fused):
            got = bitonic_sort_narrow({k: BShare(v.to(cuda)) for k, v in cols.items()}, ("a", "b"), prf)
        torch.cuda.synchronize()
        assert (launch_counts().get("bitonic_swap", 0) > 0) == fused
        for name in cols:
            assert torch.equal(got[name].shares.cpu(), want[name].shares), name


# the hop gather: mixed widths in one hop, a permutation per case
def _hop(rng, n, widths, device):
    cols = [_words(rng, (3, n, w), device) for w in widths]
    return cols, torch.from_numpy(rng.permutation(n)).to(device)


def _assert_equals_plain(got, cols, index):
    torch.cuda.synchronize()
    for out, col in zip(got, cols):
        assert out.is_contiguous()
        assert torch.equal(out, shuffle_gather_plain(col, index))


def test_gather_hop_direct_route_equals_plain(cuda):
    # 2^20 rows x 3 words = 12 MiB a plane: the direct route's own size
    rng = np.random.default_rng(20)
    cols, index = _hop(rng, 1 << 20, (1, 3, 1, 1), cuda)
    reset_launch_counts()
    got = gather_direct(cols, index)
    _assert_equals_plain(got, cols, index)
    assert launch_counts() == {"shuffle_gather": 1}
    # gather_hop takes the direct route by itself at this size
    small, sindex = _hop(rng, 1 << 20, (1,), cuda)
    reset_launch_counts()
    _assert_equals_plain(gather_hop(small, sindex), small, sindex)
    assert launch_counts() == {"shuffle_gather": 1}


@pytest.mark.parametrize("widths", [(1, 1), (1, 3, 1, 2, 1, 1)])
def test_gather_hop_two_pass_route_equals_plain(cuda, widths):
    rng = np.random.default_rng(len(widths))
    cols, index = _hop(rng, (1 << 24) + 3, widths, cuda)
    reset_launch_counts()
    got = gather_hop(cols, index)
    _assert_equals_plain(got, cols, index)
    assert launch_counts() == {"shuffle_plan": 1, "shuffle_gather": 2}


@pytest.mark.parametrize("n,chunk_rows,tile_rows", [(1, 1, 1), (4099, 1000, 64), (1_000_003, 20_000, 2048)])
def test_gather_plan_kernel_equals_plain(cuda, n, chunk_rows, tile_rows):
    # counts and starts exactly; each bucket's slots hold the same rows (their
    # order inside a bucket follows the kernel's atomics)
    rng = np.random.default_rng(n)
    index = torch.from_numpy(rng.permutation(n)).to(cuda)
    index[n // 2] = -5
    got = gather_plan(index, chunk_rows, tile_rows)
    want = gather_plan_plain(index, chunk_rows, tile_rows)
    for name in ("counts", "start"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    bucket = torch.repeat_interleave(torch.arange(want.counts.numel(), device=cuda), want.counts.view(-1).long())
    key = lambda plan: torch.sort(bucket * 2**32 + plan.packed.long()).values  # noqa: E731
    assert torch.equal(key(got), key(want))


@pytest.mark.parametrize("route", ["direct", "two_pass"])
def test_gather_hop_unaligned_and_strided_planes(cuda, route):
    # a column one word into its storage, and columns sliced from a stacked one
    rng = np.random.default_rng(21)
    n = 300_001
    shifted = _words(rng, (3 * n * 2 + 1,), cuda)[1:].view(3, n, 2)
    stacked = _words(rng, (3, n, 3), cuda)
    cols = [shifted, stacked[:, :, 0:1], stacked[:, :, 1:3]]
    index = torch.from_numpy(rng.permutation(n)).to(cuda)
    if route == "direct":
        got = gather_direct(cols, index)
    else:
        got = gather_two_pass(cols, index, chunk_rows=20_000, tile_rows=512)
    _assert_equals_plain(got, cols, index)


@pytest.mark.parametrize("route", ["direct", "two_pass"])
def test_gather_hop_out_of_range_rows_equal_plain(cuda, route):
    rng = np.random.default_rng(22)
    n = 200_000
    cols, index = _hop(rng, n, (1, 2), cuda)
    bad = torch.tensor([0, 7, n // 2, n - 1], device=cuda)
    index[bad] = torch.tensor([-1, n, 2**40, -(2**40)], device=cuda)
    if route == "direct":
        got = gather_direct(cols, index)
    else:
        got = gather_two_pass(cols, index, chunk_rows=30_000, tile_rows=1024)
    _assert_equals_plain(got, cols, index)
    assert not any(out[:, bad].any() for out in got)


def test_shuffle_round_trip_on_cuda_equals_cpu(cuda):
    # secure_shuffle then inverse_shuffle over 6 M rows and two columns
    # (23 MiB a plane: the two-pass route) gives the same shares on both devices
    from repro_torch.core import threefry
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.sharing import AShare, BShare
    from repro_torch.core.shuffle import inverse_shuffle, secure_shuffle

    rng = np.random.default_rng(23)
    n = 6_000_000
    host = {"k": BShare(_words(rng, (3, n), "cpu")), "v": AShare(_words(rng, (3, n), "cpu"))}
    prf = setup_prf(threefry.PRNGKey(9))
    want = inverse_shuffle(secure_shuffle(host, prf), prf.fold(1))
    reset_launch_counts()
    got = inverse_shuffle(secure_shuffle({k: type(v)(v.shares.to(cuda)) for k, v in host.items()}, prf),
                          prf.fold(1))
    torch.cuda.synchronize()
    assert launch_counts() == {"shuffle_plan": 6, "shuffle_gather": 12}
    for name in host:
        assert type(got[name]) is type(want[name])
        assert torch.equal(got[name].shares.cpu(), want[name].shares), name
