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
    with pytest.raises(TypeError):  # int64 words are ring-64: one ring for all three
        gate(x.long(), x, x.long(), True)
    with pytest.raises(TypeError):
        gate(x.to(torch.int16), x.to(torch.int16), x.to(torch.int16), True)
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
    with pytest.raises(TypeError):  # int64 words are ring-64: one ring for all operands
        and_fold(x.long(), torch.zeros((3, 1, 8), dtype=torch.int32, device=cuda), (1,))
    with pytest.raises(TypeError):
        and_fold(x.to(torch.int16), torch.zeros((3, 1, 8), dtype=torch.int16, device=cuda), (1,))


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


@pytest.mark.parametrize("n", [0, 1, 1023, (1 << 20) + 3])
@pytest.mark.parametrize("r", [1, 3, 6])
def test_threefry_kernel_equals_plain(cuda, r, n):
    """Host keys (one launch per four keys) and device keys (one launch)
    against the plain draws, bit for bit, with their launch counts."""
    from repro_torch.core import threefry
    from repro_torch.kernels.threefry import draw, draw_plain

    keys = torch.stack([threefry.PRNGKey(1000 * r + i) for i in range(r)])
    want = draw_plain(keys, n, cuda)
    for k, launches in ((keys, -(-r // 4)), (keys.to(cuda), 1)):
        reset_launch_counts()
        got = draw(k, n, cuda)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert launch_counts().get("threefry_bits", 0) == (launches if n else 0)
    assert torch.equal(want.cpu(), draw_plain(keys, n, "cpu"))


def test_threefry_kernel_in_a_graph_reads_its_device_keys(cuda):
    """A captured draw on device keys, replayed after the keys are
    refilled, draws with the new keys."""
    from repro_torch.core import threefry
    from repro_torch.kernels.threefry import draw, draw_plain

    keys = torch.stack([threefry.PRNGKey(s) for s in (1, 2, 3)]).to(cuda)
    draw(keys, 4099, cuda)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = draw(keys, 4099, cuda)
    for seeds in ((4, 5, 6), (7, 8, 9)):
        keys.copy_(torch.stack([threefry.PRNGKey(s) for s in seeds]))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, draw_plain(keys, 4099, cuda))


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
    # 2 shuffles x 3 hops, each permutation 3 rounds of 32-bit sort keys (18
    # draws), and each hop's zero sharings of its two columns (12 draws)
    assert launch_counts() == {"shuffle_plan": 6, "shuffle_gather": 12, "threefry_bits": 30}
    for name in host:
        assert type(got[name]) is type(want[name])
        assert torch.equal(got[name].shares.cpu(), want[name].shares), name


@pytest.mark.parametrize("fanout,theta", [(1, None), (4, ("t", "le", "t"))])
def test_sortmerge_join_on_cuda_equals_cpu(cuda, fanout, theta):
    # a 2,000 x 1,500-row sort-merge join (a 4,096-row union), fused and gate
    # by gate: the same shares on both devices, and every kernel of the path
    # launched on the fused one
    from repro_torch.core import threefry
    from repro_torch.core.prf import setup_prf
    from repro_torch.kernels import override_fusion
    from repro_torch.ops import SecretTable, oblivious_join_sortmerge

    rng = np.random.default_rng(fanout)
    data = [
        {"k": rng.integers(0, 400, n).astype(np.uint32), "t": rng.integers(0, 50, n).astype(np.uint32)}
        for n in (2000, 1500)
    ]
    valid = [(rng.random(len(d["k"])) < 0.8).astype(np.uint32) for d in data]
    prf = setup_prf(threefry.PRNGKey(3))

    def run(device):
        left, right = (SecretTable.from_plaintext(d, threefry.PRNGKey(i), valid=v, device=device)
                       for i, (d, v) in enumerate(zip(data, valid)))
        return oblivious_join_sortmerge(left, right, ("k", "k"), prf, theta=theta, fanout=fanout, build="right")

    want = run("cpu")
    for fused in (True, False):
        reset_launch_counts()
        with override_fusion(fused):
            got = run(cuda)
        torch.cuda.synchronize()
        launches = launch_counts()
        kernels = {"rss_gate", "shuffle_gather", "ks_prefix", "and_fold", "bitonic_swap"}
        if fanout > 1:
            kernels |= {"a2b_fused", "bit2a_fused"}
        if fused:
            assert kernels <= {k for k, c in launches.items() if c}, launches
        assert list(got.cols) == list(want.cols)
        for name in want.cols:
            assert torch.equal(got.col(name).shares.cpu(), want.col(name).shares), name
        assert torch.equal(got.valid.shares.cpu(), want.valid.shares)


# -----------------------------------------------------------------------------
# batch rules: K slots under torch.func.vmap in one launch
# -----------------------------------------------------------------------------

K = 4


def _slots(rng, shape, device, batched=True):
    return _words(rng, ((K,) + shape) if batched else shape, device)


def _one_launch_equals_k_launches(kind, fn, plain, operands, dims):
    """vmap(fn) launches ``kind`` once for all K slots; each slot equals a
    launch of its own and the plain version."""
    reset_launch_counts()
    got = torch.func.vmap(fn, in_dims=dims)(*operands)
    torch.cuda.synchronize()
    assert launch_counts().get(kind, 0) == 1, launch_counts()
    for i in range(K):
        slot = [t if d is None else t[i] for t, d in zip(operands, dims)]
        assert torch.equal(got[i], fn(*slot))
        assert torch.equal(got[i], plain(*slot))


@pytest.mark.parametrize("boolean", [True, False])
def test_rss_gate_batch_rule(cuda, boolean):
    rng = np.random.default_rng(11)
    ops = [_slots(rng, (3, 1000), cuda), _slots(rng, (3, 1000), cuda), _slots(rng, (3, 1000), cuda, False)]
    _one_launch_equals_k_launches("rss_gate", lambda x, y, a: gate(x, y, a, boolean),
                                  lambda x, y, a: gate_plain(x, y, a, boolean), ops, (0, 0, None))


def test_ks_prefix_and_fold_batch_rules(cuda):
    rng = np.random.default_rng(12)
    ks, fs = ks_shifts(32), fold_shifts(32)
    ops = [_slots(rng, (3, 777), cuda), _slots(rng, (3, 777), cuda), _slots(rng, (3, 2 * len(ks), 777), cuda, False)]
    _one_launch_equals_k_launches("ks_prefix", lambda g, p, a: ks_prefix(g, p, a, ks),
                                  lambda g, p, a: ks_prefix_plain(g, p, a, ks), ops, (0, 0, None))
    ops = [_slots(rng, (3, 777), cuda), _slots(rng, (3, len(fs), 777), cuda)]
    _one_launch_equals_k_launches("and_fold", lambda v, a: and_fold(v, a, fs),
                                  lambda v, a: and_fold_plain(v, a, fs), ops, (0, 0))


def test_a2b_and_bit2a_batch_rules(cuda):
    rng = np.random.default_rng(13)
    ks = ks_shifts(32)
    ops = [_slots(rng, (3, 513), cuda), _slots(rng, (3, 2 * (1 + 2 * len(ks)), 513), cuda, False)]
    _one_launch_equals_k_launches("a2b_fused", lambda x, a: a2b_kernel(x, a, ks),
                                  lambda x, a: a2b_plain(x, a, ks), ops, (0, None))
    ops = [_slots(rng, (3, 513), cuda), _slots(rng, (3, 2, 513), cuda)]
    _one_launch_equals_k_launches("bit2a_fused", bit2a_kernel, bit2a_plain, ops, (0, 0))


def test_bitonic_swap_batch_rule(cuda):
    rng = np.random.default_rng(14)
    ops = [_slots(rng, (3, 1030), cuda), _slots(rng, (3, 5, 1030), cuda), _slots(rng, (3, 5, 1030), cuda),
           _slots(rng, (3, 5, 1030), cuda, False)]
    _one_launch_equals_k_launches("bitonic_swap", stage_swap, stage_swap_plain, ops, (0, 0, 0, None))


@pytest.mark.parametrize("n,ncols", [(4099, 2), (4099, 12), (2_000_000, 2)])
def test_gather_hop_batch_rule(cuda, n, ncols):
    # one index for all slots (a hop's permutation): the K slots are K times
    # a column's planes, so a hop of 12 columns (48 slot-columns, above the
    # kernels' 32 a launch) still launches once; at 2,000,000 rows x 3 words
    # a plane passes 22 MiB (the two-pass route)
    rng = np.random.default_rng(15)
    cols = [_slots(rng, (3, n, 1 + 2 * (i % 2)), cuda) for i in range(ncols)]
    index = torch.from_numpy(rng.permutation(n)).to(cuda)
    reset_launch_counts()
    serial = gather_hop([c[0] for c in cols], index)
    serial_launches = launch_counts()
    reset_launch_counts()
    got = torch.func.vmap(lambda *xs: gather_hop(list(xs), index))(*cols)
    torch.cuda.synchronize()
    assert launch_counts() == serial_launches
    for col, out, first in zip(cols, got, serial):
        for i in range(K):
            assert torch.equal(out[i], shuffle_gather_plain(col[i], index))
        assert torch.equal(out[0], first)


def test_gather_hop_batch_rule_with_an_index_per_slot(cuda):
    rng = np.random.default_rng(16)
    n = 3001
    a = _slots(rng, (3, n, 2), cuda)
    index = torch.stack([torch.from_numpy(rng.permutation(n)) for _ in range(K)]).to(cuda)
    reset_launch_counts()
    (got,) = torch.func.vmap(lambda x, i: gather_hop([x], i))(a, index)
    torch.cuda.synchronize()
    assert launch_counts().get("shuffle_gather", 0) == 1
    for i in range(K):
        assert torch.equal(got[i], shuffle_gather_plain(a[i], index[i]))


def test_execute_batch_on_cuda_equals_cpu(cuda):
    from repro_torch.core import threefry
    from repro_torch.core.noise import BetaNoise
    from repro_torch.core.resizer import ResizerConfig
    from repro_torch.data import dosage_study_plan, generate_healthlnk
    from repro_torch.engine import Engine
    from repro_torch.plan import insert_resizers

    plan = insert_resizers(dosage_study_plan(), lambda node: ResizerConfig(noise=BetaNoise(2, 6)))
    pow2 = lambda s: 1 << max(s - 1, 0).bit_length()  # noqa: E731
    results = {}
    for device in ("cpu", cuda):
        tables, _ = generate_healthlnk(n=64, seed=1, device=device)
        eng = Engine(tables, key=threefry.PRNGKey(4), bucket_fn=pow2, device=device)
        results[str(device)] = (eng.execute_batch([plan] * 3), dict(eng.last_batch_stats))
    (cpu, cstats), (gpu, gstats) = results["cpu"], results["cuda"]
    assert cstats == gstats and gstats["stacked_nodes"] > 0
    for (co, cr), (go, gr) in zip(cpu, gpu):
        assert [(s.node, s.rounds, s.bytes_per_party, s.extra) for s in cr.nodes] == \
            [(s.node, s.rounds, s.bytes_per_party, s.extra) for s in gr.nodes]
        assert torch.equal(co.valid.shares, go.valid.shares.cpu())
        for name in co.cols:
            assert torch.equal(co.col(name).shares, go.col(name).shares.cpu()), name


def _service_results(device, tmp_path, offline="on"):
    from repro_torch.core import threefry
    from repro_torch.data import QUERY_SQL, generate_healthlnk
    from repro_torch.service import AnalyticsService

    tables, plain = generate_healthlnk(n=48, seed=0, device=device)
    svc = AnalyticsService(tables, key=threefry.PRNGKey(42), offline=offline, device=device,
                           state_dir=str(tmp_path / f"{torch.device(device).type}-{offline}"))
    dosage = QUERY_SQL["dosage_study"]
    sequence = [("alice", dosage), ("bob", QUERY_SQL["aspirin_count"]), ("carol", QUERY_SQL["comorbidity"]),
                ("alice", dosage.replace("390", "414")), ("dave", dosage)]
    results = []
    for i, (tenant, sql) in enumerate(sequence):
        results.append(svc.session(tenant).submit(sql))
        if i == 0:
            svc.drain()  # the idle window: the provisioner refills the pool
    svc.close()
    return svc, results


def _assert_same_results(a, b):
    for x, y in zip(a, b):
        assert [(s.node, s.rounds, s.bytes_per_party, s.n_out, s.extra.get("s")) for s in x.report.nodes] == \
            [(s.node, s.rounds, s.bytes_per_party, s.n_out, s.extra.get("s")) for s in y.report.nodes]
        assert torch.equal(x.table.valid.shares.cpu(), y.table.valid.shares.cpu())
        for name in x.table.cols:
            assert torch.equal(x.table.col(name).shares.cpu(), y.table.col(name).shares.cpu()), name
        for k in x.rows:
            assert np.array_equal(x.rows[k], y.rows[k])


def test_service_on_cuda_equals_cpu(cuda, tmp_path):
    """The service at n=48: the same submits on the card and on the CPU
    give the same shares, ledgers, S, rows, accountant, plan cache and pool."""
    gsvc, gpu = _service_results(cuda, tmp_path)
    csvc, cpu = _service_results("cpu", tmp_path)
    _assert_same_results(gpu, cpu)
    assert gsvc.accountant.status() == csvc.accountant.status()
    assert gsvc.stats == csvc.stats and gsvc.pool.stats() == csvc.pool.stats()
    assert gsvc.pool.stats()["hits"] > 0


def test_service_pool_hits_equal_misses_on_cuda(cuda, tmp_path):
    _, hot = _service_results(cuda, tmp_path, offline="on")
    _, cold = _service_results(cuda, tmp_path, offline="off")
    _assert_same_results(hot, cold)


def test_service_submit_launches_equal_engine_execute(cuda, tmp_path):
    from repro_torch.core import threefry
    from repro_torch.data import QUERY_SQL, generate_healthlnk
    from repro_torch.engine import Engine
    from repro_torch.service import AnalyticsService

    tables, _ = generate_healthlnk(n=48, seed=0, device=cuda)
    svc = AnalyticsService(tables, key=threefry.PRNGKey(42), device=cuda, state_dir=str(tmp_path))
    reset_launch_counts()
    res = svc.session("a").submit(QUERY_SQL["dosage_study"])
    torch.cuda.synchronize()
    submitted = launch_counts()
    reset_launch_counts()
    Engine(tables, key=threefry.PRNGKey(42), device=cuda).execute(res.plan)
    torch.cuda.synchronize()
    executed = launch_counts()
    # the service's randomness pool draws its material ahead of the
    # protocol, so the draws (threefry_bits) differ; every other kernel
    # launches as often
    draws = "threefry_bits"
    assert {k: v for k, v in executed.items() if k != draws} == {k: v for k, v in submitted.items() if k != draws}
    assert submitted.get("shuffle_gather", 0) > 0 and submitted.get(draws, 0) > 0 and executed.get(draws, 0) > 0


def test_background_provisioner_on_cuda(cuda, tmp_path):
    """The provisioner thread draws on the card on the default stream; the
    pooled material it hands the engine equals the on-demand draws."""
    import time

    from repro_torch.core import threefry
    from repro_torch.data import QUERY_SQL, generate_healthlnk
    from repro_torch.service import AnalyticsService

    tables, _ = generate_healthlnk(n=48, seed=0, device=cuda)
    ref = AnalyticsService(tables, key=threefry.PRNGKey(42), device=cuda, offline="off")
    want = [ref.session("a").submit(QUERY_SQL["dosage_study"]) for _ in range(3)]
    svc = AnalyticsService(tables, key=threefry.PRNGKey(42), device=cuda, offline="background")
    try:
        svc.provisioner.interval_s = 0.05
        got = [svc.session("a").submit(QUERY_SQL["dosage_study"])]
        deadline = time.monotonic() + 60
        while svc.pool.stats()["counter_entries"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        got += [svc.session("a").submit(QUERY_SQL["dosage_study"]) for _ in range(2)]
        assert svc.provisioner.stats()["error"] is None and svc.pool.stats()["hits"] > 0
    finally:
        svc.close()
    _assert_same_results(got, want)


def _net_summary(res):
    """A networked result's output shares, per-node ledger, S and rows."""
    return (
        {k: res.table.col(k).shares.cpu().numpy().tolist() for k in res.table.cols},
        res.table.valid.shares.cpu().numpy().tolist(),
        [(s.node, s.n_ins, s.n_out, s.rounds, s.bytes_per_party, s.extra.get("s")) for s in res.report.nodes],
        {k: np.asarray(v).tolist() for k, v in res.rows.items()},
    )


def test_loopback_mesh_on_cuda_equals_cpu(cuda):
    """Three party threads on the card (a loopback mesh) give the shares,
    per-node ledger, S and rows of three party threads on the CPU, with wire
    bytes equal to ledger bytes and every kernel launch three times one
    in-process run's."""
    from repro_torch.core import threefry
    from repro_torch.data import QUERY_SQL, generate_healthlnk
    from repro_torch.runtime import ReflexClient

    queries = ("dosage_study", "med_dosage_sum", "comorbidity")
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        tables, _ = generate_healthlnk(n=48, seed=3, aspirin_frac=0.5, device=dev)
        with ReflexClient.networked(tables, key_seed=2, device=dev) as net:
            got = []
            for q in queries:
                got.append(_net_summary(net.submit("t", QUERY_SQL[q])))
                for a in net.service.engine.last_wire_audit:
                    assert a["wire_bytes"] == a["exchange_bytes"] == a["ledger_bytes"]
                    assert a["payload_exchanges"] > 0
            runs[dev.type] = got
    assert runs["cuda"] == runs["cpu"]
    # launches: networked = 3 x in-process, query by query
    tables, _ = generate_healthlnk(n=48, seed=3, aspirin_frac=0.5, device=cuda)
    local = ReflexClient.in_process(tables, key=threefry.PRNGKey(2), offline="off", device=cuda)
    with ReflexClient.networked(tables, key_seed=2, device=cuda) as net:
        for q in queries:
            counts = []
            for client in (local, net):
                torch.cuda.synchronize()
                reset_launch_counts()
                client.submit("t", QUERY_SQL[q])
                torch.cuda.synchronize()
                counts.append(launch_counts())
            assert counts[1] == {k: 3 * v for k, v in counts[0].items()} and counts[0]
    local.close()


# -----------------------------------------------------------------------------
# ring-64: the five 64-bit builds (int64 planes), counted as "<kernel>_u64"
# -----------------------------------------------------------------------------

def _words64(rng, shape, device):
    return torch.from_numpy(rng.integers(0, 2**64, size=shape, dtype=np.uint64).view(np.int64)).to(device)


def _wide_calls(rng, n, cuda):
    """(kernel name, kernel call, plain call) of each 64-bit build at n lanes."""
    ks, fs = ks_shifts(64), fold_shifts(64)
    x, y, a = (_words64(rng, (3, n), cuda) for _ in range(3))
    alpha_ks = _words64(rng, (3, 2 * len(ks), n), cuda)
    alpha_fold = _words64(rng, (3, len(fs), n), cuda)
    alpha_a2b = _words64(rng, (3, 2 * (1 + 2 * len(ks)), n), cuda)
    alpha_bit = _words64(rng, (3, 2, n), cuda)
    return [
        ("rss_gate", lambda: gate(x, y, a, True), lambda: gate_plain(x, y, a, True)),
        ("rss_gate", lambda: gate(x, y, a, False), lambda: gate_plain(x, y, a, False)),
        ("ks_prefix", lambda: ks_prefix(x, y, alpha_ks, ks), lambda: ks_prefix_plain(x, y, alpha_ks, ks)),
        ("and_fold", lambda: and_fold(x, alpha_fold, fs), lambda: and_fold_plain(x, alpha_fold, fs)),
        ("a2b_fused", lambda: a2b_kernel(x, alpha_a2b, ks), lambda: a2b_plain(x, alpha_a2b, ks)),
        ("bit2a_fused", lambda: bit2a_kernel(x, alpha_bit), lambda: bit2a_plain(x, alpha_bit)),
    ]


@pytest.mark.parametrize("n", [1 << 16, 4099])
def test_wide_builds_equal_plain(cuda, n):
    # an aligned lane count (the 16-byte path) and an odd one (the scalar path)
    for kind, kernel, plain in _wide_calls(np.random.default_rng(n), n, cuda):
        reset_launch_counts()
        got = kernel()
        torch.cuda.synchronize()
        assert launch_counts() == {kind + "_u64": 1}
        assert got.dtype == torch.int64 and torch.equal(got, plain()), kind


@pytest.mark.parametrize("width", [18, 32])
def test_wide_builds_at_the_circuits_other_widths(cuda, width):
    rng = np.random.default_rng(width)
    ks, fs = ks_shifts(width), fold_shifts(width)
    g, p = _words64(rng, (3, 1031), cuda), _words64(rng, (3, 1031), cuda)
    a = _words64(rng, (3, 2 * len(ks), 1031), cuda)
    assert torch.equal(ks_prefix(g, p, a, ks), ks_prefix_plain(g, p, a, ks))
    a = _words64(rng, (3, len(fs), 1031), cuda)
    assert torch.equal(and_fold(g, a, fs), and_fold_plain(g, a, fs))
    a = _words64(rng, (3, 2 * (1 + 2 * len(ks)), 1031), cuda)
    assert torch.equal(a2b_kernel(g, a, ks), a2b_plain(g, a, ks))


def test_wide_builds_unaligned_planes(cuda):
    rng = np.random.default_rng(5)
    base = _words64(rng, (3 * 1024 + 1,), cuda)
    x = base[1:].view(3, 1024)  # 8 bytes into its storage: the scalar path
    y, a = _words64(rng, (3, 1024), cuda), _words64(rng, (3, 1024), cuda)
    assert torch.equal(gate(x, y, a, False), gate_plain(x, y, a, False))
    ks = ks_shifts(64)
    alpha = _words64(rng, (3, 2 * (1 + 2 * len(ks)), 1024), cuda)
    assert torch.equal(a2b_kernel(x, alpha, ks), a2b_plain(x, alpha, ks))


def test_wide_batch_rules(cuda):
    rng = np.random.default_rng(15)

    def slots(shape, batched=True):
        return _words64(rng, ((K,) + shape) if batched else shape, cuda)

    ops = [slots((3, 999)), slots((3, 999)), slots((3, 999), False)]
    _one_launch_equals_k_launches("rss_gate_u64", lambda x, y, a: gate(x, y, a, False),
                                  lambda x, y, a: gate_plain(x, y, a, False), ops, (0, 0, None))
    ks = ks_shifts(64)
    ops = [slots((3, 999)), slots((3, 2 * (1 + 2 * len(ks)), 999), False)]
    _one_launch_equals_k_launches("a2b_fused_u64", lambda x, a: a2b_kernel(x, a, ks),
                                  lambda x, a: a2b_plain(x, a, ks), ops, (0, None))


def test_ring64_circuits_on_cuda_equal_cpu(cuda):
    """Ring-64 circuits on the card: the shares and ledger of the CPU, on
    both paths, and the answers of numpy uint64."""
    from repro_torch.core import circuits as c
    from repro_torch.core import sharing as sh
    from repro_torch.core import threefry
    from repro_torch.core.ledger import CommLedger
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.ring import RING64, to_numpy
    from repro_torch.kernels import override_fusion

    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**64, 1000, dtype=np.uint64)
    y = rng.integers(0, 2**64, 1000, dtype=np.uint64)
    x[:3] = [0, 2**63, 2**64 - 1]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        prf = setup_prf(threefry.PRNGKey(1))
        xb, yb = sh.share_b(x, threefry.PRNGKey(2), dev, RING64), sh.share_b(y, threefry.PRNGKey(3), dev, RING64)
        xa = sh.share_a(x, threefry.PRNGKey(4), dev, RING64)
        for fused in (True, False):
            with override_fusion(fused), CommLedger() as led:
                outs = [c.lt(xb, yb, prf), c.eq(xb, yb, prf), c.a2b(xa, prf), c.b2a(xb, prf), sh.mul(xa, xa, prf)]
            runs[dev.type, fused] = ([to_numpy(o.shares) for o in outs], led.tally())
    for fused in (True, False):
        got, want = runs["cuda", fused], runs["cpu", fused]
        assert got[1] == want[1] and all((a == b).all() for a, b in zip(got[0], want[0]))
    lt = np.bitwise_xor.reduce(runs["cuda", True][0][0], axis=0) & np.uint64(1)
    assert (lt == (x < y)).all()
    with pytest.raises(TypeError, match="ring-32"):
        shuffle_gather(_words64(rng, (3, 8, 1), cuda), torch.arange(8, device=cuda))



@pytest.mark.parametrize("fuse", [True, False])
def test_measure_comm_of_cuda_tensors_launches_nothing(cuda, fuse):
    """``measure_comm`` maps the card's tensors to ``meta``: no launch, the
    tally of the executed call, which launches its kernels."""
    from repro_torch.core import threefry
    from repro_torch.core.circuits import a2b, lt
    from repro_torch.core.ledger import CommLedger, measure_comm
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.sharing import AShare, BShare
    from repro_torch.kernels import override_fusion

    rng = np.random.default_rng(25)
    prf = setup_prf(threefry.PRNGKey(25))
    x, y, z = (_words(rng, (3, 4099), cuda) for _ in range(3))

    def fn(a, b, c):
        return lt(BShare(a), BShare(b), prf), a2b(AShare(c), prf)

    with override_fusion(fuse):
        reset_launch_counts()
        tally = measure_comm(fn, x, y, z)
        assert not launch_counts()
        with CommLedger() as led:
            fn(x, y, z)
        torch.cuda.synchronize()
    assert tally == led.tally()
    assert launch_counts().get("ks_prefix" if fuse else "rss_gate", 0) > 0


def test_lazy_and_eager_joins_on_cuda_equal_cpu(cuda):
    from repro_torch.core import threefry
    from repro_torch.core.prf import setup_prf
    from repro_torch.ops import SecretTable, oblivious_join
    from repro_torch.ops.table import gather_log, reset_gather_log, table_nbytes

    rng = np.random.default_rng(26)
    left = {"pid": rng.integers(0, 5, 40).astype(np.uint32), "x": np.arange(40, dtype=np.uint32)}
    right = {"pid2": rng.integers(0, 5, 33).astype(np.uint32), "y": np.arange(33, dtype=np.uint32)}
    prf = setup_prf(threefry.PRNGKey(26))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        lt_ = SecretTable.from_plaintext(left, threefry.PRNGKey(1), device=dev)
        rt_ = SecretTable.from_plaintext(right, threefry.PRNGKey(2), device=dev)
        for lazy in (True, False):
            joined = oblivious_join(lt_, rt_, ("pid", "pid2"), prf, lazy=lazy, tile=97)
            reset_gather_log()
            shares = {k: joined.col(k).shares.cpu() for k in joined.cols}
            out[dev.type, lazy] = (shares, joined.valid.shares.cpu(), gather_log(), table_nbytes(joined))
    for lazy in (True, False):
        (ga, va, la, ba), (gb, vb, lb, bb) = out["cuda", lazy], out["cpu", lazy]
        assert list(ga) == list(gb) and all(torch.equal(ga[k], gb[k]) for k in ga)
        assert torch.equal(va, vb) and la == lb and ba == bb
    assert out["cuda", True][2] == [40 * 33] * 4 and out["cuda", False][2] == []

# -- the LM side: plain PyTorch, no kernel; cuda against cpu -------------------------------

from repro_torch.configs import ARCH_IDS as LM_ARCH_IDS  # noqa: E402

LM_RECURRENT = ("recurrentgemma_9b", "xlstm_1_3b")


def _lm_tree_to(tree, device):
    return {k: _lm_tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _lm_inputs(cfg, rng, s):
    out = {}
    if cfg.input_mode == "embeddings":
        n_emb = cfg.n_prefix if cfg.prefix_lm and cfg.n_prefix else s
        out["embeds"] = torch.from_numpy(rng.standard_normal((2, n_emb, cfg.d_model)).astype(np.float32))
        if not (cfg.prefix_lm and cfg.n_prefix):
            return out
    out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32))
    return out


@pytest.mark.parametrize("arch", LM_ARCH_IDS)
def test_lm_reduced_on_cuda_equals_cpu(cuda, arch):
    # f32 without TF32: forward, prefill and four decode steps within the CPU
    # tests' tolerances (1e-4; 5e-3 for the recurrent families)
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_caches, init_params
    from repro_torch.serve import prefill

    tol = 5e-3 if arch in LM_RECURRENT else 1e-4
    cfg = get_config(arch).reduced()
    p_cpu = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    p_gpu = _lm_tree_to(p_cpu, cuda)
    rng = np.random.default_rng(2)
    b = _lm_inputs(cfg, rng, 20)
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.no_grad():
            torch.testing.assert_close(forward(cfg, p_gpu, _lm_tree_to(b, cuda))[0].cpu(), forward(cfg, p_cpu, b)[0],
                                       rtol=tol, atol=tol)
            (lg, cg), (lc, cc) = prefill(cfg, p_gpu, _lm_tree_to(b, cuda)), prefill(cfg, p_cpu, b)
            torch.testing.assert_close(lg.cpu(), lc, rtol=tol, atol=tol)
            torch.testing.assert_close(_lm_tree_to(cg, "cpu"), cc, rtol=tol, atol=tol)
            c_gpu, c_cpu = init_caches(cfg, 2, 8, device=cuda), init_caches(cfg, 2, 8, device="cpu")
            for _ in range(4):
                step = {k: v[:, :1] for k, v in _lm_inputs(cfg, rng, 1).items()}
                if cfg.prefix_lm and cfg.n_prefix:  # a prefix LM decodes tokens: its image prefix was prefilled
                    step = {"tokens": step["tokens"]}
                (lg, c_gpu), (lc, c_cpu) = (decode_step(cfg, p_gpu, c_gpu, _lm_tree_to(step, cuda)),
                                            decode_step(cfg, p_cpu, c_cpu, step))
                torch.testing.assert_close(lg.cpu(), lc, rtol=tol, atol=tol)
            torch.testing.assert_close(_lm_tree_to(c_gpu, "cpu"), c_cpu, rtol=tol, atol=tol)
    finally:
        torch.set_float32_matmul_precision(precision)


def test_lm_entry_points_run_on_cuda_by_default(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import TransformerLM, decode_step, init_caches, init_params
    from repro_torch.serve import make_serve_step

    cfg = get_config("mixtral_8x7b").reduced()
    params = init_params(cfg)
    assert params["embed"].device.type == "cuda"
    caches = init_caches(cfg, 2, 8)
    assert caches["0"]["k"].device.type == "cuda"
    logits, caches = decode_step(cfg, params, caches, {"tokens": torch.zeros((2, 1), dtype=torch.int32, device=cuda)})
    assert logits.device.type == "cuda" and logits.shape == (2, 1, cfg.vocab_size)
    logits, _ = make_serve_step(cfg)(params, caches, {"tokens": torch.ones((2, 1), dtype=torch.int32, device=cuda)})
    assert bool(torch.isfinite(logits).all()) and int(caches["0"]["idx"][0]) == 1
    assert next(TransformerLM(cfg).parameters()).device.type == "cuda"


def test_jit_cache_captures_and_replays_cuda_graphs(cuda):
    """``Engine(jit_ops=True)`` on the card: each protocol node is captured
    once as a CUDA graph and replayed with new inputs (another key, another
    table of the same shapes), each result equal to the CPU's; a result held
    across the next replay stays unchanged (the replays return clones); and
    evicting the entries frees their graphs' memory pools."""
    import gc

    from repro_torch.core import threefry
    from repro_torch.data import generate_healthlnk
    from repro_torch.engine import Engine
    from repro_torch.ops.filter import Predicate
    from repro_torch.plan.nodes import CountValid, Filter, Scan

    def shares(out):
        return {c: out.col(c).shares.cpu() for c in out.cols} | {"_valid": out.valid.shares.cpu()}

    def run(device, seed, key, jit=True):
        tables, _ = generate_healthlnk(n=48, seed=seed, device=device)
        plan = CountValid(Filter(Scan("diagnoses"), [Predicate("icd9", "eq", 414)]))
        out, report = Engine(tables, key=threefry.PRNGKey(key), jit_ops=jit, device=device).execute(plan)
        return shares(out), [(s.node, s.rounds, s.bytes_per_party) for s in report.nodes], out

    Engine._JIT_CACHE.clear()
    Engine.reset_jit_stats()
    reset_launch_counts()
    first, ledger, held = run(cuda, 0, 3)
    assert launch_counts().get("and_fold", 0) > 0  # the Filter's eq, captured
    held_copy = shares(held)
    graphs = [g for e in Engine._JIT_CACHE.values() for g in e.graphs.values()]
    assert len(graphs) == 2 and all(g.replays == 1 and g.pool_bytes > 0 for g in graphs)
    cpu = run("cpu", 0, 3, jit=False)
    assert all(torch.equal(first[k], cpu[0][k]) for k in first) and ledger == cpu[1]
    for seed, key in ((0, 9), (1, 3)):  # another key, then another table
        reset_launch_counts()
        got, got_ledger, _ = run(cuda, seed, key)
        assert launch_counts().get("and_fold", 0) == 0  # replayed, not launched by the wrapper
        want, want_ledger, _ = run("cpu", seed, key, jit=False)
        assert all(torch.equal(got[k], want[k]) for k in got) and got_ledger == want_ledger
    assert all(g.replays == 3 for g in graphs) and Engine.jit_cache_stats()["misses"] == 2
    assert all(torch.equal(held_copy[k], shares(held)[k]) for k in held_copy)
    torch.cuda.synchronize()
    pools = sum(g.pool_bytes for g in graphs)
    del graphs
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    Engine._JIT_CACHE.clear()
    gc.collect()
    torch.cuda.empty_cache()
    assert before - torch.cuda.memory_reserved() >= pools


def test_jit_cache_pools_stay_under_their_byte_bound(cuda, monkeypatch):
    """Captures at distinct table sizes (a new entry for each, as a new S
    gives one) evict the least recently used entries while the pools held
    exceed the cache's share of the card's memory; each result still
    equals the CPU's."""
    from repro_torch.core import threefry
    from repro_torch.data import generate_healthlnk
    from repro_torch.engine import Engine
    from repro_torch.ops.filter import Predicate
    from repro_torch.plan.nodes import Filter, Scan

    def run(device, n):
        tables, _ = generate_healthlnk(n=n, seed=0, device=device)
        out, _ = Engine(tables, key=threefry.PRNGKey(3), jit_ops=True, device=device).execute(
            Filter(Scan("diagnoses"), [Predicate("icd9", "eq", 414)]))
        return out.valid.shares.cpu()

    Engine._JIT_CACHE.clear()
    Engine.reset_jit_stats()
    assert torch.equal(run(cuda, 48), run("cpu", 48))
    (entry,) = Engine._JIT_CACHE.values()
    total = torch.cuda.mem_get_info()[1]
    # room for two entries of the first one's size
    monkeypatch.setattr(Engine, "_JIT_POOL_SHARE", 2.5 * entry.pool_bytes / total)
    budget = int(Engine._JIT_POOL_SHARE * total)
    for n in (56, 64, 72, 80):
        assert torch.equal(run(cuda, n), run("cpu", n))
        held = sum(e.pool_bytes for e in Engine._JIT_CACHE.values())
        assert held <= budget or len(Engine._JIT_CACHE) == 1
    assert Engine.jit_cache_stats()["misses"] == 5 and len(Engine._JIT_CACHE) < 5
    Engine._JIT_CACHE.clear()
    Engine.reset_jit_stats()
