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
    assert launch_counts() == submitted and submitted.get("shuffle_gather", 0) > 0


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
