"""The hop-level gather (``gather_hop``) and the two-pass route's plan and
passes in their plain versions, against repro's ``gather_rows`` /
``shuffle_gather_ref`` and the direct gather, on numpy-seeded inputs (exact
equality). The kernels themselves, on the card, are held against these plain
versions in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.shuffle_gather.ops import gather_rows as jgather_rows  # noqa: E402
from repro.kernels.shuffle_gather.ref import shuffle_gather_ref  # noqa: E402
from repro_torch.core.ring import from_numpy, to_numpy  # noqa: E402
from repro_torch.core.shuffle import _inverse  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.shuffle_gather import (  # noqa: E402
    gather_direct,
    gather_hop,
    gather_plan,
    gather_plan_plain,
    gather_two_pass,
    gather_two_pass_plain,
    shuffle_gather_plain,
    uses_two_pass,
)
from repro_torch.kernels.shuffle_gather.ops import block_rows_for  # noqa: E402

WIDTHS = (1, 3, 1)


def _cols(rng, n, widths=WIDTHS, planes=3):
    return [rng.integers(0, 2**32, size=(planes, n, w), dtype=np.uint64).astype(np.uint32) for w in widths]


def _direct(cols, index):
    return [shuffle_gather_plain(c, index) for c in cols]


@pytest.mark.parametrize("n", [1, 257, 4096])
def test_gather_hop_plain_equals_repro_per_plane_and_column(n):
    rng = np.random.default_rng(n)
    cols = _cols(rng, n)
    perm = rng.permutation(n)
    reset_launch_counts()
    got = gather_hop([from_numpy(c, "cpu") for c in cols], torch.from_numpy(perm))
    assert not launch_counts()  # a CPU tensor never launches
    jperm = jnp.asarray(perm.astype(np.int32))
    for col, out in zip(cols, got):
        assert out.shape == col.shape and out.is_contiguous()
        for p in range(3):
            table = jnp.asarray(col[p])
            want = np.asarray(shuffle_gather_ref(table, jperm))
            assert (to_numpy(out[p]) == want).all()
            assert (to_numpy(out[p]) == np.asarray(jgather_rows(table, jperm))).all()


@pytest.mark.parametrize("n", [1, 257, 4096])
def test_gather_direct_plain_equals_gather_hop(n):
    rng = np.random.default_rng(10 + n)
    cols = [from_numpy(c, "cpu") for c in _cols(rng, n)]
    perm = torch.from_numpy(rng.permutation(n))
    for a, b in zip(gather_direct(cols, perm), gather_hop(cols, perm)):
        assert torch.equal(a, b)


# (N, chunk_rows, tile_rows): K = 1, K = 2 (dividing N), K not dividing N,
# one row per chunk, tiles that do not divide N, a tile larger than N
TWO_PASS_CASES = [
    (257, 257, 16),
    (256, 128, 16),
    (257, 100, 32),
    (4096, 1000, 256),
    (97, 1, 8),
    (1000, 300, 2048),
    (1, 1, 1),
]


@pytest.mark.parametrize("n,chunk_rows,tile_rows", TWO_PASS_CASES)
def test_two_pass_plain_equals_direct(n, chunk_rows, tile_rows):
    rng = np.random.default_rng(n + chunk_rows + tile_rows)
    cols = [from_numpy(c, "cpu") for c in _cols(rng, n)]
    perm = torch.from_numpy(rng.permutation(n))
    got = gather_two_pass(cols, perm, chunk_rows=chunk_rows, tile_rows=tile_rows)
    for a, b in zip(got, _direct(cols, perm)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,chunk_rows,tile_rows", [(257, 100, 32), (4096, 1000, 256), (9, 4, 2)])
def test_two_pass_plain_out_of_range_rows_read_zero(n, chunk_rows, tile_rows):
    # the plan sends them to the last tile, whose slots pass 1 writes as zeros
    rng = np.random.default_rng(7 * n)
    cols = [from_numpy(c, "cpu") for c in _cols(rng, n)]
    perm = torch.from_numpy(rng.permutation(n))
    bad = torch.tensor([0, n // 2, n - 1])
    perm[bad] = torch.tensor([-1, n, 2**40])
    plan = gather_plan_plain(perm, chunk_rows, tile_rows)
    assert int(plan.counts[:, -1].sum()) == 3
    got = gather_two_pass_plain(cols, plan)
    for a, b in zip(got, _direct(cols, perm)):
        assert torch.equal(a, b)
        assert not a[:, bad].any()


@pytest.mark.parametrize("n,chunk_rows,tile_rows", TWO_PASS_CASES)
def test_gather_plan_plain_layout(n, chunk_rows, tile_rows):
    # buckets in chunk-major order; each bucket's slots hold exactly its rows
    rng = np.random.default_rng(3 * n + tile_rows)
    perm = torch.from_numpy(rng.permutation(n))
    plan = gather_plan(perm, chunk_rows, tile_rows)  # on the CPU: the plain plan
    n_chunks, n_tiles = plan.counts.shape
    assert n_chunks == -(-n // chunk_rows) and n_tiles == -(-n // tile_rows) + 1
    counts = plan.counts.long()
    assert torch.equal(plan.start.long(), torch.cumsum(counts, 1) - counts)
    assert int(counts[:, :-1].sum()) == n and int(counts[:, -1].sum()) == 0
    # chunk k's rows fill its slots; each slot decodes to its row and source
    assert torch.equal(counts.sum(1), torch.bincount(torch.arange(n) // chunk_rows))
    bucket = torch.repeat_interleave(torch.arange(counts.numel()), counts.view(-1))
    packed = plan.packed.long()
    slots = torch.arange(n)
    dst = slots - slots % chunk_rows + (packed & 0xFFFF)
    src = (bucket % n_tiles) * tile_rows + (packed >> 16)
    assert torch.equal(bucket // n_tiles, slots // chunk_rows)
    assert torch.equal(torch.sort(dst).values, torch.arange(n))
    assert torch.equal(src, perm[dst])


class _Elsewhere(torch.Tensor):
    """A tensor on a device the wrappers have no route for (neither cpu,
    cuda nor meta)."""

    @property
    def device(self):
        return torch.device("xpu")


def test_two_pass_plain_strided_views():
    # columns sliced from one stacked tensor: row stride 3, offsets 0..2
    rng = np.random.default_rng(5)
    stacked = from_numpy(_cols(rng, 300, widths=(3,))[0], "cpu")
    cols = [stacked[:, :, i:i + 1] for i in range(3)] + [stacked[:, :, 1:3]]
    perm = torch.from_numpy(rng.permutation(300))
    want = _direct([c.contiguous() for c in cols], perm)
    for got in (gather_two_pass(cols, perm, chunk_rows=70, tile_rows=64), gather_hop(cols, perm)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 2, 17, 4096])
def test_scatter_inverse_equals_argsort(n):
    perm = torch.from_numpy(np.random.default_rng(n).permutation(n))
    assert torch.equal(_inverse(perm), torch.argsort(perm))


def test_size_rule():
    # up to 22 MiB a plane (N rows x the widest column's words) stay direct
    assert not uses_two_pass((22 << 20) // 4, 1)
    assert uses_two_pass((22 << 20) // 4 + 1, 1)
    assert not uses_two_pass((22 << 20) // 12, 3) and uses_two_pass((22 << 20) // 12 + 1, 3)
    assert uses_two_pass(29_632_384, 1)
    # above 2^27 rows the plan's tables outgrow shared memory: direct
    assert uses_two_pass(1 << 27, 1) and not uses_two_pass((1 << 27) + 1, 1)
    # chunks and tiles: the power of two whose square reaches 32 N, so that a
    # (chunk, tile) run holds some 32 rows; 1,024 to 32,768 rows
    assert block_rows_for(1) == 1024
    assert block_rows_for(1_572_864) == 8192
    assert block_rows_for(29_632_384) == 32768
    assert block_rows_for(1 << 27) == 32768


def test_gather_hop_checks_its_inputs():
    x = torch.zeros((3, 8, 1), dtype=torch.int32)
    with pytest.raises(TypeError):
        gather_hop([x], torch.arange(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather_hop([x, torch.zeros((2, 8, 1), dtype=torch.int32)], torch.arange(8))
    with pytest.raises(ValueError):
        gather_hop([x], torch.arange(7))
    with pytest.raises(ValueError):
        gather_hop([], torch.arange(8))
    with pytest.raises(ValueError):
        gather_hop([x.as_subclass(_Elsewhere)], torch.arange(8).as_subclass(_Elsewhere))
    # meta (measure_comm) gives the outputs' shapes and launches nothing
    reset_launch_counts()
    (out,) = gather_hop([x.to("meta")], torch.arange(8, device="meta"))
    assert out.device.type == "meta" and out.shape == x.shape and not launch_counts()
    big = torch.empty((3, 2**31, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gather_hop([big], torch.empty(2**31, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError):
        gather_plan(torch.arange(8), 4, 40_000)
    with pytest.raises(ValueError):
        gather_plan(torch.arange(8), 0, 4)
    with pytest.raises(ValueError):
        gather_plan(torch.arange(5000), 1, 2)  # 5,000 chunks: more than pass 1's run table holds
