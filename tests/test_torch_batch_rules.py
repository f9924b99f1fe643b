"""The kernels' batch rules on the CPU: under ``torch.func.vmap`` each
``repro_torch`` custom op folds the K slots into one call of its launch
function (the plain version on a CPU tensor), and the result equals K
separate plain calls, slot by slot. Batched and unbatched operands (a zero
sharing drawn at per-slot shape is unbatched) mix in every case; the batch
axis sits at different positions. On the card the same rules fold the
slots into one kernel launch (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro_torch.kernels.a2b_fused.ops import a2b_plain, bit2a_plain
from repro_torch.kernels.bitonic_stage.ops import stage_swap_plain
from repro_torch.kernels.ks_prefix.ops import and_fold_plain, fold_shifts, ks_prefix_plain, ks_shifts
from repro_torch.kernels.rss_gate.ops import gate_plain
from repro_torch.kernels.shuffle_gather.ops import shuffle_gather_plain

K = 3
OPS = torch.ops.repro_torch


def _words(rng, shape):
    return torch.from_numpy(rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32))


def _batched(rng, shape, bdim):
    """K slots of ``shape`` with the batch axis at ``bdim`` (None: one
    unbatched operand shared by every slot)."""
    if bdim is None:
        return _words(rng, shape)
    return torch.movedim(_words(rng, (K,) + shape), 0, bdim)


def _slot(t, bdim, i):
    return t if bdim is None else t.select(bdim, i)


def _check(op_call, plain_call, operands, dims, out_pos=0):
    got = vmap(op_call, in_dims=tuple(dims))(*operands)
    for i in range(K):
        want = plain_call(*[_slot(t, d, i) for t, d in zip(operands, dims)])
        assert torch.equal(got[i], want)


@pytest.mark.parametrize("dims", [(0, 0, None), (1, None, 2), (None, 0, 1)])
@pytest.mark.parametrize("boolean", [True, False])
def test_rss_gate_rule(dims, boolean):
    rng = np.random.default_rng(1)
    shape = (3, 5, 7)
    ops = [_batched(rng, shape, d) for d in dims]
    _check(lambda x, y, a: OPS.rss_gate(x, y, a, boolean), lambda x, y, a: gate_plain(x, y, a, boolean), ops, dims)


@pytest.mark.parametrize("dims", [(0, 0, None), (2, 1, 0)])
def test_ks_prefix_rule(dims):
    rng = np.random.default_rng(2)
    shifts = list(ks_shifts(32))
    n = 11
    ops = [_batched(rng, (3, n), dims[0]), _batched(rng, (3, n), dims[1]),
           _batched(rng, (3, 2 * len(shifts), n), dims[2])]
    _check(lambda g, p, a: OPS.ks_prefix(g, p, a, shifts), lambda g, p, a: ks_prefix_plain(g, p, a, shifts),
           ops, dims)


@pytest.mark.parametrize("dims", [(0, None), (1, 3)])
def test_and_fold_rule(dims):
    rng = np.random.default_rng(3)
    shifts = list(fold_shifts(32))
    ops = [_batched(rng, (3, 9), dims[0]), _batched(rng, (3, len(shifts), 9), dims[1])]
    _check(lambda v, a: OPS.and_fold(v, a, shifts), lambda v, a: and_fold_plain(v, a, shifts), ops, dims)


@pytest.mark.parametrize("dims", [(0, None), (None, 2)])
def test_a2b_rule(dims):
    rng = np.random.default_rng(4)
    shifts = list(ks_shifts(32))
    ops = [_batched(rng, (3, 6), dims[0]), _batched(rng, (3, 2 * (1 + 2 * len(shifts)), 6), dims[1])]
    _check(lambda x, a: OPS.a2b_fused(x, a, shifts), lambda x, a: a2b_plain(x, a, shifts), ops, dims)


@pytest.mark.parametrize("dims", [(0, None), (1, 0)])
def test_bit2a_rule(dims):
    rng = np.random.default_rng(5)
    ops = [_batched(rng, (3, 8), dims[0]), _batched(rng, (3, 2, 8), dims[1])]
    _check(OPS.bit2a_fused, bit2a_plain, ops, dims)


@pytest.mark.parametrize("dims", [(0, 0, 0, None), (None, 1, 3, 0)])
def test_bitonic_swap_rule(dims):
    rng = np.random.default_rng(6)
    ops = [_batched(rng, (3, 10), dims[0])] + [_batched(rng, (3, 4, 10), d) for d in dims[1:]]
    _check(OPS.bitonic_swap, stage_swap_plain, ops, dims)


@pytest.mark.parametrize("index_batched", [False, True])
def test_gather_hop_rule(index_batched):
    rng = np.random.default_rng(7)
    n = 13
    a = _batched(rng, (3, n, 2), 0)
    b = _batched(rng, (3, n, 1), 2)
    c = _batched(rng, (3, n, 3), None)
    if index_batched:
        index = torch.stack([torch.from_numpy(rng.permutation(n)) for _ in range(K)])
        index[1, 4] = n + 5  # outside [0, N): a zero row, not another slot's
        idim = 0
    else:
        index, idim = torch.from_numpy(rng.permutation(n)), None
    got = vmap(lambda x, y, z, i: OPS.gather_hop([x, y, z], i), in_dims=(0, 2, None, idim))(a, b, c, index)
    for s in range(K):
        idx = _slot(index, idim, s)
        for col, d, out in zip((a, b, c), (0, 2, None), got):
            assert torch.equal(out[s], shuffle_gather_plain(_slot(col, d, s), idx))
