"""shuffle_gather: the secure-shuffle row gather (CUDA kernels + plain versions).

Replaces the Pallas TPU kernel ``repro/kernels/shuffle_gather/
shuffle_gather.py:33`` (wrapper ``ops.py:16``, oracle ``ref.py:7``). The TPU
kernel gathers one ``(N, C)`` share plane per launch and falls back to XLA
above 8 MiB of VMEM; here :func:`gather_hop` moves every column and plane of a
shuffle hop by one index, for any N. The CUDA source is
``kernels/csrc/shuffle_gather.cu``, which explains the two routes:

* **direct** — one launch, one thread per output row of one (column,
  plane), the pairs one after the other so that each plane's scattered
  reads share the 50 MB L2: for a hop whose planes take at most
  :data:`TWO_PASS_PLANE_BYTES` each;
* **two-pass** — above that: a per-hop plan (:func:`gather_plan`, one
  launch) buckets the output rows by (chunk, source tile); pass 1 moves each
  source tile, read once and coalesced, into its slots; pass 2 puts each
  chunk's slots in place. Every scattered access of the two passes lands in
  shared memory, a tile or a chunk of up to 32,768 rows at a time.

Both routes equal :func:`shuffle_gather_plain` on every input; the plan and
the passes have plain versions too (:func:`gather_plan_plain`,
:func:`gather_two_pass_plain`), which follow the kernels' bucketing and slot
arithmetic. A CPU tensor runs the plain versions, a CUDA tensor the kernels.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence

import torch

from .. import batch_to, check_launch, library, record_launch

__all__ = [
    "GatherPlan",
    "TWO_PASS_PLANE_BYTES",
    "gather_hop",
    "gather_direct",
    "gather_two_pass",
    "gather_plan",
    "gather_plan_plain",
    "gather_two_pass_plain",
    "uses_two_pass",
    "block_rows_for",
    "shuffle_gather",
    "shuffle_gather_plain",
]

# A hop with a plane (N rows x W words of one column) larger than this runs
# in two passes: on the H100 the direct route is the faster up to 20 MiB a
# plane and the two-pass route from 24 MiB (PERF.md, chip_smoke.py phase 4).
TWO_PASS_PLANE_BYTES = 22 << 20
# Rows of a chunk or a tile: one word of each fits in shared memory.
MAX_BLOCK_ROWS = 32768
# pass 1 keeps a tile's run table (two words per chunk) in shared memory, and
# the plan a chunk's count per tile: up to 2^27 rows at the largest chunks
MAX_CHUNKS = 4096
MAX_TWO_PASS_ROWS = MAX_CHUNKS * MAX_BLOCK_ROWS
# columns the kernels take per launch; a wider hop launches once per group
MAX_COLS = 32


class GatherPlan(NamedTuple):
    """The two-pass route's per-hop plan: output rows bucketed by (chunk of
    the row, tile of its source). Chunk k's rows take the slots
    ``[k * chunk_rows, (k + 1) * chunk_rows)``, grouped by tile. A row whose
    index lies outside ``[0, N)`` goes to the last tile, whose slots read as
    zeros."""

    chunk_rows: int
    tile_rows: int
    counts: torch.Tensor  # (chunks, tiles) int32: rows of each bucket
    start: torch.Tensor  # (chunks, tiles) int32: each bucket's first slot within its chunk
    packed: torch.Tensor  # (N,) int32 per slot: (row within the chunk) | (source within the tile) << 16


def uses_two_pass(n: int, width: int) -> bool:
    """The size rule between the routes, for a hop of ``n`` rows whose
    widest column has ``width`` words a row."""
    return 4 * n * width > TWO_PASS_PLANE_BYTES and n <= MAX_TWO_PASS_ROWS


def block_rows_for(n: int) -> int:
    """Rows of a chunk and of a tile for ``n`` rows: the power of two from
    1,024 to :data:`MAX_BLOCK_ROWS` whose square first reaches 32 n, so that
    a (chunk, tile) run holds some 32 rows and pass 1 writes in runs."""
    rows = 1024
    while rows < MAX_BLOCK_ROWS and rows * rows < 32 * n:
        rows *= 2
    return rows


def shuffle_gather_plain(planes: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """``out[p, r, c] = planes[p, perm[r], c]`` in plain PyTorch — per plane,
    the reference ``gather_rows(table, perm)``: the row index broadcast over
    planes and columns, then an elementwise gather. A row whose index lies
    outside ``[0, N)`` comes out as zeros, as in the kernels."""
    p, n, c = planes.shape
    inside = (perm >= 0) & (perm < n)
    rows = torch.gather(planes, 1, torch.where(inside, perm, 0).view(1, n, 1).expand(p, n, c))
    return torch.where(inside.view(1, n, 1), rows, 0)


def _check_hop(name: str, cols: Sequence[torch.Tensor], index: torch.Tensor, devices=("cpu", "cuda")) -> int:
    """Raise unless ``cols`` are ``(P, N, W)`` int32 columns of one P and N
    with contiguous words, and ``index`` an ``(N,)`` int64 tensor on their
    device (one of ``devices``), N < 2^31. Returns P."""
    if index.dim() != 1 or not cols:
        raise ValueError(f"{name} needs (P, N, W) columns and an (N,) index, got {len(cols)} columns "
                         f"and {tuple(index.shape)}")
    n = index.shape[0]
    if any(c.dim() != 3 or c.shape[1] != n or c.shape[0] != cols[0].shape[0] for c in cols):
        raise ValueError(f"{name} needs (P, N, W) columns of one P and an (N,) index, got "
                         f"{[tuple(c.shape) for c in cols]} and {tuple(index.shape)}")
    if n >= 2**31:
        raise ValueError(f"{name} takes fewer than 2^31 rows, got {n}")
    if index.dtype != torch.int64 or any(c.dtype != torch.int32 for c in cols):
        raise TypeError(f"{name} needs int32 (ring-32) columns and an int64 index, got "
                        f"{[c.dtype for c in cols]}, {index.dtype}; no path shuffles ring-64 "
                        f"shares, so it has no 64-bit build (ROADMAP.md, Queue 1, step 5)")
    if any(c.device != index.device for c in cols):
        raise ValueError(f"{name} operands lie on different devices")
    if index.device.type not in devices:
        raise ValueError(f"{name} runs on {' or '.join(devices)}, not {index.device}")
    return cols[0].shape[0]


def _check_layout(name: str, cols: Sequence[torch.Tensor], index: torch.Tensor) -> None:
    """What the kernels read by pointer: a contiguous index, and the words
    of each row contiguous."""
    if not index.is_contiguous():
        raise ValueError(f"{name} needs a contiguous index")
    if any(c.shape[2] > 1 and c.stride(2) != 1 for c in cols):
        raise ValueError(f"{name} needs the words of a row contiguous")


def gather_hop(cols: Sequence[torch.Tensor], index: torch.Tensor) -> List[torch.Tensor]:
    """Gather the rows of every column of a shuffle hop by one index:
    ``out[i][p, r, :] = cols[i][p, index[r], :]``.

    ``cols``: ``(P, N, W)`` int32 share planes (W words a row; a column may
    be a strided view, as long as a row's words are contiguous); ``index``:
    ``(N,)`` int64, a permutation of ``[0, N)``, N < 2^31. A row whose index
    lies outside ``[0, N)`` comes out as zeros. On a CUDA tensor the hop takes
    the direct route, one launch, or with a plane above
    :data:`TWO_PASS_PLANE_BYTES` the two-pass route (plan, pass 1, pass 2),
    under ``vmap`` once for all slots; on a CPU tensor it runs
    :func:`shuffle_gather_plain` per column. Outputs are contiguous.
    """
    _check_hop("gather_hop", cols, index, ("cpu", "cuda", "meta"))
    if index.device.type == "cpu":
        return [shuffle_gather_plain(c, index) for c in cols]
    return _gather_hop_op(list(cols), index)


def _hop_launch(cols, index: torch.Tensor) -> List[torch.Tensor]:
    """The hop's route on real tensors (the plain version on the CPU, so the
    batch rule also runs there)."""
    if index.device.type == "cpu":
        return [shuffle_gather_plain(c, index) for c in cols]
    if uses_two_pass(index.shape[0], max(c.shape[2] for c in cols)):
        return gather_two_pass(cols, index)
    return gather_direct(cols, index)


@torch.library.custom_op("repro_torch::gather_hop", mutates_args=())
def _gather_hop_op(cols: List[torch.Tensor], index: torch.Tensor) -> List[torch.Tensor]:
    return _hop_launch(cols, index)


@_gather_hop_op.register_fake
def _(cols, index):
    return [torch.empty(c.shape, dtype=torch.int32, device=c.device) for c in cols]


def _gather_hop_batch_rule(info, in_dims, cols, index):
    """K slots in one hop. With one index for every slot (a shuffle hop's
    permutation is drawn at per-slot shape), the slots of a column are K
    times its planes: (K, P, N, W) read as (K*P, N, W), so the hop launches
    as often as one slot's. With an index per slot, the slots' rows stack
    into one K*N-row table and each slot's index is offset by its first
    row."""
    k = info.batch_size
    col_dims, index_dim = in_dims
    if index_dim is None:
        stacked = [batch_to(c, d, k, 0) for c, d in zip(cols, col_dims)]
        outs = _hop_launch([c.flatten(0, 1) for c in stacked], index)
        return [o.unflatten(0, (k, -1)) for o in outs], [0] * len(outs)
    idx = index.movedim(index_dim, 0)
    n = idx.shape[1]
    inside = (idx >= 0) & (idx < n)
    first = torch.arange(k, dtype=idx.dtype, device=idx.device).unsqueeze(1) * n
    flat = torch.where(inside, idx + first, -1).reshape(-1).contiguous()
    tables = [batch_to(c, d, k, 1).flatten(1, 2) for c, d in zip(cols, col_dims)]
    outs = _hop_launch(tables, flat)
    return [o.unflatten(1, (k, n)) for o in outs], [1] * len(outs)


_gather_hop_op.register_vmap(_gather_hop_batch_rule)


def _descriptors(cols, outs, stages) -> "ctypes.Array":
    """The kernels' column table: (in, out, stage, in plane stride, in row
    stride, words a row) for each column, as int64s."""
    vals = []
    for col, out, stage in zip(cols, outs, stages):
        vals += [col.data_ptr(), out.data_ptr(), 0 if stage is None else stage.data_ptr(),
                 col.stride(0), col.stride(1), col.shape[2]]
    return (ctypes.c_int64 * len(vals))(*vals)


def _groups(cols, outs, stages):
    """The hop's non-empty columns in launches of at most MAX_COLS (and at
    most 65,535 (column, plane) pairs, the direct grid's y limit)."""
    live = [(c, o, s) for c, o, s in zip(cols, outs, stages) if c.shape[2]]
    size = max(1, min(MAX_COLS, 65535 // cols[0].shape[0]))
    for i in range(0, len(live), size):
        yield tuple(zip(*live[i:i + size]))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_direct(cols: Sequence[torch.Tensor], index: torch.Tensor) -> List[torch.Tensor]:
    """The direct route: one launch for the hop (one per :data:`MAX_COLS`
    columns), its grid's y axis walking the (column, plane) pairs. A CPU
    tensor runs :func:`shuffle_gather_plain` per column."""
    planes = _check_hop("gather_direct", cols, index)
    if index.device.type == "cpu":
        return [shuffle_gather_plain(c, index) for c in cols]
    _check_layout("gather_direct", cols, index)
    n = index.shape[0]
    outs = [torch.empty(c.shape, dtype=torch.int32, device=c.device) for c in cols]
    if n == 0 or planes == 0:
        return outs
    for group, gouts, gstages in _groups(cols, outs, [None] * len(cols)):
        err = library().gather_direct_launch(
            _descriptors(group, gouts, gstages), len(group), planes, index.data_ptr(), n, _stream(index))
        check_launch("gather_direct", err)
        record_launch("shuffle_gather")
    return outs


def gather_plan_plain(index: torch.Tensor, chunk_rows: int, tile_rows: int) -> GatherPlan:
    """The two-pass plan in plain PyTorch: bucket ``(r // chunk_rows, tile of
    index[r])`` for every output row r, the last tile holding the rows whose
    index lies outside ``[0, N)``; slots in bucket order, so chunk k's rows
    fill ``[k * chunk_rows, (k + 1) * chunk_rows)``; a bucket's rows in row
    order. The kernel gives a row the slot ``k * chunk_rows + start[bucket] +
    rank``, its rank among its bucket's rows in the order of its atomics;
    here that order is the row order."""
    n = index.shape[0]
    dev = index.device
    n_chunks = max(-(-n // chunk_rows), 1)
    n_tiles = -(-n // tile_rows) + 1
    inside = (index >= 0) & (index < n)
    tile = torch.where(inside, index // tile_rows, n_tiles - 1)
    off = torch.where(inside, index - tile * tile_rows, 0)
    rows = torch.arange(n, device=dev)
    buckets = (rows // chunk_rows) * n_tiles + tile
    counts = torch.bincount(buckets, minlength=n_chunks * n_tiles).view(n_chunks, n_tiles)
    order = torch.sort(buckets, stable=True).indices
    return GatherPlan(
        chunk_rows, tile_rows, counts.to(torch.int32), (torch.cumsum(counts, 1) - counts).to(torch.int32),
        ((order % chunk_rows) | (off[order] << 16)).to(torch.int32),
    )


def _plan_shape(n: int, chunk_rows: int, tile_rows: int) -> None:
    if not (1 <= chunk_rows <= MAX_BLOCK_ROWS and 1 <= tile_rows <= MAX_BLOCK_ROWS):
        raise ValueError(f"chunk_rows and tile_rows lie in [1, {MAX_BLOCK_ROWS}], got {chunk_rows}, {tile_rows}")
    if -(-n // chunk_rows) > MAX_CHUNKS or -(-n // tile_rows) > MAX_CHUNKS:
        raise ValueError(f"{n} rows make more than {MAX_CHUNKS} chunks or tiles of {chunk_rows}, {tile_rows}")


def gather_plan(index: torch.Tensor, chunk_rows: int, tile_rows: int) -> GatherPlan:
    """The two-pass plan of one hop: on a CUDA tensor the plan kernel, one
    block per chunk; on a CPU tensor :func:`gather_plan_plain`."""
    if index.dim() != 1 or index.dtype != torch.int64:
        raise TypeError(f"gather_plan needs an (N,) int64 index, got {tuple(index.shape)} {index.dtype}")
    n = index.shape[0]
    _plan_shape(n, chunk_rows, tile_rows)
    if index.device.type == "cpu" or n == 0:
        return gather_plan_plain(index, chunk_rows, tile_rows)
    if index.device.type != "cuda" or not index.is_contiguous():
        raise ValueError(f"gather_plan needs a contiguous index on cuda or cpu, got {index.device}")
    n_chunks = -(-n // chunk_rows)
    n_tiles = -(-n // tile_rows) + 1
    counts = torch.empty((n_chunks, n_tiles), dtype=torch.int32, device=index.device)
    start = torch.empty_like(counts)
    packed = torch.empty(n, dtype=torch.int32, device=index.device)
    check_launch("gather_plan", library().gather_plan_launch(
        index.data_ptr(), n, chunk_rows, tile_rows, n_chunks, n_tiles, counts.data_ptr(), start.data_ptr(),
        packed.data_ptr(), _stream(index)))
    record_launch("shuffle_plan")
    return GatherPlan(chunk_rows, tile_rows, counts, start, packed)


def gather_two_pass_plain(cols: Sequence[torch.Tensor], plan: GatherPlan) -> List[torch.Tensor]:
    """The two passes in plain PyTorch, walking the plan as the kernels do:
    pass 1 visits tile t's entries e = 0, 1, ... run by run (with ``begin[k,
    t]`` the exclusive scan of tile t's counts over the chunks, entry e lies
    in the last chunk k with ``begin[k, t] <= e``, at slot ``k * chunk_rows +
    start[k, t] + e - begin[k, t]``) and stages each entry's source row;
    pass 2 writes chunk k's slot j to row ``k * chunk_rows`` plus the slot's
    row within the chunk."""
    n = plan.packed.shape[0]
    dev = plan.packed.device
    n_tiles = plan.counts.shape[1]
    ends = torch.cumsum(plan.counts.to(torch.int64), 0)
    per_tile = ends[-1]
    tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), per_tile)
    e = torch.arange(n, device=dev) - (torch.cumsum(per_tile, 0) - per_tile)[tile]
    run_ends = ends.t()[tile]  # (N, chunks): the entry's tile's run ends
    k = (run_ends <= e[:, None]).sum(1)
    begin = torch.where(k > 0, run_ends.gather(1, (k - 1).clamp(min=0)[:, None]).squeeze(1), 0)
    slot = k * plan.chunk_rows + plan.start.to(torch.int64)[k, tile] + e - begin
    packed = plan.packed.to(torch.int64)
    src = tile * plan.tile_rows + (packed[slot] >> 16)
    real = tile < n_tiles - 1
    rows = torch.arange(n, device=dev)
    dst = rows - rows % plan.chunk_rows + (packed & 0xFFFF)
    outs = []
    for col in cols:
        stage = torch.zeros(col.shape, dtype=torch.int32, device=dev)
        stage[:, slot[real]] = col[:, src[real]]
        out = torch.empty_like(stage)
        out[:, dst] = stage
        outs.append(out)
    return outs


def gather_two_pass(
    cols: Sequence[torch.Tensor],
    index: torch.Tensor,
    chunk_rows: Optional[int] = None,
    tile_rows: Optional[int] = None,
) -> List[torch.Tensor]:
    """The two-pass route: :func:`gather_plan` once for the hop, then pass 1
    and pass 2 (one launch each per :data:`MAX_COLS` columns). ``chunk_rows``
    and ``tile_rows`` default to :func:`block_rows_for` the hop's rows. A CPU
    tensor runs :func:`gather_plan_plain` and :func:`gather_two_pass_plain`."""
    planes = _check_hop("gather_two_pass", cols, index)
    n = index.shape[0]
    chunk_rows = chunk_rows or block_rows_for(n)
    tile_rows = tile_rows or block_rows_for(n)
    _plan_shape(n, chunk_rows, tile_rows)
    if index.device.type == "cpu":
        return gather_two_pass_plain(cols, gather_plan_plain(index, chunk_rows, tile_rows))
    _check_layout("gather_two_pass", cols, index)
    outs = [torch.empty(c.shape, dtype=torch.int32, device=c.device) for c in cols]
    if n == 0 or planes == 0:
        return outs
    plan = gather_plan(index, chunk_rows, tile_rows)
    n_chunks, n_tiles = plan.counts.shape
    stages = [torch.empty_like(o) for o in outs]
    lib, stream = library(), _stream(index)
    for group, gouts, gstages in _groups(cols, outs, stages):
        table = _descriptors(group, gouts, gstages)
        check_launch("gather_two_pass", lib.gather_pass1_launch(
            table, len(group), planes, plan.packed.data_ptr(), plan.counts.data_ptr(), plan.start.data_ptr(),
            n, chunk_rows, n_chunks, tile_rows, n_tiles, stream))
        record_launch("shuffle_gather")
        check_launch("gather_two_pass", lib.gather_pass2_launch(
            table, len(group), planes, plan.packed.data_ptr(), n, chunk_rows, stream))
        record_launch("shuffle_gather")
    return outs


def shuffle_gather(planes: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Gather rows of every share plane of one column by one permutation:
    the one-column case of :func:`gather_hop`.

    ``planes``: ``(P, N, C)`` int32; ``perm``: ``(N,)`` int64, a permutation
    of ``[0, N)``. An entry outside ``[0, N)`` is not checked: its row comes
    out as zeros on either device. A CUDA tensor launches the kernels, a CPU
    tensor runs :func:`shuffle_gather_plain`; any other device, dtype or
    shape raises.
    """
    return gather_hop([planes], perm)[0]
