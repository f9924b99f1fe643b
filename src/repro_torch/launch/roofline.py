"""Roofline analysis of one step's counted work, with NVIDIA H100 constants.

A port of ``repro.launch.roofline``: the same three terms per (arch x shape
x mesh),

    t_compute    = FLOPs            / (chips * PEAK_FLOPS)   [bf16 dense peak]
    t_memory     = bytes            / (chips * HBM_BW)       [HBM3]
    t_collective = collective_bytes / (chips * link_bw)      [per-GPU link]

but where the reference reads an XLA compile (``cost_analysis()`` and the
optimized HLO text), the port counts the step as it runs: :class:`StepCounter`
is a dispatch mode around one step over DTensors (on ``meta`` tensors and a
fake process group in the dry-run, so nothing is computed or sent). It sees
the local operations DTensor issues on each device, so every count is one
device's, times ``chips``, as the reference scales XLA's per-device costs:

* **FLOPs**: the matrix products' (``torch.utils.flop_counter``'s formulas:
  mm, bmm, addmm, baddbmm, convolutions, attention kernels) over the local
  shard shapes. Work that every device repeats counts on every device, so a
  replicated matmul counts ``chips`` times what the same matmul sharded
  counts. Elementwise work is not counted here: it does not run on the
  tensor cores that the bf16 peak describes, and its cost shows in bytes.
* **bytes**: each operation's input and output bytes (views, aliases and
  bare allocations excluded). It is an unfused count, an upper bound on HBM
  traffic, like the reference's ``bytes accessed`` from XLA's CPU backend.
* **collectives**: bytes and counts by the reference's kind names, recorded
  at the collectives DTensor issues (operand bytes, as the reference sums
  operand sizes). A shard-to-shard move is an all-to-all on NCCL; the CPU
  group runs it as an all-gather and a chunk, and the counter records the
  all-to-all NCCL would issue.

The reference's text parsers, :func:`shape_bytes` and
:func:`parse_collectives`, are kept as the port's own copy: they read an
XLA HLO module's text (for instance one the reference's dry-run wrote), not
a step the port ran.

MODEL_FLOPS (the "useful" compute) = 6*N*D for training (N = active params,
D = tokens) and 2*N*B for one decode token; the ratio MODEL_FLOPS/FLOPs
exposes remat recompute and dispatch/padding waste.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import sys
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM5 80 GB data sheet, at its 700 W limit (dense rates)
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12  # HBM3 bytes/s per GPU
# per-GPU link bandwidth, one direction: NVLink 4 within an 8-GPU node
# (900 GB/s both ways), InfiniBand NDR (400 Gb/s a GPU) between nodes
NVLINK_BW = 450e9
IB_BW = 50e9
NODE_GPUS = 8
CARD = "NVIDIA H100 SXM5 80 GB, 700 W"

COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# the collective ops DTensor and torch.distributed issue, by kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}
_NOT_COUNTED = ("wait_tensor", "_wrap_tensor_autograd")
# operations that allocate or alias and move no bytes
_NO_TRAFFIC = frozenset(("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_unsafe_view",
                         "lift_fresh", "detach", "alias"))


def link_bandwidth(chips: int) -> float:
    """Per-GPU link bytes/s a collective of ``chips`` GPUs runs at: NVLink
    within one node, InfiniBand beyond it (no axis of the 16 x 16 or
    2 x 16 x 16 meshes fits in an 8-GPU node)."""
    return NVLINK_BW if chips <= NODE_GPUS else IB_BW


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?([%\w.\-]+)\s*=\s*(.+)$")
_COLLECTIVE_RE = re.compile(r"\s(" + "|".join(COLLECTIVES) + r")(-start)?\(([^)]*)\)")


def shape_bytes(shape_str: str) -> int:
    """Bytes of one HLO shape string (a tuple's are summed)."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Operand bytes and counts of every collective in an HLO module's
    text, by kind: a first pass maps each instruction's name to its result
    shape, a second resolves each collective's operands (a bare name, or an
    operand typed inline). An async pair counts at its ``-start``."""
    shapes: Dict[str, str] = {}
    lines = hlo_text.splitlines()
    for ln in lines:
        m = _INSTR_RE.match(ln)
        if m:
            name, rhs = m.groups()
            sp = rhs.find(" ")
            shapes[name.lstrip("%")] = rhs[: sp if sp > 0 else len(rhs)]
    bytes_by = {k: 0 for k in COLLECTIVES}
    count_by = {k: 0 for k in COLLECTIVES}
    for ln in lines:
        if "-done(" in ln:
            continue
        m = _COLLECTIVE_RE.search(ln)
        if not m:
            continue
        kind, _, operands = m.groups()
        total = 0
        for op in operands.split(","):
            head = op.strip().lstrip("%").split(" ")[0]
            if _SHAPE_RE.search(head):
                total += shape_bytes(head)
            elif head in shapes:
                total += shape_bytes(shapes[head])
        count_by[kind] += 1
        bytes_by[kind] += total
    return CollectiveStats(bytes_by, count_by)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _in_sharding_propagation() -> bool:
    """True while DTensor's sharding propagation runs. The first time it
    meets an operator's signature it works out the strategy, some of it by
    running operations on ``meta`` tensors; later meetings hit its cache. Its
    operations are not the step's, and counting them would make a count
    depend on what ran before it in the process."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "propagate_op_sharding_non_cached":
            return True
        f = f.f_back
    return False


class StepCounter(TorchDispatchMode):
    """Counts one device's FLOPs, bytes and collectives while active (see
    the module docstring). Operations on DTensors are passed on to DTensor,
    so the counter sees the local operations they become; DTensor's own
    shape inference (on fake tensors) and sharding propagation are not
    counted, so a count is the same whatever ran before it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = CollectiveStats({k: 0 for k in COLLECTIVES}, {k: 0 for k in COLLECTIVES})
        self._in_alltoall = 0
        self._restore = contextlib.ExitStack()

    # a shard-to-shard redistribution: an all-to-all, whatever the group runs
    def _patch_alltoall(self) -> None:
        try:
            import torch.distributed.tensor.placement_types as pt
        except ImportError:
            return
        original = getattr(pt, "shard_dim_alltoall", None)
        if original is None:
            return

        def counted(input, *args, **kwargs):
            self._record("all-to-all", _nbytes(input))
            self._in_alltoall += 1
            try:
                return original(input, *args, **kwargs)
            finally:
                self._in_alltoall -= 1

        pt.shard_dim_alltoall = counted
        self._restore.callback(setattr, pt, "shard_dim_alltoall", original)

    def __enter__(self):
        self._patch_alltoall()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._restore.close()

    def _record(self, kind: str, nbytes: int) -> None:
        c = self.collectives
        c.bytes_by_kind[kind] = c.bytes_by_kind.get(kind, 0) + nbytes
        c.count_by_kind[kind] = c.count_by_kind.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = _tensors((args, kwargs))
        from torch._subclasses.fake_tensor import FakeTensor

        if any(type(t) is not torch.Tensor and not isinstance(t, (torch.nn.Parameter, FakeTensor)) for t in flat):
            return NotImplemented  # a DTensor: count the local operations it issues
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in flat + _tensors(out)) or _in_sharding_propagation():
            return out  # DTensor's shape inference and sharding propagation
        name = func._schema.name.split("::")[-1]
        if name in _NOT_COUNTED:
            return out
        if name in _KIND:
            if not self._in_alltoall:
                self._record(_KIND[name], sum(_nbytes(t) for t in flat))
            return out
        self.ops += 1
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not (func.is_view or name in _NO_TRAFFIC):
            self.bytes += sum(_nbytes(t) for t in flat) + sum(_nbytes(t) for t in _tensors(out))
        return out


def cost_analysis_of(counter: StepCounter) -> Dict[str, float]:
    """One device's counts, under the reference's ``cost_analysis`` keys."""
    return {"flops": float(counter.flops), "bytes accessed": float(counter.bytes), "ops": float(counter.ops)}


def local_bytes(tree) -> int:
    """Bytes of one device's shards of every tensor in ``tree`` (a DTensor's
    local shard; a plain tensor whole)."""
    total = 0
    for t in _tensors(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += _nbytes(local)
    return total


def memory_analysis_of(argument_bytes: int) -> str:
    """The per-device memory the dry-run can state: the step's arguments
    (parameter, optimizer-state, cache and batch shards). Temporaries are not
    tracked on ``meta`` tensors."""
    return f"argument_size_in_bytes={int(argument_bytes)}"


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: Dict[str, int]
    collective_counts: Dict[str, int]
    model_flops: float
    bytes_per_device: Optional[float] = None

    @property
    def link_bw(self) -> float:
        return link_bandwidth(self.chips)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.chips * self.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant-term-bound step time that is useful
        compute: (model_flops / (chips*peak)) / max(t_compute, t_mem, t_coll)."""
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_bound if t_bound > 0 else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_breakdown": self.collectives,
            "collective_counts": self.collective_counts,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_per_device": self.bytes_per_device,
            "link_bytes_per_s": self.link_bw,
            "card": CARD,
        }


def np_prod(shape) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def analytic_bytes_for(cfg, shape_name: str) -> float:
    """First-principles HBM-traffic lower-bound model (a sanity column next
    to the counted, unfused bytes):

    train:   params fwd+bwd reads (2x2B) + grad write/read (2x4B) +
             AdamW moments read+write (4x4B) + param write (2B)
             + activations ~ 2 passes x ~12 intermediate tensors x B*S*d x 2B
    prefill: params read (2B) + activations 1 pass
    decode:  params read (2B) + full KV/state cache read (2B)
    """
    from ..configs.shapes import SHAPE_DEFS

    n = cfg.param_count()
    d = SHAPE_DEFS[shape_name]
    if d["step"] == "train":
        tok = d["seq"] * d["batch"]
        act = 2 * 12 * tok * cfg.d_model * 2.0 * cfg.n_layers
        return n * (2 * 2 + 2 * 4 + 4 * 4 + 2) + act
    if d["step"] == "prefill":
        tok = d["seq"] * d["batch"]
        return n * 2 + 12 * tok * cfg.d_model * 2.0 * cfg.n_layers
    # decode: weights + cache traffic dominate
    from ..models import init_caches

    caches = init_caches(cfg, d["batch"], d["seq"], device="meta")
    cache_bytes = sum(np_prod(t.shape) * t.element_size() for t in _tensors(caches))
    n_active = cfg.active_param_count()
    return n_active * 2 + cache_bytes


def model_flops_for(cfg, shape_name: str) -> float:
    """6*N_active*D (train) / 2*N_active*D (prefill) / 2*N_active*B (decode)."""
    from ..configs.shapes import SHAPE_DEFS

    n_active = cfg.active_param_count()
    d = SHAPE_DEFS[shape_name]
    if d["step"] == "train":
        return 6.0 * n_active * d["seq"] * d["batch"]
    if d["step"] == "prefill":
        return 2.0 * n_active * d["seq"] * d["batch"]
    return 2.0 * n_active * d["batch"]  # one decode token
