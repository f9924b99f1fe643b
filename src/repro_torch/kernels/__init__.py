"""Hand-written CUDA kernels for the engine's hot spots, with launch accounting.

* ``rss_gate``       — the 1-round RSS multiplication / AND gate (every
                       gate outside a fused circuit);
* ``shuffle_gather`` — the row gather of each secure-shuffle hop, every
                       column at once (``gather_hop``: one direct launch,
                       or above the L2 a plan and two passes through
                       shared memory);
* ``ks_prefix``      — every Kogge-Stone level of a comparison or adder in
                       one launch, and ``and_fold``, the equality AND tree;
* ``a2b_fused``      — the whole arithmetic -> boolean conversion (two
                       chained Kogge-Stone adders) in one launch, and
                       ``bit2a_fused``, the bit injection's two dependent
                       ring products;
* ``bitonic_stage``  — ``bitonic_swap``, one bitonic sort stage's
                       conditional swap over all columns (the select of
                       every stage on the fused path).

Each kernel is a CUDA C++ source in ``csrc/`` with a plain C entry point.
:func:`library` builds them at first use — one ``nvcc`` per source for
``sm_90a``, all started together, linked into one shared library — from the
checkout's sources alone into ``kernels/_build/`` (ignored by git), and loads
it with ``ctypes``. Each wrapper (``rss_gate.gate``,
``shuffle_gather.gather_hop``, ``ks_prefix.ks_prefix`` / ``and_fold``,
``a2b_fused.a2b_kernel`` / ``bit2a_kernel``, ``bitonic_stage.stage_swap``)
launches its kernel for a CUDA tensor and runs its plain PyTorch version for
a CPU tensor; it records one launch in :func:`launch_counts` where it
launches its kernel, and nowhere else.

Batched execution
-----------------
The engine's stacked pass runs a node's protocol once under
``torch.func.vmap`` over K query slots. A CUDA launch goes through a
``torch.library.custom_op`` (namespace ``repro_torch``) whose ``vmap`` rule
folds the batch axis into the kernel's lanes (:func:`fold_lanes`; the row
gather takes the K slots as K times the planes), so a stacked node
launches each kernel as often as one serial slot does. An unbatched
operand (a zero sharing drawn at per-slot shape) is broadcast to the K
slots first. On the CPU the plain versions run under ``vmap`` directly.

Circuit fusion
--------------
The device is the kernel switch; :func:`fusion_enabled` picks the circuit
path. On (:func:`~repro_torch.config.current_config`'s ``fuse_circuits``,
the default) the comparison,
equality and conversion circuits go through the fused kernels, one launch a
circuit, and each sort stage's select through ``bitonic_swap``; off, they
run gate by gate through ``rss_gate``. Both paths draw
the same randomness and log the same ledger entries, so their shares and
costs are bit-identical. :func:`override_fusion` sets the path for the
current thread and beats the config, which the engine applies with
``use_config`` for one execution.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from ..config import current_config

__all__ = [
    "fusion_enabled",
    "override_fusion",
    "record_launch",
    "launch_counts",
    "reset_launch_counts",
    "library",
    "build",
    "check_launch",
    "check_lanes",
    "require_contiguous",
    "batch_to",
    "fold_lanes",
    "c_shifts",
]

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"
_LIB_NAME = "librepro_torch_kernels.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

_LAUNCHES: Counter = Counter()
_LOCK = threading.Lock()
_LIB = None
_STATE = threading.local()


def fusion_enabled() -> bool:
    """True when circuits route through the single-launch fused kernels."""
    ov = getattr(_STATE, "fusion", None)
    return current_config().fuse_circuits if ov is None else ov


@contextlib.contextmanager
def override_fusion(enabled: Optional[bool]) -> Iterator[None]:
    """Thread-locally force circuit fusion on/off (None = the default)."""
    prev = getattr(_STATE, "fusion", None)
    _STATE.fusion = enabled
    try:
        yield
    finally:
        _STATE.fusion = prev


def record_launch(kind: str) -> None:
    _LAUNCHES[kind] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


def _nvcc() -> str:
    """``nvcc`` from PATH, else from the toolkit at ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one shared library.
    Reuses an existing library that is newer than every source. The
    compiler's ``-Xptxas -v`` report is kept in ``kernels/_build/ptxas.log``."""
    sources = sorted(_CSRC.glob("*.cu"))
    headers = sorted(_CSRC.glob("*.cuh"))
    lib = _BUILD / _LIB_NAME
    newest = max(p.stat().st_mtime for p in sources + headers)
    if lib.exists() and lib.stat().st_mtime >= newest:
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [_BUILD / (src.stem + ".o") for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    logs = []
    failed = []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (_BUILD / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = _BUILD / f".{_LIB_NAME}.{os.getpid()}"
    link = subprocess.run(
        [nvcc, *_NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The built kernel library (built and loaded at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.rss_gate_launch.argtypes = [vp, vp, vp, vp, i64, i32, vp]
            lib.rss_gate_launch.restype = i32
            # (cols, ncols, planes, index, n, stream)
            lib.gather_direct_launch.argtypes = [vp, i32, i32, vp, i64, vp]
            # (index, n, chunk_rows, tile_rows, n_chunks, n_tiles, counts, starts, packed, stream)
            lib.gather_plan_launch.argtypes = [vp, i64, i32, i32, i32, i32, vp, vp, vp, vp]
            # (cols, ncols, planes, packed, counts, starts, n, chunk_rows, n_chunks, tile_rows,
            #  n_tiles, stream)
            lib.gather_pass1_launch.argtypes = [vp, i32, i32, vp, vp, vp, i64, i32, i32, i32, i32, vp]
            # (cols, ncols, planes, packed, n, chunk_rows, stream)
            lib.gather_pass2_launch.argtypes = [vp, i32, i32, vp, i64, i32, vp]
            for fn in ("gather_direct_launch", "gather_plan_launch", "gather_pass1_launch",
                       "gather_pass2_launch"):
                getattr(lib, fn).restype = i32
            # (g, p, alpha, out, n, shifts, n_shifts, stream)
            lib.ks_prefix_launch.argtypes = [vp, vp, vp, vp, i64, vp, i32, vp]
            lib.ks_prefix_launch.restype = i32
            # (v, alpha, out, n, shifts, n_shifts, stream)
            lib.and_fold_launch.argtypes = [vp, vp, vp, i64, vp, i32, vp]
            lib.and_fold_launch.restype = i32
            # (x, alpha, out, n, shifts, n_shifts, stream)
            lib.a2b_launch.argtypes = [vp, vp, vp, i64, vp, i32, vp]
            lib.a2b_launch.restype = i32
            # (b, alpha, out, n, stream)
            lib.bit2a_launch.argtypes = [vp, vp, vp, i64, vp]
            lib.bit2a_launch.restype = i32
            # (mask, own, other, alpha, out, c, n, stream)
            lib.bitonic_swap_launch.argtypes = [vp, vp, vp, vp, vp, i64, i64, vp]
            lib.bitonic_swap_launch.restype = i32
            lib.kernel_error_string.argtypes = [i32]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def check_lanes(name: str, planes, alpha, words: int) -> None:
    """Raise unless every tensor of ``planes`` is a ``(3, N)`` int32 share
    triple and ``alpha`` a ``(3, words, N)`` int32 zero sharing, all of one
    N and on one device (the fused kernels' operands)."""
    n = planes[0].shape[-1] if planes[0].dim() == 2 else -1
    if any(p.dim() != 2 or p.shape[0] != 3 or p.shape[1] != n for p in planes) or tuple(
        alpha.shape
    ) != (3, words, n):
        raise ValueError(
            f"{name} needs (3, N) operands and a (3, {words}, N) alpha, got "
            f"{[tuple(p.shape) for p in planes]} and {tuple(alpha.shape)}"
        )
    if any(t.dtype != torch.int32 for t in (*planes, alpha)):
        raise TypeError(f"{name} needs int32 ring words, got {[t.dtype for t in (*planes, alpha)]}")
    if any(t.device != alpha.device for t in planes):
        raise ValueError(f"{name} operands lie on different devices")
    if alpha.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {alpha.device}")


def require_contiguous(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every operand a kernel reads by pointer is contiguous."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")


def batch_to(t: torch.Tensor, bdim: Optional[int], k: int, pos: int) -> torch.Tensor:
    """A ``vmap`` operand's physical tensor with its batch axis moved to
    ``pos``, contiguous; an unbatched operand (``bdim`` None) is broadcast to
    the ``k`` slots first."""
    if bdim is None:
        t, bdim = t.unsqueeze(0).expand(k, *t.shape), 0
    return t.movedim(bdim, pos).contiguous()


def fold_lanes(t: torch.Tensor, bdim: Optional[int], k: int) -> torch.Tensor:
    """Fold the batch axis into the lane axis (the last): a per-slot
    ``(3, ..., N)`` operand becomes one contiguous ``(3, ..., K*N)``, slot
    after slot. The kernel's output unfolds with ``unflatten(-1, (k, N))``."""
    return batch_to(t, bdim, k, -2).flatten(-2)


def c_shifts(shifts) -> "ctypes.Array":
    """A level shift list as the C int array the fused kernels take (at most
    8 levels, each shift in [0, 31])."""
    shifts = tuple(int(d) for d in shifts)
    if len(shifts) > 8 or any(not 0 <= d < 32 for d in shifts):
        raise ValueError(f"shift lists take at most 8 shifts in [0, 31], got {shifts}")
    return (ctypes.c_int * max(len(shifts), 1))(*shifts)
