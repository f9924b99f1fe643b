"""Hand-written CUDA kernels for the engine's hot spots, with launch accounting.

Two kernels carry the gate-by-gate query path:

* ``rss_gate``       — the 1-round RSS multiplication / AND gate (every
                       comparison circuit bottoms out here);
* ``shuffle_gather`` — the row gather of each secure-shuffle hop.

Each kernel is a CUDA C++ source in ``csrc/`` with a plain C entry point.
:func:`library` builds them at first use — one ``nvcc`` per source for
``sm_90a``, all started together, linked into one shared library — from the
checkout's sources alone into ``kernels/_build/`` (ignored by git), and loads
it with ``ctypes``. Each wrapper (``rss_gate.gate``,
``shuffle_gather.shuffle_gather``) launches its kernel for a CUDA tensor and
runs its plain PyTorch version for a CPU tensor; it records one launch in
:func:`launch_counts` where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Dict

__all__ = [
    "record_launch",
    "launch_counts",
    "reset_launch_counts",
    "library",
    "build",
    "check_launch",
]

_CSRC = Path(__file__).parent / "csrc"
_BUILD = Path(__file__).parent / "_build"
_LIB_NAME = "librepro_torch_kernels.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

_LAUNCHES: Counter = Counter()
_LOCK = threading.Lock()
_LIB = None


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
            lib.shuffle_gather_launch.argtypes = [vp, vp, vp, i32, i64, i64, vp]
            lib.shuffle_gather_launch.restype = i32
            lib.kernel_error_string.argtypes = [i32]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
