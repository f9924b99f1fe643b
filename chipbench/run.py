#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on one CUDA card.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device`` (and with ``--trace 1`` ``breakdown``), then ``checks``: each
number the comparison with the plain reference compared, with its limit.
The checks are also the last lines of standard error.

Without the program beside it, or without a CUDA card (or with fewer than
the cell asks for), it exits with 2 and prints no result; it never runs on
the CPU. It also refuses to print a
result (exit 3) if JAX, Flax or the JAX package ``repro`` was loaded.
Every build and kernel cache lies in the checkout, at fixed paths.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".chipbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _set_up_paths() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's, Flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _set_up_paths()
    if importlib.util.find_spec("repro_torch") is None:
        print(f"chipbench: the program (src/repro_torch) is not in {ROOT}; no result", file=sys.stderr)
        return 2

    import torch

    from chipbench.harness.cell import run_cell
    from chipbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"chipbench: {args.workload} needs {chips} CUDA card(s), found {have}; no result", file=sys.stderr)
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), _T0)
    found = forbidden_modules()
    if found:
        print(f"chipbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
