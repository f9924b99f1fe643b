#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
runs these phases; each one fails the run (non-zero exit) on any mismatch:

1. kernels: ``rss_gate`` (both modes) and ``shuffle_gather`` against their
   plain PyTorch versions on the card, bit for bit, at the listed shapes
   (the gather well above the TPU kernel's 8 MiB VMEM limit);
2. cross-device: the quickstart plan (n=48) on ``cuda`` and on ``cpu`` gives
   identical output shares, per-node (rounds, bytes/party) and Resize sizes S;
3. full size: ``dosage_study`` and the quickstart plan over
   ``generate_healthlnk(n)`` with Beta(2,6) Resizers on every internal
   operator. Launch counts are reset before each plan and read after it;
   both kernels must have launched, and the revealed rows must equal the
   plaintext oracle. Per-node seconds, S and launch counts are printed;
4. timing: each kernel's median time at the shapes the full-size run gave
   it, beside its plain version, the one-call library equivalent (where one
   exists) and the least time the card could take (``bound_ms``);
5. with ``--profile`` only: a ``torch.profiler`` breakdown of device time
   by kernel for one Distinct sort stage and one join tile at full size.

The lines before the last are the ``{"kernels": [...]}`` summary and the
card's name and power limit from ``nvidia-smi``; the last line is
``{"ok": true, "device": {...}}``. ``--out PATH`` also writes the details as JSON.
Without a CUDA device, or without the repository beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data-sheet peaks: HBM3 bandwidth, and the int32 rate of the
# CUDA cores (64 INT32 lanes per SM, half the 67 TFLOP/s float32 rate).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

# the full-size run: rows in each healthlnk table (2,048 patients)
ROWS_PER_TABLE = 8192
# the >8 MiB gather of the kernel phase: the product join's size as planned
GATHER_ROWS = 7_900_000
# timed calls in a row per kernel measurement
REPS = 20

RSS_GATE_TPU = "src/repro/kernels/rss_gate/rss_gate.py:43"
SHUFFLE_GATHER_TPU = "src/repro/kernels/shuffle_gather/shuffle_gather.py:33"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]


def words(rng, shape, device):
    import numpy as np
    import torch

    w = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def max_abs_err(a, b) -> int:
    """Largest |a - b| over the unsigned ring words of two int32 tensors."""
    import torch

    if a.numel() == 0:
        return 0
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max())


def median_ms(fn) -> float:
    """Time of one call: CUDA events around ``REPS`` calls in a row, over the
    count; the median of 5 such runs, after a warm-up. For a small
    kernel this is the wrapper's host time per call, as the engine sees it."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / REPS)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# 1. kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.rss_gate import gate, gate_plain
    from repro_torch.kernels.shuffle_gather import shuffle_gather, shuffle_gather_plain

    errs = {"rss_gate": 0, "shuffle_gather": 0}
    rng = np.random.default_rng(0)
    for boolean in (True, False):
        for n in (0, 1, 2049, 65_536, 1 << 21):
            x, y, a = (words(rng, (3, n), dev) for _ in range(3))
            reset_launch_counts()
            got = gate(x, y, a, boolean)
            torch.cuda.synchronize()
            check(launch_counts().get("rss_gate", 0) == (1 if n else 0), f"rss_gate n={n} did not launch")
            err = max_abs_err(got, gate_plain(x, y, a, boolean))
            print(f"  rss_gate     bool={int(boolean)} n={n:>9}  max_abs_err={err}")
            check(err == 0, f"rss_gate bool={boolean} n={n} differs from its plain version")
            errs["rss_gate"] = max(errs["rss_gate"], err)
    for n, c in ((1, 1), (257, 3), (GATHER_ROWS, 1)):
        planes = words(rng, (3, n, c), dev)
        perm = torch.randperm(n, device=dev)
        reset_launch_counts()
        got = shuffle_gather(planes, perm)
        torch.cuda.synchronize()
        check(launch_counts().get("shuffle_gather", 0) == 1, f"shuffle_gather n={n} did not launch")
        err = max_abs_err(got, shuffle_gather_plain(planes, perm))
        mib = planes[0].numel() * 4 / 2**20
        print(f"  shuffle_gather (N, C)=({n}, {c}) plane={mib:.1f} MiB  max_abs_err={err}")
        check(err == 0, f"shuffle_gather ({n}, {c}) differs from its plain version")
        errs["shuffle_gather"] = max(errs["shuffle_gather"], err)
    # an index outside [0, N) reads as zeros in the kernel and the plain version
    planes = words(rng, (3, 257, 3), dev)
    perm = torch.randperm(257, device=dev)
    perm[[0, 128, 256]] = torch.tensor([-1, 257, 2**40], device=dev)
    got = shuffle_gather(planes, perm)
    err = max_abs_err(got, shuffle_gather_plain(planes, perm))
    print(f"  shuffle_gather (N, C)=(257, 3), 3 indices out of range  max_abs_err={err}")
    check(err == 0 and not got[:, [0, 128, 256]].any(), "shuffle_gather: out-of-range rows differ")
    reset_launch_counts()
    return errs


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def quickstart_plan(right_key: str):
    """The plan of examples/quickstart.py: Filter -> Join -> Distinct."""
    from repro_torch.ops import Predicate
    from repro_torch.plan import Distinct, Filter, Join, Scan

    return Distinct(
        Join(
            Filter(Scan("diagnoses"), [Predicate("icd9", "eq", 414)]),
            Filter(Scan("medications"), [Predicate("med", "eq", 1)]),
            ("pid", right_key),
        ),
        "pid",
    )


def with_resizers(plan):
    from repro_torch.core.noise import BetaNoise
    from repro_torch.core.resizer import ResizerConfig
    from repro_torch.plan import insert_resizers

    return insert_resizers(
        plan,
        lambda node: ResizerConfig(noise=BetaNoise(2, 6), addition="parallel"),
        placement="all_internal",
    )


def node_rows(report) -> list:
    return [
        {
            "node": s.node,
            "n_ins": s.n_ins,
            "n_out": s.n_out,
            "seconds": s.seconds,
            "rounds": s.rounds,
            "bytes_per_party": s.bytes_per_party,
            "s": s.extra.get("s"),
        }
        for s in report.nodes
    ]


# ---------------------------------------------------------------------------
# 2. the same plan on cuda and on cpu
# ---------------------------------------------------------------------------

def cross_device_phase(dev) -> None:
    import numpy as np
    import torch

    from repro_torch.core import threefry
    from repro_torch.core.ring import to_numpy
    from repro_torch.engine import Engine
    from repro_torch.ops import SecretTable

    rng = np.random.default_rng(7)
    n = 48
    patients = {
        "pid": rng.integers(0, 12, n).astype(np.uint32),
        "icd9": rng.choice([390, 401, 414], n).astype(np.uint32),
    }
    meds = {
        "pid2": rng.integers(0, 12, n).astype(np.uint32),
        "med": rng.choice([1, 2, 3], n).astype(np.uint32),
    }
    plan = with_resizers(quickstart_plan("pid2"))
    runs = {}
    for d in (dev, torch.device("cpu")):
        tables = {
            "diagnoses": SecretTable.from_plaintext(patients, threefry.PRNGKey(0), device=d),
            "medications": SecretTable.from_plaintext(meds, threefry.PRNGKey(1), device=d),
        }
        runs[d.type] = Engine(tables, key=threefry.PRNGKey(42), device=d).execute(plan)
    (gout, grep), (cout, crep) = runs["cuda"], runs["cpu"]
    ledger = [(s.node, s.rounds, s.bytes_per_party, s.n_out, s.extra.get("s")) for s in grep.nodes]
    check(
        ledger == [(s.node, s.rounds, s.bytes_per_party, s.n_out, s.extra.get("s")) for s in crep.nodes],
        "per-node ledgers or Resize sizes differ between cuda and cpu",
    )
    check(list(gout.cols) == list(cout.cols), "output columns differ between cuda and cpu")
    for name in gout.cols:
        check(
            (to_numpy(gout.col(name).shares) == to_numpy(cout.col(name).shares)).all(),
            f"output shares of {name!r} differ between cuda and cpu",
        )
    check((to_numpy(gout.valid.shares) == to_numpy(cout.valid.shares)).all(), "valid shares differ")
    pids = sorted(set(gout.reveal_true_rows()["pid"].tolist()))
    want = sorted(set(np.intersect1d(patients["pid"][patients["icd9"] == 414],
                                     meds["pid2"][meds["med"] == 1]).tolist()))
    check(pids == want, f"quickstart rows {pids} != oracle {want}")
    sizes = [s.extra["s"] for s in grep.nodes if "s" in s.extra]
    print(f"  quickstart n=48: shares, ledgers and S={sizes} identical on cuda and cpu; rows {pids}")


# ---------------------------------------------------------------------------
# 3. full-size run
# ---------------------------------------------------------------------------

def full_phase(dev, n: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import threefry
    from repro_torch.data.healthlnk import generate_healthlnk, plaintext_oracle
    from repro_torch.data.queries import dosage_study_plan
    from repro_torch.engine import Engine
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    tables, plain = generate_healthlnk(n=n, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"  generate_healthlnk(n={n}): {time.perf_counter() - t0:.3f} s (set-up)")
    d, m = plain["diagnoses"], plain["medications"]
    plans = {
        "dosage_study": (dosage_study_plan(), plaintext_oracle("dosage_study", plain)),
        "quickstart": (
            quickstart_plan("pid"),
            sorted(int(p) for p in np.intersect1d(d["pid"][d["icd9"] == 414],
                                                  m["pid"][m["med"] == 1])),
        ),
    }
    results = {}
    for i, (name, (plan, want)) in enumerate(plans.items()):
        engine = Engine(tables, key=threefry.PRNGKey(42 + i), device=dev)
        placed = with_resizers(plan)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, report = engine.execute(placed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        reset_launch_counts()
        rows = sorted(set(out.reveal_true_rows()["pid"].tolist()))
        print(f"  {name}: {seconds:.3f} s, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
              f"launches {launches}")
        for line in report.summary().splitlines():
            print("    " + line)
        check(rows == want, f"{name}: revealed rows differ from the plaintext oracle")
        for kernel in ("rss_gate", "shuffle_gather"):
            check(launches.get(kernel, 0) > 0, f"{name}: {kernel} was never launched")
        print(f"  {name}: {len(rows)} rows equal the plaintext oracle")
        results[name] = {
            "seconds": seconds,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": launches,
            "nodes": node_rows(report),
            "rows": len(rows),
        }
    return results


# ---------------------------------------------------------------------------
# 4. timing at the main path's shapes
# ---------------------------------------------------------------------------

def timing_phase(dev, gate_lanes: int, gather_rows: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.rss_gate import gate, gate_plain
    from repro_torch.kernels.shuffle_gather import shuffle_gather, shuffle_gather_plain

    rng = np.random.default_rng(1)
    out = {}

    rows = []
    for boolean in (True, False):
        for n in sorted({65_536, gate_lanes}):
            x, y, a = (words(rng, (3, n), dev) for _ in range(3))
            err = max_abs_err(gate(x, y, a, boolean), gate_plain(x, y, a, boolean))
            check(err == 0, f"rss_gate n={n} differs from its plain version")
            ms = median_ms(lambda: gate(x, y, a, boolean))
            plain_ms = median_ms(lambda: gate_plain(x, y, a, boolean))
            bytes_moved = 12 * 4 * n  # x, y, alpha read, z written: 3 words each
            ops = 3 * 6 * n  # per share word: 3 products / ANDs and 3 sums / XORs
            bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
            by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S else "operations"
            rows.append({"boolean": boolean, "n": n, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err})
            print(f"  rss_gate     bool={int(boolean)} n={n:>9}: {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {bound_ms:.4f} ms ({by})")
    out["rss_gate"] = rows

    rows = []
    for n, c in sorted({(gather_rows, 1), (1 << 21, 1)}):
        planes = words(rng, (3, n, c), dev)
        perm = torch.randperm(n, device=dev)
        err = max_abs_err(shuffle_gather(planes, perm), shuffle_gather_plain(planes, perm))
        check(err == 0, f"shuffle_gather ({n}, {c}) differs from its plain version")
        ms = median_ms(lambda: shuffle_gather(planes, perm))
        plain_ms = median_ms(lambda: shuffle_gather_plain(planes, perm))
        library_ms = median_ms(lambda: torch.index_select(planes, 1, perm))
        bytes_moved = 2 * 3 * n * c * 4 + 8 * n  # every word read and written once, plus the index
        bound_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
        rows.append({"n": n, "c": c, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": "bytes", "max_abs_err": err})
        print(f"  shuffle_gather (N, C)=({n}, {c}): {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"index_select {library_ms:.4f} ms  bound {bound_ms:.4f} ms (bytes)")
    out["shuffle_gather"] = rows
    return out


# ---------------------------------------------------------------------------
# 5. (--profile) device-time breakdown of the two heaviest operators
# ---------------------------------------------------------------------------

def _kernel_category(name: str) -> str:
    low = name.lower()
    if "rss_gate" in low:
        return "rss_gate kernel"
    if "shuffle_gather" in low:
        return "shuffle_gather kernel"
    if "sort" in low or "radix" in low:
        return "sort (torch)"
    if "index" in low or "gather" in low or "scatter" in low:
        return "index / gather (torch)"
    return "elementwise (torch)"


def _profile_window(label: str, fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((e.key, e.count, us / 1e3))
    busy_ms = sum(k[2] for k in kernels)
    cats: dict = {}
    for name, count, ms in kernels:
        c = cats.setdefault(_kernel_category(name), {"ms": 0.0, "launches": 0})
        c["ms"] += ms
        c["launches"] += count
    print(f"  {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f} %), {sum(k[1] for k in kernels)} kernel launches")
    if not kernels:
        print("    the profiler saw no device time: not measured")
    for cat, v in sorted(cats.items(), key=lambda kv: -kv[1]["ms"]):
        print(f"    {cat:<24} {v['ms']:10.3f} ms  {v['launches']:>7} launches")
    top = sorted(kernels, key=lambda k: -k[2])[:6]
    for name, count, ms in top:
        print(f"      {ms:10.3f} ms {count:>7}x  {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "categories": cats,
            "top": [{"name": n, "count": c, "ms": m} for n, c, m in top]}


def profile_phase(dev, distinct_rows: int) -> dict:
    import numpy as np

    from repro_torch.core import threefry
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.sharing import BShare
    from repro_torch.core.sort import _stage
    from repro_torch.ops import SecretTable
    from repro_torch.ops.join import oblivious_join

    rng = np.random.default_rng(2)
    prf = setup_prf(threefry.PRNGKey(3))
    # one compare-exchange stage of Distinct's bitonic network at the run's
    # row count: the sort key and the row-index column ride the network
    net = {name: BShare(words(rng, (3, distinct_rows), dev)) for name in ("__sk", "__idx")}
    # one 65,536-row tile of the product join's valid column (256 x 256 rows)
    side = {"pid": rng.integers(0, 64, 256).astype(np.uint32)}
    left = SecretTable.from_plaintext(side, threefry.PRNGKey(4), device=dev)
    right = SecretTable.from_plaintext(side, threefry.PRNGKey(5), device=dev)
    return {
        "distinct_stage": _profile_window(
            f"one bitonic stage, {distinct_rows} rows",
            lambda: _stage(net, ["__sk"], 4, 2, prf, False)),
        "join_tile": _profile_window(
            "one join tile, 65536 product rows",
            lambda: oblivious_join(left, right, ("pid", "pid"), prf)),
    }


def largest_shapes(full: dict) -> tuple:
    """(gate lanes, gather rows) of the full-size run: the bitonic sort's
    compare-exchange pairs over the Distinct's power-of-two rows (two words
    per row, ``_and_pair``) and the Resize shuffle right after the join."""
    distinct_rows = join_rows = 1
    for res in full.values():
        for node in res["nodes"]:
            if node["node"].startswith("Distinct"):
                distinct_rows = max(distinct_rows, node["n_out"])
            if node["node"].startswith("Join"):
                join_rows = max(join_rows, node["n_out"])
    return 2 * distinct_rows, join_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one Distinct stage and one join tile with torch.profiler")
    ap.add_argument("--out", help="write the run's details as JSON to this path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    import repro_torch.kernels as kernels

    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = nvidia_smi_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = kernels.build()
    kernels.library()
    build_s = time.perf_counter() - t0
    print(f"[build] {lib.name} from {len(list((lib.parent.parent / 'csrc').glob('*.cu')))} sources "
          f"in {build_s:.1f} s")

    print("[1] kernels against their plain versions")
    errs = kernel_phase(dev)

    print("[2] cross-device: quickstart n=48 on cuda and cpu")
    cross_device_phase(dev)

    print(f"[3] full size: n={ROWS_PER_TABLE} rows per table")
    full = full_phase(dev, ROWS_PER_TABLE)

    gate_lanes, join_rows = largest_shapes(full)
    print(f"[4] kernel timing at the run's shapes (gate lanes {gate_lanes}, gather rows {join_rows})")
    timing = timing_phase(dev, gate_lanes, join_rows)

    profiled = None
    if args.profile:
        print("[5] device-time breakdown (torch.profiler)")
        profiled = profile_phase(dev, gate_lanes // 2)

    launches = {k: sum(r["launches"].get(k, 0) for r in full.values()) for k in errs}
    g = max(timing["rss_gate"], key=lambda r: (r["n"], r["boolean"]))
    s = max(timing["shuffle_gather"], key=lambda r: r["n"])
    summary = {"kernels": [
        {"name": "rss_gate", "route": "cuda", "source": "src/repro_torch/kernels/csrc/rss_gate.cu",
         "replaces": RSS_GATE_TPU, "launches": launches["rss_gate"],
         "max_abs_err": max(errs["rss_gate"], *(r["max_abs_err"] for r in timing["rss_gate"])),
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"], "bound_by": g["bound_by"],
         "library_ms": None},
        {"name": "shuffle_gather", "route": "cuda", "source": "src/repro_torch/kernels/csrc/shuffle_gather.cu",
         "replaces": SHUFFLE_GATHER_TPU, "launches": launches["shuffle_gather"],
         "max_abs_err": max(errs["shuffle_gather"], *(r["max_abs_err"] for r in timing["shuffle_gather"])),
         "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
         "library_ms": s["library_ms"]},
    ]}
    total_s = time.perf_counter() - t_all
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "n": ROWS_PER_TABLE, "build_s": build_s, "total_s": total_s, "full": full,
               "timing": timing, "profile": profiled, "summary": summary}
    print(f"total {total_s:.1f} s")
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(details, indent=1))
        print(f"details in {out}")

    print(json.dumps(summary))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
