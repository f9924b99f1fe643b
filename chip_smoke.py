#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
runs these phases; each one fails the run (non-zero exit) on any mismatch:

1. kernels: ``rss_gate`` (both modes), ``shuffle_gather`` and the hop
   gather ``gather_hop`` on both of its routes, the fused circuit kernels
   ``ks_prefix``, ``and_fold``, ``a2b_fused`` and ``bit2a_fused``, and the
   sort's stage select ``bitonic_swap`` against their plain PyTorch versions
   on the card, bit for bit, at the listed shapes (the gather well above the
   TPU kernel's 8 MiB VMEM limit: direct at 2^20 rows, two-pass at 2^24 + 3
   rows with 2 and 6 columns of mixed widths, on unaligned and strided
   planes and with indices out of range; the fused kernels and
   ``bitonic_swap`` at ragged lane counts and on unaligned planes, the fused
   kernels at the widths the path uses, and ``bit2a`` on a 2-D lane shape);
2. cross-device: the quickstart plan, ``comorbidity`` and
   ``diag_breakdown`` (n=48) on the default fused path on ``cuda`` and on
   ``cpu`` give identical output shares, per-node (rounds, bytes/party) and
   Resize sizes S, and on ``cuda`` the gate-by-gate path
   (``fuse_circuits=False``) gives the same again;
3. full size over ``generate_healthlnk(n)`` with Beta(2,6) Resizers on every
   internal operator: ``aspirin_count`` (theta join, COUNT(DISTINCT)) on the
   fused path, ``dosage_study`` and ``comorbidity`` (GroupBy, then ORDER BY
   DESC LIMIT 10) on the fused and on the gate-by-gate path (identical
   shares, ledgers and S), the quickstart plan, the ten dialect goldens
   (Project, SUM, AVG, MIN, MAX, OR, composite-key GroupBy, GroupBy SUM and
   AVG, HAVING), ``three_join`` at a reduced n (its later product joins grow
   as n^3 and n^4), and ``comorbidity`` once more over a 1,048,576-row
   diagnoses table. Launch counts are reset before each run and read after
   it; every kernel of that run's path must have launched, the gather once
   per shuffle hop (twice, after its plan, on a two-pass hop), and every
   answer must equal the plaintext oracle. Per-node seconds, S, peak memory,
   launch counts and each run's shuffle hops (rows, planes, column widths)
   are printed;
4. timing: each kernel's median time at the shapes the full-size run gave
   it, beside its plain version, the one-call library equivalent (where one
   exists) and the least time the card could take (``bound_ms``); for
   ``bitonic_swap`` also the gate-by-gate route it replaces at the same
   shape; for the gather, at the largest recorded hop and at one column over
   the largest join's rows, also the direct route, the plan alone and the
   one-pass sector cost, then both routes over hops from 6 to 192 MiB (the
   size rule) and the two-pass route's chunk size;
5. with ``--profile`` only: a ``torch.profiler`` breakdown of device time
   by kernel for one stage of the full-size Distinct's sort (2^23 rows) on
   the fused and on the gate-by-gate path, one join tile, and the largest
   shuffle hop.

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
# three_join's rows per table: its second and third product joins hold about
# S1 * n/4 and S2 * n/4 rows (S: the Resize sizes), which grow as n^3 and n^4
THREE_JOIN_ROWS = 512
# comorbidity's second run: a one-million-row diagnoses table
BIG_ROWS = 1 << 20
# the >8 MiB gather of the kernel phase: the product join's size as planned
GATHER_ROWS = 7_900_000
# timed calls in a row per kernel measurement
REPS = 20
# rows of the hops (two one-word columns, 24 bytes a row) over which phase 4
# times both gather routes, 6 MiB to 288 MiB (1 to 48 MiB a plane): the
# measurement behind the size rule between them
SIZE_RULE_ROWS = (1 << 18, 1 << 20, 1 << 21, 1 << 22, 5 << 20, 6 << 20, 7 << 20, 1 << 23, 3 << 22)

CSRC = "src/repro_torch/kernels/csrc/"
# name (as the launch counts have it) -> (CUDA source, TPU kernel it replaces)
KERNELS = {
    "rss_gate": (CSRC + "rss_gate.cu", "src/repro/kernels/rss_gate/rss_gate.py:43"),
    "shuffle_gather": (CSRC + "shuffle_gather.cu", "src/repro/kernels/shuffle_gather/shuffle_gather.py:33"),
    "ks_prefix": (CSRC + "ks_prefix.cu", "src/repro/kernels/ks_prefix/ks_prefix.py:83"),
    "and_fold": (CSRC + "ks_prefix.cu", "src/repro/kernels/ks_prefix/ks_prefix.py:111"),
    "a2b_fused": (CSRC + "a2b_fused.cu", "src/repro/kernels/a2b_fused/a2b_fused.py:78"),
    "bit2a_fused": (CSRC + "a2b_fused.cu", "src/repro/kernels/a2b_fused/a2b_fused.py:101"),
    "bitonic_swap": (CSRC + "bitonic_swap.cu", "src/repro/kernels/bitonic_stage/bitonic_stage.py:41"),
}
GATE_KERNELS = ("rss_gate", "shuffle_gather")  # the gate-by-gate path's
FUSED_KERNELS = ("ks_prefix", "and_fold", "a2b_fused", "bit2a_fused", "bitonic_swap")
# the kernels each golden's fused path launches with Resizers on every
# internal operator: every plan filters, joins, resizes or sorts through
# rss_gate, ks_prefix and and_fold; a Resize adds shuffle_gather and
# a2b_fused; COUNT, SUM, AVG and GroupBy add bit2a_fused; a sort adds
# bitonic_swap (diag_breakdown's sort has no payload to narrow and no Resize,
# so it shuffles nothing; the other GroupBys at the root convert no a2b)
_BASE = ("rss_gate", "ks_prefix", "and_fold")
_RESIZED = _BASE + ("shuffle_gather", "a2b_fused")
PATH_KERNELS = {
    "comorbidity": _RESIZED + ("bit2a_fused", "bitonic_swap"),
    "dosage_study": _RESIZED + ("bitonic_swap",),
    "aspirin_count": _RESIZED + ("bit2a_fused", "bitonic_swap"),
    "three_join": _RESIZED + ("bit2a_fused", "bitonic_swap"),
    "projection_join": _RESIZED,
    "dosage_sum": _RESIZED + ("bit2a_fused",),
    "dosage_avg": _RESIZED + ("bit2a_fused",),
    "dosage_min": _RESIZED + ("bitonic_swap",),
    "dosage_max": _RESIZED + ("bitonic_swap",),
    "heart_or_circulatory": _RESIZED + ("bit2a_fused",),
    "diag_breakdown": _BASE + ("bit2a_fused", "bitonic_swap"),
    "med_dosage_sum": _BASE + ("shuffle_gather", "bit2a_fused", "bitonic_swap"),
    "med_dosage_avg": _BASE + ("shuffle_gather", "bit2a_fused", "bitonic_swap"),
    "repeat_diagnoses": _RESIZED + ("bit2a_fused", "bitonic_swap"),
}
# the goldens the full-size phase runs beyond the earlier slices' four
NEW_GOLDENS = ("comorbidity", "projection_join", "dosage_sum", "dosage_avg", "dosage_min", "dosage_max",
               "heart_or_circulatory", "diag_breakdown", "med_dosage_sum", "med_dosage_avg", "repeat_diagnoses")


def check_launches(label: str, launches: dict, query: str, fused: bool) -> None:
    """Every kernel of the run's path launched; the gate-by-gate path
    launched none of the fused kernels."""
    need = [k for k in PATH_KERNELS[query] if fused or k in GATE_KERNELS]
    missing = [k for k in need if not launches.get(k, 0)]
    check(not missing, f"{label}: {missing} never launched (launches {launches})")
    if not fused:
        check(not any(launches.get(k, 0) for k in FUSED_KERNELS),
              f"{label}: the gate-by-gate path launched a fused kernel ({launches})")


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
    from repro_torch.kernels.shuffle_gather import shuffle_gather, shuffle_gather_plain, uses_two_pass

    errs = dict.fromkeys(KERNELS, 0)
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
        passes = 2 if uses_two_pass(n, c) else 1
        check(launch_counts().get("shuffle_gather", 0) == passes, f"shuffle_gather n={n} did not launch")
        err = max_abs_err(got, shuffle_gather_plain(planes, perm))
        mib = planes[0].numel() * 4 / 2**20
        print(f"  shuffle_gather (N, C)=({n}, {c}) plane={mib:.1f} MiB, {passes} pass(es)  max_abs_err={err}")
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
    hop_kernel_checks(dev, rng, errs)
    fused_kernel_checks(dev, rng, errs)
    bitonic_kernel_checks(dev, rng, errs)
    reset_launch_counts()
    return errs


def hop_kernel_checks(dev, rng, errs: dict) -> None:
    """The hop gather on both routes against the plain gather, bit for bit:
    direct at 2^20 rows, two-pass at 2^24 + 3 rows with 2 and 6 columns of
    mixed widths (each with its launch counts), a column one word off its
    storage and columns sliced from a stacked one, out-of-range indices; and
    the two-pass plan's counts and scans against the plain plan."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.shuffle_gather import (
        gather_direct,
        gather_hop,
        gather_plan,
        gather_plan_plain,
        gather_two_pass,
        shuffle_gather_plain,
    )

    def hop(n, widths):
        return [words(rng, (3, n, w), dev) for w in widths], torch.randperm(n, device=dev)

    def compare(label, got, cols, index):
        torch.cuda.synchronize()
        err = max(max_abs_err(out, shuffle_gather_plain(col, index)) for out, col in zip(got, cols))
        print(f"  gather_hop {label}  max_abs_err={err}")
        check(err == 0, f"gather_hop {label} differs from the plain gather")
        errs["shuffle_gather"] = max(errs["shuffle_gather"], err)

    cases = [("direct", 1 << 20, (1, 3, 1), {"shuffle_gather": 1}),
             ("two-pass", (1 << 24) + 3, (1, 1), {"shuffle_plan": 1, "shuffle_gather": 2}),
             ("two-pass", (1 << 24) + 3, (1, 3, 1, 2, 1, 1), {"shuffle_plan": 1, "shuffle_gather": 2})]
    for route, n, widths, want in cases:
        cols, index = hop(n, widths)
        reset_launch_counts()
        got = (gather_direct if route == "direct" else gather_hop)(cols, index)
        compare(f"{route} N={n} widths={widths}", got, cols, index)
        check(launch_counts() == want, f"gather_hop {route} N={n}: launches {launch_counts()}, not {want}")
        del cols, index, got
    n = 300_001
    shifted = words(rng, (3 * n * 2 + 1,), dev)[1:].view(3, n, 2)
    stacked = words(rng, (3, n, 3), dev)
    cols = [shifted, stacked[:, :, 0:1], stacked[:, :, 1:3]]
    index = torch.randperm(n, device=dev)
    bad_index = index.clone()
    bad = torch.tensor([0, 7, n // 2, n - 1], device=dev)
    bad_index[bad] = torch.tensor([-1, n, 2**40, -(2**40)], device=dev)
    for idx, label in ((index, "unaligned and strided planes"), (bad_index, "4 indices out of range")):
        compare(f"direct N={n} {label}", gather_direct(cols, idx), cols, idx)
        compare(f"two-pass N={n} {label}", gather_two_pass(cols, idx, chunk_rows=20_000, tile_rows=512), cols, idx)
    plan = gather_plan(bad_index, 20_000, 2048)
    want_plan = gather_plan_plain(bad_index, 20_000, 2048)
    same = all(torch.equal(getattr(plan, k), getattr(want_plan, k)) for k in ("counts", "start"))
    print(f"  gather_plan N={n}: counts and starts {'equal' if same else 'differ from'} the plain plan")
    check(same, "gather_plan's counts or starts differ from the plain plan")


def operand(rng, shape, dev, aligned: bool):
    """Random ring words of ``shape`` on the card; unaligned: a view one word
    into its storage, which sends the kernels down their scalar path."""
    if aligned:
        return words(rng, shape, dev)
    n = 1
    for d in shape:
        n *= d
    return words(rng, (n + 1,), dev)[1:].view(shape)


def fused_kernel_checks(dev, rng, errs: dict) -> None:
    """The four fused circuit kernels against their plain versions, bit for
    bit: ragged and aligned lane counts, aligned and unaligned planes, the
    widths the path uses (Kogge-Stone 32 / 18 / 16, fold 32 / 18), and
    ``bit2a`` on a 2-D lane shape through ``b2a``."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.core.circuits import b2a
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.sharing import BShare
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.a2b_fused import a2b_kernel, a2b_plain, bit2a_kernel, bit2a_plain
    from repro_torch.kernels.ks_prefix import (
        and_fold,
        and_fold_plain,
        fold_shifts,
        ks_prefix,
        ks_prefix_plain,
        ks_shifts,
    )

    def one(name, label, kernel, plain, args):
        reset_launch_counts()
        got = kernel(*args)
        torch.cuda.synchronize()
        check(launch_counts().get(name, 0) == 1, f"{name} {label} did not launch")
        err = max_abs_err(got, plain(*args))
        check(err == 0, f"{name} {label} differs from its plain version")
        errs[name] = max(errs[name], err)

    for n in (1, 5, 4097, 1 << 21):
        for aligned in (True, False):
            label = f"n={n}" + ("" if aligned else " planes one word off 16-byte alignment")
            for width in (32, 18, 16):
                sh = ks_shifts(width)
                g, p = operand(rng, (3, n), dev, aligned), operand(rng, (3, n), dev, aligned)
                al = operand(rng, (3, 2 * len(sh), n), dev, aligned)
                one("ks_prefix", f"{label} width={width}", lambda g, p, al, sh=sh: ks_prefix(g, p, al, sh),
                    lambda g, p, al, sh=sh: ks_prefix_plain(g, p, al, sh), (g, p, al))
                al = operand(rng, (3, 2 * (1 + 2 * len(sh)), n), dev, aligned)
                one("a2b_fused", f"{label} width={width}", lambda x, al, sh=sh: a2b_kernel(x, al, sh),
                    lambda x, al, sh=sh: a2b_plain(x, al, sh), (g, al))
            for width in (32, 18):
                sh = fold_shifts(width)
                v = operand(rng, (3, n), dev, aligned)
                al = operand(rng, (3, len(sh), n), dev, aligned)
                one("and_fold", f"{label} width={width}", lambda v, al, sh=sh: and_fold(v, al, sh),
                    lambda v, al, sh=sh: and_fold_plain(v, al, sh), (v, al))
            b = operand(rng, (3, n), dev, aligned)
            al = operand(rng, (3, 2, n), dev, aligned)
            one("bit2a_fused", label, bit2a_kernel, bit2a_plain, (b, al))
            print(f"  ks_prefix, a2b_fused (widths 32/18/16), and_fold (32/18), bit2a_fused  {label}  "
                  f"max_abs_err=0")
    # bit2a on a (4097, 32) lane shape: b2a's bit planes, on the card against
    # the same words and PRF keys through the plain versions on the CPU
    x = BShare(words(rng, (3, 4097), dev))
    prf = setup_prf(threefry.PRNGKey(9))
    reset_launch_counts()
    got = b2a(x, prf)
    torch.cuda.synchronize()
    check(launch_counts().get("bit2a_fused", 0) == 1, "b2a did not launch bit2a_fused")
    err = max_abs_err(got.shares.cpu(), b2a(BShare(x.shares.cpu()), prf).shares)
    print(f"  bit2a_fused  lanes (4097, 32) via b2a, cuda vs cpu  max_abs_err={err}")
    check(err == 0, "b2a on the card differs from its plain version on the CPU")


def bitonic_kernel_checks(dev, rng, errs: dict) -> None:
    """``bitonic_swap`` against its plain version, bit for bit: ragged and
    aligned lane counts, C = 1, 3 and 9 columns, aligned and unaligned
    planes."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.bitonic_stage import stage_swap, stage_swap_plain

    for n in (1, 257, 4099, 1 << 20):
        for c in (1, 3, 9):
            for aligned in (True, False):
                mask = operand(rng, (3, n), dev, aligned)
                own, other, alpha = (operand(rng, (3, c, n), dev, aligned) for _ in range(3))
                reset_launch_counts()
                got = stage_swap(mask, own, other, alpha)
                torch.cuda.synchronize()
                label = f"N={n} C={c}" + ("" if aligned else " unaligned")
                check(launch_counts().get("bitonic_swap", 0) == 1, f"bitonic_swap {label} did not launch")
                err = max_abs_err(got, stage_swap_plain(mask, own, other, alpha))
                check(err == 0, f"bitonic_swap {label} differs from its plain version")
                errs["bitonic_swap"] = max(errs["bitonic_swap"], err)
                del mask, own, other, alpha, got
        print(f"  bitonic_swap N={n:>7}, C = 1/3/9, aligned and unaligned planes  max_abs_err=0")


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

def share_rows(out) -> dict:
    """Every output column's and the valid column's shares, on the host."""
    from repro_torch.core.ring import to_numpy

    rows = {name: to_numpy(out.col(name).shares) for name in out.cols}
    rows["__valid"] = to_numpy(out.valid.shares)
    return rows


def same_outputs(a, b) -> bool:
    sa, sb = share_rows(a), share_rows(b)
    return list(sa) == list(sb) and all((sa[k] == sb[k]).all() for k in sa)


def ledger_rows(report) -> list:
    return [(s.node, s.rounds, s.bytes_per_party, s.n_out, s.extra.get("s")) for s in report.nodes]


def three_ways(dev, label: str, make_tables, plan, key: int, query: str):
    """One plan fused on ``cuda``, fused on ``cpu`` and gate by gate on
    ``cuda``: identical shares, per-node ledgers and S, and the launches of
    each path. Returns the cuda fused run's (output, report)."""
    import torch

    from repro_torch import RuntimeConfig
    from repro_torch.core import threefry
    from repro_torch.engine import Engine
    from repro_torch.kernels import launch_counts, reset_launch_counts

    runs = {}
    for name, d, fuse in (("cuda", dev, True), ("cpu", torch.device("cpu"), True), ("cuda gates", dev, False)):
        engine = Engine(make_tables(d), key=threefry.PRNGKey(key), config=RuntimeConfig(fuse_circuits=fuse), device=d)
        reset_launch_counts()
        runs[name] = engine.execute(plan)
        if d.type == "cuda":  # a CPU tensor runs the plain versions and launches nothing
            torch.cuda.synchronize()
            check_launches(f"{label} {name}", launch_counts(), query, fuse)
    reset_launch_counts()
    (gout, grep), (cout, crep), (uout, urep) = runs["cuda"], runs["cpu"], runs["cuda gates"]
    check(ledger_rows(grep) == ledger_rows(crep), f"{label}: per-node ledgers or Resize sizes differ between cuda and cpu")
    check(same_outputs(gout, cout), f"{label}: output shares differ between cuda and cpu")
    check(ledger_rows(grep) == ledger_rows(urep), f"{label}: fused and gate-by-gate ledgers or sizes differ on cuda")
    check(same_outputs(gout, uout), f"{label}: fused and gate-by-gate output shares differ on cuda")
    return gout, grep


def cross_device_phase(dev) -> None:
    import numpy as np

    from repro_torch.core import threefry
    from repro_torch.data import all_query_plans, generate_healthlnk, plaintext_oracle, revealed_answer
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

    def quickstart_tables(d):
        return {
            "diagnoses": SecretTable.from_plaintext(patients, threefry.PRNGKey(0), device=d),
            "medications": SecretTable.from_plaintext(meds, threefry.PRNGKey(1), device=d),
        }

    out, report = three_ways(dev, "quickstart n=48", quickstart_tables, with_resizers(quickstart_plan("pid2")), 42,
                             "dosage_study")
    pids = sorted(set(out.reveal_true_rows()["pid"].tolist()))
    want = sorted(set(np.intersect1d(patients["pid"][patients["icd9"] == 414],
                                     meds["pid2"][meds["med"] == 1]).tolist()))
    check(pids == want, f"quickstart rows {pids} != oracle {want}")
    sizes = [s.extra["s"] for s in report.nodes if "s" in s.extra]
    print(f"  quickstart n=48: shares, ledgers and S={sizes} identical on cuda and cpu (fused) and "
          f"on cuda gate by gate; rows {pids}")

    plain = generate_healthlnk(n=n, seed=0, device="cpu")[1]
    for query in ("comorbidity", "diag_breakdown"):
        plan = with_resizers(all_query_plans()[query])
        out, report = three_ways(dev, f"{query} n={n}", lambda d: generate_healthlnk(n=n, seed=0, device=d)[0],
                                 plan, 46, query)
        got = revealed_answer(query, plan, out)
        check(got == plaintext_oracle(query, plain), f"{query} n={n}: {got} differs from the plaintext oracle")
        sizes = [s.extra["s"] for s in report.nodes if "s" in s.extra]
        print(f"  {query} n={n}: shares, ledgers and S={sizes} identical on cuda and cpu (fused) and "
              f"on cuda gate by gate; {len(got)} groups equal the oracle")


# ---------------------------------------------------------------------------
# 3. full-size run
# ---------------------------------------------------------------------------

def full_phase(dev, n: int, three_join_n: int, big_n: int) -> dict:
    """The full-size runs, each with its launch counts set to 0 just before
    it and read just after, and the shape of each shuffle hop it gathers
    (rows, planes, the columns' widths)."""
    import numpy as np
    import torch

    import repro_torch.core.shuffle as shuffle
    from repro_torch.data import all_query_plans, generate_healthlnk

    data = {}
    for rows in (n, three_join_n, big_n):
        t0 = time.perf_counter()
        data[rows] = generate_healthlnk(n=rows, seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"  generate_healthlnk(n={rows}): {time.perf_counter() - t0:.3f} s (set-up)")
    d, m = data[n][1]["diagnoses"], data[n][1]["medications"]
    quickstart_rows = sorted(int(p) for p in np.intersect1d(d["pid"][d["icd9"] == 414], m["pid"][m["med"] == 1]))
    plans = all_query_plans()
    # name -> (golden, plan, rows per table, engine key, fused, expected
    # answer); the quickstart plan answers in dosage_study's form
    runs = {
        "aspirin_count": ("aspirin_count", plans["aspirin_count"], n, 44, True, None),
        "dosage_study": ("dosage_study", plans["dosage_study"], n, 42, True, None),
        "dosage_study gates": ("dosage_study", plans["dosage_study"], n, 42, False, None),
        "quickstart": ("dosage_study", quickstart_plan("pid"), n, 43, True, quickstart_rows),
        "comorbidity gates": ("comorbidity", plans["comorbidity"], n, 46, False, None),
    }
    for i, query in enumerate(NEW_GOLDENS):
        runs[query] = (query, plans[query], n, 46 + i, True, None)
    runs["three_join"] = ("three_join", plans["three_join"], three_join_n, 45, True, None)
    runs[f"comorbidity n={big_n}"] = ("comorbidity", plans["comorbidity"], big_n, 46, True, None)

    hops: list = []
    gather_hop = shuffle.gather_hop

    def recorded_hop(cols, index):
        hops.append((index.shape[0], cols[0].shape[0], tuple(c.shape[2] for c in cols)))
        return gather_hop(cols, index)

    shuffle.gather_hop = recorded_hop
    try:
        results, outputs = _full_runs(dev, runs, data, hops, n)
    finally:
        shuffle.gather_hop = gather_hop
    for query in ("dosage_study", "comorbidity"):
        (fout, frep), (gout, grep) = outputs[query], outputs[f"{query} gates"]
        check(ledger_rows(frep) == ledger_rows(grep), f"{query}: fused and gate-by-gate ledgers or S differ")
        check(same_outputs(fout, gout), f"{query}: fused and gate-by-gate output shares differ")
        print(f"  {query}: output shares, per-node ledger and every S identical fused and gate by gate")
    return results


def _full_runs(dev, runs: dict, data: dict, hops: list, n: int) -> tuple:
    """Each run of ``full_phase``, with ``hops`` filled by the recording
    ``gather_hop``; returns the results and the outputs at ``n`` rows of
    the runs compared fused and gate by gate."""
    import torch

    from repro_torch import RuntimeConfig
    from repro_torch.core import threefry
    from repro_torch.data import plaintext_oracle, revealed_answer
    from repro_torch.engine import Engine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.shuffle_gather import uses_two_pass

    results, outputs = {}, {}
    for name, (query, plan, rows, key, fuse, want) in runs.items():
        if want is None:
            want = plaintext_oracle(query, data[rows][1])
        engine = Engine(data[rows][0], key=threefry.PRNGKey(key), config=RuntimeConfig(fuse_circuits=fuse),
                        device=dev)
        placed = with_resizers(plan)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        hops.clear()
        reset_launch_counts()
        t0 = time.perf_counter()
        out, report = engine.execute(placed)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        reset_launch_counts()
        run_hops = list(hops)
        peak = torch.cuda.max_memory_allocated(dev)
        got = revealed_answer(query, placed, out)
        print(f"  {name} (n={rows}, {'fused' if fuse else 'gate by gate'}): {seconds:.3f} s, "
              f"peak {peak / 2**30:.2f} GiB, launches {launches}")
        for line in report.summary().splitlines():
            print("    " + line)
        check(got == want, f"{name}: the result {got} differs from the plaintext oracle {want}")
        check_launches(name, launches, query, fuse)
        two_pass = sum(uses_two_pass(h[0], max(h[2])) for h in run_hops)
        passes = len(run_hops) + two_pass
        if run_hops:
            top = max(run_hops, key=lambda h: h[0] * h[1] * sum(h[2]))
            print(f"  {name}: {len(run_hops)} shuffle hops ({two_pass} two-pass), the largest {top[0]} rows x "
                  f"{top[1]} planes x widths {top[2]}; shuffle_gather launches {launches.get('shuffle_gather', 0)}")
        check(launches.get("shuffle_gather", 0) == passes and launches.get("shuffle_plan", 0) == two_pass,
              f"{name}: {len(run_hops)} hops ({two_pass} two-pass) but launches {launches}")
        size = 0 if got is None else 1 if isinstance(got, int) else len(got)
        print(f"  {name}: " + (f"{got}" if size <= 10 else f"{size} rows") + " equals the plaintext oracle")
        results[name] = {
            "query": query,
            "n": rows,
            "fused": fuse,
            "seconds": seconds,
            "peak_bytes": peak,
            "launches": launches,
            "nodes": node_rows(report),
            "hops": [[h[0], h[1], list(h[2])] for h in run_hops],
            "result": got if isinstance(got, int) else size,
        }
        if name.startswith(("dosage_study", "comorbidity")) and rows == n:
            outputs[name] = (out, report)
    return results, outputs


# ---------------------------------------------------------------------------
# 4. timing at the main path's shapes
# ---------------------------------------------------------------------------

def timing_phase(dev, shapes: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.rss_gate import gate, gate_plain

    rng = np.random.default_rng(1)
    out = {}
    gate_lanes = shapes["gate_lanes"]

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

    out.update(time_gather(dev, rng, shapes))
    out.update(time_fused(dev, rng, shapes))
    out.update(time_bitonic(dev, rng, shapes))
    return out


def gather_cost(n: int, planes: int, widths) -> tuple:
    """(bound bytes, one-pass sector bytes) of a hop over ``n`` rows: every
    word read and written once and the int32 index read once; and what a
    one-pass gather moves when each scattered 4-byte read costs a 32-byte
    sector."""
    w = planes * sum(widths)
    return (2 * 4 * w + 4) * n, (32 + 4) * w * n + 4 * n


def time_gather(dev, rng, shapes: dict) -> dict:
    """The hop gather at the largest hop the full-size runs recorded and at
    one one-word column over the largest product join's rows (the shape the
    one-launch-per-column gather was timed at): ``gather_hop`` (its own route), the direct route, the two-pass
    plan alone, the plain gather, and ``torch.index_select`` summed over the
    hop's columns (the library time). Then the measurements behind the size
    rule: both routes over hops of two one-word columns around the L2, and
    the two-pass route's chunk size at the largest hop."""
    import torch

    from repro_torch.kernels.shuffle_gather import (
        gather_direct,
        gather_hop,
        gather_plan,
        gather_two_pass,
        shuffle_gather_plain,
        uses_two_pass,
    )
    from repro_torch.kernels.shuffle_gather.ops import block_rows_for

    hop_n, planes, widths = shapes["hop"]
    rows = []
    for n, ws in sorted({(hop_n, widths), (shapes["join_rows"], (1,))}):
        cols = [words(rng, (planes, n, w), dev) for w in ws]
        index = torch.randperm(n, device=dev)
        want = [shuffle_gather_plain(c, index) for c in cols]
        err = max(max_abs_err(a, b) for route in (gather_hop, gather_direct)
                  for a, b in zip(route(cols, index), want))
        check(err == 0, f"gather_hop N={n} widths={ws} differs from the plain gather")
        del want
        ms = median_ms(lambda: gather_hop(cols, index))
        direct_ms = median_ms(lambda: gather_direct(cols, index))
        plan_ms = median_ms(lambda: gather_plan(index, block_rows_for(n), block_rows_for(n)))
        plain_ms = median_ms(lambda: [shuffle_gather_plain(c, index) for c in cols])
        library_ms = median_ms(lambda: [torch.index_select(c, 1, index) for c in cols])
        bound_bytes, sector_bytes = gather_cost(n, planes, ws)
        bound_ms = 1e3 * bound_bytes / HBM_BYTES_PER_S
        sector_ms = 1e3 * sector_bytes / HBM_BYTES_PER_S
        route = "two-pass" if uses_two_pass(n, max(ws)) else "direct"
        rows.append({"n": n, "planes": planes, "widths": list(ws), "route": route, "bytes": bound_bytes,
                     "ms": ms, "direct_ms": direct_ms, "plan_ms": plan_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                     "one_pass_sector_ms": sector_ms, "max_abs_err": err})
        print(f"  shuffle_gather hop N={n} planes={planes} widths={ws} ({route}): {ms:.4f} ms "
              f"({ms / len(ws):.4f} per column)  direct {direct_ms:.4f} ms  plan {plan_ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  index_select {library_ms:.4f} ms  bound {bound_ms:.4f} ms (bytes), "
              f"{100 * bound_ms / ms:.1f} % of it; one-pass sector cost {sector_ms:.4f} ms")
        if n == hop_n and ws == widths:
            sizes = []
            for chunk_rows, tile_rows in ((32768, 32768), (16384, 32768), (32768, 16384), (16384, 16384)):
                cms = median_ms(lambda: gather_two_pass(cols, index, chunk_rows=chunk_rows, tile_rows=tile_rows))
                sizes.append({"chunk_rows": chunk_rows, "tile_rows": tile_rows, "ms": cms})
                print(f"    two-pass, chunks of {chunk_rows} rows, tiles of {tile_rows}: {cms:.4f} ms")
            rows[-1]["block_sweep"] = sizes
        del cols, index
    sweep = []
    for n in SIZE_RULE_ROWS:
        cols = [words(rng, (3, n, 1), dev) for _ in range(2)]
        index = torch.randperm(n, device=dev)
        direct_ms = median_ms(lambda: gather_direct(cols, index))
        two_ms = median_ms(lambda: gather_two_pass(cols, index))
        library_ms = median_ms(lambda: [torch.index_select(c, 1, index) for c in cols])
        sweep.append({"n": n, "mib": 24 * n / 2**20, "direct_ms": direct_ms, "two_pass_ms": two_ms,
                      "library_ms": library_ms})
        print(f"    size rule: N={n:>8} x 6 words ({24 * n / 2**20:6.1f} MiB, {4 * n / 2**20:4.1f} MiB a plane): "
              f"direct {direct_ms:.4f} ms  "
              f"two-pass {two_ms:.4f} ms  index_select {library_ms:.4f} ms  "
              f"({'two-pass' if uses_two_pass(n, 1) else 'direct'} chosen)")
        del cols, index
    return {"shuffle_gather": rows, "shuffle_gather_size_rule": sweep}


def fused_cost(name: str, n: int, levels: int) -> tuple:
    """(bytes, integer operations) one call must move and do over n lanes
    with ``levels`` Kogge-Stone or fold levels: every input word read once,
    the output written once; operations per share word as the kernel counts
    them (a 3-term AND or product cross term: 3 ANDs / products and 3 XORs /
    sums)."""
    if name == "ks_prefix":  # g, p, 2L alpha words in; g out
        return n * (24 + 24 * levels + 12), n * 3 * 15 * levels
    if name == "and_fold":  # v, L alpha words in; v out
        return n * (12 + 12 * levels + 12), n * 3 * 7 * levels
    if name == "a2b_fused":  # x, 2(1 + 2L) alpha words in; the result out
        return n * (12 + 24 * (1 + 2 * levels) + 12), n * 3 * 2 * (10 + 15 * levels)
    return n * 48, n * 3 * 19  # bit2a_fused: b, 2 alpha words in; the result out


def time_fused(dev, rng, shapes: dict) -> dict:
    """The fused kernels at the shapes the full-size run gave them: the sort's
    32-bit ``lt`` and segment-start ``eq`` over Distinct's rows, the Resize's
    18-bit coin ``a2b`` and 16-bit ``lt_public`` over the rows it trims, and
    COUNT's ``bit2a`` over CountDistinct's rows."""
    from repro_torch.kernels.a2b_fused import a2b_kernel, a2b_plain, bit2a_kernel, bit2a_plain
    from repro_torch.kernels.ks_prefix import (
        and_fold,
        and_fold_plain,
        fold_shifts,
        ks_prefix,
        ks_prefix_plain,
        ks_shifts,
    )

    cases = [
        ("ks_prefix", shapes["sort_rows"], 32), ("ks_prefix", shapes["resize_rows"], 16),
        ("and_fold", shapes["sort_rows"], 32),
        ("a2b_fused", shapes["resize_rows"], 18),
        ("bit2a_fused", shapes["count_rows"], None),
    ]
    out: dict = {}
    for name, n, width in cases:
        if name == "ks_prefix":
            sh = ks_shifts(width)
            args = (words(rng, (3, n), dev), words(rng, (3, n), dev), words(rng, (3, 2 * len(sh), n), dev))
            kernel, plain = (lambda g, p, a, sh=sh: ks_prefix(g, p, a, sh)), (
                lambda g, p, a, sh=sh: ks_prefix_plain(g, p, a, sh))
        elif name == "and_fold":
            sh = fold_shifts(width)
            args = (words(rng, (3, n), dev), words(rng, (3, len(sh), n), dev))
            kernel, plain = (lambda v, a, sh=sh: and_fold(v, a, sh)), (lambda v, a, sh=sh: and_fold_plain(v, a, sh))
        elif name == "a2b_fused":
            sh = ks_shifts(width)
            args = (words(rng, (3, n), dev), words(rng, (3, 2 * (1 + 2 * len(sh)), n), dev))
            kernel, plain = (lambda x, a, sh=sh: a2b_kernel(x, a, sh)), (lambda x, a, sh=sh: a2b_plain(x, a, sh))
        else:
            sh = ()
            args = (words(rng, (3, n), dev), words(rng, (3, 2, n), dev))
            kernel, plain = bit2a_kernel, bit2a_plain
        err = max_abs_err(kernel(*args), plain(*args))
        check(err == 0, f"{name} n={n} width={width} differs from its plain version")
        ms = median_ms(lambda: kernel(*args))
        plain_ms = median_ms(lambda: plain(*args))
        bytes_moved, ops = fused_cost(name, n, len(sh))
        bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
        by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S else "operations"
        out.setdefault(name, []).append({
            "n": n, "width": width, "bytes": bytes_moved, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err, "library_ms": None})
        w = f" width={width}" if width else ""
        print(f"  {name:<12} n={n:>9}{w}: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, "
              f"{bytes_moved / 2**20:.1f} MiB), {100 * bound_ms / ms:.1f} % of the bound")
        del args
    return out


def time_bitonic(dev, rng, shapes: dict) -> dict:
    """``bitonic_swap`` at the largest sort stage of the run: the sort's rows
    and the columns of its network (a narrowed network carries the key and
    the row index). Beside it, its plain version and the gate-by-gate route
    it replaces at the same shape: ``own ^ other``, the mask broadcast to a
    contiguous (3, C, N), ``rss_gate``, and ``own ^ d``."""
    from repro_torch.kernels.bitonic_stage import stage_swap, stage_swap_plain
    from repro_torch.kernels.rss_gate import gate

    n, c = shapes["sort_rows"], shapes["sort_cols"]
    mask = words(rng, (3, n), dev)
    own, other, alpha = (words(rng, (3, c, n), dev) for _ in range(3))
    args = (mask, own, other, alpha)

    def replaced():
        m3 = mask[:, None, :].expand(own.shape).contiguous()
        return own ^ gate(m3, own ^ other, alpha, True)

    err = max(max_abs_err(stage_swap(*args), stage_swap_plain(*args)), max_abs_err(replaced(), stage_swap_plain(*args)))
    check(err == 0, f"bitonic_swap N={n} C={c} differs from its plain version or the route it replaces")
    ms = median_ms(lambda: stage_swap(*args))
    plain_ms = median_ms(lambda: stage_swap_plain(*args))
    replaced_ms = median_ms(replaced)
    bytes_moved = 4 * (3 * n + 4 * 3 * c * n)  # mask, own, other, alpha read; out written
    ops = 3 * c * n * 8  # per column word: 1 XOR for d, 3 ANDs, 3 XORs, 1 XOR into own
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
    by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S else "operations"
    print(f"  bitonic_swap N={n:>9} C={c}: {ms:.4f} ms  plain {plain_ms:.4f} ms  replaced route "
          f"{replaced_ms:.4f} ms  bound {bound_ms:.4f} ms ({by}, {bytes_moved / 2**20:.1f} MiB), "
          f"{100 * bound_ms / ms:.1f} % of the bound")
    return {"bitonic_swap": [{
        "n": n, "c": c, "bytes": bytes_moved, "ms": ms, "plain_ms": plain_ms, "replaced_route_ms": replaced_ms,
        "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err, "library_ms": None}]}


# ---------------------------------------------------------------------------
# 5. (--profile) device-time breakdown of the two heaviest operators
# ---------------------------------------------------------------------------

def _kernel_category(name: str) -> str:
    low = name.lower()
    for kernel in ("rss_gate", "shuffle_gather", "ks_prefix", "and_fold", "a2b", "bit2a", "bitonic_swap"):
        if kernel in low:
            return f"{kernel} kernel"
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


def profile_phase(dev, distinct_rows: int, hop: tuple) -> dict:
    import numpy as np
    import torch

    from repro_torch.core import threefry
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.sharing import BShare
    from repro_torch.core.sort import _stage
    from repro_torch.kernels import override_fusion
    from repro_torch.kernels.shuffle_gather import gather_hop
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
    # the largest shuffle hop of the full-size runs
    cols = [words(rng, (hop[1], hop[0], w), dev) for w in hop[2]]
    index = torch.randperm(hop[0], device=dev)

    def stage(fuse: bool):
        with override_fusion(fuse):
            _stage(net, ["__sk"], 4, 2, prf, False)

    return {
        "distinct_stage_fused": _profile_window(
            f"one bitonic stage, {distinct_rows} rows, fused", lambda: stage(True)),
        "distinct_stage_gates": _profile_window(
            f"one bitonic stage, {distinct_rows} rows, gate by gate", lambda: stage(False)),
        "join_tile": _profile_window(
            "one join tile, 65536 product rows, fused",
            lambda: oblivious_join(left, right, ("pid", "pid"), prf)),
        "gather_hop": _profile_window(
            f"one shuffle hop, {hop[0]} rows x {hop[1]} planes x widths {hop[2]}",
            lambda: gather_hop(cols, index)),
    }


def largest_shapes(full: dict) -> dict:
    """The largest shapes the full-size runs gave the kernels: the rows of a
    bitonic sort (Distinct's power-of-two rows; CountDistinct pads its input
    to them), of a Resize's input, of a product join, and of COUNT's bit2a
    (the CountDistinct's sort rows); and Distinct's rows alone, the stage
    that ``--profile`` traces."""
    def pow2(k: int) -> int:
        return 1 << max(k - 1, 0).bit_length()

    sort_rows = join_rows = resize_rows = count_rows = distinct_rows = 1
    hop = (1, 3, (1,))
    for res in full.values():
        for n, planes, widths in res["hops"]:
            if n * planes * sum(widths) > hop[0] * hop[1] * sum(hop[2]):
                hop = (n, planes, tuple(widths))
        for node in res["nodes"]:
            name, n_in = node["node"], node["n_ins"][0] if node["n_ins"] else 0
            if name.startswith("Distinct"):
                distinct_rows = max(distinct_rows, node["n_out"])
                sort_rows = max(sort_rows, node["n_out"])
            if name.startswith(("CountDistinct", "GroupBy", "OrderBy", "Min", "Max")):
                sort_rows = max(sort_rows, pow2(n_in))
            if name.startswith("CountDistinct"):
                count_rows = max(count_rows, pow2(n_in))
            if name.startswith("Join"):
                join_rows = max(join_rows, node["n_out"])
            if name.startswith("Resize"):
                resize_rows = max(resize_rows, n_in)
    # the largest sort is a Distinct's (three_join's CountDistinct): its
    # narrowed network carries two columns, the key and the row index, and
    # rss_gate's largest call is the gate-by-gate select over them
    return {"gate_lanes": 2 * sort_rows, "sort_rows": sort_rows, "sort_cols": 2, "join_rows": join_rows,
            "resize_rows": resize_rows, "count_rows": count_rows, "distinct_rows": distinct_rows, "hop": hop}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one Distinct stage, one join tile and the largest shuffle hop "
                         "with torch.profiler")
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

    print(f"[3] full size: n={ROWS_PER_TABLE} rows per table (three_join: n={THREE_JOIN_ROWS}; "
          f"comorbidity also at n={BIG_ROWS})")
    full = full_phase(dev, ROWS_PER_TABLE, THREE_JOIN_ROWS, BIG_ROWS)

    gathers = sum(r["launches"].get("shuffle_gather", 0) for r in full.values())
    plans = sum(r["launches"].get("shuffle_plan", 0) for r in full.values())
    hops = sum(len(r["hops"]) for r in full.values())
    per_column = sum(len(h[2]) for r in full.values() for h in r["hops"])
    print(f"  shuffle_gather launches over the {len(full)} full-size runs: {gathers} for {hops} hops, {plans} of "
          f"them two-pass (shuffle_plan launches); one launch per column per hop would be {per_column}")
    shapes = largest_shapes(full)
    print(f"[4] kernel timing at the run's shapes {shapes}")
    timing = timing_phase(dev, shapes)

    profiled = None
    if args.profile:
        print("[5] device-time breakdown (torch.profiler)")
        profiled = profile_phase(dev, shapes["distinct_rows"], shapes["hop"])

    launches = {k: sum(r["launches"].get(k, 0) for r in full.values()) for k in KERNELS}
    summary = {"kernels": []}
    for name, (source, tpu) in KERNELS.items():
        rows = timing[name]
        # the row of the largest call: most lanes (rss_gate: arithmetic last),
        # or most bytes for the fused kernels
        top = max(rows, key=lambda r: (r.get("bytes", 0), r["n"], r.get("boolean", False)))
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu, "launches": launches[name],
            "max_abs_err": max(errs[name], *(r["max_abs_err"] for r in rows)),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top.get("library_ms"),
        })
    total_s = time.perf_counter() - t_all
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "n": ROWS_PER_TABLE, "three_join_n": THREE_JOIN_ROWS, "big_n": BIG_ROWS, "build_s": build_s, "total_s": total_s, "full": full,
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
