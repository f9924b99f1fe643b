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
2. cross-device: the quickstart plan, ``comorbidity``, ``diag_breakdown``,
   and ``dosage_study`` and ``three_join`` compiled from SQL by the port's
   ``compile_query`` with the sort-merge join forced (n=48, over a catalog
   that declares each table's pid bound) on the default fused path on
   ``cuda`` and on ``cpu`` give identical output shares, per-node (rounds,
   bytes/party) and Resize sizes S, and on ``cuda`` the gate-by-gate path
   (``fuse_circuits=False``) gives the same again;
3. full size over ``generate_healthlnk(n)`` with Beta(2,6) Resizers on every
   internal operator: ``aspirin_count`` (theta join, COUNT(DISTINCT)) on the
   fused path, ``dosage_study`` and ``comorbidity`` (GroupBy, then ORDER BY
   DESC LIMIT 10) on the fused and on the gate-by-gate path (identical
   shares, ledgers and S), the quickstart plan, the ten dialect goldens
   (Project, SUM, AVG, MIN, MAX, OR, composite-key GroupBy, GroupBy SUM and
   AVG, HAVING), ``three_join`` at a reduced n (its later product joins grow
   as n^3 and n^4), ``comorbidity`` once more over a 1,048,576-row
   diagnoses table, and ``dosage_study``, ``aspirin_count`` and
   ``three_join`` (uncut) compiled from SQL with the sort-merge join forced.
   Launch counts are reset before each run and read after it; every kernel
   of that run's path must have launched, the gather once per shuffle hop
   (twice, after its plan, on a two-pass hop), and every answer must equal
   the plaintext oracle (the sort-merge ``dosage_study`` and
   ``aspirin_count`` also their product runs'). Per-node seconds, S, peak
   memory, launch counts, each run's shuffle hops (rows, planes, column
   widths) and each sort-merge join's fanout, build side and union rows are
   printed, and which algorithm ``join_algo="auto"`` picks for each join of
   the three. Then the SQL front end's ``--check`` runs in-process on
   ``cuda``: the fourteen goldens compile to their hand plans, the ten
   dialect goldens execute to the oracle's answers, and the sort-merge
   ``dosage_study`` equals the product run and the oracle;
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
   shuffle hop;
6. batched execution: ``Engine.execute_batch`` of K = 4 copies of the
   sort-merge ``dosage_study`` (n rows per table, Beta(2,6) Resizers,
   ``bucket_fn`` the next power of two), each slot against a serial
   ``execute`` of one engine with the same key: stacked and split node
   counts, every slot's shares, per-node ledger, S and rows identical to
   its serial run and its rows the oracle's, each kernel's launches in the
   batch (its Resize nodes, which run per slot, apart) against one serial
   run's, the batch's seconds against the serial runs' and peak memory;
   the same with ``RevealNoise`` Resizers (S = T in every slot, so the
   slots stay stacked through the join and the Distinct and every kernel
   runs stacked); then a K = 3 batch of the n=48 quickstart plan on
   ``cuda`` and ``cpu`` (identical);
7. tracing: one full-size sort-merge ``dosage_study`` under an
   ``obs.Tracer``: the span count, every span through
   ``redact.assert_emittable``, the ``node[...]`` spans' seconds summing to
   the report's total, and ``ExecutionReport.from_dict(to_dict())``;
8. the service: ``AnalyticsService`` over the same n rows per table and
   the catalog of phase 3's sort-merge runs, with its defaults (Shrinkwrap's
   TLap noise, parallel addition, cost-based placement, the escalating
   accountant), the offline pool on and durable state in a temporary
   directory. Three tenants submit ``dosage_study``, ``aspirin_count`` and
   ``comorbidity``, then ``dosage_study`` with another literal (a plan
   cache rebind) and once more; each answer equals the oracle and each
   submit a pool-off service's with the same key (shares, per-node ledger,
   S, rows), with seconds, pool hits, misses and bytes per submit and the
   plan cache's hits, misses and rebinds; the first submit's per-kernel
   launches equal ``Engine.execute`` of its plan; four tenants enqueue
   ``comorbidity`` and one drain runs them stacked, each slot equal to the
   serial submit of a fresh service; a refusing accountant runs out of
   budget, refuses with ``BudgetRefused``, and a service restarted over the
   same state directory has the same counts and refuses too (each
   signature's budget, observed count and ``crt_rounds``); then the
   service at n=48 gives identical results on ``cuda`` and ``cpu``.

The kernels line's launches sum phases 3, 6 and 8. The lines before the
last are the ``{"kernels": [...]}`` summary and the
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
    # the sort-merge join at fanout > 1: the union sort (bitonic_swap), the
    # rank (bit2a_fused, a2b_fused) and the payload's gather (shuffle_gather)
    "sortmerge": _RESIZED + ("bit2a_fused", "bitonic_swap"),
}
# the goldens with joins that phases 2 and 3 also compile from SQL with the
# sort-merge join forced
SORTMERGE_GOLDENS = ("dosage_study", "aspirin_count", "three_join")
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


def sortmerge_plan(query: str, tables: dict, plain: dict, join_algo: str = "sortmerge", noise=None):
    """``query`` compiled from its SQL by the port's ``compile_query`` with
    Resizers (``noise``, default Beta(2,6)) on every internal operator, over
    a catalog that declares each table's observed pid bound (the sort-merge
    join needs a declared bound on its build side's key)."""
    import numpy as np

    from repro_torch.core.noise import BetaNoise
    from repro_torch.data import QUERY_SQL
    from repro_torch.sql import Catalog, compile_query

    mult = {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}
    catalog = Catalog.from_tables(tables, multiplicity=mult)
    return compile_query(QUERY_SQL[query], catalog, placement="all_internal", noise=noise or BetaNoise(2, 6),
                         join_algo=join_algo)


def post_order(plan):
    """The plan's nodes in the order the engine reports them."""
    for c in plan.children():
        yield from post_order(c)
    yield plan


def join_rows(plan, report) -> list:
    """Each join of an executed plan: its algorithm, rows in and out, and for
    a sort-merge join its fanout, build side and union rows."""
    from repro_torch.plan import Join, JoinSortMerge

    rows = []
    for node, stats in zip(post_order(plan), report.nodes):
        if not isinstance(node, Join):
            continue
        row = {"algo": "sortmerge" if isinstance(node, JoinSortMerge) else "product", "n_ins": stats.n_ins,
               "n_out": stats.n_out, "seconds": stats.seconds}
        if isinstance(node, JoinSortMerge):
            union = 1 << max(sum(stats.n_ins) - 1, 0).bit_length()
            row.update(fanout=node.fanout, build=node.build, union_rows=union)
        rows.append(row)
    return rows


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
    each path (``query`` names its entry in ``PATH_KERNELS``). Returns the
    cuda fused run's (output, report)."""
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

    # compiled from SQL with the sort-merge join forced
    tables = generate_healthlnk(n=n, seed=0, device="cpu")[0]
    for query in ("dosage_study", "three_join"):
        plan = sortmerge_plan(query, tables, plain)
        out, report = three_ways(dev, f"{query} sort-merge n={n}",
                                 lambda d: generate_healthlnk(n=n, seed=0, device=d)[0], plan, 47, "sortmerge")
        got = revealed_answer(query, plan, out)
        check(got == plaintext_oracle(query, plain), f"{query} sort-merge n={n}: {got} differs from the oracle")
        joins = [(j["fanout"], j["build"], j["union_rows"]) for j in join_rows(plan, report)]
        sizes = [s.extra["s"] for s in report.nodes if "s" in s.extra]
        print(f"  {query} sort-merge n={n}: joins (fanout, build, union rows) {joins}; shares, ledgers and "
              f"S={sizes} identical on cuda and cpu (fused) and on cuda gate by gate; {got} equals the oracle")


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
    import repro_torch.ops.join_sortmerge as jsm
    from repro_torch.data import all_query_plans, generate_healthlnk

    data = {}
    for rows in (n, three_join_n, big_n):
        t0 = time.perf_counter()
        data[rows] = generate_healthlnk(n=rows, seed=0, device=dev)
        torch.cuda.synchronize()
        print(f"  generate_healthlnk(n={rows}): {time.perf_counter() - t0:.3f} s (set-up)")
    d, m = data[n][1]["diagnoses"], data[n][1]["medications"]
    quickstart_rows = sorted(int(p) for p in np.intersect1d(d["pid"][d["icd9"] == 414], m["pid"][m["med"] == 1]))
    plans = {name: with_resizers(plan) for name, plan in all_query_plans().items()}
    # name -> (golden, plan with its Resizers, rows per table, engine key,
    # fused, expected answer, PATH_KERNELS entry); the quickstart plan
    # answers in dosage_study's form
    runs = {
        "aspirin_count": ("aspirin_count", plans["aspirin_count"], n, 44, True, None, "aspirin_count"),
        "dosage_study": ("dosage_study", plans["dosage_study"], n, 42, True, None, "dosage_study"),
        "dosage_study gates": ("dosage_study", plans["dosage_study"], n, 42, False, None, "dosage_study"),
        "quickstart": ("dosage_study", with_resizers(quickstart_plan("pid")), n, 43, True, quickstart_rows,
                       "dosage_study"),
        "comorbidity gates": ("comorbidity", plans["comorbidity"], n, 46, False, None, "comorbidity"),
    }
    for i, query in enumerate(NEW_GOLDENS):
        runs[query] = (query, plans[query], n, 46 + i, True, None, query)
    runs["three_join"] = ("three_join", plans["three_join"], three_join_n, 45, True, None, "three_join")
    runs[f"comorbidity n={big_n}"] = ("comorbidity", plans["comorbidity"], big_n, 46, True, None, "comorbidity")
    # compiled from SQL with the sort-merge join forced, three_join uncut
    for query, key in zip(SORTMERGE_GOLDENS, (42, 44, 45)):
        runs[f"{query} sort-merge"] = (query, sortmerge_plan(query, *data[n]), n, key, True, None, "sortmerge")

    hops: list = []
    gather_hop = shuffle.gather_hop

    def recorded_hop(cols, index):
        hops.append((index.shape[0], cols[0].shape[0], tuple(c.shape[2] for c in cols)))
        return gather_hop(cols, index)

    # each sort-merge join's union sort and payload gather, timed in place
    phases: list = []
    sort, gather = jsm.bitonic_sort, jsm.apply_secret_perm

    def timed(fn, part: str):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            if part == "sort_s":
                phases.append({})
            phases[-1][part] = time.perf_counter() - t0
            return out

        return run

    shuffle.gather_hop = recorded_hop
    jsm.bitonic_sort, jsm.apply_secret_perm = timed(sort, "sort_s"), timed(gather, "gather_s")
    try:
        results, outputs, answers = _full_runs(dev, runs, data, hops, phases, n)
    finally:
        shuffle.gather_hop = gather_hop
        jsm.bitonic_sort, jsm.apply_secret_perm = sort, gather
    for query in ("dosage_study", "comorbidity"):
        (fout, frep), (gout, grep) = outputs[query], outputs[f"{query} gates"]
        check(ledger_rows(frep) == ledger_rows(grep), f"{query}: fused and gate-by-gate ledgers or S differ")
        check(same_outputs(fout, gout), f"{query}: fused and gate-by-gate output shares differ")
        print(f"  {query}: output shares, per-node ledger and every S identical fused and gate by gate")
    for query in ("dosage_study", "aspirin_count"):
        check(answers[f"{query} sort-merge"] == answers[query],
              f"{query}: the sort-merge run's answer differs from the product run's")
        print(f"  {query}: the sort-merge run's answer equals the product run's and the oracle")
    for query in SORTMERGE_GOLDENS:
        plan = sortmerge_plan(query, *data[n], join_algo="auto")
        auto = [(type(j).__name__, getattr(j, "fanout", None), getattr(j, "build", None))
                for j in post_order(plan) if type(j).__name__.startswith("Join")]
        print(f"  {query}: join_algo=auto picks {auto} at n={n} with the declared pid bounds")
    return results


def _full_runs(dev, runs: dict, data: dict, hops: list, phases: list, n: int) -> tuple:
    """Each run of ``full_phase``, with ``hops`` filled by the recording
    ``gather_hop`` and ``phases`` by the timed union sort and payload gather
    of each sort-merge join; returns the results, the outputs of the runs compared
    fused and gate by gate, and every run's answer."""
    import torch

    from repro_torch import RuntimeConfig
    from repro_torch.core import threefry
    from repro_torch.data import plaintext_oracle, revealed_answer
    from repro_torch.engine import Engine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.shuffle_gather import uses_two_pass

    results, outputs, answers = {}, {}, {}
    for name, (query, placed, rows, key, fuse, want, path) in runs.items():
        if want is None:
            want = plaintext_oracle(query, data[rows][1])
        engine = Engine(data[rows][0], key=threefry.PRNGKey(key), config=RuntimeConfig(fuse_circuits=fuse),
                        device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        hops.clear()
        phases.clear()
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
        answers[name] = got
        check_launches(name, launches, path, fuse)
        joins = join_rows(placed, report)
        for j, times in zip([j for j in joins if j["algo"] == "sortmerge"], phases):
            j.update(times)
            print(f"    sort-merge join {'x'.join(map(str, j['n_ins']))} -> union {j['union_rows']} rows, "
                  f"fanout {j['fanout']}, build {j['build']}: {j['n_out']} rows in {j['seconds']:.3f} s "
                  f"(union sort {j['sort_s']:.3f} s, payload gather {j['gather_s']:.3f} s, the rest "
                  f"{j['seconds'] - j['sort_s'] - j['gather_s']:.3f} s)")
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
            "joins": joins,
            "result": got if isinstance(got, int) else size,
        }
        if name in ("dosage_study", "dosage_study gates", "comorbidity", "comorbidity gates"):
            outputs[name] = (out, report)
    return results, outputs, answers


# ---------------------------------------------------------------------------
# 6. batched execution
# ---------------------------------------------------------------------------

BATCH_SLOTS = 4


def pow2(s: int) -> int:
    """The batch's bucket_fn: the next power of two."""
    return 1 << max(s - 1, 0).bit_length()


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counting_engine():
    """An Engine that also counts each node's kernel launches, keyed by the
    node: a serial run's nodes and a batch's per-slot nodes (Resize, and
    the nodes after a split) go through ``_run_node_slot``, a batch's
    stacked nodes through ``_run_batch_stacked``."""
    from collections import Counter, defaultdict

    from repro_torch.engine import Engine
    from repro_torch.kernels import launch_counts

    def delta(before):
        after = launch_counts()
        return Counter({k: after.get(k, 0) - before.get(k, 0) for k in after if after.get(k, 0) > before.get(k, 0)})

    class CountingEngine(Engine):
        def _run_node_slot(self, node, children):
            before = launch_counts()
            out = super()._run_node_slot(node, children)
            self.per_slot[id(node)].update(delta(before))
            return out

        def _run_batch_stacked(self, node, children, ctx):
            before = launch_counts()
            out = super()._run_batch_stacked(node, children, ctx)
            self.stacked[id(node)].update(delta(before))
            return out

    def make(*args, **kwargs):
        eng = CountingEngine(*args, **kwargs)
        eng.per_slot, eng.stacked = defaultdict(Counter), defaultdict(Counter)
        return eng

    return make


def batch_phase(dev, n: int, k: int = BATCH_SLOTS, noise=None) -> dict:
    """``execute_batch`` of K copies of the sort-merge ``dosage_study``
    (n rows per table, Resizers with ``noise`` on every internal operator,
    default Beta(2,6); bucket_fn = next power of two) against K serial
    ``execute`` runs of one engine with the same key: every slot identical
    to its serial run, each stacked node launching each kernel no more
    often than the same node of one serial run (per-slot nodes, Resize and
    any after a split, launch once per slot), every kernel of the path
    launched, and the answers the oracle's. The launch counts are set to 0
    just before the batch and read just after."""
    from collections import Counter

    import torch

    from repro_torch.core import threefry
    from repro_torch.data import generate_healthlnk, plaintext_oracle, revealed_answer
    from repro_torch.kernels import launch_counts, reset_launch_counts

    tables, plain = generate_healthlnk(n=n, seed=0, device=dev)
    plan = sortmerge_plan("dosage_study", tables, plain, noise=noise)
    want = plaintext_oracle("dosage_study", plain)
    engine = _counting_engine()

    serial, serial_s, serial_launches, first = [], [], [], None
    eng = engine(tables, key=threefry.PRNGKey(42), bucket_fn=pow2, device=dev)
    for i in range(k):
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        serial.append(eng.execute(plan))
        _sync(dev)
        serial_s.append(time.perf_counter() - t0)
        serial_launches.append(launch_counts())
        if i == 0:
            first = {node: Counter(c) for node, c in eng.per_slot.items()}  # one serial run, by node

    beng = engine(tables, key=threefry.PRNGKey(42), bucket_fn=pow2, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    slots = beng.execute_batch([plan] * k)
    _sync(dev)
    batch_s = time.perf_counter() - t0
    launches = launch_counts()
    reset_launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stats = dict(beng.last_batch_stats)

    check(stats["stacked_nodes"] > 0, f"batch: no node ran stacked ({stats})")
    for i, ((bout, brep), (sout, srep)) in enumerate(zip(slots, serial)):
        check(ledger_rows(brep) == ledger_rows(srep), f"batch slot {i}: per-node ledger or S differs from serial")
        check([s.extra for s in brep.nodes] == [s.extra for s in srep.nodes],
              f"batch slot {i}: Resize info (S, p) differs from its serial run")
        check(same_outputs(bout, sout), f"batch slot {i}: output shares differ from its serial run")
        got = revealed_answer("dosage_study", plan, bout)
        check(got == want, f"batch slot {i}: {got} differs from the oracle {want}")
    sizes = [[s.extra["s"] for s in rep.nodes if "s" in s.extra] for _, rep in slots]
    stacked_names = [node.describe() for node in post_order(plan) if id(node) in beng.stacked]
    label = "Beta(2,6)" if noise is None else type(noise).__name__
    print(f"  dosage_study sort-merge, {label} Resizers, K={k} slots at n={n}: {stats['stacked_nodes']} stacked nodes "
          f"{stacked_names} and {stats['split_nodes']} split nodes; every slot's shares, per-node ledger, S and "
          f"rows identical to its serial run; S per slot {sizes}; {len(want)} rows equal the oracle in every slot")
    stacked_serial = Counter()
    for node in beng.stacked:
        stacked_serial.update(first.get(node, Counter()))
    stacked_batch = sum(beng.stacked.values(), Counter())
    per_slot_batch = sum(beng.per_slot.values(), Counter())
    rows = {}
    for kind in KERNELS:
        rows[kind] = {"batch": launches.get(kind, 0), "serial": serial_launches[0].get(kind, 0),
                      "stacked_batch": stacked_batch.get(kind, 0), "stacked_serial": stacked_serial.get(kind, 0),
                      "per_slot_batch": per_slot_batch.get(kind, 0)}
        r = rows[kind]
        print(f"    {kind:14s} batch {r['batch']:6d}, one serial run {r['serial']:6d}; the stacked nodes: batch "
              f"{r['stacked_batch']:6d}, the same nodes of one serial run {r['stacked_serial']:6d}; per-slot nodes "
              f"(Resize, split) {r['per_slot_batch']:6d} for {k} slots")
    if dev.type == "cuda":
        for node in beng.stacked:
            for kind, c in beng.stacked[node].items():
                check(c <= first[node].get(kind, 0),
                      f"batch: a stacked node launched {kind} {c} times, the same node of one serial run "
                      f"{first[node].get(kind, 0)}")
        check_launches("batch", launches, "sortmerge", True)
    card = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    print(f"  batch {batch_s:.3f} s against {sum(serial_s):.3f} s for the {k} serial runs "
          f"({', '.join(f'{x:.3f}' for x in serial_s)}); peak {peak / 2**30:.2f} GiB; {card}")
    return {"noise": label, "n": n, "slots": k, "stats": stats, "stacked": stacked_names, "batch_s": batch_s,
            "serial_s": serial_s, "peak_bytes": peak, "launches": launches, "kernels": rows, "sizes": sizes}


def batch_cross_device(dev, k: int = 3) -> None:
    """A K=3 batch of the n=48 quickstart plan on ``dev`` and on ``cpu``:
    identical shares, ledgers, S and batch stats."""
    import numpy as np
    import torch

    from repro_torch.core import threefry
    from repro_torch.engine import Engine
    from repro_torch.ops import SecretTable

    rng = np.random.default_rng(7)
    patients = {"pid": rng.integers(0, 12, 48).astype(np.uint32),
                "icd9": rng.choice([390, 401, 414], 48).astype(np.uint32)}
    meds = {"pid2": rng.integers(0, 12, 48).astype(np.uint32), "med": rng.choice([1, 2, 3], 48).astype(np.uint32)}
    plan = with_resizers(quickstart_plan("pid2"))
    runs = {}
    for d in (dev, torch.device("cpu")):
        tables = {"diagnoses": SecretTable.from_plaintext(patients, threefry.PRNGKey(0), device=d),
                  "medications": SecretTable.from_plaintext(meds, threefry.PRNGKey(1), device=d)}
        eng = Engine(tables, key=threefry.PRNGKey(42), bucket_fn=pow2, device=d)
        runs[d.type] = (eng.execute_batch([plan] * k), dict(eng.last_batch_stats))
    (a, astats), (b, bstats) = runs[dev.type], runs["cpu"]
    check(astats == bstats, f"quickstart batch: stats differ between {dev.type} and cpu ({astats}, {bstats})")
    for i, ((ao, ar), (bo, br)) in enumerate(zip(a, b)):
        check(ledger_rows(ar) == ledger_rows(br), f"quickstart batch slot {i}: ledgers or S differ from cpu")
        check(same_outputs(ao, bo), f"quickstart batch slot {i}: output shares differ from cpu")
    print(f"  quickstart n=48, K={k}: every slot's shares, ledgers and S identical on {dev.type} and cpu "
          f"({astats['stacked_nodes']} stacked, {astats['split_nodes']} split nodes)")


# ---------------------------------------------------------------------------
# 7. tracing
# ---------------------------------------------------------------------------

def tracing_phase(dev, n: int) -> dict:
    """One full-size sort-merge ``dosage_study`` under a ``Tracer``: every
    span passes the disclosure audit, the ``node[...]`` spans' seconds sum
    to the report's total, and the report survives ``to_dict`` /
    ``from_dict``."""
    from repro_torch.core import threefry
    from repro_torch.data import generate_healthlnk
    from repro_torch.engine import Engine
    from repro_torch.engine.executor import ExecutionReport
    from repro_torch.obs import Tracer, redact

    tables, plain = generate_healthlnk(n=n, seed=0, device=dev)
    plan = sortmerge_plan("dosage_study", tables, plain)
    engine = Engine(tables, key=threefry.PRNGKey(42), device=dev)
    tracer = Tracer()
    with tracer:
        _, report = engine.execute(plan)
    spans = tracer.spans
    nodes = [s for s in spans if s.name.startswith("node[")]
    for s in spans:
        redact.assert_emittable(s.attrs)
    span_s = sum(s.seconds for s in nodes)
    check(len(nodes) == len(report.nodes), f"tracing: {len(nodes)} node spans for {len(report.nodes)} nodes")
    check(abs(span_s - report.total_seconds) <= 1e-9 * max(1.0, report.total_seconds),
          f"tracing: node spans sum to {span_s} s, the report to {report.total_seconds} s")
    d = report.to_dict()
    check(ExecutionReport.from_dict(d).to_dict() == d, "tracing: ExecutionReport.from_dict(to_dict()) differs")
    print(f"  dosage_study sort-merge n={n} under a Tracer: {len(spans)} spans ({len(nodes)} node spans) pass the "
          f"disclosure audit; node spans sum to {span_s:.6f} s = the report's total; to_dict/from_dict round-trips; "
          f"redacted keys {sorted(set(tracer.redactions))}")
    return {"spans": len(spans), "node_spans": len(nodes), "node_seconds": span_s,
            "report_seconds": report.total_seconds, "redacted": sorted(set(tracer.redactions))}


# ---------------------------------------------------------------------------
# 8. the multi-tenant service
# ---------------------------------------------------------------------------

# the offline pool's byte budget in phase 8: the dosage_study template's
# static material and eight counters' Resize material fit in it with room
SERVICE_POOL_BYTES = 256 << 20
# the refusing accountant's error margin: Eq. 1 over err^2 = 64 gives the
# default noise a budget of four observations of one subplan
REFUSE_ERR = 8.0
BUDGET_SQL = "SELECT COUNT(*) FROM medications WHERE med = 1"


def dosage_oracle(plain: dict, icd9: int) -> list:
    """dosage_study's answer with ``d.icd9 = icd9``."""
    import numpy as np

    d, m = plain["diagnoses"], plain["medications"]
    mp = m["pid"][(m["med"] == 1) & (m["dosage"] == 325)]
    return [int(p) for p in np.intersect1d(d["pid"][d["icd9"] == icd9], mp)]


def _service(dev, tables, catalog, state_dir, offline: str, **kw):
    """The service with its defaults (Shrinkwrap's TLap noise, parallel
    addition, cost-based placement, the escalating accountant), one key."""
    from repro_torch.core import threefry
    from repro_torch.service import AnalyticsService

    return AnalyticsService(tables, catalog=catalog, key=threefry.PRNGKey(42), offline=offline, state_dir=state_dir,
                            offline_pool_bytes=SERVICE_POOL_BYTES, device=dev, **kw)


def _submit(dev, svc, tenant: str, sql: str):
    """One submit with the launch counts set to 0 just before it and read
    just after: (result, seconds, launches)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    _sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = svc.session(tenant).submit(sql)
    _sync(dev)
    dt = time.perf_counter() - t0
    launches = launch_counts()
    reset_launch_counts()
    return res, dt, launches


def _same_result(a, b) -> bool:
    """Two QueryResults: the same output shares, per-node ledger and S, rows."""
    import numpy as np

    return (same_outputs(a.table, b.table) and ledger_rows(a.report) == ledger_rows(b.report)
            and a.rows.keys() == b.rows.keys() and all(np.array_equal(a.rows[k], b.rows[k]) for k in a.rows))


def _add(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def service_phase(dev, n: int) -> dict:
    """``AnalyticsService`` over ``generate_healthlnk(n)`` under the catalog
    that declares each table's pid bound, with the offline pool on and
    durable state in a temporary directory:

    * three tenants submit ``dosage_study``, ``aspirin_count`` and
      ``comorbidity``, then ``dosage_study`` with another literal (a plan
      cache rebind) and once more (a hit): every answer the oracle's; after
      the first submit the scheduler's idle window refills the pool, so the
      later runs of the template hit it; a second service with the pool off
      and the same key gives the same shares, per-node ledger, S and rows
      for every submit;
    * the first submit's per-kernel launches equal ``Engine.execute`` of the
      same plan on a fresh engine with the same key;
    * four tenants ``enqueue`` ``comorbidity`` (no Resize under the
      service's placement, so its slots stay stacked end to end) and
      ``drain`` runs one stacked pass; each slot equals the serial submit
      of a service with the same key;
    * a refusing accountant (err = 8: a budget of a few observations; a
      Resizer on every internal operator) refuses with ``BudgetRefused``
      once the budget is spent, and a new service over the same state
      directory has the same counts and refuses too.

    Launches of every submit and of the batch are summed for the kernels
    line; every kernel must have launched."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.crt import crt_rounds
    from repro_torch.core import threefry
    from repro_torch.data import QUERY_SQL, generate_healthlnk, plaintext_oracle, revealed_answer
    from repro_torch.engine import Engine
    from repro_torch.errors import BudgetRefused
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.service import PrivacyAccountant
    from repro_torch.sql import Catalog

    tables, plain = generate_healthlnk(n=n, seed=0, device=dev)
    mult = {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}
    catalog = Catalog.from_tables(tables, multiplicity=mult)
    dosage = QUERY_SQL["dosage_study"]
    check(dosage_oracle(plain, 390) == plaintext_oracle("dosage_study", plain), "service: the rebind oracle is wrong")
    sequence = [("alice", "dosage_study", dosage, 390), ("bob", "aspirin_count", QUERY_SQL["aspirin_count"], None),
                ("carol", "comorbidity", QUERY_SQL["comorbidity"], None),
                ("alice", "dosage_study", dosage.replace("390", "414"), 414), ("dave", "dosage_study", dosage, 390)]
    totals: dict = {}
    out: dict = {"n": n, "pool_limit_bytes": SERVICE_POOL_BYTES, "runs": []}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        on = _service(dev, tables, catalog, f"{tmp}/on", "on")
        off = _service(dev, tables, catalog, f"{tmp}/off", "off")
        for i, (tenant, query, sql, icd9) in enumerate(sequence):
            p0 = on.pool.stats()
            res, dt, launches = _submit(dev, on, tenant, sql)
            p1 = on.pool.stats()
            ref, dt_off, launches_off = _submit(dev, off, tenant, sql)
            _add(totals, launches)
            want = dosage_oracle(plain, icd9) if icd9 is not None else plaintext_oracle(query, plain)
            got = revealed_answer(query, res.plan, res.table)
            check(got == want, f"service {tenant} {query}: {got} differs from the oracle {want}")
            check(_same_result(res, ref), f"service {tenant} {query}: pool on and off differ")
            if dev.type == "cuda":
                check(launches == launches_off, f"service {tenant} {query}: launches differ with the pool off")
            run = {"tenant": tenant, "query": query, "sql": sql, "seconds": dt, "seconds_off": dt_off,
                   "hits": p1["hits"] - p0["hits"], "misses": p1["misses"] - p0["misses"],
                   "pool_bytes": p1["depth_bytes"], "cache_hit": res.cache_hit, "launches": launches,
                   "s": [s.extra["s"] for s in res.report.nodes if "s" in s.extra], "nodes": node_rows(res.report)}
            out["runs"].append(run)
            top = max(res.report.nodes, key=lambda s: s.seconds)
            label = f"{query} (icd9 {icd9})" if icd9 else query
            print(f"  {tenant:5s} {label}: {dt:.3f} s (pool off {dt_off:.3f} s; heaviest node {top.node} "
                  f"{top.seconds:.3f} s, rows in {top.n_ins}), pool hits {run['hits']} misses "
                  f"{run['misses']}, pool "
                  f"{run['pool_bytes']} bytes, plan cache {'hit' if res.cache_hit else 'miss'}, S {run['s']}; "
                  f"equals the oracle and the pool-off service")
            if i == 0:
                first_plan, first_launches = ref.plan, launches_off
                on.drain()  # the idle window: the provisioner refills inline
                r = on.provisioner.stats()
                print(f"  idle window: the provisioner refilled the pool in {r['last_refill_seconds']:.3f} s; "
                      f"pool {on.pool.stats()}")
        warm = [r for r in out["runs"] if r["query"] == "dosage_study"][1:]
        check(all(r["hits"] > 0 for r in warm), f"service: warm runs did not hit the pool ({warm})")
        ps = on.pool.stats()
        check(ps["evictions"] == 0, f"service: the pool evicted under {SERVICE_POOL_BYTES} bytes ({ps})")
        cache = on.stats
        print(f"  plan cache: {cache['plan_cache_hits']} hits, {cache['plan_cache_misses']} misses, "
              f"{cache['plan_cache_rebinds']} rebinds; pool {ps['depth_bytes']} bytes of {SERVICE_POOL_BYTES} "
              f"({ps['static_entries']} static, {ps['counter_entries']} counter entries, {ps['evictions']} "
              f"evictions); accountant {[(a['observed'], a['budget']) for a in on.accountant.status()]}")
        out.update(pool=ps, cache={k: cache[k] for k in ("plan_cache_hits", "plan_cache_misses",
                                                          "plan_cache_rebinds")})

        # launches: the first submit against Engine.execute of its plan
        engine = Engine(tables, key=threefry.PRNGKey(42), device=dev)
        _sync(dev)
        reset_launch_counts()
        engine.execute(first_plan)
        _sync(dev)
        direct = launch_counts()
        reset_launch_counts()
        if dev.type == "cuda":
            check(direct == first_launches, f"service: a submit launched {first_launches}, Engine.execute {direct}")
        print(f"  launches of the first submit equal Engine.execute of its plan: {dict(sorted(direct.items()))}")
        out["submit_launches"] = direct

        # a batch of four tenants against the serial submits of a fresh service
        batch_sql = QUERY_SQL["comorbidity"]
        batch_svc = _service(dev, tables, catalog, f"{tmp}/batch", "on")
        serial_svc = _service(dev, tables, catalog, f"{tmp}/serial", "on")
        serial, serial_s = [], []
        for i in range(BATCH_SLOTS):
            res, dt, _ = _submit(dev, serial_svc, f"t{i}", batch_sql)
            serial.append(res)
            serial_s.append(dt)
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(BATCH_SLOTS):
            batch_svc.enqueue(f"t{i}", batch_sql)
        slots = batch_svc.drain()
        _sync(dev)
        batch_s = time.perf_counter() - t0
        # drain() ends with the idle window's inline pool refill
        refill_s = batch_svc.provisioner.stats()["last_refill_seconds"]
        batch_launches = launch_counts()
        reset_launch_counts()
        _add(totals, batch_launches)
        stats = dict(batch_svc.engine.last_batch_stats)
        check(len(slots) == BATCH_SLOTS and all(r.batch_slots == BATCH_SLOTS for r in slots),
              f"service batch: {[r.batch_slots for r in slots]} slots a pass")
        for i, (b, s) in enumerate(zip(slots, serial)):
            check(_same_result(b, s), f"service batch slot {i}: differs from its serial submit")
            check(revealed_answer("comorbidity", b.plan, b.table) == plaintext_oracle("comorbidity", plain),
                  f"service batch slot {i}: differs from the oracle")
        print(f"  batch: {BATCH_SLOTS} tenants' comorbidity, one pass of {stats['stacked_nodes']} stacked and "
              f"{stats['split_nodes']} split nodes: enqueue and drain {batch_s:.3f} s, of which the idle refill "
              f"{refill_s:.3f} s, against {sum(serial_s):.3f} s for the serial submits "
              f"({', '.join(f'{x:.3f}' for x in serial_s)}); every slot equals its serial submit")
        out["batch"] = {"stats": stats, "batch_s": batch_s, "refill_s": refill_s, "serial_s": serial_s,
                        "launches": batch_launches}

        # the budget: a refusing accountant, then a restart over the same
        # state; a Resizer on every internal operator, so the restarted
        # service's calibrated cost model cannot place the query's one
        # disclosure away
        def refusing(state):
            return _service(dev, tables, catalog, state, "on", placement="all_internal",
                            accountant=PrivacyAccountant(err=REFUSE_ERR, policy="refuse"))

        budget_svc = refusing(f"{tmp}/budget")
        admitted = 0
        for _ in range(16):
            try:
                _, _, launches = _submit(dev, budget_svc, "mallory", BUDGET_SQL)
            except BudgetRefused as e:
                refusal = (e.observed, e.budget)
                break
            _add(totals, launches)
            admitted += 1
        else:
            check(False, "service: the refusing accountant never refused")
        status = budget_svc.accountant.status()
        check(admitted == refusal[1] == refusal[0], f"service: {admitted} admitted, refused at {refusal}")
        restarted = refusing(f"{tmp}/budget")
        check(restarted.accountant.status() == status, "service: the restarted accountant's counts differ")
        try:
            restarted.session("trent").submit(BUDGET_SQL)
            check(False, "service: the restarted service admitted a spent signature")
        except BudgetRefused as e:
            check((e.observed, e.budget) == refusal, f"service: restarted refusal {e.observed, e.budget}")
        noise, addition = budget_svc.noise, budget_svc.addition
        sigs = [{"subplan": a["subplan"], "budget": a["budget"], "observed": a["observed"],
                 "crt_rounds": crt_rounds(noise, addition, a["n"], a["t"], err=REFUSE_ERR)} for a in status]
        for sg in sigs:
            print(f"  budget: {sg['subplan']} budget {sg['budget']}, observed {sg['observed']}, crt_rounds "
                  f"{sg['crt_rounds']:.4f} (err {REFUSE_ERR}); {admitted} admitted, then BudgetRefused, and again "
                  f"after a restart over the same state directory")
        out["budget"] = {"admitted": admitted, "signatures": sigs}
        for svc in (on, off, batch_svc, serial_svc, budget_svc, restarted):
            svc.close()
    out["seconds"] = time.perf_counter() - t_phase
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out["launches"] = totals
    if dev.type == "cuda":
        missing = [k for k in KERNELS if not totals.get(k, 0)]
        check(not missing, f"service: {missing} never launched ({totals})")
    card = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    print(f"  phase 8 in {out['seconds']:.1f} s; peak {out['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{dict(sorted(totals.items()))}; {card}")
    return out


def service_cross_device(dev, n: int = 48) -> None:
    """The service at n=48 on ``dev`` and on ``cpu``: identical results,
    accountant, plan cache and pool."""
    import tempfile

    import torch

    from repro_torch.data import QUERY_SQL, generate_healthlnk

    dosage = QUERY_SQL["dosage_study"]
    sequence = [("alice", dosage), ("bob", QUERY_SQL["aspirin_count"]), ("carol", QUERY_SQL["comorbidity"]),
                ("alice", dosage.replace("390", "414")), ("dave", dosage)]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for d in (dev, torch.device("cpu")):
            tables, _ = generate_healthlnk(n=n, seed=0, device=d)
            svc = _service(d, tables, None, f"{tmp}/{d.type}", "on")
            results = [svc.session(t).submit(sql) for t, sql in sequence]
            runs[d.type] = (results, svc.accountant.status(), svc.stats, svc.pool.stats())
            svc.close()
    (a, astat, astats, apool), (b, bstat, bstats, bpool) = runs[dev.type], runs["cpu"]
    for i, (x, y) in enumerate(zip(a, b)):
        check(_same_result(x, y), f"service n={n}: submit {i} differs between {dev.type} and cpu")
    check(astat == bstat and astats == bstats and apool == bpool,
          f"service n={n}: accountant, stats or pool differ between {dev.type} and cpu")
    print(f"  service n={n}: {len(sequence)} submits identical on {dev.type} and cpu (shares, ledgers, S, rows, "
          f"accountant, plan cache, pool {apool['depth_bytes']} bytes)")


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

    print(f"[3] full size: n={ROWS_PER_TABLE} rows per table (three_join's product run: n={THREE_JOIN_ROWS}; "
          f"comorbidity also at n={BIG_ROWS})")
    full = full_phase(dev, ROWS_PER_TABLE, THREE_JOIN_ROWS, BIG_ROWS)
    print("  python -m repro_torch.sql --check, in-process on cuda:")
    from repro_torch.sql.__main__ import check as sql_check

    t0 = time.perf_counter()
    check(sql_check(dev) == 0, "the SQL front end's --check failed on cuda")
    print(f"  --check passed on cuda in {time.perf_counter() - t0:.3f} s")

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

    print(f"[6] batched execution: K={BATCH_SLOTS} slots of the sort-merge dosage_study at n={ROWS_PER_TABLE}")
    from repro_torch.core.noise import RevealNoise

    batch = batch_phase(dev, ROWS_PER_TABLE)
    # S = T in every slot: the slots stay stacked through the join and the
    # Distinct, so every kernel runs stacked
    stacked = batch_phase(dev, ROWS_PER_TABLE, noise=RevealNoise())
    batch_cross_device(dev)

    print(f"[7] tracing: the sort-merge dosage_study at n={ROWS_PER_TABLE} under a Tracer")
    traced = tracing_phase(dev, ROWS_PER_TABLE)

    print(f"[8] the service: AnalyticsService over n={ROWS_PER_TABLE} rows per table, pool on, durable state")
    service = service_phase(dev, ROWS_PER_TABLE)
    service_cross_device(dev)

    # launches on the main paths: phase 3's runs, phase 6's batches and
    # phase 8's submits and batch
    launches = {k: sum(r["launches"].get(k, 0) for r in full.values()) + batch["launches"].get(k, 0)
                + stacked["launches"].get(k, 0) + service["launches"].get(k, 0) for k in KERNELS}
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
               "timing": timing, "profile": profiled, "batch": [batch, stacked], "tracing": traced, "service": service,
               "summary": summary}
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
