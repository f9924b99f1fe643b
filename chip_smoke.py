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
   and the PRF's draws ``threefry_bits`` with host and device keys, 1 to 6
   keys, up to 2^22 + 3 words a key, and its words for ``PRNGKey(0)``
   against jax.random's;
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
   size rule) and the two-pass route's chunk size; ``threefry_bits`` at the
   largest draw of the full-size runs, with host and with device keys;
5. with ``--profile`` only: a ``torch.profiler`` breakdown of device time
   by kernel for one stage of the full-size Distinct's sort (2^23 rows) on
   the fused and on the gate-by-gate path, one join tile, and the largest
   shuffle hop;
6. batched execution: ``Engine.execute_batch`` of K = 4 copies of the
   sort-merge ``dosage_study`` (n = 2,048 rows per table, a quarter of
   phase 3's, as in phases 8 and 9; Beta(2,6) Resizers,
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
8. the service: ``AnalyticsService`` over phase 6's n rows per table and
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
   service at n=48 gives identical results on ``cuda`` and ``cpu``;
9. the networked runtime (``repro_torch.runtime``) over the same n rows per
   table, the catalog of phase 8 and the service's defaults with the pool
   off: ``ReflexClient.networked`` with three party threads on the card
   (a loopback mesh) submits phase 8's three tenants' queries, each equal
   to an in-process client's (rows, per-node ledger, S and the output share
   triples, max difference 0) and the oracle, with ledger bytes =
   exchange-log bytes = wire bytes for each party and each kernel's
   launches exactly three times the in-process submit's (seconds, stall,
   payload exchanges and their device-to-host bytes printed per party);
   then ``python -m repro_torch.runtime.run_parties --party all`` starts
   three party processes on the card, a ``connect_tcp`` client's
   ``dosage_study`` equals the loopback mesh's and the launcher exits 0;
   then ``python -m repro_torch.sql --explain-analyze --networked`` on one
   golden exits 0 and writes its trace;
10. ring-64 and sort&cut: the five 64-bit builds (``rss_gate`` in both
    modes, ``ks_prefix`` and ``a2b_fused`` at widths 64 and 18,
    ``and_fold`` at widths 64 and 32, ``bit2a_fused``) against their plain
    versions on int64 planes at 2^24 lanes and at 2^24 + 1 (the scalar
    path), each one launch of its ``_u64`` build and none of the 32-bit
    one, max_abs_err 0, and ``shuffle_gather`` and ``bitonic_swap``
    refusing an int64 plane; then the ring-64 circuits ``lt_public``,
    ``lt``, ``eq``, ``ks_add``, ``a2b``, ``b2a`` (over 2^18 values, 2^24
    bit lanes), ``bit2a``, ``mul`` and ``and_`` over 2^24 lanes of 64-bit
    values shared with ``ring=RING64``, fused and gate by gate: identical
    shares and ledgers, the answers of numpy ``uint64``, each path's
    launches exactly as listed in ``RING64_CIRCUITS``, with seconds; at
    n = 4,096 every circuit identical on cuda and cpu on both paths; the
    64-bit builds timed at those shapes as phase 4 times the 32-bit ones;
    then the paper's four Resizer modes (``benchmarks/bench_healthlnk.py:38-45``:
    no Resizer; sort&cut, TLap(eps=0.5, delta=5e-5, sensitivity=n/8) with
    sequential addition and ``use_sort=True``; Reflex, the same noise with
    parallel addition; revealed, ``RevealNoise``; placement
    ``all_internal``, ``bucket_fn`` the next power of two) over the
    sort-merge ``dosage_study`` and ``aspirin_count`` at n = 4,096 rows
    per table (half of phase 3's n, so that the script keeps to its time)
    and phase 3's catalog, and the product-join ``dosage_study`` under
    sort&cut at n=512 (at n=8192 its join's sort&cut Resize would pad to
    2^26 rows), each answer the oracle's, with seconds, the heaviest node,
    peak memory and each Resize's (S, n), a sort&cut Resize's n padded to
    a power of two; then the n=48 quickstart plan under sort&cut identical
    on cuda and cpu and gate by gate;
11. the LM side's serving path (``repro_torch.models``, ``configs``,
    ``serve``; plain PyTorch, no TPU kernel lies on it): the ten reduced
    architectures in f32 with TF32 off, ``forward``, ``prefill`` and eight
    decode steps on ``cuda`` equal to ``cpu`` (max |diff| 1e-4; 5e-3 for
    recurrentgemma and xlstm); ``stablelm_1_6b`` at full width cut to 4 of
    its 24 layers (f32 masters, bf16 compute), eight seeded requests of
    40-500 tokens through ``BucketedBatcher((128, 256, 512), (1, 2, 4, 8))``
    drained lot by lot: the prefill step's next-token logits, the serve
    step over ``init_caches(B, bucket + 16)`` fed the bucket's tokens (each
    position's logits against ``forward``'s and the last against the
    prefill step, max |diff| 0.25 and mean 0.02: ``LM_BF16_MAX``,
    ``LM_BF16_MEAN``), then 16 greedy tokens, with prefill tokens/s, serve
    ms per step, peak memory and seconds; then every other architecture at
    full width cut to one group of its pattern (two layers; recurrentgemma
    19, xlstm 8): ``forward`` at B = 2, S = 128 (paligemma: 256 patch
    embeddings then 128 tokens; musicgen: frame embeddings), 4 serve steps
    from empty caches against ``forward`` (paligemma against its causal
    forward; mixtral with the ``full`` capacity; xlstm only finite, with
    the reference's mLSTM decode gap printed), mixtral under the four
    capacity policies (C, dropped assignments, distance from ``full``),
    stablelm chunked against dense and with the int8 KV cache and bf16
    decode scores; ``arctic_480b`` is left out (its reason printed);
12. the LM side's training path (``repro_torch.data.pipeline``, ``train``,
    ``launch.train``; plain PyTorch, no TPU kernel lies on it): the ten
    reduced architectures in f32 with TF32 off, one train step (loss,
    gradients, then AdamW's parameters and state) on ``cuda`` equal to
    ``cpu`` and remat on equal to remat off (per leaf, max |diff| at most
    1e-4 times max(1, max |value|); 5e-3 for recurrentgemma and xlstm);
    ``stablelm_1_6b`` uncut (1,644,267,520 parameters, f32 masters and
    moments, bf16 compute, ``remat`` as its config has it) on 4 x 512-token
    ``TokenPipeline`` batches: the first step's forward and backward with
    remat off and on (equal loss, grad norms within 1e-3, each one's peak
    memory), a ``grad_accum=2`` step within 5e-2 of the large batch's loss,
    then three AdamW steps (seconds, tokens/s and the model-FLOP share 6 N T
    over the step time against 989 TFLOP/s bf16, loss and grad norm finite,
    the parameters moved, peak memory); then ``repro_torch.launch.train``'s
    failure drill in-process on ``cuda`` (an uninterrupted run, a run that
    stops at step 6 and returns 17, a resume from step 5 with the same
    ``loss[last 5]``); no MPC kernel launches during the phase. A
    checkpoint at full width is left out (its reason printed);
13. the LM side's multi-device stack (``repro_torch.sharding``,
    ``launch.mesh``, ``launch.roofline``; plain PyTorch and DTensor, no TPU
    kernel lies on it): a one-rank NCCL process group and a (1, 1)
    ("data", "model") mesh (no fallback: a group that fails to start fails
    the script); the ten reduced architectures in f32 with TF32 off, one
    train step over DTensors (parameters by ``make_param_specs``, ZeRO-1
    moments, the batch by ``batch_specs``; an axis of extent 1 replicates)
    equal to the plain ``cuda`` step by phase 12's rule (loss, grad norm,
    parameters and AdamW state, gathered); ``stablelm_1_6b`` uncut, one
    sharded forward and backward on phase 12's first 4 x 512 batch, loss
    and grad norm within phase 12's remat limits of the plain one, with
    seconds and peak memory; then the port's roofline, counted on ``meta``,
    of phase 11's serve step at its largest lot's shape and of phase 12's
    train step, each bound beside the times those phases measured and the
    ratio; no MPC kernel launches during the phase.

14. the serving configuration under ``jit_ops=True`` (the engine's
    per-operator cache, each entry a captured CUDA graph): the reference's
    serving demo (``examples/healthlnk_queries.py``: ``SELECT major_icd9,
    COUNT(*) AS c FROM diagnoses GROUP BY major_icd9`` through
    ``ReflexClient.in_process(..., noise=NoTrim(), placement="none",
    jit_ops=True)``; a warm submit, eight tenants' serial submits, a warm
    then a timed drain of eight) at n = 48 on ``cuda`` and ``cpu``
    (identical results, shares included, and cache statistics), then at
    n = 8,192 against the same sequence eager (identical shares, per-node
    ledger and rows; every answer the oracle's; the drained slots equal the
    serial submits; the statistics equal the CPU's): capture seconds, pool
    bytes and launches of each graph, seconds per replayed submit against
    eager, the drain against the serial submits, peak memory; a replay
    under another engine's key gives that key's shares; each kernel
    launched inside the graphs, at every argument shape the captures gave
    it, captured alone and replayed against its plain version; then phase
    3's sort-merge ``aspirin_count`` (Beta(2,6) parallel Resizers on every
    internal operator) executed three times on one ``Engine(jit_ops=True)``
    (cache misses and new graphs per execution: the nodes after a Resize
    miss when S changes), the first against phase 3's eager run with the
    same key (shares, ledger, S), every answer the oracle's. Its replays launch no wrapper, so the kernels
    line's launches do not count them; each graph's recorded launches are
    printed;
15. the reference's remaining MPC surface: (a) every Resize after a
    product join in phase 3's runs (recorded there, no extra work): the
    gather log holds S rows for each lazy column and nothing larger
    (``max(gather_log()) == S < n1 n2``), no column leaves the Resize
    lazy, and the table's bytes before and after the trim; (b)
    ``dosage_study``'s two filtered HealthLNK tables (n = 8,192 rows each,
    phase 3's size) joined by ``oblivious_join(lazy=True)`` and by
    ``lazy=False``, each followed by the same Beta(2,6) Resizer and key:
    identical S, revealed rows and ledger tally, with each join's bytes,
    peak memory and seconds, after the same comparison at n = 64 on
    ``cuda`` and ``cpu`` (identical shares, ledger, S); (c)
    ``measure_comm`` on ``meta`` tensors against the ledger of the same
    call executed on the card, for ``lt``, ``eq``, ``a2b`` and ``bit2a``
    at 2^24 lanes and a 3-hop ``secure_shuffle`` and a bitonic sort at
    2^16 rows, on both circuit paths, with the seconds of each.

The kernels line's launches sum phases 3, 6, 8, 9, 10's sort&cut runs and
15's joins and Resizes;
the nested ``"u64"`` object of each kernel with a 64-bit build holds that
build's error, times and bound from phase 10 and its launches over phase
10's ring-64 circuits. The lines before the
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
# rows per table of phases 6, 8 and 9 (batch, service, networked runtime):
# a quarter of the full size, so that the whole script, phase 11 included,
# stays inside its time limit on the slower hosts the card comes with (their
# host-bound nodes take up to 1.6x as long)
LATER_ROWS = 2048
# three_join's rows per table: its second and third product joins hold about
# S1 * n/4 and S2 * n/4 rows (S: the Resize sizes), which grow as n^3 and n^4
THREE_JOIN_ROWS = 512
# comorbidity's second run: a one-million-row diagnoses table
BIG_ROWS = 1 << 20
# the >8 MiB gather of the kernel phase: the product join's size as planned
GATHER_ROWS = 7_900_000
# timed calls in a row per kernel measurement
REPS = 20
# the plain versions take 3-100 ms a call: 5 x PLAIN_REPS calls time them
PLAIN_REPS = 4
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
    # no Pallas kernel: the reference's draw, jax.random.bits, which XLA
    # lowers to elementwise code on the TPU
    "threefry_bits": (CSRC + "threefry.cu", "src/repro/core/prf.py:51"),
}
# the gate-by-gate path's (every path draws its randomness through
# threefry_bits)
GATE_KERNELS = ("rss_gate", "shuffle_gather", "threefry_bits")
FUSED_KERNELS = ("ks_prefix", "and_fold", "a2b_fused", "bit2a_fused", "bitonic_swap")
# the kernels each golden's fused path launches with Resizers on every
# internal operator: every plan filters, joins, resizes or sorts through
# rss_gate, ks_prefix and and_fold; a Resize adds shuffle_gather and
# a2b_fused; COUNT, SUM, AVG and GroupBy add bit2a_fused; a sort adds
# bitonic_swap (diag_breakdown's sort has no payload to narrow and no Resize,
# so it shuffles nothing; the other GroupBys at the root convert no a2b); every
# gate draws its zero sharing through threefry_bits
_BASE = ("rss_gate", "ks_prefix", "and_fold", "threefry_bits")
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
    # sort&cut Resizers with sequential addition: the filler count
    # (bit2a_fused, a2b_fused), the keep-bit sort (bitonic_swap) and the
    # payload's move by the sorted index (shuffle_gather)
    "sortcut": _RESIZED + ("bit2a_fused", "bitonic_swap"),
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


def median_ms(fn, reps: int = REPS) -> float:
    """Time of one call: CUDA events around ``reps`` calls in a row, over the
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
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
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
    threefry_kernel_checks(dev, errs)
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


# jax.random.bits(jax.random.PRNGKey(0), (4,), jnp.uint32) under jax 0.9.0
# (jax_threefry_partitionable=True)
JAX_BITS_KEY0 = [4070199207, 4202968722, 1427181096, 2012915765]


def threefry_kernel_checks(dev, errs: dict) -> None:
    """``threefry_bits`` against its plain version, bit for bit: host keys
    (one launch per four) and device keys (one launch), 1 to 6 keys, ragged
    and large draws; and its words for PRNGKey(0) against jax.random's
    (``tests/test_torch_threefry.py`` holds the draws against jax on the
    CPU)."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.threefry import draw, draw_plain

    for r in (1, 3, 6):
        keys = torch.stack([threefry.PRNGKey(100 * r + i) for i in range(r)])
        for n in (1, 4099, (1 << 22) + 3):
            want = draw_plain(keys, n, dev)
            for label, k, launches in (("host", keys, -(-r // 4)), ("device", keys.to(dev), 1)):
                reset_launch_counts()
                got = draw(k, n, dev)
                torch.cuda.synchronize()
                check(launch_counts().get("threefry_bits", 0) == launches,
                      f"threefry_bits {label} keys R={r} n={n}: launches {launch_counts()}, not {launches}")
                err = max_abs_err(got, want)
                check(err == 0, f"threefry_bits {label} keys R={r} n={n} differs from its plain version")
                errs["threefry_bits"] = max(errs["threefry_bits"], err)
            del want, got
        print(f"  threefry_bits R={r} keys, n = 1 / 4099 / {(1 << 22) + 3}, host and device keys  max_abs_err=0")
    got = (threefry.bits(threefry.PRNGKey(0), (4,), dev).cpu().to(torch.int64) & 0xFFFFFFFF).tolist()
    check(got == JAX_BITS_KEY0, f"threefry_bits of PRNGKey(0) on the card: {got}, jax.random: {JAX_BITS_KEY0}")


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
    from repro_torch.core.noise import BetaNoise
    from repro_torch.data import QUERY_SQL
    from repro_torch.sql import compile_query

    return compile_query(QUERY_SQL[query], pid_catalog(tables, plain), placement="all_internal",
                         noise=noise or BetaNoise(2, 6), join_algo=join_algo)


def pid_catalog(tables: dict, plain: dict):
    """The tables' catalog declaring each table's observed pid bound."""
    import numpy as np

    from repro_torch.sql import Catalog

    mult = {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}
    return Catalog.from_tables(tables, multiplicity=mult)


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

# outputs of phase 3's runs that phase 14 holds its jit runs against: name ->
# (share_rows, ledger_rows)
EAGER_RUNS: dict = {}


def recording_resizes(resizes: list):
    """A ``Resizer.__call__`` that, for an input with lazy columns (a
    product join's output), resets the gather log before the Resize and
    records after it: rows in, S, the lazy columns, the gather log, the
    table's bytes before and after the trim, and the columns it left lazy.
    Phase 15 (a) reads the records."""
    from repro_torch.core.resizer import Resizer
    from repro_torch.ops.table import LazyGather, gather_log, reset_gather_log, table_nbytes

    resize = Resizer.__call__

    def recorded(self, table, *args, **kwargs):
        lazy = [k for k, c in table.cols.items() if isinstance(c, LazyGather)]
        if not lazy:
            return resize(self, table, *args, **kwargs)
        before = table_nbytes(table)
        reset_gather_log()
        out, info = resize(self, table, *args, **kwargs)
        resizes.append({"n": table.n, "s": info.get("s"), "lazy_cols": len(lazy), "log": gather_log(),
                        "bytes_before": before, "bytes_after": table_nbytes(out), "left_lazy": out.lazy_names()})
        return out, info

    return resize, recorded


def full_phase(dev, n: int, three_join_n: int, big_n: int) -> dict:
    """The full-size runs, each with its launch counts set to 0 just before
    it and read just after, the shape of each shuffle hop it gathers
    (rows, planes, the columns' widths) and each Resize after a product
    join (:func:`recording_resizes`)."""
    import numpy as np
    import torch

    import repro_torch.core.shuffle as shuffle
    import repro_torch.kernels.threefry.ops as tf_ops
    import repro_torch.ops.join_sortmerge as jsm
    from repro_torch.core.resizer import Resizer
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

    # each draw's keys and words per key
    draws: list = []
    draw_launch = tf_ops._launch

    def recorded_draw(keys, n, device):
        draws.append((keys.shape[0], n))
        return draw_launch(keys, n, device)

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

    resizes: list = []
    resize, recorded_resize = recording_resizes(resizes)
    shuffle.gather_hop = recorded_hop
    tf_ops._launch = recorded_draw
    jsm.bitonic_sort, jsm.apply_secret_perm = timed(sort, "sort_s"), timed(gather, "gather_s")
    Resizer.__call__ = recorded_resize
    try:
        results, outputs, answers = _full_runs(dev, runs, data, hops, phases, resizes, draws, n)
    finally:
        shuffle.gather_hop = gather_hop
        tf_ops._launch = draw_launch
        jsm.bitonic_sort, jsm.apply_secret_perm = sort, gather
        Resizer.__call__ = resize
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


def _full_runs(dev, runs: dict, data: dict, hops: list, phases: list, resizes: list, draws: list,
               n: int) -> tuple:
    """Each run of ``full_phase``, with ``hops`` filled by the recording
    ``gather_hop``, ``phases`` by the timed union sort and payload gather
    of each sort-merge join, ``resizes`` by the recording Resizer and
    ``draws`` by the recording ``threefry_bits`` launch;
    returns the results, the outputs of the runs compared fused and gate by
    gate, and every run's answer."""
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
        resizes.clear()
        draws.clear()
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
            "lazy_resizes": list(resizes),
            "largest_draw": list(max(draws, key=lambda d: d[0] * d[1], default=(0, 0))),
            "result": got if isinstance(got, int) else size,
        }
        if name in ("dosage_study", "dosage_study gates", "comorbidity", "comorbidity gates"):
            outputs[name] = (out, report)
        if name == "aspirin_count sort-merge":  # phase 14's eager reference
            EAGER_RUNS[name] = (share_rows(out), ledger_rows(report))
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


def _without_draws(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if k != "threefry_bits"}


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

    import torch

    from repro_torch.core.crt import crt_rounds
    from repro_torch.core import threefry
    from repro_torch.data import QUERY_SQL, generate_healthlnk, plaintext_oracle, revealed_answer
    from repro_torch.engine import Engine
    from repro_torch.errors import BudgetRefused
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.service import PrivacyAccountant

    tables, plain = generate_healthlnk(n=n, seed=0, device=dev)
    catalog = pid_catalog(tables, plain)
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
            if dev.type == "cuda":  # the pool serves draws made before the submit: threefry_bits aside
                check(_without_draws(launches) == _without_draws(launches_off),
                      f"service {tenant} {query}: launches differ with the pool off")
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
        # the batch window of the reference's batched-admission demo: the
        # four enqueues form one bucket however long admission takes (at the
        # default 0.05 s a slow host's deadline flush split them 3 + 1)
        batch_svc = _service(dev, tables, catalog, f"{tmp}/batch", "on", batch_wait_s=60.0)
        serial_svc = _service(dev, tables, catalog, f"{tmp}/serial", "on")
        serial, serial_s = [], []
        for i in range(BATCH_SLOTS):
            res, dt, _ = _submit(dev, serial_svc, f"t{i}", batch_sql)
            serial.append(res)
            serial_s.append(dt)
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        admit_s = []  # each enqueue's admission, against the default 0.05 s window
        for i in range(BATCH_SLOTS):
            t1 = time.perf_counter()
            batch_svc.enqueue(f"t{i}", batch_sql)
            admit_s.append(time.perf_counter() - t1)
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
              f"({', '.join(f'{x:.3f}' for x in serial_s)}); every slot equals its serial submit; admission "
              f"{', '.join(f'{x:.4f}' for x in admit_s)} s an enqueue")
        out["batch"] = {"stats": stats, "batch_s": batch_s, "refill_s": refill_s, "serial_s": serial_s,
                        "admit_s": admit_s, "launches": batch_launches}

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
# 9. the networked runtime: three parties
# ---------------------------------------------------------------------------

# the tenants of phase 8 and their queries, through both clients
RUNTIME_QUERIES = (("alice", "dosage_study"), ("bob", "aspirin_count"), ("carol", "comorbidity"))


def _runtime_answer(plain: dict, query: str, res):
    from repro_torch.data import plaintext_oracle, revealed_answer

    got, want = revealed_answer(query, res.plan, res.table), plaintext_oracle(query, plain)
    check(got == want, f"runtime {query}: {got} differs from the oracle {want}")


def _table_err(a, b) -> int:
    """Largest |difference| over two output tables' share words."""
    import numpy as np

    sa, sb = share_rows(a), share_rows(b)
    check(list(sa) == list(sb), "runtime: the output columns differ")
    return max(int(np.abs(sa[k].astype(np.int64) - sb[k].astype(np.int64)).max(initial=0)) for k in sa)


def _audit_line(audit: list) -> str:
    return "; ".join(f"p{a['party']} {a['wire_bytes']} B wire = ledger, {a['exchanges']} exchanges "
                     f"({a['payload_exchanges']} with shares, {a['d2h_bytes']} B to the host), stall "
                     f"{a['stall_seconds']:.3f} s, bodies {a['body_seconds']:.3f} s" for a in audit)


def _check_audit(label: str, audit: list) -> None:
    check([a["party"] for a in audit] == [0, 1, 2], f"{label}: audit of parties {audit}")
    for a in audit:
        check(a["ledger_bytes"] == a["exchange_bytes"] == a["wire_bytes"],
              f"{label}: party {a['party']} wire {a['wire_bytes']} != ledger {a['ledger_bytes']}")


def _party_endpoints(proc, timeout: float) -> dict:
    """The ``[party p] listening on HOST:PORT`` lines of a ``run_parties``
    launcher, until all three parties listen (the launcher is killed past
    ``timeout``)."""
    import re
    import threading

    endpoints, seen = {}, []
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        while len(endpoints) < 3:
            line = proc.stdout.readline()
            check(bool(line), f"runtime tcp: the party launcher exited early: {''.join(seen)}")
            seen.append(line)
            m = re.match(r"\[party (\d)\] listening on (.+):(\d+)", line)
            if m:
                endpoints[int(m.group(1))] = (m.group(2), int(m.group(3)))
    finally:
        timer.cancel()
    return endpoints


def runtime_phase(dev, n: int) -> dict:
    """The multi-party runtime over ``generate_healthlnk(n)`` with the
    catalog of phase 3's sort-merge runs and the service's defaults, the
    offline pool off (``networked()`` pins it):

    * loopback: ``ReflexClient.networked`` with three party threads on
      ``dev`` submits phase 8's three tenants' queries; each equals an
      in-process client's with the same key (rows, per-node ledger, S, and
      the reassembled output share triples, max difference 0) and the
      oracle; each party's ledger bytes = exchange-log bytes = wire bytes;
      each kernel's launches are exactly three times the in-process
      submit's;
    * TCP: ``python -m repro_torch.runtime.run_parties --party all`` on
      free ports (the kernels are built before), ``connect_tcp``, one
      ``dosage_study`` equal to the loopback's; the launcher exits 0 after
      the shutdown;
    * the CLI: ``python -m repro_torch.sql --explain-analyze --networked``
      on one golden exits 0.

    Launches of the networked submits are summed for the kernels line."""
    import os
    import tempfile

    import torch

    import repro_torch.kernels as kernels
    from repro_torch.core import threefry
    from repro_torch.data import QUERY_SQL, generate_healthlnk
    from repro_torch.runtime import ReflexClient, connect_tcp

    tables, plain = generate_healthlnk(n=n, seed=0, device=dev)
    catalog = pid_catalog(tables, plain)
    out: dict = {"n": n, "runs": []}
    totals: dict = {}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()

    inproc = ReflexClient.in_process(tables, catalog=catalog, key=threefry.PRNGKey(42), offline="off", device=dev)
    net = ReflexClient.networked(tables, catalog=catalog, key_seed=42, device=dev)
    loop_results = {}
    try:
        for tenant, query in RUNTIME_QUERIES:
            sql = QUERY_SQL[query]
            ref, dt_in, l_in = _submit(dev, inproc.service, tenant, sql)
            res, dt_net, l_net = _submit(dev, net.service, tenant, sql)
            _add(totals, l_net)
            audit = net.service.engine.last_wire_audit
            _runtime_answer(plain, query, res)
            check(_same_result(res, ref), f"runtime {query}: networked differs from in-process")
            err = _table_err(res.table, ref.table)
            check(err == 0, f"runtime {query}: output shares differ by {err}")
            _check_audit(f"runtime {query}", audit)
            if dev.type == "cuda":
                want = {k: 3 * v for k, v in l_in.items()}
                check(l_net == want, f"runtime {query}: networked launched {l_net}, 3x in-process is {want}")
            loop_results[query] = res
            run = {"tenant": tenant, "query": query, "seconds": dt_net, "seconds_in_process": dt_in,
                   "audit": audit, "launches": l_net, "launches_in_process": l_in, "max_abs_err": err,
                   "s": [s.extra["s"] for s in res.report.nodes if "s" in s.extra], "nodes": node_rows(res.report)}
            out["runs"].append(run)
            print(f"  {tenant:5s} {query}: networked {dt_net:.3f} s, in-process {dt_in:.3f} s "
                  f"({dt_net / dt_in:.2f}x), S {run['s']}; rows, ledger, S and output shares equal "
                  f"(max |diff| {err}); {_audit_line(audit)}")
            print(f"    launches networked {dict(sorted(l_net.items()))} = 3 x in-process "
                  f"{dict(sorted(l_in.items()))}")
        status = net.status()["runtime"]["mesh"]
        check(status["ok"] and [p["queries"] for p in status["parties"]] == [len(RUNTIME_QUERIES)] * 3,
              f"runtime: mesh status {status}")
        print(f"  mesh status: {[(p['party'], p['queries'], p['bytes']) for p in status['parties']]}, "
              f"control rtt {status['rtt_seconds']}")
    finally:
        net.close()
        inproc.close()
    check(not any(t.is_alive() for t in net.coordinator.party_threads), "runtime: a party thread outlived the mesh")
    out["loopback_seconds"] = time.perf_counter() - t_phase

    # TCP: three party processes on this card
    t0 = time.perf_counter()
    if dev.type == "cuda":
        kernels.build()  # once, before the parties start
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.runtime.run_parties", "--party", "all", "--base-port", "0",
         "--device", dev.type], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        endpoints = _party_endpoints(proc, timeout=300.0)
        client = ReflexClient.networked(tables, coordinator=connect_tcp(endpoints), catalog=catalog, key_seed=42,
                                        device=dev)
        try:
            tcp, dt_tcp, _ = _submit(dev, client.service, "alice", QUERY_SQL["dosage_study"])
            audit = client.service.engine.last_wire_audit
        finally:
            client.close()
        rc = proc.wait(timeout=120.0)
        log = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60.0)
        proc.stdout.close()
    check(rc == 0, f"runtime tcp: the party launcher exited {rc}:\n{log}")
    _check_audit("runtime tcp", audit)
    _runtime_answer(plain, "dosage_study", tcp)
    err = _table_err(tcp.table, loop_results["dosage_study"].table)
    check(_same_result(tcp, loop_results["dosage_study"]) and err == 0,
          "runtime tcp: dosage_study differs from the loopback mesh's")
    out["tcp"] = {"endpoints": {str(k): list(v) for k, v in endpoints.items()}, "seconds": dt_tcp, "audit": audit,
                  "phase_seconds": time.perf_counter() - t0}
    print(f"  tcp: three party processes on {endpoints}: dosage_study {dt_tcp:.3f} s, equal to the loopback "
          f"mesh's; {_audit_line(audit)}; the launcher exited 0 ({time.perf_counter() - t0:.1f} s with start-up)")

    # the SQL CLI's networked EXPLAIN ANALYZE
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trace = f"{tmp}/trace.jsonl"
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.sql", "--explain-analyze", "--networked", "--device", dev.type,
             "--trace-out", trace, QUERY_SQL["dosage_study"]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, timeout=600)
        traced = os.path.exists(trace) and os.path.exists(trace + ".chrome.json")
    check(cli.returncode == 0 and traced and "wire:" in cli.stdout,
          f"runtime cli: exit {cli.returncode}, trace written {traced}:\n{cli.stdout}")
    out["cli_seconds"] = time.perf_counter() - t0
    print(f"  python -m repro_torch.sql --explain-analyze --networked --device {dev.type} dosage_study: exit 0 in "
          f"{out['cli_seconds']:.1f} s; its wire line: "
          f"{next(ln for ln in cli.stdout.splitlines() if ln.startswith('wire:'))}")

    out["seconds"] = time.perf_counter() - t_phase
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out["launches"] = totals
    if dev.type == "cuda":
        missing = [k for k in KERNELS if not totals.get(k, 0)]
        check(not missing, f"runtime: {missing} never launched ({totals})")
    card = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    print(f"  phase 9 in {out['seconds']:.1f} s; peak {out['peak_bytes'] / 2**30:.2f} GiB; launches "
          f"{dict(sorted(totals.items()))}; {card}")
    return out


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
            plain_ms = median_ms(lambda: gate_plain(x, y, a, boolean), PLAIN_REPS)
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
    out.update(time_threefry(dev, shapes))
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
        plain_ms = median_ms(lambda: [shuffle_gather_plain(c, index) for c in cols], PLAIN_REPS)
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
        plain_ms = median_ms(lambda: plain(*args), PLAIN_REPS)
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
    plain_ms = median_ms(lambda: stage_swap_plain(*args), PLAIN_REPS)
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


# integer operations a word of threefry-2x32 takes: 20 rounds of add, rotate
# and XOR, five key injections of two adds, the two input words' adds and the
# final XOR
THREEFRY_OPS_PER_WORD = 73


def time_threefry(dev, shapes: dict) -> dict:
    """``threefry_bits`` at the largest draw of the run (its keys, its words
    a key), with host keys and with device keys, against its plain version.
    No PyTorch call computes threefry (its generators are Philox and
    Mersenne twister): no library time."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.kernels.threefry import draw, draw_plain

    r, n = shapes["draw"]
    keys = torch.stack([threefry.PRNGKey(500 + i) for i in range(r)])
    rows = []
    for label, k in (("host keys", keys), ("device keys", keys.to(dev))):
        err = max_abs_err(draw(k, n, dev), draw_plain(keys, n, dev))
        check(err == 0, f"threefry_bits {label} R={r} n={n} differs from its plain version")
        ms = median_ms(lambda: draw(k, n, dev))
        plain_ms = median_ms(lambda: draw_plain(keys, n, dev), PLAIN_REPS)
        bytes_moved = 4 * r * n  # the words written; the keys are a few bytes
        ops = THREEFRY_OPS_PER_WORD * r * n
        bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
        by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S else "operations"
        print(f"  threefry_bits {label:<11} R={r} n={n:>9}: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({by}), {100 * bound_ms / ms:.1f} % of the bound")
        rows.append({"keys": label, "r": r, "n": r * n, "bytes": bytes_moved, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err, "library_ms": None,
                     "device_keys": label == "device keys"})
    return {"threefry_bits": rows}


# ---------------------------------------------------------------------------
# 10. ring-64 (the five 64-bit builds) and the Resizer's sort&cut
# ---------------------------------------------------------------------------

# the kernels with a 64-bit build, as the launch counts name them (the
# 64-bit launches count as "<name>_u64")
WIDE_KERNELS = ("rss_gate", "ks_prefix", "and_fold", "a2b_fused", "bit2a_fused")
RING64_LANES = 1 << 24
RING64_ODD = (1 << 24) + 1  # odd: every 64-bit build's scalar path
RING64_SMALL = 4096  # the cuda-against-cpu size
# b2a turns each value into 64 bit lanes: 2^18 values are 2^24 bit lanes
RING64_B2A_VALUES = 1 << 18
# the circuits' launches per call: fused, and gate by gate (all rss_gate_u64)
RING64_CIRCUITS = {
    "lt_public": ({"ks_prefix_u64": 1}, 6),
    "lt": ({"rss_gate_u64": 1, "ks_prefix_u64": 1}, 7),
    "eq": ({"and_fold_u64": 1}, 6),
    "ks_add": ({"rss_gate_u64": 1, "ks_prefix_u64": 1}, 7),
    "a2b": ({"a2b_fused_u64": 1}, 14),
    "b2a": ({"bit2a_fused_u64": 1}, 2),
    "bit2a": ({"bit2a_fused_u64": 1}, 2),
    "mul": ({"rss_gate_u64": 1}, 1),
    "and": ({"rss_gate_u64": 1}, 1),
}
# the paper's four modes (benchmarks/bench_healthlnk.py:38-45) over the
# sort-merge plans of phase 3 at half its rows per table (so that the whole
# script, phase 11 included, stays inside its time limit on the slower
# hosts), and the product-join run's cut size
SORTCUT_QUERIES = ("dosage_study", "aspirin_count")
SORTCUT_ROWS = 4096
SORTCUT_PRODUCT_ROWS = 512


def words64(gen, shape, device):
    """Random 64-bit ring words drawn on ``device`` by the generator
    ``gen`` (two 32-bit halves; every bit pattern can occur)."""
    import torch

    hi = torch.randint(-2**31, 2**31, shape, generator=gen, device=device, dtype=torch.int64)
    lo = torch.randint(0, 2**32, shape, generator=gen, device=device, dtype=torch.int64)
    return (hi << 32) | lo


def device_generator(device, seed: int):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def max_abs_err64(a, b) -> int:
    """Largest |a - b| over the unsigned ring words of two int64 tensors (on
    the lanes that differ, at most 65,536 of them)."""
    from repro_torch.core.ring import to_numpy

    diff = a != b
    if not bool(diff.any()):
        return 0
    ua, ub = to_numpy(a[diff][:1 << 16]), to_numpy(b[diff][:1 << 16])
    return max(abs(int(x) - int(y)) for x, y in zip(ua, ub))


def wide_cases(dev, gen, n: int) -> list:
    """(name, label, kernel call, plain call) of each 64-bit build at ``n``
    lanes: both rss_gate modes, ks_prefix and a2b at width 64 and at the
    coin's width 18, and_fold at widths 64 and 32, bit2a."""
    from repro_torch.kernels.a2b_fused import a2b_kernel, a2b_plain, bit2a_kernel, bit2a_plain
    from repro_torch.kernels.ks_prefix import and_fold, and_fold_plain, fold_shifts, ks_prefix, ks_prefix_plain, ks_shifts
    from repro_torch.kernels.rss_gate import gate, gate_plain

    def w(*shape):
        return words64(gen, shape, dev)

    cases = []
    for boolean in (True, False):
        args = (w(3, n), w(3, n), w(3, n))
        cases.append(("rss_gate", f"bool={int(boolean)}", lambda a=args, b=boolean: gate(*a, b),
                      lambda a=args, b=boolean: gate_plain(*a, b)))
    for width in (64, 18):
        sh = ks_shifts(width)
        args = (w(3, n), w(3, n), w(3, 2 * len(sh), n))
        cases.append(("ks_prefix", f"width={width}", lambda a=args, sh=sh: ks_prefix(*a, sh),
                      lambda a=args, sh=sh: ks_prefix_plain(*a, sh)))
    for width in (64, 32):
        sh = fold_shifts(width)
        args = (w(3, n), w(3, len(sh), n))
        cases.append(("and_fold", f"width={width}", lambda a=args, sh=sh: and_fold(*a, sh),
                      lambda a=args, sh=sh: and_fold_plain(*a, sh)))
    for width in (64, 18):
        sh = ks_shifts(width)
        args = (w(3, n), w(3, 2 * (1 + 2 * len(sh)), n))
        cases.append(("a2b_fused", f"width={width}", lambda a=args, sh=sh: a2b_kernel(*a, sh),
                      lambda a=args, sh=sh: a2b_plain(*a, sh)))
    args = (w(3, n), w(3, 2, n))
    cases.append(("bit2a_fused", "", lambda a=args: bit2a_kernel(*a), lambda a=args: bit2a_plain(*a)))
    return cases


def wide_kernel_checks(dev, gen) -> dict:
    """Each 64-bit build against its plain version on the card at 2^24 lanes
    and at an odd lane count; one launch of the ``_u64`` build, none of the
    32-bit one; the 32-bit-only kernels refuse int64 planes."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.bitonic_stage import stage_swap
    from repro_torch.kernels.shuffle_gather import shuffle_gather

    errs = dict.fromkeys(WIDE_KERNELS, 0)
    for n in (RING64_LANES, RING64_ODD):
        for name, label, kernel, plain in wide_cases(dev, gen, n):
            reset_launch_counts()
            got = kernel()
            torch.cuda.synchronize()
            launched = launch_counts()
            check(launched == {name + "_u64": 1}, f"{name} u64 {label} n={n} launched {launched}")
            err = max_abs_err64(got, plain())
            print(f"  {name + '_u64':<16} {label:<9} n={n:>9}  max_abs_err={err}")
            check(err == 0, f"{name} u64 {label} n={n} differs from its plain version")
            errs[name] = max(errs[name], err)
            del got
        torch.cuda.empty_cache()
    reset_launch_counts()
    wide = words64(gen, (3, 8, 2), dev)
    for label, call in (("shuffle_gather", lambda: shuffle_gather(wide, torch.arange(8, device=dev))),
                        ("bitonic_swap", lambda: stage_swap(wide[:, 0], wide, wide, wide))):
        try:
            call()
        except TypeError as exc:
            check("ring-32" in str(exc), f"{label} refused an int64 plane with {exc}")
            print(f"  {label}: an int64 plane raises TypeError ({exc})")
        else:
            raise SmokeFailure(f"{label} took an int64 plane")
    return errs


def ring64_inputs(n: int, seed: int = 3):
    """x, y: numpy uint64 values with the ring's edges (0, 2^63 - 1, 2^63,
    2^64 - 1) and some equal lanes; c: a public constant at 2^63."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**64, n, dtype=np.uint64)
    y = rng.integers(0, 2**64, n, dtype=np.uint64)
    edges = np.array([0, 2**63 - 1, 2**63, 2**64 - 1], dtype=np.uint64)
    x[:4], y[4:8] = edges, edges
    y[8:n:7] = x[8:n:7]
    return x, y, 2**63


def ring64_circuits(dev, n: int):
    """(name -> (call, plaintext answer)) of the ring-64 circuits over shares
    of n values (b2a over n // 64 values: as many bit lanes)."""
    import numpy as np

    from repro_torch.core import circuits as c
    from repro_torch.core import sharing as sh
    from repro_torch.core import threefry
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.ring import RING64

    x, y, cst = ring64_inputs(n)
    prf = setup_prf(threefry.PRNGKey(1))
    xb = sh.share_b(x, threefry.PRNGKey(2), dev, RING64)
    yb = sh.share_b(y, threefry.PRNGKey(3), dev, RING64)
    xa = sh.share_a(x, threefry.PRNGKey(4), dev, RING64)
    ya = sh.share_a(y, threefry.PRNGKey(5), dev, RING64)
    small = max(n // 64, 1)
    xs = sh.share_b(x[:small], threefry.PRNGKey(6), dev, RING64)
    one = np.uint64(1)
    return {
        "lt_public": (lambda: c.lt_public(xb, cst, prf), x < np.uint64(cst)),
        "lt": (lambda: c.lt(xb, yb, prf), x < y),
        "eq": (lambda: c.eq(xb, yb, prf), x == y),
        "ks_add": (lambda: c.ks_add(xb, yb, prf), x + y),
        "a2b": (lambda: c.a2b(xa, prf), x),
        "b2a": (lambda: c.b2a(xs, prf), x[:small]),
        "bit2a": (lambda: c.bit2a(xb.and_public(1), prf), x & one),
        "mul": (lambda: sh.mul(xa, ya, prf), x * y),
        "and": (lambda: sh.and_(xb, yb, prf), x & y),
    }


def _ledger_tally(fn):
    from repro_torch.core.ledger import CommLedger

    with CommLedger() as led:
        out = fn()
    return out, [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


def ring64_phase(dev, lanes: int = RING64_LANES) -> dict:
    """The ring-64 circuits at ``lanes`` lanes on the card, fused and gate by
    gate (identical shares and ledgers, answers equal to numpy uint64), the
    launches of each; then n = 4,096 on the card and on the CPU. On the CPU
    (a rehearsal) the launch checks are skipped: a CPU tensor launches
    nothing."""
    import numpy as np
    import torch

    from repro_torch.core.ring import to_numpy
    from repro_torch.core.sharing import AShare, reveal_a, reveal_b
    from repro_torch.kernels import launch_counts, override_fusion, reset_launch_counts

    total: dict = {}
    rows = {}
    on_card = dev.type == "cuda"
    with np.errstate(over="ignore"):
        circuits = ring64_circuits(dev, lanes)
    for name, (call, want) in circuits.items():
        fused_launches, gate_launches = RING64_CIRCUITS[name]
        runs = {}
        for path, fuse in (("fused", True), ("gates", False)):
            _sync(dev)
            reset_launch_counts()
            t0 = time.perf_counter()
            with override_fusion(fuse):
                out, ledger = _ledger_tally(call)
            _sync(dev)
            seconds = time.perf_counter() - t0
            launches = launch_counts()
            reset_launch_counts()
            expect = fused_launches if fuse else {"rss_gate_u64": gate_launches}
            # the draws: 32-bit words, widened, so threefry_bits has no 64-bit build
            circuit = {k: v for k, v in launches.items() if k != "threefry_bits"}
            check(circuit == expect and launches.get("threefry_bits", 0) > 0 or not on_card,
                  f"ring-64 {name} {path}: launches {launches}, expected {expect} and draws")
            _add(total, launches)
            runs[path] = (out, ledger, seconds, launches)
        (fout, fled, fs, fl), (gout, gled, gs, gl) = runs["fused"], runs["gates"]
        check(bool(torch.equal(fout.shares, gout.shares)), f"ring-64 {name}: fused and gate-by-gate shares differ")
        check(fled == gled, f"ring-64 {name}: fused and gate-by-gate ledgers differ")
        check(fout.shares.dtype == torch.int64, f"ring-64 {name}: the output is not int64")
        opened = to_numpy(reveal_a(fout) if isinstance(fout, AShare) else reveal_b(fout))
        check(bool((opened == want.astype(np.uint64)).all()), f"ring-64 {name}: the answer differs from numpy uint64")
        print(f"  ring-64 {name:<9} {fout.size:>9} lanes: fused {fs:.4f} s {fl}, gate by gate {gs:.4f} s {gl}; "
              f"shares and ledger identical, answer = numpy uint64")
        rows[name] = {"lanes": fout.size, "fused_s": fs, "gates_s": gs, "fused_launches": fl, "gates_launches": gl}
        del fout, gout, runs
    del circuits
    if on_card:
        torch.cuda.empty_cache()
        missing = [k for k in WIDE_KERNELS if not total.get(k + "_u64", 0)]
        check(not missing, f"ring-64: {missing} never launched their 64-bit build")

    # n = 4,096: identical on the card and on the CPU, both paths
    with np.errstate(over="ignore"):
        on = {"dev": ring64_circuits(dev, RING64_SMALL), "cpu": ring64_circuits(torch.device("cpu"), RING64_SMALL)}
    for name in RING64_CIRCUITS:
        for fuse in (True, False):
            with override_fusion(fuse):
                gout, gled = _ledger_tally(on["dev"][name][0])
                cout, cled = _ledger_tally(on["cpu"][name][0])
            check(bool((to_numpy(gout.shares) == to_numpy(cout.shares)).all()) and gled == cled,
                  f"ring-64 {name} n={RING64_SMALL} {'fused' if fuse else 'gates'}: {dev.type} and cpu differ")
    reset_launch_counts()
    print(f"  ring-64 n={RING64_SMALL}: all {len(RING64_CIRCUITS)} circuits identical on {dev.type} and cpu (shares "
          f"and ledger), fused and gate by gate")
    return {"circuits": rows, "launches": total}


def wide_cost(name: str, n: int, levels: int, boolean: bool = True) -> tuple:
    """(bytes, 32-bit integer instructions) one call of a 64-bit build must
    move and issue over n lanes: every input word read once, the output
    written once (8 bytes a word); each 64-bit AND, XOR, add or shift is two
    32-bit instructions, and a 64-bit multiply three (the low product,
    widened, and the two cross halves: ``tools/sass_mix.py`` counts them in
    the built library)."""
    if name == "rss_gate":  # x, y, alpha in; z out. Per share word: 3 ANDs + 3 XORs, or 3 products + 3 sums
        return 12 * 8 * n, 3 * (12 if boolean else 9 + 6) * n
    if name == "bit2a_fused":  # 19 operations a share word, 6 of them products
        return 96 * n, 3 * (6 * 3 + 13 * 2) * n
    bytes_moved, ops = fused_cost(name, n, levels)
    return 2 * bytes_moved, 2 * ops


def time_wide(dev, gen) -> dict:
    """The 64-bit builds at the ring-64 circuits' shapes (2^24 lanes, width
    64), beside their plain versions and bounds, as phase 4 times the
    32-bit ones."""
    import torch

    out: dict = {}
    for name, label, kernel, plain in wide_cases(dev, gen, RING64_LANES):
        if "width=18" in label or "width=32" in label:
            continue
        err = max_abs_err64(kernel(), plain())
        check(err == 0, f"{name} u64 {label} differs from its plain version")
        ms = median_ms(kernel)
        plain_ms = median_ms(plain, PLAIN_REPS)
        levels = {"ks_prefix": 6, "and_fold": 6, "a2b_fused": 6}.get(name, 0)
        bytes_moved, ops = wide_cost(name, RING64_LANES, levels, "bool=1" in label)
        bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
        by = "bytes" if bytes_moved / HBM_BYTES_PER_S >= ops / INT32_OPS_PER_S else "operations"
        out.setdefault(name, []).append({
            "n": RING64_LANES, "label": label, "bytes": bytes_moved, "ops": ops, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err})
        print(f"  {name + '_u64':<16} {label:<9} n={RING64_LANES}: {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({by}, {bytes_moved / 2**20:.1f} MiB, {ops / 1e9:.2f} G instructions), "
              f"{100 * bound_ms / ms:.1f} % of the bound")
        torch.cuda.empty_cache()
    return out


def sortcut_modes(n: int) -> dict:
    """The paper's four modes (``benchmarks/bench_healthlnk.py:38-45``):
    mode -> ResizerConfig, None for no Resizer."""
    from repro_torch.core.noise import RevealNoise, TruncatedLaplace
    from repro_torch.core.resizer import ResizerConfig

    tlap = TruncatedLaplace(eps=0.5, delta=5e-5, sensitivity=n // 8)
    return {
        "fully_oblivious": None,
        "sortcut": ResizerConfig(noise=tlap, addition="sequential", use_sort=True),
        "reflex": ResizerConfig(noise=tlap, addition="parallel"),
        "revealed": ResizerConfig(noise=RevealNoise()),
    }


def sortcut_plan(query: str, tables: dict, plain: dict, cfg, join_algo: str = "sortmerge"):
    """``query`` from its SQL over phase 3's catalog, with ``cfg`` on every
    internal operator (none when ``cfg`` is None)."""
    from repro_torch.data import QUERY_SQL
    from repro_torch.sql import compile_query

    catalog = pid_catalog(tables, plain)
    if cfg is None:
        return compile_query(QUERY_SQL[query], catalog, placement="none", join_algo=join_algo)
    return compile_query(QUERY_SQL[query], catalog, placement="all_internal", cfg_factory=lambda node: cfg,
                         join_algo=join_algo)


def sortcut_phase(dev, n: int, product_n: int) -> dict:
    """The four modes over the sort-merge ``dosage_study`` and
    ``aspirin_count`` at n rows per table (and the product-join
    ``dosage_study`` at ``product_n`` under sort&cut), each answer equal to
    the oracle; then the n=48 quickstart plan under sort&cut, identical on
    cuda and cpu and gate by gate. On the CPU (a rehearsal) the launch
    checks and the cross-device run are skipped."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.data import all_query_plans, generate_healthlnk, plaintext_oracle, revealed_answer
    from repro_torch.engine import Engine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.plan import insert_resizers

    results, total = {}, {}
    on_card = dev.type == "cuda"
    data = {rows: generate_healthlnk(n=rows, seed=0, device=dev) for rows in (n, product_n)}
    plans = []
    for query in SORTCUT_QUERIES:
        for mode, cfg in sortcut_modes(n).items():
            tables, plain = data[n]
            plans.append((f"{query} {mode}", query, n, sortcut_plan(query, tables, plain, cfg), mode))
    cfg = sortcut_modes(product_n)["sortcut"]
    plans.append((f"dosage_study sortcut, product join n={product_n}", "dosage_study", product_n,
                  insert_resizers(all_query_plans()["dosage_study"], lambda node: cfg, placement="all_internal"),
                  "sortcut"))
    for label, query, rows, plan, mode in plans:
        tables, plain = data[rows]
        engine = Engine(tables, key=threefry.PRNGKey(5), bucket_fn=pow2, device=dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        reset_launch_counts()
        t0 = time.perf_counter()
        out, report = engine.execute(plan)
        _sync(dev)
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        reset_launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        got = revealed_answer(query, plan, out)
        want = plaintext_oracle(query, plain)
        check(got == want, f"{label}: the result {got} differs from the plaintext oracle {want}")
        heavy = max(report.nodes, key=lambda s: s.seconds)
        resizes = [(s.extra["s"], s.extra["n"]) for s in report.nodes if "s" in s.extra and "n" in s.extra]
        if mode == "sortcut":
            check(resizes and (launches.get("bitonic_swap", 0) > 0 or not on_card),
                  f"{label}: no sort&cut Resize sorted ({launches})")
            check(all(m & (m - 1) == 0 for _, m in resizes), f"{label}: a sort&cut Resize did not pad to 2^k")
        size = got if isinstance(got, int) else len(got)
        print(f"  {label}: {seconds:.3f} s, heaviest {heavy.node} {heavy.seconds:.3f} s, peak "
              f"{peak / 2**30:.2f} GiB; Resize (S, padded n) {resizes}; answer {size} = oracle; launches {launches}")
        _add(total, launches)
        results[label] = {"query": query, "mode": mode, "n": rows, "seconds": seconds, "peak_bytes": peak,
                          "heaviest": [heavy.node, heavy.seconds], "resizes": resizes, "launches": launches,
                          "nodes": node_rows(report)}
    if on_card:
        for kernel in KERNELS:
            check(total.get(kernel, 0) > 0, f"sort&cut runs: {kernel} never launched ({total})")
        sortcut_cross_device(dev)
    return {"runs": results, "launches": total}


def sortcut_cross_device(dev) -> None:
    """The n=48 quickstart plan with sort&cut Resizers on every internal
    operator: identical on cuda and cpu, and gate by gate on cuda."""
    import numpy as np

    from repro_torch.core import threefry
    from repro_torch.ops import SecretTable
    from repro_torch.plan import insert_resizers

    rng = np.random.default_rng(7)
    n = 48
    patients = {"pid": rng.integers(0, 12, n).astype(np.uint32), "icd9": rng.choice([390, 401, 414], n).astype(np.uint32)}
    meds = {"pid2": rng.integers(0, 12, n).astype(np.uint32), "med": rng.choice([1, 2, 3], n).astype(np.uint32)}

    def tables(d):
        return {"diagnoses": SecretTable.from_plaintext(patients, threefry.PRNGKey(0), device=d),
                "medications": SecretTable.from_plaintext(meds, threefry.PRNGKey(1), device=d)}

    cfg = sortcut_modes(n)["sortcut"]
    plan = insert_resizers(quickstart_plan("pid2"), lambda node: cfg, placement="all_internal")
    out, report = three_ways(dev, "quickstart n=48 sort&cut", tables, plan, 42, "sortcut")
    pids = sorted(set(out.reveal_true_rows()["pid"].tolist()))
    check(pids == [1, 2, 4, 6, 8, 9, 11], f"quickstart sort&cut rows {pids}")
    sizes = [(s.extra["s"], s.extra["n"]) for s in report.nodes if "s" in s.extra]
    print(f"  quickstart n=48 sort&cut: shares, ledgers and (S, padded n)={sizes} identical on cuda and cpu (fused) "
          f"and on cuda gate by gate; rows {pids}")


# ---------------------------------------------------------------------------
# 11. the LM side's serving path (models, configs, serve)
# ---------------------------------------------------------------------------

# f32 cross-device tolerances (the CPU tests' against JAX): attention, dense
# and MoE families; the recurrent ones
LM_F32_TOL = 1e-4
LM_RECURRENT_TOL = 5e-3
LM_RECURRENT = ("recurrentgemma_9b", "xlstm_1_3b")
# bf16 compute at full width: serve-step logits against forward's (logits of
# order 4; a wrong position or cache gives errors of 0.2 to 3): the largest
# |difference| and the mean |difference| over all logits compared
LM_BF16_MAX = 0.25
LM_BF16_MEAN = 0.02
LM_SEED = 20
LM_REQUESTS = 8
LM_PROMPT_LENGTHS = (40, 500)
LM_LEN_BUCKETS = (128, 256, 512)
LM_BATCH_BUCKETS = (1, 2, 4, 8)
LM_NEW_TOKENS = 16
LM_SEQ = 128  # forward at full width: B = 2, S = 128
LM_STEPS = 4  # serve steps from empty caches against forward
LM_SERVED = "stablelm_1_6b"
# the served model's depth: full width, 4 of its 24 layers. At full depth
# feeding the buckets' 896 positions one serve step at a time (about 43 ms a
# step, host-bound) took 43 s of the script's time limit; phases 12 and 13
# run the uncut model
LM_SERVED_LAYERS = 4
LM_EXCUSED = {
    "arctic_480b": "one layer at full width holds 53.6 GB of f32 expert weights plus 26.8 GB of per-call "
                   "bf16 casts, more than the card's 80 GB: it waits for the sharding slice",
}


def served_config():
    """``LM_SERVED`` at full width, cut to ``LM_SERVED_LAYERS`` layers."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(LM_SERVED), n_layers=LM_SERVED_LAYERS)


def _lm_batch(cfg, rng, b: int, s: int, dev) -> dict:
    """A seeded batch of ``s`` positions: tokens, frame embeddings (musicgen)
    or an image prefix of ``n_prefix`` patch embeddings and ``s`` tokens
    (paligemma)."""
    import torch

    out = {}
    if cfg.input_mode == "embeddings":
        n_emb = cfg.n_prefix if cfg.prefix_lm and cfg.n_prefix else s
        out["embeds"] = torch.from_numpy(rng.standard_normal((b, n_emb, cfg.d_model)).astype("float32")).to(dev)
        if not (cfg.prefix_lm and cfg.n_prefix):
            return out
    out["tokens"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype("int32")).to(dev)
    return out


def _lm_step_input(cfg, rng) -> dict:
    """One seeded decode step's input on the CPU: a token, or a frame
    embedding (musicgen)."""
    import torch

    if cfg.input_mode == "embeddings" and not (cfg.prefix_lm and cfg.n_prefix):
        return {"embeds": torch.from_numpy(rng.standard_normal((2, 1, cfg.d_model)).astype("float32"))}
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)).astype("int32"))}


def _lm_steps(b: dict, t: int) -> dict:
    """Position ``t`` of a batch as one serve step's input."""
    return {k: v[:, t : t + 1] for k, v in b.items()}


def _tree_err(a: dict, b: dict) -> float:
    from repro_torch.models.lm import tree_items

    worst = 0.0
    for (pa, ta), (pb, tb) in zip(tree_items(a), tree_items(b)):
        check(pa == pb and ta.shape == tb.shape and ta.dtype == tb.dtype, f"cache trees differ at {pa} / {pb}")
        worst = max(worst, float((ta.double().cpu() - tb.double().cpu()).abs().max()) if ta.numel() else 0.0)
    return worst


def _to(tree, dev):
    from repro_torch.models.lm import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def lm_cross_device(dev) -> dict:
    """All ten reduced architectures in f32 with TF32 off: ``forward``,
    ``prefill`` and eight decode steps on ``dev`` equal to the CPU's."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import decode_step, forward, init_caches, init_params
    from repro_torch.serve import prefill

    cpu = torch.device("cpu")
    out = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_config(arch).reduced()
        tol = LM_RECURRENT_TOL if arch in LM_RECURRENT else LM_F32_TOL
        p_cpu = init_params(cfg, torch.Generator().manual_seed(LM_SEED + i), device="cpu")
        p_dev = _to(p_cpu, dev)
        b_cpu = _lm_batch(cfg, np.random.default_rng(LM_SEED + i), 2, 20, cpu)
        b_dev = _to(b_cpu, dev)
        errs = {}
        with torch.no_grad():
            errs["forward"] = float((forward(cfg, p_dev, b_dev)[0].cpu() - forward(cfg, p_cpu, b_cpu)[0]).abs().max())
            (la, ca), (lb, cb) = prefill(cfg, p_dev, b_dev), prefill(cfg, p_cpu, b_cpu)
            errs["prefill"] = max(float((la.cpu() - lb).abs().max()), _tree_err(ca, cb))
            c_dev, c_cpu = init_caches(cfg, 2, 12, device=dev), init_caches(cfg, 2, 12, device="cpu")
            step_rng = np.random.default_rng(LM_SEED + 100 + i)
            worst = 0.0
            for _ in range(8):
                s_cpu = _lm_step_input(cfg, step_rng)
                (ld, c_dev), (lc, c_cpu) = decode_step(cfg, p_dev, c_dev, _to(s_cpu, dev)), decode_step(cfg, p_cpu, c_cpu, s_cpu)
                worst = max(worst, float((ld.cpu() - lc).abs().max()))
            errs["decode"] = max(worst, _tree_err(c_dev, c_cpu))
        out[arch] = errs
        check(all(e <= tol for e in errs.values()), f"{arch} reduced: {dev} against cpu {errs} above {tol}")
        print(f"  {arch:18s} reduced f32, {dev} vs cpu max |diff|: forward {errs['forward']:.3g}, "
              f"prefill {errs['prefill']:.3g}, 8 decode steps {errs['decode']:.3g} (tolerance {tol:g})")
    return out


def _logit_errs(got, want) -> tuple:
    d = (got.float() - want.float()).abs()
    return float(d.max()), float(d.mean())


def _check_bf16(label: str, got, want) -> tuple:
    import torch

    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()), f"{label}: non-finite logits")
    mx, mean = _logit_errs(got, want)
    check(mx <= LM_BF16_MAX and mean <= LM_BF16_MEAN,
          f"{label}: max |diff| {mx:.4f} (limit {LM_BF16_MAX}), mean {mean:.5f} (limit {LM_BF16_MEAN})")
    return mx, mean


def _peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else float("nan")


def _reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def lm_serve_phase(dev, card: str, cfg=None, requests: int = LM_REQUESTS, lengths=LM_PROMPT_LENGTHS,
                   len_buckets=LM_LEN_BUCKETS, new_tokens: int = LM_NEW_TOKENS) -> dict:
    """``stablelm_1_6b`` at full width, cut in depth to ``LM_SERVED_LAYERS``
    layers: seeded requests through ``BucketedBatcher``, drained lot by lot.
    Per lot: the prefill step's next-token logits; the serve step over
    ``init_caches(B, bucket + new)`` fed the bucket's tokens, each
    position's logits against ``forward``'s and the last one against the
    prefill step; then greedy decoding."""
    import numpy as np
    import torch

    from repro_torch.models import forward, init_caches, init_params
    from repro_torch.models.lm import tree_items
    from repro_torch.serve import BucketedBatcher, make_prefill_step, make_serve_step

    cfg = cfg or served_config()
    t_phase = time.perf_counter()
    _reset_peak(dev)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_items(params))
    rng = np.random.default_rng(LM_SEED)
    batcher = BucketedBatcher(len_buckets=len_buckets, batch_buckets=LM_BATCH_BUCKETS)
    lens = rng.integers(lengths[0], lengths[1] + 1, requests)
    for n in lens:
        batcher.submit(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32))
    print(f"  {cfg.name}: {n_params:,} parameters ({4 * n_params / 1e9:.2f} GB f32), {cfg.dtype} compute, "
          f"initialised on {dev} in {init_s:.2f} s; prompts {sorted(lens.tolist())}")
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    lots, largest = [], None
    while batcher.n_pending:
        lot, ids = batcher.next_batch(max_batch=requests)
        toks = torch.from_numpy(lot["tokens"]).to(dev)
        b, n = toks.shape
        prefill_step(params, {"tokens": toks})  # warm-up at this shape
        _sync(dev)
        t0 = time.perf_counter()
        last = prefill_step(params, {"tokens": toks})
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        with torch.no_grad():
            full, _ = forward(cfg, params, {"tokens": toks})
        caches = init_caches(cfg, b, n + new_tokens, device=dev)
        fed = torch.empty((b, n, cfg.vocab_size), dtype=torch.float32, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        for t in range(n):
            lg, caches = serve_step(params, caches, {"tokens": toks[:, t : t + 1]})
            fed[:, t] = lg[:, 0]
        _sync(dev)
        fed_s = time.perf_counter() - t0
        tok = fed[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(new_tokens):
            lg, caches = serve_step(params, caches, {"tokens": tok})
            tok = lg[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            generated.append(tok)
        _sync(dev)
        decode_s = time.perf_counter() - t0
        check(bool(torch.isfinite(lg).all()), f"lot {ids}: non-finite logits in greedy decoding")
        check(int(caches["0"]["idx"][0]) == n + new_tokens, f"lot {ids}: cache index {caches['0']['idx']}")
        fed_err = _check_bf16(f"lot {ids}: serve step against forward", fed, full)
        last_err = _check_bf16(f"lot {ids}: last fed position against the prefill step", fed[:, -1:], last)
        gen_ids = torch.cat(generated, 1).cpu()
        check(bool(((gen_ids >= 0) & (gen_ids < cfg.vocab_size)).all()), f"lot {ids}: token out of range")
        row = {"ids": ids, "batch": b, "bucket": n, "prompt_lens": [int(lens[i]) for i in ids],
               "prefill_s": prefill_s, "prefill_tokens_per_s": b * n / prefill_s,
               "fed_ms_per_step": 1e3 * fed_s / n, "decode_ms_per_step": 1e3 * decode_s / new_tokens,
               "fed_max_err": fed_err[0], "fed_mean_err": fed_err[1], "last_vs_prefill_max_err": last_err[0]}
        lots.append(row)
        print(f"  lot {ids}: B={b} bucket {n}: prefill {row['prefill_tokens_per_s']:,.0f} tokens/s "
              f"({prefill_s * 1e3:.2f} ms); serve step fed {row['fed_ms_per_step']:.3f} ms/step, greedy "
              f"{row['decode_ms_per_step']:.3f} ms/step over {new_tokens}; vs forward max |diff| {fed_err[0]:.4f} "
              f"mean {fed_err[1]:.5f}, last vs prefill {last_err[0]:.4f} [{card}]")
        del full, fed, caches
        if largest is None or b * n > largest.numel():
            largest = toks
    peak = _peak_gib(dev)
    seconds = time.perf_counter() - t_phase
    print(f"  {cfg.name} served {requests} requests in {len(lots)} lots: peak {peak:.2f} GiB, {seconds:.1f} s [{card}]")
    profiled = None
    if dev.type == "cuda":
        # where a step's time goes: device busy share of one serve step and
        # one prefill step at the largest lot's shape
        b, n = largest.shape
        caches = init_caches(cfg, b, n + new_tokens, device=dev)
        one = {"tokens": largest[:, :1]}
        profiled = {
            "serve_step": _profile_window(f"one serve step, B={b}, cache {n + new_tokens} [{card}]",
                                          lambda: serve_step(params, caches, one)),
            "prefill_step": _profile_window(f"one prefill step, B={b} x {n} tokens [{card}]",
                                            lambda: prefill_step(params, {"tokens": largest})),
        }
    del params
    return {"arch": cfg.name, "params": n_params, "init_s": init_s, "lots": lots, "peak_gib": peak,
            "seconds": seconds, "profile": profiled}


def lm_cut(cfg):
    """Full width, cut in depth to one group of the pattern (at least two
    layers: recurrentgemma 19, xlstm 8, the others 2)."""
    import dataclasses

    period = cfg.pattern_period
    return dataclasses.replace(cfg, n_layers=period if period > 1 else 2)


class _DropCounter:
    """Counts the MoE router's kept and dropped assignments while active."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.route = moe, moe._route
        self.assigned = self.dropped = 0
        self.capacity = None

        def counting(params, cfg, xt):
            out = self.route(params, cfg, xt)
            pos, cap = out[2], out[3]
            self.assigned += pos.numel()
            self.dropped += int((pos >= cap).sum())
            self.capacity = cap
            return out

        moe._route = counting
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route


def _serve_vs_forward(cfg, params, b: dict, steps: int, dev):
    """``steps`` serve steps from empty caches against ``forward`` on the
    same ``steps`` inputs: (serve logits, forward logits)."""
    import torch

    from repro_torch.models import forward, init_caches
    from repro_torch.serve import make_serve_step

    serve_step = make_serve_step(cfg)
    first = {k: v[:, :steps] for k, v in b.items()}
    with torch.no_grad():
        full, _ = forward(cfg, params, first)
    caches = init_caches(cfg, 2, steps, device=dev)
    outs = []
    for t in range(steps):
        lg, caches = serve_step(params, caches, _lm_steps(first, t))
        outs.append(lg)
    return torch.cat(outs, 1), full


def lm_zoo_phase(dev, card: str, cut=lm_cut, seq: int = LM_SEQ, steps: int = LM_STEPS) -> dict:
    """Every other architecture at full width, cut in depth by ``cut``:
    ``forward`` at B = 2, S = ``seq``; ``steps`` serve steps from empty caches
    against ``forward`` (xlstm: finite, and finding (b)'s gap); mixtral under
    the four capacity policies; stablelm chunked against dense, and with the
    int8 KV cache and bf16 decode scores."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import forward, init_params
    from repro_torch.models.lm import tree_items

    out = {}
    for i, arch in enumerate(ARCH_IDS):
        if arch in LM_EXCUSED:
            print(f"  {arch}: left out: {LM_EXCUSED[arch]}")
            out[arch] = {"left_out": LM_EXCUSED[arch]}
            continue
        cfg = cut(get_config(arch))
        t_arch = time.perf_counter()
        _reset_peak(dev)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(LM_SEED + i), device=dev)
        n_params = sum(t.numel() for _, t in tree_items(params))
        b = _lm_batch(cfg, np.random.default_rng(LM_SEED + i), 2, seq, dev)
        with torch.no_grad():
            forward(cfg, params, b)  # warm-up
            _sync(dev)
            t0 = time.perf_counter()
            logits, aux = forward(cfg, params, b)
            _sync(dev)
        fwd_ms = 1e3 * (time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux)), f"{arch}: non-finite forward")
        row = {"layers": cfg.n_layers, "params": n_params, "forward_ms": fwd_ms,
               "forward_shape": list(logits.shape)}
        del logits
        # decode computes causal attention: paligemma's prefix mask is bidirectional
        # over its first n_prefix positions, so its reference is the causal forward
        ref_cfg = dataclasses.replace(cfg, prefix_lm=False) if cfg.prefix_lm else cfg
        steps_b = {"tokens": b["tokens"]} if cfg.prefix_lm else b
        if cfg.ffn_type == "moe":
            # no drops in either (decode routes B tokens, forward B x steps):
            # the comparison is of attention and caches
            ref_cfg = dataclasses.replace(ref_cfg, capacity_policy="full")
        served, full = _serve_vs_forward(ref_cfg, params, steps_b, steps, dev)
        if arch == "xlstm_1_3b":
            check(bool(torch.isfinite(served).all()), f"{arch}: non-finite serve-step logits")
            row["finding_b_gap"] = _logit_errs(served, full)[0]
            note = f"finding (b): serve steps vs forward max |diff| {row['finding_b_gap']:.4f} (the reference's gap)"
        else:
            row["serve_max_err"], row["serve_mean_err"] = _check_bf16(f"{arch}: serve steps against forward",
                                                                      served, full)
            note = f"{steps} serve steps vs forward max |diff| {row['serve_max_err']:.4f} mean {row['serve_mean_err']:.5f}"
        del served, full
        if arch == "mixtral_8x7b":
            row["policies"] = lm_capacity_policies(cfg, params, b, card)
        if arch == LM_SERVED:
            row.update(lm_attention_variants(cfg, params, b, steps, dev, card))
        row["peak_gib"] = _peak_gib(dev)
        row["seconds"] = time.perf_counter() - t_arch
        print(f"  {arch:18s} {cfg.n_layers} layers, {n_params:,} parameters: forward B=2 S={_seq_len(b)} "
              f"{fwd_ms:.2f} ms; {note}; peak {row['peak_gib']:.2f} GiB, {row['seconds']:.1f} s [{card}]")
        out[arch] = row
        del params, b
    return out


def _seq_len(b: dict) -> int:
    """Positions in a batch: patch embeddings and tokens together."""
    return sum(v.shape[1] for v in b.values())


def lm_capacity_policies(cfg, params, b: dict, card: str) -> dict:
    """mixtral's forward under the four capacity policies: the capacity C,
    the share of dropped assignments, and the logits' distance from the
    fully oblivious buffer (``full``: no drops)."""
    import dataclasses

    import torch

    from repro_torch.models import forward

    rows, ref = {}, None
    for policy in ("full", "const", "reflex_tlap", "reflex_beta"):
        pcfg = dataclasses.replace(cfg, capacity_policy=policy)
        with _DropCounter() as drops, torch.no_grad():
            logits, _ = forward(pcfg, params, b)
        check(bool(torch.isfinite(logits).all()), f"mixtral {policy}: non-finite logits")
        ref = logits if ref is None else ref
        share = drops.dropped / max(drops.assigned, 1)
        rows[policy] = {"capacity": drops.capacity, "dropped": drops.dropped, "assigned": drops.assigned,
                        "dropped_share": share, "max_err_vs_full": _logit_errs(logits, ref)[0]}
        print(f"    capacity_policy={policy:11s}: C={drops.capacity} of {_seq_len(b) * 2} tokens, dropped "
              f"{drops.dropped}/{drops.assigned} assignments ({100 * share:.2f} %), logits vs full max |diff| "
              f"{rows[policy]['max_err_vs_full']:.4f} [{card}]")
        del logits
    check(rows["full"]["dropped"] == 0, "the fully oblivious capacity dropped an assignment")
    return rows


def lm_attention_variants(cfg, params, b: dict, steps: int, dev, card: str) -> dict:
    """stablelm: chunked attention against dense, and the int8 KV cache with
    bf16 decode scores against forward."""
    import dataclasses

    import torch

    from repro_torch.models import forward

    chunked = dataclasses.replace(cfg, attn_impl="chunked", attn_chunk=_seq_len(b) // 4)
    with torch.no_grad():
        dense_logits, _ = forward(cfg, params, b)
        chunked_logits, _ = forward(chunked, params, b)
    chunk_err = _check_bf16("stablelm chunked against dense", chunked_logits, dense_logits)
    del dense_logits, chunked_logits
    quant = dataclasses.replace(cfg, kv_quant=True, decode_score_dtype="bf16")
    served, full = _serve_vs_forward(quant, params, b, steps, dev)
    check(bool(torch.isfinite(served).all()), "stablelm kv_quant: non-finite logits")
    quant_err = _logit_errs(served, full)
    print(f"    stablelm attn_impl=chunked ({chunked.attn_chunk}-key chunks) vs dense max |diff| {chunk_err[0]:.4f}; "
          f"kv_quant int8 + bf16 decode scores, {steps} serve steps vs forward max |diff| {quant_err[0]:.4f} "
          f"mean {quant_err[1]:.5f} [{card}]")
    return {"chunked_max_err": chunk_err[0], "kv_quant_max_err": quant_err[0], "kv_quant_mean_err": quant_err[1]}


def lm_phase(dev, card: str) -> dict:
    """Phase 11: cross-device at the reduced configs, then stablelm served at
    full width (cut in depth), then the other architectures at full width."""
    import torch

    t_phase = time.perf_counter()
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # no TF32 in the f32 comparisons
    try:
        print("  cross-device: the ten reduced architectures, f32, TF32 off")
        cross = lm_cross_device(dev)
    finally:
        torch.set_float32_matmul_precision(precision)
    print(f"  {LM_SERVED} at full width, {LM_SERVED_LAYERS} of its layers: {LM_REQUESTS} requests of {LM_PROMPT_LENGTHS[0]}-"
          f"{LM_PROMPT_LENGTHS[1]} tokens, BucketedBatcher{LM_LEN_BUCKETS}x{LM_BATCH_BUCKETS}, "
          f"{LM_NEW_TOKENS} greedy tokens each")
    served = lm_serve_phase(dev, card)
    print(f"  every other architecture at full width, one group of its pattern: forward B=2 S={LM_SEQ}, "
          f"{LM_STEPS} serve steps from empty caches")
    zoo = lm_zoo_phase(dev, card)
    seconds = time.perf_counter() - t_phase
    print(f"  phase 11 in {seconds:.1f} s [{card}]")
    return {"cross_device": cross, "served": served, "zoo": zoo, "seconds": seconds}


# ---------------------------------------------------------------------------
# 12. the LM side's training path
# ---------------------------------------------------------------------------

# the trained architecture, uncut, and its batches: 4 x 512 tokens from
# TokenPipeline, f32 masters, bf16 compute, remat as its config has it
TRAIN_ARCH = "stablelm_1_6b"
TRAIN_BATCH = 4
TRAIN_SEQ = 512
TRAIN_STEPS = 3
TRAIN_SEED = 21
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak
BF16_FLOPS_PER_S = 989e12
# the launcher's failure drill (tests/test_torch_train_launch.py) on the card
DRILL_ARGS = ["--arch", "stablelm-1.6b", "--reduced", "--batch", "2", "--seq", "16", "--steps", "10",
              "--ckpt-every", "5", "--log-every", "1"]
TRAIN_EXCUSED = ("a checkpoint at full width is left out: params and the two AdamW moments are 19.7 GB of f32 "
                 "to write to disk per save; the drill saves and restores the reduced config on the card")


def _scaled_err(want: dict, got: dict) -> float:
    """max over leaves of max|got - want| / max(1, max|want|) (the training
    tests' per-leaf rule), with every leaf of ``got`` finite."""
    import torch

    from repro_torch.models.lm import tree_items

    worst = 0.0
    for (pa, w), (pb, g) in zip(tree_items(want), tree_items(got)):
        check(pa == pb and w.shape == g.shape and w.dtype == g.dtype, f"trees differ at {pa} / {pb}")
        w, g = w.double().cpu(), g.double().cpu()
        check(bool(torch.isfinite(g).all()), f"non-finite values at {pb}")
        if w.numel():
            worst = max(worst, float((g - w).abs().max()) / max(1.0, float(w.abs().max())))
    return worst


def train_cross_device(dev) -> dict:
    """All ten reduced architectures in f32 with TF32 off: one train step on
    ``dev`` equal to the CPU's (loss, grads, then the parameters and AdamW
    state after the update), and remat on equal to remat off on ``dev``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.train.train_step import loss_and_grads

    cpu = torch.device("cpu")
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_config(arch).reduced()
        tol = LM_RECURRENT_TOL if arch in LM_RECURRENT else LM_F32_TOL
        p_cpu = init_params(cfg, torch.Generator().manual_seed(TRAIN_SEED + i), device="cpu")
        pipe = TokenPipeline(cfg.vocab_size, 24, 2, seed=TRAIN_SEED + i, d_model=cfg.d_model,
                             mode=cfg.input_mode, n_prefix=cfg.n_prefix)
        b_cpu = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
        p_dev, b_dev = _to(p_cpu, dev), _to(b_cpu, dev)
        l_cpu, _, g_cpu = loss_and_grads(cfg, p_cpu, b_cpu)
        l_dev, _, g_dev = loss_and_grads(cfg, p_dev, b_dev)
        step = make_train_step(cfg, opt)
        new_cpu, state_cpu, m_cpu = step(p_cpu, adamw_init(p_cpu), b_cpu)
        new_dev, state_dev, m_dev = step(p_dev, adamw_init(p_dev), b_dev)
        errs = {
            "loss": abs(float(l_dev) - float(l_cpu)) / max(1.0, abs(float(l_cpu))),
            "grads": _scaled_err(g_cpu, g_dev),
            "params": _scaled_err(new_cpu, new_dev),
            "state": _scaled_err(state_cpu, state_dev),
            "metrics": _scaled_err(m_cpu, m_dev),
        }
        l_on, _, g_on = loss_and_grads(dataclasses.replace(cfg, remat=True), p_dev, b_dev)
        errs["remat"] = max(abs(float(l_on) - float(l_dev)), _scaled_err(g_dev, g_on))
        out[arch] = errs
        check(np.isfinite(float(l_dev)) and float(m_dev["grad_norm"]) > 0, f"{arch}: loss or grad_norm")
        check(all(e <= tol for e in errs.values()), f"{arch} reduced train step: {dev} against cpu {errs} above {tol}")
        print(f"  {arch:18s} reduced f32 train step, {dev} vs cpu scaled max |diff|: loss {errs['loss']:.3g}, "
              f"grads {errs['grads']:.3g}, params {errs['params']:.3g}, AdamW state {errs['state']:.3g}; "
              f"remat on vs off {errs['remat']:.3g} (tolerance {tol:g})")
    return out


def _synced(dev, fn):
    """``fn()`` and its seconds on the host clock, ending in a synchronise."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def train_full_width(dev, card: str, cfg=None, steps: int = TRAIN_STEPS, batch: int = TRAIN_BATCH,
                     seq: int = TRAIN_SEQ) -> dict:
    """``stablelm_1_6b`` uncut (or ``cfg``, for a rehearsal at a small
    size): the first step's loss and grad norm with remat off and on (peak
    memory of each forward and backward), a grad_accum=2 step against the
    large batch, then ``steps`` AdamW steps with the config's remat:
    seconds, tokens/s and the model-FLOP share each."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.models.lm import tree_items
    from repro_torch.train import AdamWConfig, adamw_init, adamw_update, make_train_step
    from repro_torch.train.optimizer import _global_norm
    from repro_torch.train.train_step import loss_and_grads

    cfg = get_config(TRAIN_ARCH) if cfg is None else cfg
    check(cfg.remat and cfg.dtype == "bfloat16", f"{cfg.name}: remat={cfg.remat} dtype={cfg.dtype}")
    n_params = cfg.param_count()
    tokens = batch * seq
    flops = 6 * n_params * tokens
    _reset_peak(dev)
    params = init_params(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED), dev)
    state = adamw_init(params)
    _sync(dev)
    state_gib = sum(t.numel() * t.element_size() for _, t in tree_items({"p": params, "s": state})) / 2**30
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=TRAIN_SEED)
    batches = [_to({k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}, dev) for s in range(steps)]
    print(f"  {cfg.name}: {n_params:,} parameters, f32 masters and AdamW moments {state_gib:.2f} GiB, "
          f"batches {batch} x {seq}")

    opt = AdamWConfig(lr=1e-4, warmup_steps=0, total_steps=100)
    first = {}
    for remat in (False, True):
        _reset_peak(dev)
        (loss, _, grads), sec = _synced(dev, lambda: loss_and_grads(dataclasses.replace(cfg, remat=remat),
                                                                     params, batches[0]))
        gn = float(_global_norm(grads))
        first[remat] = {"loss": float(loss), "grad_norm": gn, "seconds": sec, "peak_gib": _peak_gib(dev)}
        if remat:  # the update alone, on these grads (its outputs dropped)
            _, first[remat]["adamw_seconds"] = _synced(dev, lambda: adamw_update(opt, grads, params, state)[2])
        del grads
        check(math.isfinite(first[remat]["loss"]) and math.isfinite(gn) and gn > 0, f"remat={remat}: {first[remat]}")
    loss_gap = abs(first[True]["loss"] - first[False]["loss"])
    gn_gap = abs(first[True]["grad_norm"] - first[False]["grad_norm"]) / first[False]["grad_norm"]
    check(loss_gap <= 1e-6 * abs(first[False]["loss"]) and gn_gap <= 1e-3,
          f"remat on vs off: loss {first[True]['loss']} / {first[False]['loss']}, grad_norm gap {gn_gap:.3g}")
    for remat in (False, True):
        f = first[remat]
        print(f"    forward+backward, remat {'on ' if remat else 'off'}: loss {f['loss']:.6f} grad_norm "
              f"{f['grad_norm']:.6f}, {f['seconds']:.3f} s (first call), peak {f['peak_gib']:.2f} GiB [{card}]")
    print(f"    remat on vs off: |loss diff| {loss_gap:.3g}, grad_norm relative diff {gn_gap:.3g}; adamw_update "
          f"alone {first[True]['adamw_seconds']:.4f} s [{card}]")

    _reset_peak(dev)
    out, acc_s = _synced(dev, lambda: make_train_step(cfg, opt, grad_accum=2)(params, state, batches[0]))
    acc = out[2]
    del out  # its params and state: 19.7 GB at full width
    acc_gap = abs(float(acc["loss"]) - first[True]["loss"])
    check(acc_gap < 5e-2 and math.isfinite(float(acc["grad_norm"])), f"grad_accum=2 loss gap {acc_gap}")
    print(f"    grad_accum=2 step: loss {float(acc['loss']):.6f} (large batch {first[True]['loss']:.6f}, "
          f"|diff| {acc_gap:.4g} < 5e-2), {acc_s:.3f} s, peak {_peak_gib(dev):.2f} GiB")

    step_fn = make_train_step(cfg, opt)
    probe = params["layers"]["0"]["mixer"]["w_q"][0, :8, :8].clone()
    rows = []
    _reset_peak(dev)
    for s in range(steps):
        (params, state, m), sec = _synced(dev, lambda: step_fn(params, state, batches[s]))
        row = {"step": s, "seconds": sec, "tokens_per_s": tokens / sec, "mfu": flops / sec / BF16_FLOPS_PER_S,
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"])}
        rows.append(row)
        check(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"]), f"step {s}: {row}")
        print(f"    step {s}: {sec:.4f} s, {row['tokens_per_s']:.1f} tokens/s, model FLOP share "
              f"{100 * row['mfu']:.2f} % of {BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bf16 (6 N T = {flops / 1e12:.2f} "
              f"TFLOP), loss {row['loss']:.6f}, grad_norm {row['grad_norm']:.4f} [{card}]")
    step_peak = _peak_gib(dev)
    moved = float((params["layers"]["0"]["mixer"]["w_q"][0, :8, :8] - probe).abs().max())
    check(moved > 0 and int(state["count"]) == steps, f"params moved by {moved}, count {int(state['count'])}")
    print(f"    params moved (max |diff| of a w_q block {moved:.3g}), count {int(state['count'])}; "
          f"peak over the steps {step_peak:.2f} GiB [{card}]")
    del params, state, batches
    _reset_peak(dev)
    return {"n_params": n_params, "tokens": tokens, "flops_per_step": flops, "state_gib": state_gib,
            "first_step": {"remat_off": first[False], "remat_on": first[True]}, "grad_accum_gap": acc_gap,
            "grad_accum_seconds": acc_s, "steps": rows, "step_peak_gib": step_peak}


def train_drill(dev) -> dict:
    """The launcher's failure drill, in-process on ``dev``: an uninterrupted
    run, a run stopped at step 6 (exit 17), its resume from step 5 with the
    same ``loss[last 5]``."""
    import contextlib
    import io
    import tempfile

    from repro_torch.launch.train import main as train_main

    def run(*extra) -> tuple:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = train_main(DRILL_ARGS + ["--device", str(dev), *extra])
        return code, buf.getvalue()

    def final(out: str) -> str:
        lines = [line for line in out.splitlines() if line.startswith("final:")]
        check(len(lines) == 1, f"no final line in {out[-500:]!r}")
        return lines[0].split("loss[last 5]=")[1].split()[0]

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        code, whole = run("--ckpt-dir", f"{tmp}/ref")
        check(code == 0, f"uninterrupted run exited {code}")
        code, crash = run("--ckpt-dir", f"{tmp}/ft", "--simulate-failure", "6")
        check(code == 17 and "[failure-sim] aborting at step 6" in crash, f"failure run exited {code}")
        code, resumed = run("--ckpt-dir", f"{tmp}/ft")
        check(code == 0 and "[resume] restored step 5" in resumed, f"resume exited {code}: {resumed[:300]!r}")
        check(final(whole) == final(resumed), f"loss[last 5] {final(whole)} uninterrupted, {final(resumed)} resumed")
    seconds = time.perf_counter() - t0
    print(f"  failure drill on {dev}: uninterrupted, stopped at step 6 (exit 17), resumed from step 5 "
          f"('[resume] restored step 5'); loss[last 5]={final(whole)} both; {seconds:.1f} s")
    return {"loss_last5": final(whole), "seconds": seconds}


def train_phase(dev, card: str) -> dict:
    """Phase 12: the reduced archs' train step cuda = cpu, stablelm trained
    at full width, the launcher's failure drill; no MPC kernel launches."""
    import torch

    from repro_torch.kernels import launch_counts

    t_phase = time.perf_counter()
    before = launch_counts()
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")  # no TF32 in the f32 comparisons
    try:
        print("  cross-device: one train step of each reduced architecture, f32, TF32 off")
        cross = train_cross_device(dev)
    finally:
        torch.set_float32_matmul_precision(precision)
    print(f"  {TRAIN_ARCH} uncut, trained on {dev}")
    full = train_full_width(dev, card)
    drill = train_drill(dev)
    print(f"  {TRAIN_EXCUSED}")
    check(launch_counts() == before, f"MPC kernels launched during phase 12: {before} -> {launch_counts()}")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 12 in {seconds:.1f} s, no MPC kernel launched [{card}]")
    return {"cross_device": cross, "full": full, "drill": drill, "seconds": seconds}


# ---------------------------------------------------------------------------
# 13. sharding and the roofline on the card
# ---------------------------------------------------------------------------

# the one-card meshes: the single-pod and the multi-pod axes, each of extent 1
SHARD_MESH = ((1, 1), ("data", "model"))
SHARD_MESH_PODS = ((1, 1, 1), ("pod", "data", "model"))


def open_mesh(dev, store_dir: str):
    """A one-rank process group (NCCL on a card, gloo on the CPU) joined
    through a ``FileStore`` in ``store_dir``, and the (1, 1) ("data",
    "model") mesh over it. No fallback: a backend that fails to start fails
    the phase."""
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(store_dir, "store"), 1), rank=0,
                            world_size=1)
    check(dist.get_backend() == backend, f"process group backend {dist.get_backend()}, wanted {backend}")
    return make_mesh(*SHARD_MESH, device_type=dev.type)


def shard_cross_device(dev, mesh, shape=SHARD_MESH[0]) -> dict:
    """All ten reduced architectures in f32 with TF32 off: one train step
    over DTensors on ``mesh`` (parameters by ``make_param_specs``, ZeRO-1
    moments, the batch by ``batch_specs``) equal to the same step on plain
    tensors on ``dev`` (loss, grad norm, then parameters and AdamW state,
    gathered)."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.sharding import batch_specs, distribute_tree, gather_tree, is_sharded
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step, place_train_state

    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_config(arch).reduced()
        tol = LM_RECURRENT_TOL if arch in LM_RECURRENT else LM_F32_TOL
        params = _to(init_params(cfg, torch.Generator().manual_seed(TRAIN_SEED + i), device="cpu"), dev)
        pipe = TokenPipeline(cfg.vocab_size, 24, 2, seed=TRAIN_SEED + i, d_model=cfg.d_model,
                             mode=cfg.input_mode, n_prefix=cfg.n_prefix)
        batch = _to({k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}, dev)
        step = make_train_step(cfg, opt)
        t0 = time.perf_counter()
        new, state, m = step(params, adamw_init(params), batch)
        _sync(dev)
        plain_s = time.perf_counter() - t0
        p_sh, s_sh = place_train_state(cfg, params, adamw_init(params), mesh)
        b_sh = distribute_tree(batch, batch_specs(cfg, batch, mesh), mesh)
        check(all(is_sharded(t) for t in (p_sh["embed"], s_sh["m"]["embed"], b_sh["labels"])), f"{arch}: not DTensors")
        t0 = time.perf_counter()
        new_sh, state_sh, m_sh = step(p_sh, s_sh, b_sh)
        _sync(dev)
        sharded_s = time.perf_counter() - t0
        errs = {
            "loss": abs(float(m_sh["loss"]) - float(m["loss"])) / max(1.0, abs(float(m["loss"]))),
            "grad_norm": abs(float(m_sh["grad_norm"]) - float(m["grad_norm"])) / max(1.0, float(m["grad_norm"])),
            "params": _scaled_err(new, gather_tree(new_sh)),
            "state": _scaled_err({"m": state["m"], "v": state["v"]},
                                 gather_tree({"m": state_sh["m"], "v": state_sh["v"]})),
        }
        out[arch] = dict(errs, plain_s=plain_s, sharded_s=sharded_s)
        check(np.isfinite(float(m_sh["loss"])) and int(state_sh["count"]) == 1, f"{arch}: loss or count")
        check(all(e <= tol for e in errs.values()), f"{arch} sharded train step against unsharded {errs} above {tol}")
        print(f"  {arch:18s} reduced f32 train step, DTensor on {shape} vs plain {dev.type} scaled max "
              f"|diff|: loss {errs['loss']:.3g}, grad_norm {errs['grad_norm']:.3g}, params {errs['params']:.3g}, "
              f"AdamW state {errs['state']:.3g} (tolerance {tol:g}); {plain_s:.3f} s plain, {sharded_s:.3f} s "
              f"sharded")
    return out


def shard_full_width(dev, card: str, mesh, cfg=None, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ) -> dict:
    """``stablelm_1_6b`` uncut (or ``cfg``), phase 12's first batch: one
    forward and backward over DTensors on ``mesh`` against the same on plain
    tensors, loss and grad norm within phase 12's remat limits, with each
    one's seconds and peak memory."""
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.models import init_params
    from repro_torch.sharding import batch_specs, distribute_tree, make_param_specs
    from repro_torch.train.optimizer import _global_norm
    from repro_torch.train.train_step import loss_and_grads

    cfg = get_config(TRAIN_ARCH) if cfg is None else cfg
    _reset_peak(dev)
    params = init_params(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED), dev)
    pipe = TokenPipeline(cfg.vocab_size, seq, batch, seed=TRAIN_SEED)
    b = _to({k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}, dev)
    runs = {}
    for label in ("plain", "sharded"):
        if label == "sharded":
            p_in = distribute_tree(params, make_param_specs(cfg, params, mesh), mesh)
            b_in = distribute_tree(b, batch_specs(cfg, b, mesh), mesh)
        else:
            p_in, b_in = params, b
        _reset_peak(dev)
        (loss, _, grads), sec = _synced(dev, lambda: loss_and_grads(cfg, p_in, b_in))
        gn = float(_global_norm(grads))
        runs[label] = {"loss": float(loss), "grad_norm": gn, "seconds": sec, "peak_gib": _peak_gib(dev)}
        del grads, p_in, b_in
        check(math.isfinite(runs[label]["loss"]) and math.isfinite(gn) and gn > 0, f"{label}: {runs[label]}")
    plain, sharded = runs["plain"], runs["sharded"]
    loss_gap = abs(sharded["loss"] - plain["loss"])
    gn_gap = abs(sharded["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
    check(loss_gap <= 1e-6 * abs(plain["loss"]) and gn_gap <= 1e-3,
          f"sharded vs plain: loss {sharded['loss']} / {plain['loss']}, grad_norm gap {gn_gap:.3g}")
    for label, r in runs.items():
        print(f"    forward+backward {label:7s}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.6f}, "
              f"{r['seconds']:.3f} s, peak {r['peak_gib']:.2f} GiB [{card}]")
    print(f"    sharded vs plain: |loss diff| {loss_gap:.3g}, grad_norm relative diff {gn_gap:.3g}")
    del params
    _reset_peak(dev)
    return {"runs": runs, "loss_gap": loss_gap, "grad_norm_gap": gn_gap, "batch": batch, "seq": seq}


def _counted(label: str, cfg, step, args, shape: str, measured_s: list, card: str) -> dict:
    """``step(*args)`` counted on ``meta`` (one card, ``chips=1``): its
    roofline bound beside the seconds measured for that step on the card."""
    from repro_torch.launch.roofline import CARD, Roofline, StepCounter

    t0 = time.perf_counter()
    with StepCounter() as c:
        step(*args)
    r = Roofline(arch=cfg.name, shape=shape, mesh="1x1", chips=1, hlo_flops=float(c.flops),
                 hlo_bytes=float(c.bytes), collective_bytes=0.0, collectives={}, collective_counts={},
                 model_flops=0.0)
    bound = max(r.t_compute, r.t_memory)
    best, median = min(measured_s), statistics.median(measured_s)
    print(f"    {label}: counted {c.ops:,} ops, {c.flops:.4g} matmul FLOPs, {c.bytes:.4g} unfused bytes in "
          f"{time.perf_counter() - t0:.1f} s; bound {1e3 * bound:.3f} ms ({r.bottleneck}; compute "
          f"{1e3 * r.t_compute:.3f} ms, memory {1e3 * r.t_memory:.3f} ms at the {CARD} data sheet); measured "
          f"{1e3 * best:.3f} ms best, {1e3 * median:.3f} ms median over {len(measured_s)} [{card}]: "
          f"{best / bound:.2f}x and {median / bound:.2f}x the bound")
    return {"ops": c.ops, "flops": c.flops, "bytes": c.bytes, "t_compute_s": r.t_compute,
            "t_memory_s": r.t_memory, "bound_s": bound, "bottleneck": r.bottleneck, "measured_best_s": best,
            "measured_median_s": median, "ratio_best": best / bound, "ratio_median": median / bound}


def roofline_on_card(lm: dict, train: dict, card: str) -> dict:
    """The port's roofline of the two steps phases 11 and 12 timed, counted
    on ``meta``: the served ``stablelm_1_6b``'s serve step (phase 11's
    depth) at the largest lot's shape (against that lot's greedy steps) and
    the uncut model's 4 x 512 train step (against phase 12's timed
    steps)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import abstract_params, init_caches
    from repro_torch.serve import make_serve_step
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step

    served = served_config()
    lot = max(lm["served"]["lots"], key=lambda r: (r["batch"] * r["bucket"], r["bucket"]))
    b, cap = lot["batch"], lot["bucket"] + LM_NEW_TOKENS
    caches = init_caches(served, b, cap, device="meta")
    tok = {"tokens": torch.empty((b, 1), dtype=torch.int32, device="meta")}
    out = {"serve": _counted(f"serve step B={b}, cache {cap}, {served.n_layers} layers", served,
                             make_serve_step(served), (abstract_params(served), caches, tok), "decode",
                             [lot["decode_ms_per_step"] / 1e3], card)}
    cfg = get_config(TRAIN_ARCH)
    params = abstract_params(cfg)
    full = train["full"]
    tokens = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32, device="meta") for k in ("tokens", "labels")}
    out["train"] = _counted(f"train step {TRAIN_BATCH} x {TRAIN_SEQ}, remat on", cfg,
                            make_train_step(cfg, AdamWConfig()), (params, adamw_init(params), tokens), "train",
                            [r["seconds"] for r in full["steps"]], card)
    out["serve"]["lot"] = {"batch": b, "bucket": lot["bucket"], "cache": cap}
    return out


def shard_phase(dev, card: str, lm: dict, train: dict) -> dict:
    """Phase 13: a one-rank process group and a (1, 1) mesh on ``dev``, then
    a (1, 1, 1) ("pod", "data", "model") mesh over the same group, where the
    batch spans two axes (the attention core on local shards, the einsums,
    the MoE layer and the sLSTM on the merged-batch view); on each, the
    reduced archs' sharded train step = the plain one and stablelm uncut
    sharded = plain; then the roofline of phases 11 and 12's steps beside
    their measured times. No MPC kernel launches."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts

    t_phase = time.perf_counter()
    before = launch_counts()
    with tempfile.TemporaryDirectory() as store_dir:
        mesh = open_mesh(dev, store_dir)
        try:
            print(f"  process group {dist.get_backend()}, world {dist.get_world_size()}; mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}")
            precision = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")  # no TF32 in the f32 comparisons
            try:
                print("  cross-check: one train step of each reduced architecture, f32, TF32 off, sharded vs plain")
                cross = shard_cross_device(dev, mesh)
            finally:
                torch.set_float32_matmul_precision(precision)
            print(f"  {TRAIN_ARCH} uncut, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, sharded vs plain on {dev}")
            full = shard_full_width(dev, card, mesh)
            from repro_torch.launch.mesh import make_mesh

            t_pods = time.perf_counter()
            pods = make_mesh(*SHARD_MESH_PODS, device_type=dev.type)
            print(f"  mesh {dict(zip(pods.mesh_dim_names, pods.shape))} on {pods.device_type}: the batch spans "
                  f"two axes")
            torch.set_float32_matmul_precision("highest")
            try:
                cross_pods = shard_cross_device(dev, pods, SHARD_MESH_PODS[0])
            finally:
                torch.set_float32_matmul_precision(precision)
            print(f"  {TRAIN_ARCH} uncut, {TRAIN_BATCH} x {TRAIN_SEQ} tokens, sharded on {SHARD_MESH_PODS[0]} vs "
                  f"plain on {dev}")
            full_pods = shard_full_width(dev, card, pods)
            pods_s = time.perf_counter() - t_pods
            print(f"  the {SHARD_MESH_PODS[0]} mesh's checks in {pods_s:.1f} s")
        finally:
            dist.destroy_process_group()
    print("  the port's roofline (repro_torch.launch.roofline, counted on meta, one card) beside phases 11 and "
          "12's measured steps")
    roof = roofline_on_card(lm, train, card)
    check(launch_counts() == before, f"MPC kernels launched during phase 13: {before} -> {launch_counts()}")
    seconds = time.perf_counter() - t_phase
    print(f"  phase 13 in {seconds:.1f} s, no MPC kernel launched [{card}]")
    return {"cross_device": cross, "full": full, "cross_device_pods": cross_pods, "full_pods": full_pods,
            "pods_seconds": pods_s, "roofline": roof, "seconds": seconds}


# ---------------------------------------------------------------------------
# 14. the serving configuration under jit_ops=True: a cache of CUDA graphs
# ---------------------------------------------------------------------------

# examples/healthlnk_queries.py's batched-admission demo
JIT_SQL = "SELECT major_icd9, COUNT(*) AS c FROM diagnoses GROUP BY major_icd9"
JIT_TENANTS = 8
# aspirin_count's executions on one jit engine, and how many of them an
# eager engine with the same key and counters repeats
JIT_EXECUTIONS = 3
JIT_EAGER_CHECKS = 1
# eager submits of (a) after its warm eager submit (each gives the same shares)
JIT_EAGER_SUBMITS = 1
JIT_CROSS_ROWS = 48
# each kernel wrapper's launch function (module, attribute) and its plain
# version: the graphs' launches are checked against it at the shapes the
# captures gave it
_LAUNCHERS = {
    "rss_gate": ("repro_torch.kernels.rss_gate.ops", "_launch"),
    "ks_prefix": ("repro_torch.kernels.ks_prefix.ops", "_ks_prefix_launch"),
    "and_fold": ("repro_torch.kernels.ks_prefix.ops", "_and_fold_launch"),
    "a2b_fused": ("repro_torch.kernels.a2b_fused.ops", "_a2b_launch"),
    "bit2a_fused": ("repro_torch.kernels.a2b_fused.ops", "_bit2a_launch"),
    "bitonic_swap": ("repro_torch.kernels.bitonic_stage.ops", "_launch"),
    "shuffle_gather": ("repro_torch.kernels.shuffle_gather.ops", "_hop_launch"),
    "threefry_bits": ("repro_torch.kernels.threefry.ops", "_launch"),
}


def _plain_of(name: str):
    from repro_torch.kernels.a2b_fused import a2b_plain, bit2a_plain
    from repro_torch.kernels.bitonic_stage import stage_swap_plain
    from repro_torch.kernels.ks_prefix import and_fold_plain, ks_prefix_plain
    from repro_torch.kernels.rss_gate import gate_plain
    from repro_torch.kernels.shuffle_gather import shuffle_gather_plain
    from repro_torch.kernels.threefry import draw_plain

    return {
        "rss_gate": gate_plain, "ks_prefix": ks_prefix_plain, "and_fold": and_fold_plain, "a2b_fused": a2b_plain,
        "bit2a_fused": bit2a_plain, "bitonic_swap": stage_swap_plain, "threefry_bits": draw_plain,
        "shuffle_gather": lambda cols, index: [shuffle_gather_plain(c, index) for c in cols],
    }[name]


def _arg_spec(a):
    import torch

    if isinstance(a, torch.Tensor):
        return ("t", tuple(a.shape), str(a.dtype).split(".")[-1])
    if isinstance(a, (list, tuple)) and a and all(isinstance(x, torch.Tensor) for x in a):
        return ("l", tuple(_arg_spec(x) for x in a))
    return ("v", tuple(a) if isinstance(a, list) else a)


class _LaunchShapes:
    """While active, records each kernel launch function's argument shapes
    (the physical tensors a capture hands it), keyed by kernel, and the
    launches recorded into each graph the jit cache captures (``per_graph``,
    keyed by the graph's id; a replay calls no launch function)."""

    def __init__(self):
        self.seen = {}
        self.captured = {}  # kernel -> launches made while a stream captured
        self.per_graph = {}

    def __enter__(self):
        import importlib

        import torch

        from repro_torch.engine import executor

        self._saved = []
        for name, (mod, attr) in _LAUNCHERS.items():
            module = importlib.import_module(mod)
            fn = getattr(module, attr)
            self._saved.append((module, attr, fn))

            def recording(*args, _fn=fn, _name=name):
                self.seen.setdefault(_name, set()).add(tuple(_arg_spec(a) for a in args))
                if torch.cuda.is_current_stream_capturing():
                    self.captured[_name] = self.captured.get(_name, 0) + 1
                return _fn(*args)

            setattr(module, attr, recording)
        capture = executor._CompiledOp._capture
        self._saved.append((executor._CompiledOp, "_capture", capture))

        def counting(op, *args):
            before = dict(self.captured)
            graph = capture(op, *args)
            self.per_graph[id(graph)] = {k: v - before.get(k, 0) for k, v in self.captured.items()
                                         if v != before.get(k, 0)}
            return graph

        executor._CompiledOp._capture = counting
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)


def _make_arg(spec, gen, dev, n_index):
    import torch

    kind, *rest = spec
    if kind == "v":
        return rest[0] if not isinstance(rest[0], tuple) else list(rest[0])
    if kind == "l":
        return [_make_arg(s, gen, dev, n_index) for s in rest[0]]
    shape, dtype = rest
    if dtype == "int64" and len(shape) == 1 and shape[0] == n_index:  # a hop's index: a permutation
        return torch.randperm(shape[0], generator=gen, device=dev)
    if dtype == "int64":
        return words64(gen, shape, dev)
    return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev, dtype=torch.int32)


def graph_kernel_checks(dev, seen: dict) -> dict:
    """Each kernel at each argument shape the captures gave it: its launch
    function captured in a CUDA graph, replayed, against its plain version
    on the same inputs; then new inputs copied in and replayed again.
    Returns kernel -> (shapes checked, max_abs_err)."""
    import importlib

    import torch

    gen = device_generator(dev, 14)
    out = {}
    for name, specs in sorted(seen.items()):
        mod, attr = _LAUNCHERS[name]
        launch = getattr(importlib.import_module(mod), attr)
        plain = _plain_of(name)
        err = 0
        for spec in sorted(specs, key=repr):
            n_index = spec[-1][1][0] if name == "shuffle_gather" else -1
            args = [_make_arg(s, gen, dev, n_index) for s in spec]
            launch(*args)  # outside capture: builds, sets shared-memory limits
            torch.cuda.synchronize(dev)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                got = launch(*args)
            for _ in range(2):
                graph.replay()
                torch.cuda.synchronize(dev)
                want = plain(*args)
                pairs = zip(got, want) if isinstance(got, list) else [(got, want)]
                err = max(err, *(max_abs_err64(g, w) if g.dtype == torch.int64 else max_abs_err(g, w)
                                 for g, w in pairs))
                fresh = [_make_arg(s, gen, dev, n_index) for s in spec]
                for a, b in zip(args, fresh):  # refill the static inputs in place
                    for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
                        if isinstance(x, torch.Tensor):
                            x.copy_(y)
            del graph
        out[name] = {"shapes": len(specs), "max_abs_err": err}
        print(f"    {name}: {len(specs)} argument shapes, captured and replayed twice with new inputs, "
              f"max_abs_err {err} against the plain version")
        check(err == 0, f"{name} inside a CUDA graph differs from its plain version")
    return out


def _clear_jit(dev) -> None:
    import gc

    import torch

    from repro_torch.engine import Engine

    Engine._JIT_CACHE.clear()
    Engine.reset_jit_stats()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _graphs() -> list:
    """Every captured graph of the process-wide cache: (entry label, graph)."""
    from repro_torch.engine import Engine

    return [(e.label, g) for e in Engine._JIT_CACHE.values() for g in e.graphs.values()]


def _graph_launches(graphs, shapes: _LaunchShapes) -> dict:
    """The kernel launches recorded into ``graphs`` (captured while
    ``shapes`` was active)."""
    total: dict = {}
    for _, g in graphs:
        _add(total, shapes.per_graph[id(g)])
    return total


def group_oracle(plain: dict) -> list:
    import numpy as np

    keys, counts = np.unique(plain["diagnoses"]["major_icd9"], return_counts=True)
    return sorted(zip(keys.tolist(), counts.tolist()))


def _group_rows(res) -> list:
    import numpy as np

    return sorted(zip(np.asarray(res.rows["major_icd9"]).tolist(), np.asarray(res.rows["c"]).tolist()))


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def serving_sequence(dev, tables, jit: bool = True, tenants: int = JIT_TENANTS, drains: bool = True) -> dict:
    """The reference's serving demo (``examples/healthlnk_queries.py``):
    ``ReflexClient.in_process(tables, noise=NoTrim(), placement="none",
    jit_ops=jit)``, one warm submit, then ``tenants`` tenants' serial
    submits; with ``drains``, a second client enqueues eight for a warm
    drain, then for a timed drain. The jit cache is cleared first."""
    from repro_torch.core import threefry
    from repro_torch.core.noise import NoTrim
    from repro_torch.engine import Engine
    from repro_torch.runtime import ReflexClient

    def client():
        return ReflexClient.in_process(tables, noise=NoTrim(), placement="none", jit_ops=jit,
                                       key=threefry.PRNGKey(5), batch_wait_s=60.0, device=dev)

    _clear_jit(dev)
    serial = client()
    warm, warm_s = _timed(dev, lambda: serial.submit("warm", JIT_SQL))
    captured = list(_graphs())
    runs = [_timed(dev, lambda t=t: serial.submit(f"clinic_{t}", JIT_SQL)) for t in range(tenants)]
    out = {"warm": warm, "warm_s": warm_s, "captured": captured, "serial": [r for r, _ in runs],
           "serial_s": [s for _, s in runs], "drained": []}
    if drains:
        batch = client()

        def drain():
            for t in range(JIT_TENANTS):
                batch.session(f"clinic_{t}").enqueue(JIT_SQL)
            return batch.drain()

        _, out["warm_drain_s"] = _timed(dev, drain)
        out["drained"], out["drain_s"] = _timed(dev, drain)
        out["batch_stats"] = dict(batch.service.engine.last_batch_stats)
    out.update(stats=Engine.jit_cache_stats(), graphs=list(_graphs()))
    return out


def _stats_view(stats: dict) -> tuple:
    return stats["hits"], stats["misses"], stats["size"]


def jit_cross_device(dev) -> dict:
    """The serving sequence at n=48 on the card and on the CPU: every result
    identical, shares included, and the same cache statistics."""
    import torch

    from repro_torch.data import generate_healthlnk

    seqs = {}
    for d in (dev, torch.device("cpu")):
        tables, _ = generate_healthlnk(n=JIT_CROSS_ROWS, seed=0, device=d)
        seqs[d.type] = serving_sequence(d, tables)
    a, b = seqs[dev.type], seqs["cpu"]
    pairs = list(zip([a["warm"], *a["serial"], *a["drained"]], [b["warm"], *b["serial"], *b["drained"]]))
    for x, y in pairs:
        check(_same_result(x, y), "the jit serving sequence at n=48 differs between cuda and cpu")
    check(_stats_view(a["stats"]) == _stats_view(b["stats"]), f"jit cache stats differ: {a['stats']} {b['stats']}")
    if dev.type == "cuda":
        check(bool(a["graphs"]), f"no graph was captured at n={JIT_CROSS_ROWS}")
    print(f"  n={JIT_CROSS_ROWS}: {len(pairs)} results identical on cuda and cpu "
          f"(shares, per-node ledger, rows); jit cache stats {a['stats']} on both")
    return b["stats"]


def jit_serving_phase(dev, card: str, n: int, cpu_stats: dict) -> dict:
    """(a): the serving sequence at full size under jit_ops=True against the
    same sequence eager, the K=8 drain against the serial submits, the
    cache statistics against the CPU's at n=48, each captured kernel
    against its plain version, and a replay under another engine's key."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.data import generate_healthlnk
    from repro_torch.engine import Engine
    from repro_torch.kernels import reset_launch_counts

    tables, plain = generate_healthlnk(n=n, seed=0, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eager = serving_sequence(dev, tables, jit=False, tenants=JIT_EAGER_SUBMITS, drains=False)
    with _LaunchShapes() as shapes:
        jit = serving_sequence(dev, tables)
    peak = torch.cuda.max_memory_allocated(dev)
    want = group_oracle(plain)
    for label, res in [("warm", jit["warm"])] + [(f"serial {i}", r) for i, r in enumerate(jit["serial"])] + [
            (f"drained {i}", r) for i, r in enumerate(jit["drained"])]:
        check(_group_rows(res) == want, f"jit {label}: the GROUP BY differs from the plaintext oracle")
    # no Resize: every submit of the query gives the same shares, so each
    # is held against the eager warm submit
    for x in [jit["warm"], *jit["serial"], *eager["serial"]]:
        check(_same_result(x, eager["warm"]), "a jit submit differs from the eager submit (shares, ledger or rows)")
    for x, y in zip(jit["drained"], jit["serial"]):
        check(same_outputs(x.table, y.table) and ledger_rows(x.report) == ledger_rows(y.report),
              "a drained slot differs from its serial submit")
    check(_stats_view(jit["stats"]) == _stats_view(cpu_stats),
          f"jit cache stats {jit['stats']} differ from the cpu's {cpu_stats} for the same sequence")
    captured = jit["captured"]
    check(captured and all(g.replays >= 1 for _, g in captured), "the warm submit captured no graph")
    nodes = [s.node for s in jit["warm"].report.nodes if not s.node.startswith("Scan")]
    check(len(captured) == len(nodes), f"{len(captured)} graphs for the protocol nodes {nodes}")
    per_replay = _graph_launches(captured, shapes)
    print(f"  {card}")
    print(f"  (a) {JIT_SQL!r}, n={n}: {len(captured)} graphs for the warm submit's protocol nodes {nodes}")
    for label, g in captured:
        print(f"    {label}: capture {g.capture_s:.3f} s (warm-up, capture, instantiation), pool "
              f"{g.pool_bytes} bytes, launches a replay {shapes.per_graph[id(g)]}")
    eager_s, jit_s = eager["serial_s"], jit["serial_s"]
    print(f"    warm submit {jit['warm_s']:.3f} s (eager {eager['warm_s']:.3f} s); the {JIT_TENANTS} serial "
          f"submits {sum(jit_s):.3f} s, median {statistics.median(jit_s):.4f} s a submit (replays) against "
          f"eager {sum(eager_s):.3f} s, median {statistics.median(eager_s):.4f} s")
    print(f"    K={JIT_TENANTS} drain {jit['drain_s']:.3f} s (warm drain with its captures "
          f"{jit['warm_drain_s']:.3f} s) against {JIT_TENANTS} serial submits {sum(jit_s):.3f} s; batch "
          f"{jit['batch_stats']}")
    pools = sum(g.pool_bytes for _, g in jit["graphs"])
    print(f"    {len(jit['graphs'])} graphs hold {pools} pool bytes; peak device memory {peak / 2**30:.2f} GiB; "
          f"jit cache {jit['stats']} (the cpu at n={JIT_CROSS_ROWS}: {cpu_stats}); each submit's shares, "
          f"per-node ledger and rows equal the eager submit's, each drained slot its serial submit's, "
          f"every answer the oracle's")
    # another engine's key: a replay of the same entry draws with its keys
    plan = jit["warm"].plan
    misses = Engine.jit_cache_stats()["misses"]
    other, _ = Engine(tables, key=threefry.PRNGKey(77), jit_ops=True, device=dev).execute(plan)
    check(Engine.jit_cache_stats()["misses"] == misses, "another key's engine missed the cache")
    fresh, _ = Engine(tables, key=threefry.PRNGKey(77), device=dev).execute(plan)
    check(same_outputs(other, fresh), "a replay under another engine's key differs from that key's eager run")
    check(not same_outputs(other, jit["warm"].table), "a replay under another key gave the first engine's shares")
    print("    a replay under another engine's key (77) gives that key's eager shares, not key 5's")
    print("  kernels inside the graphs, at the shapes the captures gave them:")
    reset_launch_counts()
    kernel_checks = graph_kernel_checks(dev, shapes.seen)
    reset_launch_counts()
    _clear_jit(dev)
    return {"n": n, "peak_bytes": peak, "stats": jit["stats"], "cpu_stats": cpu_stats,
            "captures": [{"label": lb, "capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                          "launches": shapes.per_graph[id(g)]} for lb, g in captured],
            "pool_bytes": pools, "graphs": len(jit["graphs"]), "launches_per_replay": per_replay,
            "warm_s": jit["warm_s"], "eager_warm_s": eager["warm_s"], "serial_s": jit_s, "eager_serial_s": eager_s,
            "drain_s": jit["drain_s"], "warm_drain_s": jit["warm_drain_s"],
            "graph_launches": _graph_launches(jit["graphs"], shapes), "kernel_checks": kernel_checks,
            "answer_groups": len(want)}


def _jit_aspirin_run(dev, i: int, plan, jit, eager, want, eager_run) -> dict:
    """(b)'s execution ``i`` on the jit engine: its answer against the
    oracle and, for the first JIT_EAGER_CHECKS, its shares, per-node ledger
    and S against the eager engine's (or phase 3's ``eager_run``)."""
    from repro_torch.data import revealed_answer
    from repro_torch.engine import Engine

    before, graphs_before = Engine.jit_cache_stats(), {id(g) for _, g in _graphs()}
    ctr = jit._resize_ctr  # the noise counter this execution starts from
    (out, rep), seconds = _timed(dev, lambda: jit.execute(plan))
    after = Engine.jit_cache_stats()
    got = revealed_answer("aspirin_count", plan, out)
    check(got == want, f"aspirin_count under jit, execution {i + 1}: {got} differs from the oracle {want}")
    row = {"seconds": seconds, "misses": after["misses"] - before["misses"],
           "hits": after["hits"] - before["hits"], "captures": len(_graphs()) - len(graphs_before),
           "s": [s.extra.get("s") for s in rep.nodes if "s" in s.extra], "result": got}
    if i < JIT_EAGER_CHECKS:
        if i == 0 and eager_run is not None:
            want_shares, want_ledger = eager_run
            row["eager_seconds"] = None
        else:
            eager._resize_ctr = ctr
            (eout, erep), row["eager_seconds"] = _timed(dev, lambda: eager.execute(plan))
            want_shares, want_ledger = share_rows(eout), ledger_rows(erep)
        got_shares = share_rows(out)
        check(list(got_shares) == list(want_shares) and all((got_shares[k] == want_shares[k]).all()
                                                             for k in got_shares)
              and ledger_rows(rep) == want_ledger,
              f"aspirin_count execution {i + 1}: jit and eager differ (shares, per-node ledger or S)")
    row["capture_s"] = sum(g.capture_s for _, g in _graphs() if id(g) not in graphs_before)
    eager_note = "" if "eager_seconds" not in row else (
        " (identical shares, ledger and S to phase 3's eager run)" if row["eager_seconds"] is None
        else f" (eager {row['eager_seconds']:.3f} s, identical shares, ledger and S)")
    print(f"  (b) aspirin_count execution {i + 1}: {seconds:.3f} s, of it {row['capture_s']:.3f} s capturing"
          + eager_note
          + f", cache misses {row['misses']}, hits {row['hits']}, new graphs {row['captures']}, S {row['s']}, "
          f"answer {got} = oracle")
    return row


def jit_aspirin_phase(dev, n: int, eager_run=None) -> dict:
    """(b): aspirin_count compiled from its SQL with Beta(2,6) parallel
    Resizers on every internal operator and the sort-merge join (phase 3's
    "aspirin_count sort-merge"), executed JIT_EXECUTIONS times on one
    Engine(jit_ops=True); the first JIT_EAGER_CHECKS against an eager
    engine with the same key and noise counters (shares, per-node ledger,
    S, rows), every answer against the oracle. Nodes after a Resize miss
    the cache when S changes. ``eager_run`` (share_rows, ledger_rows)
    stands in for the first eager execution: phase 3 ran it (the same
    tables, plan, key and counter)."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.data import generate_healthlnk, plaintext_oracle
    from repro_torch.engine import Engine

    tables, plain = generate_healthlnk(n=n, seed=0, device=dev)
    plan = sortmerge_plan("aspirin_count", tables, plain)
    want = plaintext_oracle("aspirin_count", plain)
    _clear_jit(dev)
    jit = Engine(tables, key=threefry.PRNGKey(44), jit_ops=True, device=dev)
    eager = Engine(tables, key=threefry.PRNGKey(44), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with _LaunchShapes() as shapes:
        runs = [_jit_aspirin_run(dev, i, plan, jit, eager, want, eager_run) for i in range(JIT_EXECUTIONS)]
    graphs = _graphs()
    peak = torch.cuda.max_memory_allocated(dev)
    pools = sum(g.pool_bytes for _, g in graphs)
    launches = _graph_launches(graphs, shapes)
    print(f"    {len(graphs)} graphs, {pools} pool bytes, peak device memory {peak / 2**30:.2f} GiB, jit cache "
          f"{Engine.jit_cache_stats()}; kernel launches recorded into the graphs {launches}")
    out = {"n": n, "runs": runs, "graphs": len(graphs), "pool_bytes": pools, "peak_bytes": peak,
           "graph_launches": launches, "stats": Engine.jit_cache_stats(),
           "captures": [{"label": lb, "capture_s": g.capture_s, "pool_bytes": g.pool_bytes, "replays": g.replays,
                         "launches": shapes.per_graph[id(g)]} for lb, g in graphs]}
    _clear_jit(dev)
    return out


def jit_phase(dev, card: str, n: int = ROWS_PER_TABLE) -> dict:
    """Phase 14: the n=48 cross-device check, (a) and (b); (b)'s first
    execution is held against phase 3's eager aspirin_count where it ran."""
    t0 = time.perf_counter()
    cpu_stats = jit_cross_device(dev)
    serving = jit_serving_phase(dev, card, n, cpu_stats)
    aspirin = jit_aspirin_phase(dev, n, EAGER_RUNS.get("aspirin_count sort-merge") if n == ROWS_PER_TABLE else None)
    seconds = time.perf_counter() - t0
    print(f"  phase 14 in {seconds:.1f} s")
    return {"serving": serving, "aspirin": aspirin, "seconds": seconds}


# ---------------------------------------------------------------------------
# 15. the gather log, the eager join, measure_comm
# ---------------------------------------------------------------------------

# (b)'s rows per table: phase 3's (67,108,864 product rows)
LAZY_EAGER_ROWS = ROWS_PER_TABLE
LAZY_EAGER_CROSS_ROWS = 64
LAZY_EAGER_KEY = 42
# the kernels (b)'s joins and Resizes launch on the fused path: the join's
# equality tree, its valid ANDs, the Resizer's coins and shuffle, and the
# draws of them all
LAZY_EAGER_KERNELS = ("rss_gate", "and_fold", "ks_prefix", "a2b_fused", "shuffle_gather", "threefry_bits")
MEASURE_LANES = RING64_LANES  # phase 4's circuits' lanes
MEASURE_ROWS = 1 << 16


def gather_log_checks(full: dict) -> dict:
    """(a): phase 3's Resizes after a product join."""
    out = {}
    for name, res in full.items():
        for i, r in enumerate(res.get("lazy_resizes", ())):
            label = f"{name} Resize {i} (n={res['n']})"
            check(bool(r["log"]), f"{label}: its {r['lazy_cols']} lazy columns were never gathered")
            check(max(r["log"]) == r["s"] < r["n"], f"{label}: gather log {sorted(set(r['log']))} against S={r['s']} "
                                                    f"of {r['n']} product rows")
            check(not r["left_lazy"], f"{label}: columns {r['left_lazy']} leave the Resize lazy")
            print(f"  {label}: {r['n']} product rows -> S={r['s']}; {len(r['log'])} gathers of "
                  f"{sorted(set(r['log']))} rows for {r['lazy_cols']} lazy columns; {r['bytes_before']:,} bytes "
                  f"before the trim, {r['bytes_after']:,} after")
            out[label] = r
    check(bool(out), "phase 3 ran no Resize after a product join")
    return out


def _lazy_eager_sides(dev, n: int):
    """dosage_study's two filtered HealthLNK tables (n rows each) and the
    PRF of the join and the Resizer."""
    from repro_torch.core import threefry
    from repro_torch.core.prf import setup_prf
    from repro_torch.data import DOSAGE_325MG, ICD9_CIRCULATORY, MED_ASPIRIN, generate_healthlnk
    from repro_torch.ops import Predicate, oblivious_filter

    tables, _ = generate_healthlnk(n=n, seed=0, device=dev)
    prf = setup_prf(threefry.PRNGKey(LAZY_EAGER_KEY))
    d = oblivious_filter(tables["diagnoses"], [Predicate("icd9", "eq", ICD9_CIRCULATORY)], prf.fold(1))
    m = oblivious_filter(tables["medications"], [Predicate("med", "eq", MED_ASPIRIN),
                                                 Predicate("dosage", "eq", DOSAGE_325MG)], prf.fold(2))
    return d, m, prf


def lazy_eager_run(dev, d, m, prf, lazy: bool, shares: bool = False) -> dict:
    """One join of ``d`` and ``m`` on pid, lazy or eager, then the Beta(2,6)
    Resizer: seconds, bytes of the joined table, peak memory, launches, the
    ledger tally, S, the output's true rows and, with ``shares``, its
    shares on the host."""
    import torch

    from repro_torch.core import threefry
    from repro_torch.core.ledger import CommLedger
    from repro_torch.core.noise import BetaNoise
    from repro_torch.core.resizer import Resizer, ResizerConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.ops import oblivious_join
    from repro_torch.ops.table import table_nbytes

    _reset_peak(dev)
    _sync(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    with CommLedger() as led:
        joined = oblivious_join(d, m, ("pid", "pid"), prf.fold(3), lazy=lazy)
        _sync(dev)
        join_s = time.perf_counter() - t0
        nbytes = table_nbytes(joined)
        resizer = Resizer(ResizerConfig(noise=BetaNoise(2, 6), addition="parallel"))
        out, info = resizer(joined, prf.fold(4), threefry.PRNGKey(LAZY_EAGER_KEY + 2))
    _sync(dev)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    reset_launch_counts()
    run = {"lazy": lazy, "n_product": joined.n, "join_s": join_s, "seconds": seconds, "join_bytes": nbytes,
           "peak_gib": _peak_gib(dev), "launches": launches, "tally": led.tally(), "s": info["s"],
           "shares": share_rows(out) if shares else None, "rows": out.reveal_true_rows()}
    del joined, out
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return run


def _same_rows(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all((a[k] == b[k]).all() for k in a)


def lazy_eager_cross_device(dev, n: int = LAZY_EAGER_CROSS_ROWS) -> None:
    """(b) at n = 64: each path identical on ``cuda`` and ``cpu``."""
    import torch

    runs = {}
    for d in (dev, torch.device("cpu")):
        left, right, prf = _lazy_eager_sides(d, n)
        for lazy in (True, False):
            runs[d.type, lazy] = lazy_eager_run(d, left, right, prf, lazy, shares=True)
    for lazy in (True, False):
        a, b = runs[dev.type, lazy], runs["cpu", lazy]
        check(a["tally"] == b["tally"] and a["s"] == b["s"], f"n={n} lazy={lazy}: ledger or S differ across devices")
        check(_same_rows(a["shares"], b["shares"]), f"n={n} lazy={lazy}: output shares differ across devices")
    lazy_run, eager_run = runs[dev.type, True], runs[dev.type, False]
    check(lazy_run["tally"] == eager_run["tally"] and lazy_run["s"] == eager_run["s"]
          and _same_rows(lazy_run["rows"], eager_run["rows"]), f"n={n}: the lazy and eager paths differ")
    print(f"  n={n}: lazy and eager join + Resize each identical on {dev.type} and cpu (shares, ledger "
          f"{lazy_run['tally']}, S={lazy_run['s']}); lazy = eager in S, rows and ledger")


def lazy_eager_phase(dev, n: int) -> dict:
    """(b) at n rows per table."""
    d, m, prf = _lazy_eager_sides(dev, n)
    runs = {lazy: lazy_eager_run(dev, d, m, prf, lazy) for lazy in (True, False)}
    lazy_run, eager_run = runs[True], runs[False]
    for run in (lazy_run, eager_run):
        label = "lazy" if run["lazy"] else "eager"
        missing = [k for k in LAZY_EAGER_KERNELS if not run["launches"].get(k)]
        if dev.type == "cuda":  # a CPU tensor runs the plain versions and launches nothing
            check(not missing, f"{label} join + Resize at n={n}: {missing} never launched ({run['launches']})")
        print(f"  {label}: {d.n} x {m.n} = {run['n_product']} product rows -> S={run['s']}; join {run['join_s']:.3f} s, "
              f"join + Resize {run['seconds']:.3f} s; joined table {run['join_bytes']:,} bytes; peak "
              f"{run['peak_gib']:.2f} GiB; ledger {run['tally']}; launches {run['launches']}")
    check(lazy_run["s"] == eager_run["s"], f"n={n}: S {lazy_run['s']} (lazy) != {eager_run['s']} (eager)")
    check(lazy_run["tally"] == eager_run["tally"], f"n={n}: the lazy and eager ledgers differ")
    check(_same_rows(lazy_run["rows"], eager_run["rows"]), f"n={n}: the lazy and eager rows differ")
    print(f"  n={n}: lazy = eager in S, the {len(next(iter(lazy_run['rows'].values())))} revealed rows and the "
          f"ledger; the eager join holds {eager_run['join_bytes'] / lazy_run['join_bytes']:.2f}x the lazy one's "
          f"bytes")
    launches: dict = {}
    for run in runs.values():
        _add(launches, run["launches"])
    return {"n": n, "launches": launches,
            "runs": {("lazy" if k else "eager"): {f: v for f, v in r.items() if f not in ("shares", "rows")}
                     for k, r in runs.items()}}


def measure_comm_phase(dev, lanes: int = MEASURE_LANES, rows: int = MEASURE_ROWS) -> dict:
    """(c): ``measure_comm`` on ``meta`` against the executed ledger."""
    import numpy as np

    from repro_torch.core import circuits, threefry
    from repro_torch.core.ledger import CommLedger, measure_comm
    from repro_torch.core.prf import setup_prf
    from repro_torch.core.sharing import AShare, BShare
    from repro_torch.core.shuffle import secure_shuffle
    from repro_torch.core.sort import bitonic_sort
    from repro_torch.kernels import override_fusion, reset_launch_counts

    rng = np.random.default_rng(15)
    prf = setup_prf(threefry.PRNGKey(15))
    x, y = BShare(words(rng, (3, lanes), dev)), BShare(words(rng, (3, lanes), dev))
    xa = AShare(words(rng, (3, lanes), dev))
    cols = {name: BShare(words(rng, (3, rows), dev)) for name in ("k", "v", "w")}
    cases = {
        f"lt {lanes}": (lambda a, b: circuits.lt(a, b, prf), (x, y)),
        f"eq {lanes}": (lambda a, b: circuits.eq(a, b, prf), (x, y)),
        f"a2b {lanes}": (lambda a: circuits.a2b(a, prf), (xa,)),
        f"bit2a {lanes}": (lambda a: circuits.bit2a(a, prf), (x,)),
        f"secure_shuffle {rows} x 3": (lambda c: secure_shuffle(c, prf), (cols,)),
        f"bitonic_sort {rows} x 3": (lambda c: bitonic_sort(c, "k", prf), (cols,)),
    }
    out = {}
    for fuse in (True, False):
        path = "fused" if fuse else "gates"
        with override_fusion(fuse):
            for name, (fn, args) in cases.items():
                t0 = time.perf_counter()
                meta = measure_comm(fn, *args)
                meta_s = time.perf_counter() - t0
                _sync(dev)
                t0 = time.perf_counter()
                with CommLedger() as led:
                    fn(*args)
                _sync(dev)
                run_s = time.perf_counter() - t0
                check(meta == led.tally(), f"{name} {path}: measure_comm {meta} != executed {led.tally()}")
                print(f"  {name} {path}: {meta} on meta in {meta_s:.3f} s = executed on {dev.type} in {run_s:.3f} s")
                out[f"{name} {path}"] = {"tally": meta, "meta_s": meta_s, "run_s": run_s}
    reset_launch_counts()
    return out


def surface_phase(dev, full: dict, n: int = LAZY_EAGER_ROWS) -> dict:
    """Phase 15: (a) the gather log over phase 3's runs, (b) lazy against
    eager, (c) measure_comm against execution."""
    t0 = time.perf_counter()
    print("  (a) the gather log over phase 3's product-join Resizes")
    resizes = gather_log_checks(full)
    print(f"  (b) lazy against eager: dosage_study's filtered tables, n={LAZY_EAGER_CROSS_ROWS} on both devices, "
          f"then n={n}")
    lazy_eager_cross_device(dev)
    joins = lazy_eager_phase(dev, n)
    print("  (c) measure_comm on meta against execution, both circuit paths")
    measured = measure_comm_phase(dev)
    seconds = time.perf_counter() - t0
    print(f"  phase 15 in {seconds:.1f} s")
    return {"resizes": resizes, "joins": joins, "measure_comm": measured, "launches": joins["launches"],
            "seconds": seconds}


# ---------------------------------------------------------------------------
# 5. (--profile) device-time breakdown of the two heaviest operators
# ---------------------------------------------------------------------------

def _kernel_category(name: str) -> str:
    low = name.lower()
    for kernel in ("rss_gate", "shuffle_gather", "ks_prefix", "and_fold", "a2b", "bit2a", "bitonic_swap"):
        if kernel in low:
            return f"{kernel} kernel"
    if "gemm" in low or "xmma" in low or "cutlass" in low or "nvjet" in low:
        return "matmul (cuBLAS)"
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
    that ``--profile`` traces; and the largest draw (keys, words a key)."""
    def pow2(k: int) -> int:
        return 1 << max(k - 1, 0).bit_length()

    sort_rows = join_rows = resize_rows = count_rows = distinct_rows = 1
    hop = (1, 3, (1,))
    draw = max((tuple(res["largest_draw"]) for res in full.values()), key=lambda d: d[0] * d[1])
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
            "resize_rows": resize_rows, "count_rows": count_rows, "distinct_rows": distinct_rows, "hop": hop,
            "draw": draw}


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

    print(f"[6] batched execution: K={BATCH_SLOTS} slots of the sort-merge dosage_study at n={LATER_ROWS}")
    from repro_torch.core.noise import RevealNoise

    batch = batch_phase(dev, LATER_ROWS)
    # S = T in every slot: the slots stay stacked through the join and the
    # Distinct, so every kernel runs stacked
    stacked = batch_phase(dev, LATER_ROWS, noise=RevealNoise())
    batch_cross_device(dev)

    print(f"[7] tracing: the sort-merge dosage_study at n={ROWS_PER_TABLE} under a Tracer")
    traced = tracing_phase(dev, ROWS_PER_TABLE)

    print(f"[8] the service: AnalyticsService over n={LATER_ROWS} rows per table, pool on, durable state")
    service = service_phase(dev, LATER_ROWS)
    service_cross_device(dev)

    print(f"[9] the networked runtime: three parties on {dev} over n={LATER_ROWS} rows per table "
          f"(loopback threads, TCP processes, the SQL CLI)")
    runtime = runtime_phase(dev, LATER_ROWS)

    t10 = time.perf_counter()
    print(f"[10] ring-64: the five 64-bit builds at {RING64_LANES} and {RING64_ODD} lanes, then the circuits")
    wide_errs = wide_kernel_checks(dev, device_generator(dev, 10))
    ring64 = ring64_phase(dev)
    print("  64-bit builds timed at the circuits' shapes")
    wide_timing = time_wide(dev, device_generator(dev, 11))
    print(f"  sort&cut: the paper's four modes over the sort-merge {', '.join(SORTCUT_QUERIES)} at "
          f"n={SORTCUT_ROWS} (the product-join dosage_study at n={SORTCUT_PRODUCT_ROWS})")
    sortcut = sortcut_phase(dev, SORTCUT_ROWS, SORTCUT_PRODUCT_ROWS)
    print(f"  phase 10 in {time.perf_counter() - t10:.1f} s")

    print("[11] the LM side's serving path (models, configs, serve): no TPU kernel lies on it")
    lm = lm_phase(dev, card)

    print("[12] the LM side's training path (pipeline, AdamW, train step with remat, checkpoints, the "
          "launcher): no TPU kernel lies on it")
    train = train_phase(dev, card)

    print("[13] the LM side's multi-device stack (sharding rules, one-rank NCCL (1, 1) and (1, 1, 1) meshes, the "
          "roofline): no TPU kernel lies on it")
    sharded = shard_phase(dev, card, lm, train)

    print(f"[14] the serving configuration under jit_ops=True (the per-operator cache as CUDA graphs) at "
          f"n={ROWS_PER_TABLE}")
    jit = jit_phase(dev, card)

    print(f"[15] the reference's remaining MPC surface: the gather log, the eager join at n={LAZY_EAGER_ROWS}, "
          f"measure_comm on meta")
    surface = surface_phase(dev, full)

    # launches on the main paths: phase 3's runs, phase 6's batches, phase
    # 8's submits and batch, phase 9's networked submits, phase 10's
    # sort&cut runs and phase 15's joins and Resizes; a 64-bit build's,
    # phase 10's ring-64 circuits
    launches = {k: sum(r["launches"].get(k, 0) for r in full.values()) + batch["launches"].get(k, 0)
                + stacked["launches"].get(k, 0) + service["launches"].get(k, 0) + runtime["launches"].get(k, 0)
                + sortcut["launches"].get(k, 0) + surface["launches"].get(k, 0)
                for k in KERNELS}
    summary = {"kernels": []}
    for name, (source, tpu) in KERNELS.items():
        rows = timing[name]
        # the row of the largest call: most lanes (rss_gate: arithmetic last),
        # or most bytes for the fused kernels
        top = max(rows, key=lambda r: (r.get("bytes", 0), r["n"], r.get("boolean", False)))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": tpu, "launches": launches[name],
            "max_abs_err": max(errs[name], *(r["max_abs_err"] for r in rows)),
            "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top.get("library_ms"),
        }
        if name in WIDE_KERNELS:
            # the largest call of the 64-bit build (rss_gate: arithmetic)
            wrows = wide_timing[name]
            wtop = max(wrows, key=lambda r: (r["bytes"], "bool=0" in r["label"]))
            entry["u64"] = {
                "max_abs_err": max(wide_errs[name], *(r["max_abs_err"] for r in wrows)),
                "ms": wtop["ms"], "plain_ms": wtop["plain_ms"], "bound_ms": wtop["bound_ms"],
                "bound_by": wtop["bound_by"], "launches": ring64["launches"].get(name + "_u64", 0),
            }
        summary["kernels"].append(entry)
    total_s = time.perf_counter() - t_all
    details = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "n": ROWS_PER_TABLE, "later_n": LATER_ROWS, "three_join_n": THREE_JOIN_ROWS, "big_n": BIG_ROWS, "build_s": build_s, "total_s": total_s, "full": full,
               "timing": timing, "profile": profiled, "batch": [batch, stacked], "tracing": traced, "service": service, "runtime": runtime,
               "ring64": ring64, "wide_timing": wide_timing, "sortcut": sortcut, "lm": lm, "train": train,
               "sharding": sharded, "jit": jit, "surface": surface, "summary": summary}
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
