"""One run of one cell: set-up, the measured window, the judge, the metrics.

Set-up makes the plaintext tables from the seed (the configuration's
reference), shares them under a key drawn from the seed
(``SecretTable.from_plaintext``), builds the deployment (the configuration's
entry) and runs one warm block, every execution of the mix's block: the
kernels' build, where it is not cached, every CUDA-graph capture and every
shape the window's blocks will use fall there. The
window then runs whole blocks of rounds in a closed loop until ``seconds``
have passed; it ends with the last query's answer. Each block starts with
the entry's ``start_block()``, so that every block is the same work. Once
the window has closed, the peak memory is read, the program's state is
freed, and every answer of the window is judged against the reference's.

A traced run profiles the device over the window's last ``trace_seconds``
(the mix's, default the whole window), from the first block that starts
after ``seconds - trace_seconds`` to the window's end (a block more where
none did): a mix whose device runs hundreds of thousands of kernels a
second would otherwise take longer to read than a run may last. The
profiler is prepared in set-up, so that its own start-up falls outside the
window and it records from the first kernel of the traced blocks.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import spec
from .judge import LIMITS, judge
from .record import Record, Spans
from .traffic import blocks, queries

__all__ = ["run_cell", "RECORDED_SPANS"]

# spans of the program's tracer that are recorded after the work they time
# (their ``ts`` is the end): the engine's nodes and the service's steps
RECORDED_SPANS = ("compile", "admit", "schedule.wait", "offline.pass")


def _tracer_spans(tracer) -> List[tuple]:
    """The program's ``obs.trace`` spans as (name, start_ns, end_ns)."""
    out = []
    for s in tracer.spans:
        ts, dur = int(s.ts * 1e9), int(s.seconds * 1e9)
        recorded = s.name.startswith("node[") or s.name in RECORDED_SPANS
        out.append((s.name, ts - dur, ts) if recorded else (s.name, ts, ts + dur))
    return out


def share(plain: Dict, seed: int, device) -> Dict:
    """Every plaintext table shared on ``device`` under a key drawn from the seed."""
    from repro_torch.core import threefry
    from repro_torch.ops.table import SecretTable

    keys = threefry.split(threefry.PRNGKey(seed), len(plain))
    return {name: SecretTable.from_plaintext(cols, k, device=device) for (name, cols), k in zip(plain.items(), keys)}


def _log(msg: str) -> None:
    print(f"chipbench: {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_process0: float,
             data: Optional[Dict] = None) -> Tuple[Dict, Record]:
    """Run ``cell`` once; return its result line (a dict) and its record.
    ``data`` replaces the configuration's data sizes (the CPU tests' small
    tables)."""
    from repro_torch.kernels import launch_counts
    from repro_torch.obs.trace import Tracer

    t = time.perf_counter()
    _log(f"set-up: start to harness {t - t_process0:.3f} s")
    ref = spec.reference(cell.config)
    plain = ref.make_tables(data or cell.config["data"], seed)
    tables = share(plain, seed, device)
    _sync(device)
    t, t_prev = time.perf_counter(), t
    _log(f"set-up: tables made and shared {t - t_prev:.3f} s")
    spans = Spans(on=trace)
    entry = spec.entry(cell.config).Entry(cell.config, cell.traffic, tables, plain, device, spans)
    entry.start_block()
    for q in queries(cell.traffic):
        for _ in range(int(cell.traffic["block"][q])):
            got = entry.round(q)
            for a in got:
                if a.error is not None:
                    raise RuntimeError(f"the warm {q} failed for {a.client}: {a.error}")
            _sync(device)
            t, t_prev = time.perf_counter(), t
            _log(f"set-up: warm {q} {t - t_prev:.3f} s ({_slowest_nodes(got[0].report)})")
    gc.collect()
    on_card = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    rounds = blocks(cell.traffic, seed)
    trace_from = seconds - float(cell.traffic.get("trace_seconds", seconds))
    tracer = t_trace = None
    devtrace = _device_trace(launch_counts) if trace and on_card else None
    answers = []
    t_start = time.perf_counter()
    setup_s = t_start - t_process0
    try:
        while True:
            if trace and tracer is None and time.perf_counter() - t_start >= trace_from:
                tracer = Tracer().__enter__()
                if devtrace is not None:
                    devtrace.start()
                t_trace = time.perf_counter()
            entry.start_block()
            for q in next(rounds):
                answers.extend(entry.round(q))
            if time.perf_counter() - t_start >= seconds and (tracer is not None or not trace):
                break
    finally:
        _sync(device)
        if devtrace is not None and tracer is not None:
            devtrace.stop()
        if tracer is not None:
            tracer.__exit__(None, None, None)
    window_s = answers[-1].t_done - t_start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    _log(f"window {window_s:.3f} s, {len(answers)} answers; {_durations(answers)}")
    device_readings = None
    if devtrace is not None:
        t = time.perf_counter()
        device_readings = devtrace.readings(spans.items + _tracer_spans(tracer))
        _log(f"trace: profiler stop {devtrace.stop_s:.3f} s, readings {time.perf_counter() - t:.3f} s, "
             f"{device_readings['events']} device events")
        del devtrace
    entry.close()
    del entry, tables
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    _log(f"resizes (N -> S) of the window's first block: {_resizes(answers, cell.traffic)}")
    checks = judge(answers, ref, lambda q: ref.answer(q, plain), int(cell.config["guarantees"]["ring_bits"]))
    rec = Record(cell=cell.name, config=cell.config, traffic=cell.traffic, setup_s=setup_s, t_start=t_start,
                 window_s=window_s, answers=answers, t_trace=t_trace, peak_window_bytes=peak,
                 device=device_readings)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader("layer_metrics" if trace else "end_to_end", m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1,
        "memory_peak_bytes": max(setup_peak, peak),
    }
    out = {
        "correct": all(checks[k] <= LIMITS[k] for k in LIMITS),
        "attempted": len(answers),
        "failed": sum(not a.ok for a in answers),
        "metrics": metrics,
        "device": dev,
    }
    if device_readings is not None:
        dev["busy_s"] = device_readings["busy_s"]
        dev["window_s"] = device_readings["window_s"]
        out["breakdown"] = breakdown(device_readings)
    out["checks"] = {k: {"value": checks[k], "limit": LIMITS[k]} for k in LIMITS}
    return out, rec


def _device_trace(counters):
    """The device trace, prepared (the profiler's own set-up, outside the window)."""
    from .devtrace import DeviceTrace

    return DeviceTrace(spec.kernel_costs(), spec.peaks(), counters=counters).prepare()


def _slowest_nodes(report, k: int = 3) -> str:
    nodes = sorted(report.nodes, key=lambda s: -s.seconds)[:k] if report is not None else []
    return ", ".join(f"{s.node} {s.seconds:.3f} s" for s in nodes)


def _resizes(answers: List, traffic: Dict) -> str:
    """Each Resize's input size N and revealed size S, for every answer of
    the window's first block (in its order): the noise the blocks draw."""
    per_block = sum(int(k) for k in traffic["block"].values()) * int(traffic.get("clients", 1))
    out = []
    for a in answers[:per_block]:
        nodes = a.report.nodes if a.report is not None else []
        sizes = [f"{s.n_in}->{s.n_out}" for s in nodes if s.node.startswith("Resize")]
        if sizes:
            out.append(f"{a.query} [{', '.join(sizes)}]")
    return "; ".join(out) or "none"


def _durations(answers: List) -> str:
    """Each query's count and its answers' shortest, median and longest
    seconds, enqueue (or start) to answer."""
    by: Dict[str, List[float]] = {}
    for a in answers:
        by.setdefault(a.query, []).append(a.t_done - a.t_submit)
    return "; ".join(f"{q} {len(v)} x {min(v):.3f}/{sorted(v)[len(v) // 2]:.3f}/{max(v):.3f} s"
                     for q, v in sorted(by.items()))


def breakdown(readings: Dict) -> Dict:
    """The ten device operations that took most time, and the ten host spans
    in which the device sat idle longest."""
    from .devtrace import short_name

    ops: Dict[str, float] = {}
    for name, (_, s) in readings["kernels"].items():
        ops[short_name(name)] = ops.get(short_name(name), 0.0) + s
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(readings["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
