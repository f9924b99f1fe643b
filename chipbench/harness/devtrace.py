"""The traced run's device readings, from ``torch.profiler`` (CUPTI) and
from the operands of every kernel launch.

Prepared in set-up and started at a block's start, :class:`DeviceTrace`
profiles the device's activity only (no CPU operator events: they would
cost the host time the cells measure) and wraps each kernel's Python launch function (``kernel_costs/<kernel>.py``'s
``LAUNCHER``) so that every launch adds its least time, the larger of its
bytes over the memory bandwidth and its operations over the integer rate.
Aggregates stay in memory; no trace file is written.

Afterwards ``readings(spans)`` gives:

* ``busy_s`` and ``window_s``: the union of the device's activity
  intervals (kernels, copies, sets) inside the window, and its length;
* ``kernels``: {kernel name: [events, device seconds]};
* ``families``: for each kernel of ``kernel_costs/``: its device events and
  seconds, the launches its counters counted and the sum of their least
  times;
* ``idle_by_span``: idle seconds by the host span the idle gap's midpoint
  falls in (the innermost one), ``"outside spans"`` where none.
"""
from __future__ import annotations

import importlib
import re
import time
from collections import defaultdict
from typing import Dict, List

import torch

__all__ = ["DeviceTrace", "short_name"]


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces, template
    arguments and parameters, with the operation of a PyTorch elementwise
    kernel beside it: ``void at::native::vectorized_elementwise_kernel<4,
    at::native::BinaryFunctor<int, int, int, at::native::BitwiseXorFunctor<int>
    >, ...>(...)`` -> ``at::native::vectorized_elementwise_kernel[BitwiseXorFunctor]``."""
    plain = re.sub(r"\(anonymous namespace\)::", "", name)
    plain = re.sub(r"^void\s+", "", plain)
    base = re.match(r"[\w:~]+", plain)
    base = base.group(0) if base else plain
    ops = [f for f in re.findall(r"(\w+Functor\w*)", plain) if not f.startswith(("BinaryFunctor", "UnaryFunctor",
                                                                                  "AUnaryFunctor", "BUnaryFunctor"))]
    if not ops:
        ops = re.findall(r"::(\w+)\(\)::\{lambda", plain)[:1] or re.findall(r"launch_(\w+)", plain)[:1]
    return (f"{base}[{ops[-1]}]" if ops else base)[:96]


class DeviceTrace:
    def __init__(self, costs: Dict[str, object], peaks: Dict, counters=None):
        self.costs = costs
        self.hbm = float(peaks["hbm_bytes_per_s"])
        self.ops = float(peaks["int32_ops_per_s"])
        self.counters = counters  # () -> {counter: launches}, the program's
        self.least_s = defaultdict(float)
        self._saved: List[tuple] = []
        self._prof = None
        self._patterns = {k: re.compile(r"\b(" + "|".join(map(re.escape, m.DEVICE_KERNELS)) + r")\b")
                          for k, m in costs.items()}

    # -- the launch functions' operands ----------------------------------
    def _wrap(self, kernel: str, module) -> None:
        mod_name, attr = module.LAUNCHER
        owner = importlib.import_module(mod_name)
        fn = getattr(owner, attr)
        cost = module.cost

        def launcher(*args, **kwargs):
            nbytes, nops = cost(*args, **kwargs)
            self.least_s[kernel] += max(nbytes / self.hbm, nops / self.ops)
            return fn(*args, **kwargs)

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, launcher)

    def prepare(self) -> "DeviceTrace":
        """The profiler's set-up (CUPTI and its libraries), recording nothing yet."""
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.prepare_trace()
        return self

    def start(self) -> None:
        """Record from here: the device's activity and every launch's operands."""
        for kernel, module in self.costs.items():
            self._wrap(kernel, module)
        self._launches0 = dict(self.counters()) if self.counters else {}
        torch.cuda.synchronize()
        self._prof.start_trace()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        try:
            torch.cuda.synchronize()
            self.t1_ns = time.time_ns()
            t = time.perf_counter()
            self._prof.stop_trace()
            self.stop_s = time.perf_counter() - t
            now = dict(self.counters()) if self.counters else {}
            self.launches = {k: now.get(k, 0) - self._launches0.get(k, 0) for k in now}
        finally:
            for owner, attr, fn in reversed(self._saved):
                setattr(owner, attr, fn)
            self._saved.clear()

    # -- readings -----------------------------------------------------------
    def readings(self, spans: List[tuple]) -> Dict:
        t0, t1 = self.t0_ns, self.t1_ns
        intervals = []
        kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
        events = 0
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            events += 1
            s, d = e.start_ns(), e.duration_ns()
            if s + d <= t0 or s >= t1:
                continue
            s, end = max(s, t0), min(s + d, t1)
            intervals.append((s, end))
            k = kernels[e.name()]
            k[0] += 1
            k[1] += (end - s) / 1e9
        intervals.sort()
        busy, gaps, cur = 0, [], t0
        for s, end in intervals:
            if s > cur:
                gaps.append((cur, s))
            if end > cur:
                busy += end - max(s, cur)
                cur = end
        if t1 > cur:
            gaps.append((cur, t1))
        families = {}
        for kernel, module in self.costs.items():
            pat = self._patterns[kernel]
            hits = [v for name, v in kernels.items() if pat.search(name)]
            families[kernel] = {
                "events": sum(v[0] for v in hits),
                "device_s": sum(v[1] for v in hits),
                "launches": sum(self.launches.get(c, 0) for c in module.COUNTERS),
                "least_s": self.least_s.get(kernel, 0.0),
            }
        return {
            "busy_s": busy / 1e9,
            "window_s": (t1 - t0) / 1e9,
            "kernels": {name: list(v) for name, v in kernels.items()},
            "families": families,
            "idle_by_span": idle_by_span(gaps, spans),
            "events": events,
        }


def idle_by_span(gaps: List[tuple], spans: List[tuple]) -> Dict[str, float]:
    """Idle seconds by the innermost host span (name, start_ns, end_ns)
    holding each gap's midpoint. Spans nest, so a stack swept along time
    holds the spans open at each midpoint, the innermost on top."""
    spans = sorted(spans, key=lambda s: (s[1], -s[2]))
    out: Dict[str, float] = defaultdict(float)
    stack: List[tuple] = []
    i = 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        while i < len(spans) and spans[i][1] <= mid:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        out[stack[-1][0] if stack else "outside spans"] += (g1 - g0) / 1e9
    return dict(out)
