"""What a run records: each answer of the window, the benchmark's own host
spans, and the run's record that the metric readers read."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional

__all__ = ["Answer", "Spans", "Record", "share_bits"]


@dataclasses.dataclass
class Answer:
    """One query's answer as the program gave it, and its times (host
    ``perf_counter`` seconds)."""

    query: str
    client: str
    t_submit: float
    t_done: float
    rows: Optional[Dict[str, Any]] = None  # revealed columns (numpy)
    report: Any = None  # the program's ExecutionReport
    compile_s: float = 0.0
    accountant_s: float = 0.0
    slots: int = 1  # queries in the engine pass this one rode in
    ring_bits: Optional[int] = None  # the narrowest word of the shares it was revealed from
    error: Optional[str] = None  # why no answer came
    ok: Optional[bool] = None  # set by the judge


def share_bits(table) -> int:
    """The narrowest word, in bits, of the tensors that hold a secret
    table's shares (every column's and the valid bit's): the ring the
    answer revealed from it was computed in."""
    import torch

    bits = []
    for col in [*table.cols.values(), table.valid]:
        shares = col.base.shares if hasattr(col, "base") else col.shares
        info = torch.finfo if shares.dtype.is_floating_point else torch.iinfo
        bits.append(info(shares.dtype).bits)
    return min(bits)


class Spans:
    """Host spans the benchmark records around its calls into the program's
    layers, with ``time.time_ns`` clocks (the profiler's time base). Off,
    ``span`` records nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.items: List[tuple] = []  # (name, start_ns, end_ns)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))


@dataclasses.dataclass
class Record:
    """A run's record. ``window_s`` runs from the window's start to the end
    of its last query; ``answers`` are the window's, judged; ``device`` holds the
    traced run's device readings (``None`` untraced), which cover the window
    from ``t_trace`` (``None`` untraced) to its end."""

    cell: str
    config: Dict
    traffic: Dict
    setup_s: float
    t_start: float  # the window's start (perf_counter)
    window_s: float
    answers: List[Answer]
    peak_window_bytes: int
    device: Optional[Dict] = None
    t_trace: Optional[float] = None  # the device trace's start (perf_counter)

    @property
    def good(self) -> List[Answer]:
        return [a for a in self.answers if a.ok]

    @property
    def traced(self) -> List[Answer]:
        """The answers of the rounds the device trace covers."""
        if self.t_trace is None:
            return []
        return [a for a in self.answers if a.t_submit >= self.t_trace]
