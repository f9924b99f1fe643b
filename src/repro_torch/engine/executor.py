"""Query execution engine.

Executes a plan tree bottom-up, eagerly. Every operator protocol runs on
static shapes; the only place a public size changes is a ``Resize`` node's
reveal-and-trim. Each node runs under its own :class:`CommLedger` and the
engine records a per-node report: wall seconds (on the card, after a
``torch.cuda.synchronize()``), the ledger's (rounds, bytes/party), and the
input/output oblivious sizes. The engine's ``RuntimeConfig.fuse_circuits``
holds for the whole execution (:func:`~repro_torch.kernels.override_fusion`),
as the reference applies its config. A port of ``repro.engine.executor``'s
serial path: the jit cache, batched execution and tracing are not ported
yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from ..config import RuntimeConfig, resolve_device
from ..core import threefry
from ..core.ledger import CommLedger
from ..core.prf import setup_prf
from ..kernels import override_fusion
from ..ops.table import SecretTable
from ..plan.nodes import PlanNode
from ..plan.registry import infer_schema, lookup
from ..sql.catalog import Catalog

__all__ = ["Engine", "ExecutionReport", "NodeStats"]


@dataclasses.dataclass
class NodeStats:
    node: str
    n_in: int  # first input's oblivious size
    n_out: int
    seconds: float
    bytes_per_party: int
    rounds: int
    n_ins: List[int] = dataclasses.field(default_factory=list)  # all inputs
    extra: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ExecutionReport:
    nodes: List[NodeStats] = dataclasses.field(default_factory=list)

    @property
    def total_seconds(self) -> float:
        return sum(s.seconds for s in self.nodes)

    @property
    def total_bytes(self) -> int:
        return sum(s.bytes_per_party for s in self.nodes)

    @property
    def total_rounds(self) -> int:
        return sum(s.rounds for s in self.nodes)

    def summary(self) -> str:
        lines = [
            f"{'node':<42}{'n_ins':>11}{'n_out':>9}{'sec':>9}"
            f"{'MiB/party':>11}{'rounds':>8}  extra"
        ]
        for s in self.nodes:
            ins = "x".join(str(n) for n in s.n_ins) if s.n_ins else "-"
            note = f"S={s.extra['s']}" if "s" in s.extra else ""
            lines.append(
                (
                    f"{s.node:<42}{ins:>11}{s.n_out:>9}{s.seconds:>9.3f}"
                    f"{s.bytes_per_party / 2**20:>11.3f}{s.rounds:>8}  {note}"
                ).rstrip()
            )
        lines.append(
            f"{'TOTAL':<42}{'':>11}{'':>9}{self.total_seconds:>9.3f}"
            f"{self.total_bytes / 2**20:>11.3f}{self.total_rounds:>8}"
        )
        return "\n".join(lines)


class Engine:
    """Executes plans over a set of secret-shared base tables.

    ``device`` (default ``"cuda"``; raises without a card unless ``"cpu"``)
    must be where the tables' shares lie. ``key`` is a (2,) threefry key;
    the PRF setup derives from ``fold_in(key, 7)`` as in the reference.
    """

    def __init__(
        self,
        tables: Dict[str, SecretTable],
        key: Optional[torch.Tensor] = None,
        config: Optional[RuntimeConfig] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        for name, t in tables.items():
            if t.device.type != self.device.type:
                raise ValueError(f"table {name!r} lies on {t.device}, the engine runs on {self.device}")
        self.tables = tables
        self.key = key if key is not None else threefry.PRNGKey(0)
        self.prf = setup_prf(threefry.fold_in(self.key, 7))
        self.config = config or RuntimeConfig()
        self._resize_ctr = 0
        self._last_resize_info: Optional[Dict] = None

    def execute(self, plan: PlanNode) -> tuple[SecretTable, ExecutionReport]:
        # unknown columns raise PlanSchemaError here, before any MPC work
        infer_schema(plan, Catalog.from_tables(self.tables))
        report = ExecutionReport()
        self._last_resize_info = None
        with override_fusion(self.config.fuse_circuits):
            out = self._run(plan, report)
        return out, report

    def _block(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, node: PlanNode, report: ExecutionReport) -> SecretTable:
        children = [self._run(c, report) for c in node.children()]
        d = lookup(type(node))
        led = CommLedger()
        t0 = time.perf_counter()
        with led:
            out = d.apply(self, node, children)
        self._block()
        dt = time.perf_counter() - t0
        tally = led.tally()
        n_ins = [t.n for t in children]
        extra: Dict = {}
        if d.provides_resize_info:
            extra = self._last_resize_info or {}
            self._last_resize_info = None
        report.nodes.append(
            NodeStats(
                node=node.describe(),
                n_in=n_ins[0] if n_ins else 0,
                n_ins=n_ins,
                n_out=out.n,
                seconds=dt,
                bytes_per_party=int(tally["bytes_per_party"]),
                rounds=int(tally["rounds"]),
                extra=extra,
            )
        )
        return out
