"""The paper's evaluation setting: the port's hand plans with Resizers
placed by the configuration, run directly on ``Engine.execute``.

Each query gets an engine of its own, keyed from the configuration's
``engine_key`` and the query's place among the program's plans, and made
anew at the start of every block: every execution draws fresh Resizer
noise from its engine's counter, and a query's k-th execution in a block
draws the same noise in every block, whatever order the seed gives the
queries. A mix that runs each query several times a block so samples the
noise at as many draws, and every block is the same work, the warm block
included: a window's work does not hang on how many blocks it holds. A
round executes one query and reveals its answer (the analyst's reveal, and
the root's ``post_reveal``: AVG's quotient).
"""
from __future__ import annotations

import time
from typing import Dict, List

from ..harness.record import Answer, Spans, share_bits
from ..harness.spec import check_keys
from ..harness.traffic import queries

__all__ = ["Entry"]

# the configuration's engine settings this entry reads; any other is refused
ENGINE_KEYS = {"placement", "resizer", "fuse_circuits", "join_algo", "join_tile", "jit_ops", "engine_key"}


def _resizer(cfg: Dict):
    from repro_torch.core.noise import BetaNoise
    from repro_torch.core.resizer import ResizerConfig

    r = cfg["resizer"]
    check_keys("engine.resizer", r, {"noise", "alpha", "beta", "addition"})
    if r["noise"] != "beta":
        raise ValueError(f"engine_plans takes Beta noise, not {r['noise']!r}")
    return ResizerConfig(noise=BetaNoise(float(r["alpha"]), float(r["beta"])), addition=r["addition"])


class Entry:
    def __init__(self, config: Dict, traffic: Dict, tables: Dict, plain: Dict, device, spans: Spans):
        from repro_torch.config import RuntimeConfig
        from repro_torch.core import threefry
        from repro_torch.data import all_query_plans
        from repro_torch.engine import Engine
        from repro_torch.plan import insert_resizers

        cfg = config["engine"]
        check_keys("engine", cfg, ENGINE_KEYS)
        resizer = _resizer(cfg)
        runtime = RuntimeConfig(join_tile=int(cfg["join_tile"]), fuse_circuits=bool(cfg["fuse_circuits"]),
                                join_algo=cfg["join_algo"])
        plans = all_query_plans()
        names = sorted(plans)
        self.spans = spans
        self.plans = {q: insert_resizers(plans[q], lambda node: resizer, placement=cfg["placement"])
                      for q in queries(traffic)}
        self.keys = {q: threefry.PRNGKey(int(cfg["engine_key"]) + names.index(q)) for q in self.plans}
        self.new_engine = lambda key: Engine(tables, key=key, jit_ops=bool(cfg["jit_ops"]), config=runtime,
                                             device=device)
        self.engines = {}

    def start_block(self) -> None:
        """New engines: the block's executions draw the noise every block draws."""
        self.engines = {q: self.new_engine(key) for q, key in self.keys.items()}

    def round(self, query: str) -> List[Answer]:
        from repro_torch.plan.registry import lookup

        plan = self.plans[query]
        t0 = time.perf_counter()
        try:
            with self.spans.span("bench.execute"):
                out, report = self.engines[query].execute(plan)
            with self.spans.span("bench.reveal"):
                bits = share_bits(out)
                rows = out.reveal_true_rows()
                post = lookup(type(plan)).post_reveal
                if post is not None:
                    rows = {**rows, **post(plan, rows)}
        except Exception as err:  # an answer that never comes is a failure, judged later
            return [Answer(query, "analyst", t0, time.perf_counter(), error=f"{type(err).__name__}: {err}")]
        return [Answer(query, "analyst", t0, time.perf_counter(), rows=rows, report=report, ring_bits=bits)]

    def close(self) -> None:
        self.plans.clear()
        self.engines.clear()
        self.new_engine = None
