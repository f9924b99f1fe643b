"""The served deployment: ``AnalyticsService`` with the configuration's
settings, its tenants enqueuing SQL and one drain answering them.

A round is one query template: every tenant enqueues it (compile through
the plan cache, admission by the accountant), then one ``drain`` runs the
scheduler's stacked pass (under ``jit_ops``, replayed CUDA graphs), records
each query in the durable budget state and reveals each answer. A tenant's
wait runs from the start of its enqueue to the drain's return.
"""
from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np

from ..harness.record import Answer, Spans, share_bits
from ..harness.spec import check_keys

__all__ = ["Entry"]

# the configuration's service settings this entry reads; any other is refused
SERVICE_KEYS = {"placement", "noise", "addition", "accountant", "wal_fsync", "plan_cache_size", "offline",
                "offline_pool_bytes", "jit_ops", "batch_max", "batch_wait_s", "engine_key"}


def pid_catalog(tables: Dict, plain: Dict):
    """The catalog declaring each table's pid bound: the largest count of
    one pid in it."""
    from repro_torch.sql import Catalog

    mult = {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}
    return Catalog.from_tables(tables, multiplicity=mult)


class Entry:
    def __init__(self, config: Dict, traffic: Dict, tables: Dict, plain: Dict, device, spans: Spans):
        from repro_torch.core import threefry
        from repro_torch.core.noise import TruncatedLaplace
        from repro_torch.service import AnalyticsService, PrivacyAccountant

        cfg = config["service"]
        check_keys("service", cfg, SERVICE_KEYS)
        noise = cfg["noise"]
        check_keys("service.noise", noise, {"kind", "eps", "delta"})
        if noise["kind"] != "tlap":
            raise ValueError(f"service_sql takes TLap noise, not {noise['kind']!r}")
        acct = cfg["accountant"]
        check_keys("service.accountant", acct, {"err", "confidence", "policy"})
        self.state_dir = tempfile.mkdtemp(prefix="chipbench-state-")  # under TMPDIR
        self.spans = spans
        self.sql = dict(traffic["sql"])
        self.service = AnalyticsService(
            tables,
            catalog=pid_catalog(tables, plain),
            noise=TruncatedLaplace(eps=float(noise["eps"]), delta=float(noise["delta"])),
            addition=cfg["addition"],
            placement=cfg["placement"],
            accountant=PrivacyAccountant(err=float(acct["err"]), confidence=float(acct["confidence"]),
                                         policy=acct["policy"]),
            key=threefry.PRNGKey(int(cfg["engine_key"])),
            jit_ops=bool(cfg["jit_ops"]),
            plan_cache_size=int(cfg["plan_cache_size"]),
            batch_max=int(cfg["batch_max"]),
            batch_wait_s=float(cfg["batch_wait_s"]),
            state_dir=self.state_dir,
            wal_fsync=bool(cfg["wal_fsync"]),
            offline=cfg["offline"],
            offline_pool_bytes=int(cfg["offline_pool_bytes"]),
            device=device,
        )
        self.tenants = [f"clinic_{i}" for i in range(int(traffic["clients"]))]
        self.sessions = [self.service.session(t) for t in self.tenants]

    def start_block(self) -> None:
        """Nothing: the dashboard's templates draw no noise, so every block is
        the same work already."""

    def round(self, query: str) -> List[Answer]:
        sql = self.sql[query]
        submitted: Dict[str, float] = {}
        errors: Dict[str, str] = {}
        for tenant, session in zip(self.tenants, self.sessions):
            submitted[tenant] = time.perf_counter()
            try:
                with self.spans.span("bench.enqueue"):
                    session.enqueue(sql)
            except Exception as err:  # a refusal or a failed stacked pass: judged later
                errors[tenant] = f"{type(err).__name__}: {err}"
        results = []
        try:
            with self.spans.span("bench.drain"):
                results = self.service.drain()
        except Exception as err:
            for tenant in self.tenants:
                errors.setdefault(tenant, f"{type(err).__name__}: {err}")
        done = time.perf_counter()
        by_tenant = {r.tenant: r for r in results}
        answers = []
        for tenant in self.tenants:
            r = by_tenant.get(tenant)
            if r is None:
                answers.append(Answer(query, tenant, submitted[tenant], done,
                                      error=errors.get(tenant, "no answer in the drain")))
                continue
            answers.append(Answer(query, tenant, submitted[tenant], done, rows=r.rows, report=r.report,
                                  compile_s=r.compile_seconds, accountant_s=r.accountant_seconds,
                                  slots=r.batch_slots, ring_bits=share_bits(r.table)))
        return answers

    def close(self) -> None:
        self.service.close()
        self.sessions.clear()
        shutil.rmtree(self.state_dir, ignore_errors=True)
