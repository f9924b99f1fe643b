"""AnalyticsService: a multi-tenant SQL front end over the Engine (a port of
``repro.service.service``).

Each tenant opens a :class:`TenantSession` and submits SQL strings; the
service compiles them through :mod:`repro_torch.sql` (predicate pushdown,
cost-based join ordering, Resizer placement), runs them on one shared
:class:`Engine` on ``device`` (``"cuda"`` unless the caller asks for
``"cpu"``), and returns revealed results plus the full per-node
:class:`ExecutionReport`. The service adds no kernel launch of its own: a
submitted query launches each kernel exactly as often as ``Engine.execute``
of the same compiled plan.

``jit_ops=True`` runs the engine's protocol operators through its
process-wide per-operator cache (CUDA graphs on the card; see
:mod:`repro_torch.engine.executor`), the reference's serving
configuration; the ``reflex_jit_cache_logical`` gauge and the ``jit_cache``
key of :meth:`AnalyticsService.status` read its counters. Everything the
service exports equals the reference's for the same tables, key and SQL
sequence.

Two service-level layers sit on top (DESIGN.md §9):

* **Compiled-plan cache (prepared statements)** — keyed on ``(literal-masked
  plan-template fingerprint, placement, strategy, bucketed base-table
  shapes)``. Differently-written but equivalent SQL (aliases, whitespace,
  predicate spelling) normalizes to the same template, and queries that
  differ *only in predicate constants* (``WHERE age > 40`` vs ``> 50``)
  share one compiled template: the cached physical plan (with its Resizer
  placement) is re-bound with the fresh literals at submit time. Identical
  literals reuse the same *physical plan object*. Shapes are bucketed to the next power of
  two so a growing base table does not thrash the cache.
* **PrivacyAccountant** — every submit is admission-checked against the CRT
  budget before execution and charged after (accountant.py). Budgets are
  global across tenants.

A third layer batches admissions (DESIGN.md §11): ``enqueue()``/``drain()``
route through :class:`~repro_torch.service.scheduler.QueryScheduler`, which groups
same-fingerprint queries from independent tenants into shape-bucketed batches
and executes each as ONE stacked engine pass (``Engine.execute_batch``); the
synchronous ``submit()`` is the batch-of-1 special case of the same
admit -> execute -> finalize pipeline.

A fourth layer makes the service's ground truth durable (DESIGN.md §12):
``state_dir=`` puts the accountant's CRT ledger behind a WAL-backed
:class:`repro_torch.state.JournalStore` (intent -> record journaling, so budgets
survive restarts and N replicas sharing the directory enforce ONE global
budget) and adds a :class:`repro_torch.state.CalibrationStore` fed by the engine's
revealed-size hook: every already-disclosed intermediate size S refines the
planner's cost model — join reordering improves across restarts with zero
additional disclosure.

Per-query noise freshness: the Engine folds a monotonically increasing
counter into every Resizer's PRNG key, so repeated executions of the same
plan draw i.i.d. noise — exactly the attacker model CRT prices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import RuntimeConfig
from ..core import threefry
from ..core.material import material_scope
from ..core.noise import NoiseStrategy, shrinkwrap_default
from ..engine.executor import Engine, ExecutionReport
from ..obs import MetricsRegistry, explain_text, redact
from ..obs import trace as obs_trace
from ..offline import Provisioner, RandomnessPool
from ..ops.table import SecretTable
from ..plan.nodes import PlanNode
from ..sql.catalog import Catalog
from ..plan.registry import lookup
from ..sql.compile import (
    bind_params,
    compile_logical,
    default_cost_model,
    plan_params,
    template_fingerprint,
)
from ..plan.policies import insert_resizers, select_join_algorithms
from ..core.resizer import ResizerConfig
from .accountant import PrivacyAccountant, QueryRefused, strategy_key

__all__ = ["AnalyticsService", "TenantSession", "QueryResult", "AdmittedQuery"]


def _bucket_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


@dataclasses.dataclass
class QueryResult:
    tenant: str
    sql: str
    plan: PlanNode
    table: SecretTable
    rows: Optional[Dict[str, np.ndarray]]
    report: ExecutionReport
    cache_hit: bool
    compile_seconds: float
    accountant_seconds: float
    escalations: List[Dict]
    batch_slots: int = 1  # size of the engine pass this query rode in


@dataclasses.dataclass
class AdmittedQuery:
    """A compiled + admission-checked query awaiting execution (the unit the
    scheduler buckets). ``admitted`` is the accountant-rewritten plan."""

    tenant: str
    sql: str
    plan: PlanNode
    admitted: PlanNode
    cache_hit: bool
    compile_seconds: float
    accountant_seconds: float
    escalations: List[Dict]
    recorded: bool = False  # set once accountant.record committed
    # offline-pool identity: (template fingerprint hash, pow2 shape key) —
    # the same public identity the plan cache uses, never a data-dependent
    # value (see DESIGN.md §15)
    bundle_key: Optional[tuple] = None


class TenantSession:
    def __init__(self, service: "AnalyticsService", tenant: str):
        self.service = service
        self.tenant = tenant

    def submit(self, sql: str) -> QueryResult:
        return self.service.submit(self.tenant, sql)

    def enqueue(self, sql: str):
        """Queue for batched execution; results arrive via ``service.drain``."""
        return self.service.enqueue(self.tenant, sql)


class AnalyticsService:
    def __init__(
        self,
        tables: Dict[str, SecretTable],
        *,
        catalog: Optional[Catalog] = None,
        noise: Optional[NoiseStrategy] = None,
        addition: str = "parallel",
        placement: str = "cost_based",
        accountant: Optional[PrivacyAccountant] = None,
        key: Optional[torch.Tensor] = None,  # (2,) threefry key; default PRNGKey(0)
        jit_ops: bool = False,  # the engine's per-operator cache (CUDA graphs)
        plan_cache_size: int = 256,
        reveal_results: bool = True,
        reorder_joins: bool = True,
        batch_max: int = 16,
        batch_wait_s: float = 0.05,
        state_dir: Optional[str] = None,  # durable shared state (DESIGN §12)
        wal_fsync: bool = True,
        compact_wal_bytes: int = 1 << 16,  # auto-compaction threshold
        offline: str = "on",  # correlated-randomness pool (DESIGN §15):
        # "off" = derive everything on demand; "on" = pool + inline refills
        # at idle windows; "background" = pool + provisioner daemon thread
        offline_pool_bytes: int = 64 << 20,
        offline_window: int = 8,  # upcoming counters provisioned per template
        config: Optional[RuntimeConfig] = None,  # execution-strategy knobs;
        # None = env fallback. Threaded into the Engine (fusion/tile) and the
        # planner's physical join selection.
        engine_factory=None,  # Engine-compatible constructor — the networked
        # runtime passes one that builds a coordinator-backed RemoteEngine
        device=None,  # the engine's device: "cuda" unless "cpu" is asked for
    ):
        if offline not in ("off", "on", "background"):
            raise ValueError(
                f"offline={offline!r} (expected off|on|background)"
            )
        self.tables = tables
        self.config = config
        self.catalog = catalog or Catalog.from_tables(tables)
        self.noise = noise if noise is not None else shrinkwrap_default()
        self.addition = addition
        self.placement = placement
        self.accountant = accountant or PrivacyAccountant()
        self.reveal_results = reveal_results
        self.reorder_joins = reorder_joins
        # metrics registry: the single source of truth for service counters —
        # the legacy `stats` dict is a read-only view over it (DESIGN.md §14.2)
        self.metrics = MetricsRegistry()
        m = self.metrics
        self._m_queries = m.counter(
            "reflex_queries_total",
            "Completed queries (recorded and revealed)", ("tenant",),
        )
        self._m_refusals = m.counter(
            "reflex_refusals_total",
            "Queries refused at admission (CRT budget exhausted)",
        )
        self._m_plan_cache = m.counter(
            "reflex_plan_cache_lookups_total",
            "Prepared-statement cache lookups by outcome "
            "(a rebind also counts as a hit)", ("status",),
        )
        self._m_jit = m.gauge(
            "reflex_jit_cache_logical",
            "Process-wide Engine jit cache counters (logical hits: a K-slot "
            "batched pass counts K)", ("status",),
        )
        self._m_budget_total = m.gauge(
            "reflex_privacy_budget_total",
            "floor(crt_rounds) per observation signature", ("sig", "strategy"),
        )
        self._m_budget_remaining = m.gauge(
            "reflex_privacy_budget_remaining",
            "CRT observations still spendable per signature "
            "(budget - observed - foreign reserved)", ("sig", "strategy"),
        )
        self._m_budget_observed = m.gauge(
            "reflex_privacy_budget_observed",
            "Noisy-size observations already disclosed per signature",
            ("sig", "strategy"),
        )
        # offline pool traffic, labeled by template fingerprint hash — the
        # pool key IS the plan-cache identity, never a true size (§15)
        self._m_off_hits = m.counter(
            "reflex_offline_hits_total",
            "Correlated-randomness fetches served from the offline pool",
            ("template",),
        )
        self._m_off_misses = m.counter(
            "reflex_offline_misses_total",
            "Correlated-randomness fetches derived on demand (cold)",
            ("template",),
        )
        self._m_off_demand = m.counter(
            "reflex_offline_demand_total",
            "Engine passes executed under each template's pool bundle "
            "(feeds provisioner target sizing)",
            ("template",),
        )
        self._m_off_depth = m.gauge(
            "reflex_offline_pool_depth_bytes",
            "Bytes of precomputed randomness currently pooled",
        )
        self._m_off_entries = m.gauge(
            "reflex_offline_pool_entries",
            "Pooled entries by material class", ("kind",),
        )
        make_engine = engine_factory if engine_factory is not None else Engine
        self.engine = make_engine(
            tables, key=key if key is not None else threefry.PRNGKey(0),
            jit_ops=jit_ops, config=config, device=device,
        )
        self.offline_mode = offline
        self.pool: Optional[RandomnessPool] = None
        self.provisioner: Optional[Provisioner] = None
        self._offline_demand_counts: Dict[tuple, float] = {}
        if offline != "off":
            self.pool = RandomnessPool(
                max_bytes=offline_pool_bytes, device=self.engine.device
            )
            self.provisioner = Provisioner(
                self.pool,
                self.engine.prf,
                ctr_fn=lambda: self.engine._resize_ctr,
                demand_fn=lambda: dict(self._offline_demand_counts),
                window=offline_window,
                metrics=self.metrics,
            )
            if offline == "background":
                self.provisioner.start()
        self.state_dir = state_dir
        self.compact_wal_bytes = compact_wal_bytes
        self.calibration = None
        if state_dir is not None:
            from ..state import CalibrationStore, JournalStore

            if not self.accountant.durable:
                self.accountant.attach_store(
                    JournalStore(
                        state_dir, "ledger", fsync=wal_fsync,
                        metrics=self.metrics,
                    )
                )
            self.calibration = CalibrationStore(
                JournalStore(
                    state_dir, "calibration", fsync=wal_fsync,
                    metrics=self.metrics,
                )
            )
            self.engine.reveal_hook = self._observe_reveal
        self._plan_cache: "OrderedDict" = OrderedDict()
        self._plan_cache_max = plan_cache_size
        self._last_bundle_key: Optional[tuple] = None
        from .scheduler import QueryScheduler

        self.scheduler = QueryScheduler(
            self, max_batch=batch_max, max_wait_s=batch_wait_s
        )

    @property
    def stats(self) -> Dict:
        """Legacy counters dict, assembled as a read-only view over the
        metrics registry — the dict and the registry cannot drift because
        there is only one underlying counter per figure (e.g. `per_tenant`
        IS `reflex_queries_total` broken out by its tenant label)."""
        return {
            "queries": int(self._m_queries.total()),
            "plan_cache_hits": int(self._m_plan_cache.value(status="hit")),
            "plan_cache_misses": int(self._m_plan_cache.value(status="miss")),
            "plan_cache_rebinds": int(
                self._m_plan_cache.value(status="rebind")
            ),
            "refusals": int(self._m_refusals.total()),
            "per_tenant": {
                key[0]: int(v) for key, v in self._m_queries.samples()
            },
        }

    # -- sessions -------------------------------------------------------------
    def session(self, tenant: str) -> TenantSession:
        self._m_queries.touch(tenant=tenant)
        return TenantSession(self, tenant)

    # -- compile + cache ------------------------------------------------------
    def _shape_key(self) -> tuple:
        return tuple(
            (name, _bucket_pow2(t.n)) for name, t in sorted(self.tables.items())
        )

    def compile(self, sql: str) -> tuple[PlanNode, bool, float]:
        """SQL -> physical plan via the prepared-statement cache; returns
        (plan, hit, seconds). The cache is keyed on the literal-masked
        template fingerprint: a hit with different predicate constants
        re-binds the cached physical plan (Resizer placement included)
        instead of recompiling."""
        t0 = time.perf_counter()
        cm = default_cost_model(
            self.catalog, noise=self.noise, calibration=self.calibration
        )
        logical = compile_logical(
            sql, self.catalog, cost_model=cm, reorder_joins=self.reorder_joins
        )
        params = plan_params(logical)
        cache_key = (
            template_fingerprint(logical),
            self.placement,
            strategy_key(self.noise, self.addition),
            self._shape_key(),
        )
        entry = self._plan_cache.get(cache_key)
        hit = entry is not None
        rebind = False
        # the offline pool's bundle identity: same public template identity
        # as the plan cache, hashed so it can double as a metric label
        self._last_bundle_key = (
            redact.fingerprint_hash(cache_key[0]), cache_key[3],
        )
        if hit:
            self._plan_cache.move_to_end(cache_key)
            self._m_plan_cache.inc(status="hit")
            cached_params, cached_plan = entry
            if params == cached_params:
                plan = cached_plan  # identical query: shared plan object
            else:
                rebind = True
                self._m_plan_cache.inc(status="rebind")
                plan = bind_params(cached_plan, params)
        else:
            self._m_plan_cache.inc(status="miss")
            # physical join selection BEFORE resizer placement, against the
            # calibration-refined cost model: observed (already-disclosed)
            # intermediate sizes steer the product-vs-sortmerge choice with
            # zero extra disclosure. Catalogs without declared multiplicity
            # bounds never rewrite (sort-merge inapplicable).
            physical = select_join_algorithms(
                logical, cost_model=cm, catalog=self.catalog,
                mode=self.config.join_algo if self.config is not None else None,
            )
            if self.placement == "none":
                plan = physical
            else:
                cfg = ResizerConfig(noise=self.noise, addition=self.addition)
                plan = insert_resizers(
                    physical, lambda _n: cfg, placement=self.placement,
                    cost_model=cm,
                )
            self._plan_cache[cache_key] = (params, plan)
            while len(self._plan_cache) > self._plan_cache_max:
                self._plan_cache.popitem(last=False)
        dt = time.perf_counter() - t0
        obs_trace.record("compile", seconds=dt, cache_hit=hit, rebind=rebind)
        return plan, hit, dt

    # -- the query path -------------------------------------------------------
    def _admit(self, tenant: str, sql: str, planned=None) -> AdmittedQuery:
        """Compile + admission-check one query (shared by the synchronous
        path and the scheduler). ``planned`` threads the accountant's
        cross-query admission group through a batching window."""
        plan, hit, compile_s = self.compile(sql)
        bundle_key = self._last_bundle_key
        ta = time.perf_counter()
        try:
            admitted, escalations = self.accountant.admit(plan, planned)
        except QueryRefused:
            self._m_refusals.inc()
            obs_trace.record(
                "admit", seconds=time.perf_counter() - ta,
                tenant=tenant, refused=True,
            )
            raise
        obs_trace.record(
            "admit", seconds=time.perf_counter() - ta,
            tenant=tenant, refused=False, escalations=len(escalations),
        )
        return AdmittedQuery(
            tenant=tenant,
            sql=sql,
            plan=plan,
            admitted=admitted,
            cache_hit=hit,
            compile_seconds=compile_s,
            accountant_seconds=time.perf_counter() - ta,
            escalations=escalations,
            bundle_key=bundle_key,
        )

    def _finalize(
        self,
        aq: AdmittedQuery,
        out: SecretTable,
        report: ExecutionReport,
        batch_slots: int = 1,
    ) -> QueryResult:
        """Record the executed query's observations, update counters, and
        reveal — identical for serial and batched (demuxed) executions."""
        ta = time.perf_counter()
        with obs_trace.span("record", tenant=aq.tenant):
            self.accountant.record(aq.admitted, report)
            aq.recorded = True  # failure past this point must not charge_failed
            if self.calibration is not None:
                # one journal transaction for all of this query's revealed
                # sizes (buffered during execution, off the engine's critical
                # path)
                self.calibration.flush()
        acct_s = aq.accountant_seconds + (time.perf_counter() - ta)

        self._m_queries.inc(tenant=aq.tenant)
        self._publish_budget_gauges()
        with obs_trace.span("reveal", tenant=aq.tenant):
            rows = out.reveal_true_rows() if self.reveal_results else None
            post = lookup(type(aq.admitted)).post_reveal
            if rows is not None and post is not None:
                # operator-defined client-side derivation (AVG = sum // cnt)
                rows = post(aq.admitted, rows)
        return QueryResult(
            tenant=aq.tenant,
            sql=aq.sql,
            plan=aq.admitted,
            table=out,
            rows=rows,
            report=report,
            cache_hit=aq.cache_hit,
            compile_seconds=aq.compile_seconds,
            accountant_seconds=acct_s,
            escalations=aq.escalations,
            batch_slots=batch_slots,
        )

    @contextlib.contextmanager
    def _offline_scope(self, bundle_key: Optional[tuple]):
        """Install the offline randomness pool around one engine pass.

        A no-op when the pool is off. Otherwise every eager correlated-
        randomness derivation inside consults the pool first (hot) and falls
        back to on-demand derivation (cold) — bit-identical either way, the
        pool is a content-addressed cache in front of the same pure
        functions. The first pass per bundle records the derivation recipe
        the provisioner replays offline."""
        if self.pool is None or bundle_key is None:
            yield None
            return
        template = bundle_key[0]
        self._offline_demand_counts[bundle_key] = (
            self._offline_demand_counts.get(bundle_key, 0.0) + 1.0
        )
        self._m_off_demand.inc(template=template)
        src = self.pool.source(bundle_key, self.engine.prf.pair_keys)
        try:
            with obs_trace.span("offline", template=template):
                with material_scope(src):
                    yield src
        finally:
            src.finish()
            if src.hits:
                self._m_off_hits.inc(src.hits, template=template)
            if src.misses:
                self._m_off_misses.inc(src.misses, template=template)
            obs_trace.record(
                "offline.pass", template=template,
                hits=src.hits, misses=src.misses,
            )

    def _execute_admitted(self, aq: AdmittedQuery, planned) -> QueryResult:
        """Serial batch-of-1: execute + finalize with the failure-accounting
        protocol (the one shared code path for sync submits and the
        scheduler's non-batchable fallback — privacy-critical, keep single)."""
        try:
            with self._offline_scope(aq.bundle_key):
                out, report = self.engine.execute(aq.admitted)
            return self._finalize(aq, out, report)
        except Exception:
            # execution may have revealed noisy sizes that record() never
            # charged — price them conservatively (see charge_failed); a
            # post-record failure (reveal/post_reveal) is already charged
            if not aq.recorded:
                self.accountant.charge_failed(aq.admitted)
            raise
        finally:
            # recorded (or charged above): the window reservation must not
            # double-count it
            self.accountant.release_planned(aq.admitted, planned)

    def submit(self, tenant: str, sql: str) -> QueryResult:
        """Synchronous execution — admission + a batch-of-1 engine pass.

        Shares the scheduler's admission group, so a sync submit landing in
        the middle of an open batching window is charged against the queued
        (admitted-but-unrecorded) observations too."""
        self.scheduler.poll()  # sync traffic must not starve queued buckets
        with obs_trace.span("query", tenant=tenant, sql=sql):
            planned = self.scheduler._planned
            aq = self._admit(tenant, sql, planned=planned)
            return self._execute_admitted(aq, planned)

    # -- batched admission (DESIGN.md §11) ------------------------------------
    def enqueue(self, tenant: str, sql: str):
        """Admit ``sql`` into the batching queue; same-bucket queries execute
        as one stacked engine pass. Returns a :class:`~repro_torch.service.scheduler.
        QueryTicket`; fetch results with :meth:`drain`."""
        return self.scheduler.submit(tenant, sql)

    def drain(self, force: bool = True) -> List[QueryResult]:
        """Flush the batching queue (all buckets when ``force``, else only
        full/deadline-expired ones) and return completed results in
        submission order."""
        return self.scheduler.drain(force=force)

    # -- durable state (DESIGN.md §12) ----------------------------------------
    def _observe_reveal(self, node: PlanNode, info: Dict) -> None:
        """Engine revealed-size feedback hook: persist the already-public
        (N, S) pair for the resized subplan so future planning uses observed
        selectivities instead of static defaults. S is on the wire either
        way — recording it discloses nothing new."""
        if self.calibration is not None:
            self.calibration.observe_plan(
                node.child, n=int(info["n"]), s=int(info["s"])
            )

    def _maybe_compact(self) -> None:
        """Opportunistic snapshot+truncate of both journals once their WALs
        outgrow the threshold (called by the scheduler at window close and
        safe to call any time — compaction preserves open intents)."""
        if self.state_dir is None:
            return
        self.accountant.maybe_compact(self.compact_wal_bytes)
        self.calibration.maybe_compact(self.compact_wal_bytes)

    def compact_state(self) -> None:
        """Force-compact the durable journals now (restart-fast snapshots)."""
        if self.state_dir is None:
            return
        self.accountant.maybe_compact(-1)
        self.calibration.maybe_compact(-1)

    def close(self) -> None:
        """Stop background work (the offline provisioner thread, if any)."""
        if self.provisioner is not None:
            self.provisioner.stop()

    # -- reporting ------------------------------------------------------------
    def _publish_budget_gauges(self) -> None:
        """Mirror the accountant's per-signature burn-down into gauges.
        Labels carry the fingerprint *hash* and the strategy key — both
        public (the signature identifies the subplan, not its data)."""
        for e in self.accountant.budget_metrics():
            labels = {
                "sig": redact.fingerprint_hash(e["fp"]),
                "strategy": e["strategy"],
            }
            self._m_budget_observed.set(e["observed"], **labels)
            if e["budget"] is not None:
                self._m_budget_total.set(e["budget"], **labels)
                self._m_budget_remaining.set(e["remaining"], **labels)

    def _refresh_gauges(self) -> None:
        """Bring point-in-time gauges current before any export."""
        js = Engine.jit_cache_stats()
        for k in ("hits", "misses", "size"):
            self._m_jit.set(js[k], status=k)
        if self.pool is not None:
            ps = self.pool.stats()
            self._m_off_depth.set(ps["depth_bytes"])
            self._m_off_entries.set(ps["static_entries"], kind="static")
            self._m_off_entries.set(ps["counter_entries"], kind="counter")
        self.scheduler.publish_gauges()
        self._publish_budget_gauges()

    def render_metrics(self) -> str:
        """Prometheus text exposition of every service metric."""
        self._refresh_gauges()
        return self.metrics.render_prometheus()

    def metrics_snapshot(self) -> Dict:
        """JSON-safe dump of the registry (the machine-readable twin of
        :meth:`render_metrics`; validated in CI against a checked-in schema)."""
        self._refresh_gauges()
        return self.metrics.snapshot()

    # -- EXPLAIN / EXPLAIN ANALYZE (DESIGN.md §14.4) --------------------------
    def explain(self, sql: str) -> str:
        """Compile (through the plan cache) and render the placed physical
        plan with the cost model's estimates — no execution, no admission,
        nothing disclosed."""
        plan, _hit, _s = self.compile(sql)
        cm = default_cost_model(
            self.catalog, noise=self.noise, calibration=self.calibration
        )
        return explain_text(plan, cost_model=cm, title=f"EXPLAIN {sql}")

    def explain_analyze(self, tenant: str, sql: str):
        """Execute ``sql`` through the full admission pipeline and render the
        plan with estimated-vs-actual columns. Costs one real query (the
        accountant charges it like any other). Returns ``(text, result)``."""
        res = self.submit(tenant, sql)
        cm = default_cost_model(
            self.catalog, noise=self.noise, calibration=self.calibration
        )
        text = explain_text(
            res.plan, cost_model=cm, report=res.report,
            title=f"EXPLAIN ANALYZE {sql}",
            wire_audit=getattr(self.engine, "last_wire_audit", None),
        )
        return text, res

    def cache_stats(self) -> Dict[str, float]:
        h, m = self.stats["plan_cache_hits"], self.stats["plan_cache_misses"]
        return {
            "hits": h,
            "misses": m,
            "hit_rate": h / max(h + m, 1),
            "size": len(self._plan_cache),
        }

    def status(self) -> Dict:
        return {
            **self.stats,
            "plan_cache": self.cache_stats(),
            # process-wide: Engine._JIT_CACHE is shared by every Engine, so
            # these counters span all services in the process
            "jit_cache": {**Engine.jit_cache_stats(), "scope": "process"},
            "scheduler": self.scheduler.stats,
            "offline": None if self.pool is None else {
                "mode": self.offline_mode,
                **self.pool.stats(),
                "provisioner": self.provisioner.stats(),
            },
            "accountant": self.accountant.status(),
            "state": None if self.state_dir is None else {
                "dir": self.state_dir,
                "ledger": self.accountant.store.status(),
                "calibration": self.calibration.status(),
            },
        }
