"""Query admission batching: one engine pass for many tenants (DESIGN.md §11),
a port of ``repro.service.scheduler``.

The multi-tenant service used to execute admitted plans strictly serially, so
every query paid the full MPC round latency alone. This scheduler amortizes
it: queries from independent tenants whose *admitted* physical plans are
structurally identical — same normalized-plan fingerprint over the same
pow2-bucketed base-table shapes, i.e. the same identity the prepared-statement
plan cache computes, refined by bound literals and any accountant noise
rewrites — land in one bucket and execute as ONE stacked
:meth:`~repro_torch.engine.executor.Engine.execute_batch` pass. Kogge-Stone levels,
a2b conversions, bitonic stages, and their PRF folds run once for the whole
batch; per-tenant results and :class:`ExecutionReport`s are demuxed with
bit-exact parity against serial execution.

Barrier-free pipeline: there is no global batch barrier. A bucket executes
the moment it fills (``max_batch``), and partially-filled buckets are flushed
once their oldest entry ages past ``max_wait_s`` (checked on every
``submit``/``poll``/``drain``), so a mixed stream of query shapes keeps
flowing instead of waiting for stragglers that will never come.

Privacy: admission happens at ``submit`` time, against the accountant's real
state *plus* a shared ``planned`` group covering every query admitted in the
open window — K queued same-signature queries spend K observations at
admission, exactly as a serial admit/record interleaving would, even though
their ``record`` calls all land after the batched run. Inside the engine,
every slot folds its own noise counter (fresh i.i.d. noise per query), so
batching never merges CRT observations across tenants. Plans containing
non-batchable operators (singleton aggregates, post-reveal hooks) execute
immediately as a serial batch-of-1.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Tuple

from ..obs import trace as obs_trace
from ..plan.registry import plan_batchable
from ..sql.compile import plan_fingerprint

__all__ = ["QueryScheduler", "QueryTicket"]


@dataclasses.dataclass(frozen=True)
class QueryTicket:
    """Handle for an enqueued query; results come back from ``drain`` in
    ticket order (``QueryResult.tenant``/``sql`` identify the query)."""

    id: int
    tenant: str
    sql: str
    batched: bool  # False: executed immediately as a serial batch-of-1


@dataclasses.dataclass
class _Pending:
    ticket: QueryTicket
    aq: object  # service.AdmittedQuery
    enqueued_at: float


class QueryScheduler:
    """Shape-bucketed admission queue over one :class:`AnalyticsService`."""

    def __init__(
        self,
        service,
        max_batch: int = 16,
        max_wait_s: float = 0.05,
        clock=time.monotonic,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.service = service
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.clock = clock
        self._buckets: "OrderedDict[Tuple, List[_Pending]]" = OrderedDict()
        self._done: Dict[int, object] = {}  # ticket id -> QueryResult
        self._next_id = 0
        # accountant admission group for the open batching window: spans every
        # admitted-but-not-yet-recorded query so same-signature queries cannot
        # jointly overdraw a budget (see PrivacyAccountant.admit)
        self._planned: Dict[Tuple[str, str], int] = {}
        # scheduler figures live in the service's metrics registry (the
        # legacy `stats` dict below is a read-only view); a bare service
        # without one gets a private registry so the scheduler is standalone
        from ..obs import MetricsRegistry

        m = getattr(service, "metrics", None) or MetricsRegistry()
        self._m_enqueued = m.counter(
            "reflex_scheduler_enqueued_total",
            "Queries enqueued for batched execution",
        )
        self._m_batches = m.counter(
            "reflex_scheduler_batches_total", "Stacked engine passes executed",
        )
        self._m_batched_queries = m.counter(
            "reflex_scheduler_batched_queries_total",
            "Queries served by stacked passes",
        )
        self._m_serial = m.counter(
            "reflex_scheduler_serial_fallbacks_total",
            "Non-batchable queries executed as a serial batch-of-1",
        )
        self._m_flush = m.counter(
            "reflex_batch_flush_total", "Bucket flushes by trigger",
            ("reason",),
        )
        self._m_occupancy = m.histogram(
            "reflex_batch_occupancy", "Slots per stacked engine pass",
            buckets=(1, 2, 4, 8, 16, 32, 64),
        )
        self._m_wait = m.histogram(
            "reflex_schedule_wait_seconds",
            "Enqueue -> flush latency of batched tickets",
        )
        self._m_queue_depth = m.gauge(
            "reflex_scheduler_queue_depth",
            "Pending queries across open buckets",
        )
        self._m_max_batch = m.gauge(
            "reflex_batch_max_seen", "Largest stacked pass so far",
        )

    @property
    def stats(self) -> Dict[str, int]:
        """Legacy counters dict as a view over the metrics registry."""
        return {
            "enqueued": int(self._m_enqueued.total()),
            "batches": int(self._m_batches.total()),
            "batched_queries": int(self._m_batched_queries.total()),
            "serial_fallbacks": int(self._m_serial.total()),
            "full_flushes": int(self._m_flush.value(reason="full")),
            "deadline_flushes": int(self._m_flush.value(reason="deadline")),
            "forced_flushes": int(self._m_flush.value(reason="forced")),
            "max_batch_seen": int(self._m_max_batch.value()),
        }

    def publish_gauges(self) -> None:
        self._m_queue_depth.set(self.n_pending)

    # -- admission ------------------------------------------------------------
    def _bucket_key(self, aq) -> Tuple:
        # the plan cache's identity (template fingerprint x placement x
        # strategy x pow2-bucketed shapes) groups rebindable queries; stacked
        # execution additionally needs identical literals and noise configs,
        # which the *admitted* plan's full fingerprint pins down
        return (plan_fingerprint(aq.admitted), self.service._shape_key())

    def submit(self, tenant: str, sql: str) -> QueryTicket:
        """Compile, admission-check, and enqueue one query. Full buckets and
        deadline-expired buckets flush immediately (barrier-free)."""
        self.poll()  # deadline check on every submit, whatever path follows
        with obs_trace.span("query", tenant=tenant, sql=sql):
            aq = self.service._admit(tenant, sql, planned=self._planned)
            tid = self._next_id
            self._next_id += 1
            self._m_enqueued.inc()
            if not plan_batchable(aq.admitted):
                ticket = QueryTicket(tid, tenant, sql, batched=False)
                self._m_serial.inc()
                self._done[tid] = self.service._execute_admitted(
                    aq, self._planned
                )
                return ticket
            ticket = QueryTicket(tid, tenant, sql, batched=True)
            key = self._bucket_key(aq)
            bucket = self._buckets.setdefault(key, [])
            bucket.append(_Pending(ticket, aq, self.clock()))
        self._m_queue_depth.set(self.n_pending)
        if len(bucket) >= self.max_batch:
            self._flush(key, "full_flushes")
        return ticket

    # -- execution ------------------------------------------------------------
    def _flush(self, key: Tuple, reason: str) -> None:
        """Execute one bucket. Failure accounting is conservative: a query
        whose execution may have revealed its noisy sizes but could not be
        recorded is charged to the accountant's real state
        (``charge_failed``) — the attacker may hold the sample — and its
        window reservation is then released deterministically, so the shared
        ``planned`` dict never carries state past the flush."""
        entries = self._buckets.pop(key)
        k = len(entries)
        acct = self.service.accountant
        why = reason.replace("_flushes", "")  # full | deadline | forced
        with obs_trace.span("batch.flush", slots=k, reason=why):
            now = self.clock()
            for e in entries:
                wait = max(now - e.enqueued_at, 0.0)
                self._m_wait.observe(wait)
                obs_trace.record(
                    "schedule.wait", seconds=wait,
                    tenant=e.ticket.tenant, ticket=e.ticket.id,
                )
            try:
                # one bucket = one template = one pool bundle: the stacked
                # pass draws its correlated randomness through the same
                # offline scope a serial submit would
                with self.service._offline_scope(
                    getattr(entries[0].aq, "bundle_key", None)
                ):
                    results = self.service.engine.execute_batch(
                        [e.aq.admitted for e in entries]
                    )
            except Exception:
                # the pass may have died after per-slot Resizes already
                # revealed sizes: charge every slot rather than leak a free
                # observation
                for e in entries:
                    acct.charge_failed(e.aq.admitted)
                    acct.release_planned(e.aq.admitted, self._planned)
                raise
            finally:
                self._m_queue_depth.set(self.n_pending)
            self._m_batches.inc()
            self._m_batched_queries.inc(k)
            self._m_flush.inc(reason=why)
            self._m_occupancy.observe(k)
            if k > self._m_max_batch.value():
                self._m_max_batch.set(k)
            first_err: Exception | None = None
            for e, (out, report) in zip(entries, results):
                try:
                    self._done[e.ticket.id] = self.service._finalize(
                        e.aq, out, report, batch_slots=k
                    )
                except Exception as err:  # demux/record failure: slot-local
                    if not e.aq.recorded:  # post-record failures: charged
                        acct.charge_failed(e.aq.admitted)
                    if first_err is None:
                        first_err = err
                finally:
                    acct.release_planned(e.aq.admitted, self._planned)
            if first_err is not None:
                # sibling slots' results were still delivered above
                raise first_err

    def poll(self) -> int:
        """Flush buckets whose oldest entry aged past the deadline; returns
        the number of buckets flushed."""
        now = self.clock()
        due = [
            key
            for key, entries in self._buckets.items()
            if entries and now - entries[0].enqueued_at >= self.max_wait_s
        ]
        for key in due:
            self._flush(key, "deadline_flushes")
        return len(due)

    def drain(self, force: bool = True) -> List:
        """Execute queued buckets (all when ``force``, else only those past
        the deadline) and return completed :class:`QueryResult`s in ticket
        order. Once the queue is empty the admission window closes."""
        if force:
            for key in list(self._buckets):
                self._flush(key, "forced_flushes")
        else:
            self.poll()
        out = [self._done.pop(tid) for tid in sorted(self._done)]
        if not self._buckets:
            self._planned.clear()  # window closed; everything is recorded
            # quiet point: every slot's intent has its record journaled, so
            # folding the durable WALs into snapshots loses nothing
            self.service._maybe_compact()
            # ...and the engine is idle: let the offline provisioner refill
            # the randomness pool for the next window (inline in "on" mode,
            # a thread wake-up in "background" mode)
            prov = getattr(self.service, "provisioner", None)
            if prov is not None:
                prov.hint()
        return out

    # -- introspection --------------------------------------------------------
    @property
    def n_pending(self) -> int:
        return sum(len(b) for b in self._buckets.values())

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)
