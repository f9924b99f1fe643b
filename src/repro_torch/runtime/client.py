"""ReflexClient: one client API over both execution topologies (a port of
``repro.runtime.client``).

The facade exposes the service verbs — ``submit`` / ``enqueue`` / ``drain``
/ ``explain`` / ``explain_analyze`` / ``status`` — identically whether
queries execute

* **in-process** (:meth:`ReflexClient.in_process`): the single-process
  oracle, an :class:`~repro_torch.service.AnalyticsService` over a local
  :class:`~repro_torch.engine.Engine`; or
* **networked** (:meth:`ReflexClient.networked`): the same service stack
  (compiler, plan cache, accountant, scheduler, calibration) with a
  :class:`~repro_torch.runtime.coordinator.RemoteEngine` under it,
  dispatching every engine pass to three parties over a real transport.

Callers cannot tell the difference by return types: both modes yield the
same ``QueryResult`` / report / status objects, and the networked mode is
bit-exact with the oracle by construction (verified per exchange and
re-audited per query). The only behavioural deltas in networked mode are
pinned constructor arguments: ``jit_ops=False`` (jit replay skips protocol
bodies, hence exchange boundaries) and ``offline="off"`` (the randomness
pool is engine-local; parties derive material on demand so their ledgers
stay in lockstep). Both modes run on ``device``: ``"cuda"`` unless the
caller asks for ``"cpu"``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..config import RuntimeConfig, current_config
from ..core import threefry
from ..errors import TransportError
from ..obs.distributed import WireMetricsPublisher
from ..ops.table import SecretTable
from ..service.service import AnalyticsService, QueryResult, TenantSession
from .coordinator import Coordinator, RemoteEngine, launch_loopback_mesh

__all__ = ["ReflexClient"]


class ReflexClient:
    """Unified front door for Reflex analytics, any topology.

    Construct via :meth:`in_process` or :meth:`networked`; the instance then
    behaves the same way in both modes. The underlying service remains
    reachable as ``client.service`` for advanced introspection
    (``service.metrics``, ``service.accountant`` …)."""

    def __init__(
        self,
        service: AnalyticsService,
        *,
        coordinator: Optional[Coordinator] = None,
        _own_coordinator: bool = False,
    ):
        self.service = service
        self.coordinator = coordinator
        self._own_coordinator = _own_coordinator
        self._wire_pub: Optional[WireMetricsPublisher] = None

    # -- constructors ----------------------------------------------------------
    @classmethod
    def in_process(cls, tables: Dict[str, SecretTable], **service_kwargs):
        """Single-process execution (the oracle the networked mode is
        checked against). ``service_kwargs`` pass through to
        :class:`AnalyticsService`."""
        return cls(AnalyticsService(tables, **service_kwargs))

    @classmethod
    def networked(
        cls,
        tables: Dict[str, SecretTable],
        *,
        coordinator: Optional[Coordinator] = None,
        key_seed: int = 0,
        config: Optional[RuntimeConfig] = None,
        device=None,
        **service_kwargs,
    ):
        """Three-party execution behind the same verbs.

        With no ``coordinator``, an in-process loopback mesh is launched
        (three party servers on threads, their engines on ``device``); pass
        a :func:`~repro_torch.runtime.coordinator.connect_tcp` coordinator
        to drive external party processes instead. Either way the client
        ships the share triples, the engine key seed, and the resolved
        :class:`RuntimeConfig` to all parties so the three simulations are
        identical. The coordinator's own engine (and so every result) lies
        on ``device``, where ``tables`` must lie."""
        for banned, why in (
            ("jit_ops", "networked execution requires eager protocol bodies"),
            ("offline", "the randomness pool is engine-local"),
            ("engine_factory", "the networked client installs RemoteEngine"),
        ):
            if service_kwargs.pop(banned, None):
                raise ValueError(f"networked(): {banned} is pinned ({why})")
        own = coordinator is None
        if own:
            coordinator, _servers, _threads = launch_loopback_mesh(device=device)
        cfg = config if config is not None else current_config()
        coordinator.load_tables(tables, key_seed=key_seed, config=cfg)

        def factory(tbls, **kw):
            kw["jit_ops"] = False
            return RemoteEngine(tbls, coordinator, **kw)

        svc = AnalyticsService(
            tables,
            key=threefry.PRNGKey(int(key_seed)),
            jit_ops=False,
            offline="off",
            config=cfg,
            engine_factory=factory,
            device=device,
            **service_kwargs,
        )
        return cls(svc, coordinator=coordinator, _own_coordinator=own)

    # -- mode ------------------------------------------------------------------
    @property
    def mode(self) -> str:
        return "in_process" if self.coordinator is None else "networked"

    # -- the client verbs (identical across modes) -----------------------------
    def submit(self, tenant: str, sql: str) -> QueryResult:
        return self.service.submit(tenant, sql)

    def enqueue(self, tenant: str, sql: str):
        return self.service.enqueue(tenant, sql)

    def drain(self, force: bool = True) -> List[QueryResult]:
        return self.service.drain(force=force)

    def explain(self, sql: str) -> str:
        return self.service.explain(sql)

    def explain_analyze(self, tenant: str, sql: str):
        return self.service.explain_analyze(tenant, sql)

    def status(self) -> Dict:
        st = self.service.status()
        st["runtime"] = {"mode": self.mode}
        if self.coordinator is not None:
            eng = self.service.engine
            st["runtime"]["wire_audit"] = getattr(eng, "last_wire_audit", [])
            st["runtime"]["mesh"] = self._mesh_health()
        return st

    def _mesh_health(self) -> Dict:
        """Pull the ``stats`` control verb, publish the snapshots into this
        service's metrics registry as ``reflex_wire_*`` series, and return a
        compact per-party health summary (liveness, seq watermarks, byte
        totals). Works identically over loopback and TCP meshes."""
        try:
            stats = self.coordinator.stats()
        except TransportError as e:
            return {"ok": False, "reason": e.reason}
        if self._wire_pub is None:
            self._wire_pub = WireMetricsPublisher(self.service.metrics)
        parties = []
        for entry in stats["parties"]:
            self._wire_pub.publish(entry["wire"])
            w = entry["wire"]
            parties.append({
                "party": entry["party"],
                "up": True,
                "queries": entry["queries"],
                "bytes": {
                    "sent": sum(s["bytes"] for s in w["sent"]),
                    "recv": sum(s["bytes"] for s in w["recv"]),
                },
                "links": w["links"],
                "rejects": sum(r["count"] for r in w["rejects"]),
            })
        self._wire_pub.publish(stats["coordinator"])
        for p, rtt in stats["rtt_seconds"].items():
            self._wire_pub.observe_roundtrip(p, rtt)
        return {
            "ok": True,
            "parties": parties,
            "rtt_seconds": stats["rtt_seconds"],
        }

    def session(self, tenant: str) -> TenantSession:
        return self.service.session(tenant)

    def cache_stats(self) -> Dict[str, float]:
        return self.service.cache_stats()

    # -- lifecycle -------------------------------------------------------------
    def close(self) -> None:
        """Stop background service work; in networked mode also shut the
        party mesh down (owned loopback meshes are fully torn down; an
        externally provided coordinator is shut down but its processes'
        lifecycle belongs to whoever launched them; a loopback mesh's party
        threads are joined)."""
        self.service.close()
        if self.coordinator is not None:
            self.coordinator.shutdown()
            self.coordinator.close()

    def __enter__(self) -> "ReflexClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
