"""Multi-tenant analytics service: SQL sessions, plan cache, CRT budget (a
port of ``repro.service``)."""
from ..errors import BudgetRefused, ReflexError  # noqa: F401
from .accountant import (  # noqa: F401
    PrivacyAccountant,
    QueryRefused,
    escalate_strategy,
    strategy_key,
)
from .scheduler import QueryScheduler, QueryTicket  # noqa: F401
from .service import (  # noqa: F401
    AdmittedQuery,
    AnalyticsService,
    QueryResult,
    TenantSession,
)

__all__ = [
    "AdmittedQuery",
    "AnalyticsService",
    "BudgetRefused",
    "PrivacyAccountant",
    "QueryRefused",
    "ReflexError",
    "QueryResult",
    "QueryScheduler",
    "QueryTicket",
    "TenantSession",
    "escalate_strategy",
    "strategy_key",
]
