"""Typed error taxonomy of the port, a copy of ``repro.errors``.

Every externally meaningful failure has a :class:`ReflexError` subclass
with structured fields, so callers branch on types and attributes, never
on message text. Each subclass also inherits the builtin its call sites
raised before the taxonomy (``RuntimeError`` for refusal, fencing and the
wire, ``ValueError`` for schema), so ``except RuntimeError`` keeps working.

Hierarchy::

    ReflexError
      BudgetRefused     admission denied: CRT budget exhausted for a signature
      PlanSchemaError   plan references a column/table its input can't produce
      LeaseFenced       a superseded replica tried to write durable state
      TransportError    the multi-party runtime's wire layer failed
"""
from __future__ import annotations

from typing import Optional, Tuple

__all__ = [
    "ReflexError",
    "BudgetRefused",
    "PlanSchemaError",
    "LeaseFenced",
    "TransportError",
]


class ReflexError(Exception):
    """Base class for every typed Reflex failure."""


class BudgetRefused(ReflexError, RuntimeError):
    """Raised under ``policy='refuse'`` when a query would spend an
    observation a signature's CRT budget no longer covers.

    Fields: ``signature`` (the (subplan fingerprint, strategy key) pair),
    ``observed`` (observations already disclosed), ``budget`` (floor of
    ``crt_rounds`` for the signature).
    """

    def __init__(self, signature: Tuple[str, str], observed: int, budget: int):
        self.signature = signature
        self.observed = observed
        self.budget = budget
        super().__init__(
            f"CRT budget exhausted for resize of:\n{signature[0]}\n"
            f"strategy={signature[1]}: "
            f"{observed}/{budget} observations already disclosed"
        )


class PlanSchemaError(ReflexError, ValueError):
    """A plan references a column (or table) its input does not produce.

    Fields: ``node`` (the offending node's describe() string, when known),
    ``column`` / ``table`` (whichever reference failed), ``available``
    (the columns the input actually produces).
    """

    def __init__(
        self,
        message: str,
        *,
        node: Optional[str] = None,
        column: Optional[str] = None,
        table: Optional[str] = None,
        available: Optional[list] = None,
    ):
        self.node = node
        self.column = column
        self.table = table
        self.available = available
        super().__init__(message)


class LeaseFenced(ReflexError, RuntimeError):
    """A writer presented a fencing token older than one already observed —
    its lease was superseded while it was paused; the write must not land.

    Fields: ``token`` (the stale token presented), ``seen`` (the newest
    token the store has observed).
    """

    def __init__(
        self,
        message: str,
        *,
        token: Optional[int] = None,
        seen: Optional[int] = None,
    ):
        self.token = token
        self.seen = seen
        super().__init__(message)


class TransportError(ReflexError, RuntimeError):
    """The multi-party runtime's wire layer failed: a torn or out-of-order
    frame, a connect that exhausted its retries, a recv timeout, or a peer
    that died mid-query.

    Fields: ``party`` (the local party id, when known), ``peer`` (the remote
    party id / endpoint), ``seq`` (the frame sequence number in flight),
    ``op`` (the exchange op at the failure point), ``reason`` (a stable
    machine-readable tag: ``torn-frame`` | ``bad-seq`` | ``connect`` |
    ``timeout`` | ``closed`` | ``divergence`` | ``crashed``).
    """

    def __init__(
        self,
        message: str,
        *,
        party: Optional[int] = None,
        peer=None,
        seq: Optional[int] = None,
        op: Optional[str] = None,
        reason: str = "transport",
    ):
        self.party = party
        self.peer = peer
        self.seq = seq
        self.op = op
        self.reason = reason
        super().__init__(message)
