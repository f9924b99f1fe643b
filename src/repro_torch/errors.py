"""Typed failures of the port (the subset of ``repro.errors`` it raises)."""
from __future__ import annotations

from typing import Optional

__all__ = ["ReflexError", "PlanSchemaError"]


class ReflexError(Exception):
    """Base class for every typed Reflex failure."""


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
