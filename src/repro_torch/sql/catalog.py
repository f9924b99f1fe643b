"""Table catalog: the schema (and optional sizes) the SQL compiler binds to,
as ``repro.sql.catalog``.

A plan executes against whatever tables the :class:`~repro_torch.engine.Engine`
was given; the compiler only needs column names for resolution and row counts for
the cost model. ``Catalog.from_tables`` derives both from a live table dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

__all__ = ["Catalog", "HEALTHLNK_CATALOG"]


@dataclasses.dataclass(frozen=True)
class Catalog:
    tables: Dict[str, List[str]]  # table name -> ordered column names
    sizes: Optional[Dict[str, int]] = None  # table name -> row count
    # table -> column -> public upper bound on per-key duplicate count. This
    # is *declared metadata* (like a schema's uniqueness constraint), not a
    # data-dependent measurement: the planner may only pick the sort-merge
    # join when the build side's key has a finite declared bound, because the
    # merge emits at most ``fanout`` matches per probe row.
    multiplicity: Optional[Dict[str, Dict[str, int]]] = None

    def columns(self, table: str) -> List[str]:
        return self.tables[table]

    def size(self, table: str, default: int = 1000) -> int:
        if self.sizes and table in self.sizes:
            return self.sizes[table]
        return default

    def key_multiplicity(self, table: str, col: str) -> Optional[int]:
        """Declared max duplicates of ``col`` in ``table`` (None = unbounded)."""
        if self.multiplicity and table in self.multiplicity:
            return self.multiplicity[table].get(col)
        return None

    @classmethod
    def from_tables(cls, tables, multiplicity=None) -> "Catalog":
        """Derive a catalog from ``{name: SecretTable}`` (column order is the
        table's own dict order, matching what operators will see)."""
        return cls(
            tables={name: list(t.cols) for name, t in tables.items()},
            sizes={name: t.n for name, t in tables.items()},
            multiplicity=multiplicity,
        )


# Column order mirrors data/healthlnk.py's dict construction order.
HEALTHLNK_CATALOG = Catalog(
    tables={
        "diagnoses": ["pid", "icd9", "diag", "time", "major_icd9"],
        "medications": ["pid", "med", "dosage", "time"],
        "demographics": ["pid", "zip"],
    }
)
