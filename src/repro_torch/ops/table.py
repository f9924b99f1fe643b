"""SecretTable: a relation under 3-party replicated secret sharing.

Columns are XOR-shared 32-bit words (:class:`BShare`); ``valid`` is the
secret single-bit column marking true tuples, and the public row count ``n``
is the oblivious size. A column may also be a :class:`LazyGather`, a deferred
row-gather view ``value = base[index]`` with a public index map (the lazy
join's payload), materialized on first direct access or gathered for the
kept rows only by the next Resizer. A port of ``repro.ops.table``.

Every physical gather realized from a :class:`LazyGather` records its output
row count in a thread-local, bounded log (:func:`gather_log`): the tests hold
the guarantee that no payload is expanded at the product size before the
trim, and :func:`table_nbytes` gives a table's physical bytes. Under
``Engine(jit_ops=True)`` the log records what the protocol body realizes
while a node is captured (the counterpart of the reference's trace-time
record); a graph's replay realizes the same rows without logging them.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Dict, List, Optional, Union

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..config import resolve_device
from ..core import threefry
from ..core.circuits import a2b
from ..core.prf import PRFSetup
from ..core.ring import to_numpy
from ..core.sharing import AShare, BShare, reveal_a, reveal_b, share_b

Share = Union[AShare, BShare]

__all__ = ["SecretTable", "LazyGather", "gather_log", "reset_gather_log", "table_nbytes"]


# bounded (a serving session materializes lazy columns on every query) and
# thread-local (concurrent engines must not interleave)
_GATHER_LOG_MAX = 4096
_GATHER_STATE = threading.local()


def _gather_log() -> deque:
    if not hasattr(_GATHER_STATE, "log"):
        _GATHER_STATE.log = deque(maxlen=_GATHER_LOG_MAX)
    return _GATHER_STATE.log


def gather_log() -> List[int]:
    """The output row counts of this thread's gathers from lazy columns,
    oldest first (the last 4,096)."""
    return list(_gather_log())


def reset_gather_log() -> None:
    _gather_log().clear()


@dataclasses.dataclass
class LazyGather:
    """Deferred row-gather view of a base column: ``value = base[index]``.

    ``index`` is public (it encodes structure, e.g. the Cartesian product
    layout row -> (i, j), never data). Composing a further public gather
    stays lazy; padding or any share-level access materializes.
    """

    base: Share
    index: torch.Tensor  # (n,) public int64 row map into base

    @property
    def shape(self):
        return tuple(self.index.shape) + self.base.shape[1:]

    @property
    def size(self) -> int:
        s = 1
        for d in self.shape:
            s *= d
        return s

    @property
    def ring(self):
        return self.base.ring

    def take(self, indices: torch.Tensor, axis: int = 0) -> "LazyGather":
        if axis != 0:
            raise ValueError("LazyGather only supports row (axis 0) gathers")
        return LazyGather(self.base, self.index[indices])

    def gather(self, rows: torch.Tensor) -> Share:
        """Materialize only the given output rows: ``base[index[rows]]``."""
        idx = self.index[rows]
        _gather_log().append(int(idx.shape[0]))
        return self.base.take(idx, axis=0)

    def materialize(self) -> Share:
        _gather_log().append(int(self.index.shape[0]))
        return self.base.take(self.index, axis=0)

    def pad_rows(self, n_rows: int) -> Share:
        return self.materialize().pad_rows(n_rows)

    def nbytes(self) -> int:
        """Backing-store footprint: base shares + public index map (int64
        here, twice the reference's int32 map)."""
        return self.base.shares.nbytes + self.index.nbytes


Column = Union[AShare, BShare, LazyGather]


def table_nbytes(table: "SecretTable") -> int:
    """Physical bytes held by a table (share tensors + lazy index maps).
    Each storage counts once, whole: the product-layout index map that
    every LazyGather of a join side views, or any two views of one buffer.
    The share bytes equal the reference's; an index map holds int64 words,
    twice the reference's int32."""
    seen = set()
    total = 0

    def add(t: torch.Tensor) -> None:
        nonlocal total
        storage = t.untyped_storage()
        key = (t.device, storage.data_ptr()) if storage.data_ptr() else id(t)
        if key not in seen:
            seen.add(key)
            total += storage.nbytes()

    add(table.valid.shares)
    for c in table.cols.values():
        if isinstance(c, LazyGather):
            add(c.base.shares)
            add(c.index)
        else:
            add(c.shares)
    return total


@dataclasses.dataclass
class SecretTable:
    cols: Dict[str, Column]
    valid: BShare  # (n,) single-bit

    @property
    def n(self) -> int:
        return self.valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def gather_rows(self, idx: torch.Tensor) -> "SecretTable":
        """Public row gather; lazy columns compose (stay lazy)."""
        return SecretTable(
            {k: v.take(idx, axis=0) for k, v in self.cols.items()},
            self.valid.take(idx, axis=0),
        )

    def lazy_names(self) -> List[str]:
        return [k for k, v in self.cols.items() if isinstance(v, LazyGather)]

    def select_columns(self, names) -> "SecretTable":
        """Keep only the named columns (a local projection)."""
        return SecretTable({k: self.cols[k] for k in names}, self.valid)

    def pad_rows(self, n_rows: int) -> "SecretTable":
        """Pad with all-zero-share rows: value 0, valid 0 (materializes lazy
        columns: filler shares are not a base-row view)."""
        return SecretTable(
            {k: v.pad_rows(n_rows) for k, v in self.cols.items()},
            self.valid.pad_rows(n_rows),
        )

    def col(self, name: str) -> Share:
        """Column as physical shares — first direct access materializes a
        lazy column in place (cached for later operators)."""
        c = self.cols[name]
        if isinstance(c, LazyGather):
            c = c.materialize()
            self.cols[name] = c
        return c

    def bshare_col(self, name: str, prf: PRFSetup) -> BShare:
        """Column as BShare, converting from AShare if necessary."""
        col = self.col(name)
        if isinstance(col, AShare):
            return a2b(col, prf)
        return col

    # -- I/O (data-owner side / test oracle) ----------------------------------
    @classmethod
    def from_plaintext(
        cls,
        data: Dict[str, np.ndarray],
        key: torch.Tensor,
        valid: Optional[np.ndarray] = None,
        device=None,
    ) -> "SecretTable":
        """Share numpy ``uint32`` columns on ``device`` (default ``"cuda"``;
        raises without a card unless ``device="cpu"``)."""
        dev = resolve_device(device)
        n = len(next(iter(data.values())))
        keys = threefry.split(key, len(data) + 1)
        cols = {
            name: share_b(np.asarray(vals, dtype=np.uint32), k, dev)
            for (name, vals), k in zip(data.items(), keys[:-1])
        }
        v = np.ones(n, dtype=np.uint32) if valid is None else np.asarray(valid, np.uint32)
        return cls(cols, share_b(v, keys[-1], dev))

    def reveal(self) -> Dict[str, np.ndarray]:
        """Open everything (tests / final results only), as numpy uint32."""
        out = {}
        for k in self.cols:
            v = self.col(k)
            out[k] = to_numpy(reveal_a(v) if isinstance(v, AShare) else reveal_b(v))
        out["_valid"] = to_numpy(reveal_b(self.valid)) & 1
        return out

    def reveal_true_rows(self) -> Dict[str, np.ndarray]:
        d = self.reveal()
        mask = d.pop("_valid").astype(bool)
        return {k: v[mask] for k, v in d.items()}


# pytree nodes: the engine's batched pass stacks and vmaps tables leaf by leaf
pytree.register_dataclass(LazyGather)
pytree.register_dataclass(SecretTable)
