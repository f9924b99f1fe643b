"""JournalStore: snapshot + WAL + lease composed into a replicated journal.

The store is deliberately dumb about record *semantics*: consumers (the
privacy accountant, the calibration store) define record payloads and fold
them into their own in-memory state. The store guarantees the replication
mechanics (DESIGN.md §12):

* every state-changing operation runs inside a :meth:`transaction` — the
  lease is held across *read tail -> decide -> append*, so two replicas can
  never interleave decisions against stale state;
* the transaction first hands back every record appended by other replicas
  since this store last looked (``SyncResult.records``) — consumers apply
  those before deciding anything;
* appends are stamped with ``seq`` / fencing ``tok`` / ``owner`` envelope
  fields and are durable (fsync) before the transaction proceeds;
* :meth:`compact` (called inside a transaction) folds the WAL into an
  atomically-replaced snapshot, truncates the WAL, and bumps a generation
  counter; a replica whose transaction observes a generation bump gets
  ``SyncResult.reload=True`` with the snapshot + full WAL to rebuild from.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

from .lease import FileLease, StaleLeaseError
from .wal import WriteAheadLog

__all__ = ["JournalStore", "SyncResult"]


@dataclasses.dataclass
class SyncResult:
    """What a transaction learned before yielding control.

    ``reload=False``: ``records`` is the foreign tail to fold onto existing
    in-memory state. ``reload=True``: the journal was compacted (or this is
    the first transaction) — rebuild from ``snapshot`` then fold ``records``.
    """

    store: "JournalStore"
    token: int
    records: List[Dict]
    reload: bool = False
    snapshot: Optional[Dict] = None

    def append(self, rec: Dict) -> Dict:
        return self.store._append(rec, self.token)


class JournalStore:
    def __init__(
        self,
        directory: str,
        name: str,
        session: Optional[str] = None,
        fsync: bool = True,
        metrics=None,  # repro_torch.obs.MetricsRegistry for WAL latency histograms
    ):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.name = name
        # unique per store object: two replicas in one process are two sessions
        self.session = session or uuid.uuid4().hex[:12]
        self.lease = FileLease(directory, name)
        self._m_append = self._m_fsync = self._m_compact = None
        observer = None
        if metrics is not None:
            self._m_append = metrics.histogram(
                "reflex_wal_append_seconds",
                "Durable WAL append latency (write + flush + fsync)",
                ("journal",),
            )
            self._m_fsync = metrics.histogram(
                "reflex_wal_fsync_seconds",
                "fsync share of WAL append latency", ("journal",),
            )
            self._m_compact = metrics.histogram(
                "reflex_journal_compaction_seconds",
                "Snapshot + WAL-truncate compaction latency", ("journal",),
            )
            observer = self._observe_wal
        self.wal = WriteAheadLog(
            os.path.join(directory, f"{name}.wal.jsonl"), fsync=fsync,
            observer=observer,
        )
        self.snapshot_path = os.path.join(directory, f"{name}.snapshot.json")
        self.gen_path = os.path.join(directory, f"{name}.gen")
        self._offset = 0  # first byte of the WAL this store has NOT applied
        self._seq = 0  # last record seq observed (read or written)
        self._max_token = 0  # newest fencing token observed in records
        self._generation: Optional[int] = None  # None => first txn reloads
        self.stats = {"appends": 0, "syncs": 0, "reloads": 0, "compactions": 0}

    def _observe_wal(self, phase: str, seconds: float) -> None:
        m = self._m_append if phase == "append" else self._m_fsync
        if m is not None:
            m.observe(seconds, journal=self.name)

    # -- generation / snapshot -------------------------------------------------
    def _read_generation(self) -> int:
        try:
            with open(self.gen_path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _read_snapshot(self) -> Optional[Dict]:
        try:
            with open(self.snapshot_path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _write_atomic(self, path: str, payload: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- transactions ----------------------------------------------------------
    @contextmanager
    def transaction(self) -> Iterator[SyncResult]:
        """Hold the lease across sync + decision + append. The yielded
        :class:`SyncResult` carries the foreign tail (or a full reload after
        someone compacted); use its ``append`` for every record written under
        this transaction."""
        with self.lease.hold() as token:
            gen = self._read_generation()
            if self._generation is None or gen != self._generation:
                self._generation = gen
                snapshot = self._read_snapshot()
                records, self._offset = self.wal.read_from(0)
                if snapshot is not None:
                    # a crash between compact()'s snapshot replace and WAL
                    # truncate leaves both on disk: the snapshot already folds
                    # every record up to its seq, so replaying those again
                    # would double-count — filter by the persisted watermark
                    snap_seq = int(snapshot.get("seq", 0))
                    records = [
                        r for r in records if int(r.get("seq", 0)) > snap_seq
                    ]
                    # seq numbering must continue past the snapshot even when
                    # the WAL is empty, or this store's first append would
                    # land at-or-below the watermark and be filtered later
                    self._seq = max(self._seq, snap_seq)
                sync = SyncResult(self, token, records, reload=True,
                                  snapshot=snapshot)
                self.stats["reloads"] += 1
            else:
                records, self._offset = self.wal.read_from(self._offset)
                sync = SyncResult(self, token, records)
            for rec in records:
                self._seq = max(self._seq, int(rec.get("seq", 0)))
                self._max_token = max(self._max_token, int(rec.get("tok", 0)))
            if self._max_token >= token:
                # replayed records outrun the fence file (crash recovery with
                # a lost/stale fence): advance past them so fencing stays
                # strictly monotonic instead of rejecting the recovered writer
                sync.token = token = self.lease.bump_to(self._max_token + 1)
            self.stats["syncs"] += 1
            yield sync

    def _append(self, rec: Dict, token: int) -> Dict:
        if not self.lease.held:
            raise RuntimeError("append outside a JournalStore.transaction")
        if token < self._max_token:
            raise StaleLeaseError(
                f"fencing token {token} is older than an observed write "
                f"(token {self._max_token}) — this lease was superseded",
                token=token,
                seen=self._max_token,
            )
        self._seq += 1
        self._max_token = token
        full = {"seq": self._seq, "tok": token, "owner": self.session, **rec}
        # good_offset heals any torn tail a crashed writer left behind
        self._offset = self.wal.append(full, good_offset=self._offset)
        self.stats["appends"] += 1
        return full

    # -- compaction ------------------------------------------------------------
    def compact(self, state_blob: Dict) -> None:
        """Fold the journal into a snapshot and truncate the WAL. Must run
        inside a :meth:`transaction` (after the consumer applied the sync),
        so ``state_blob`` reflects every record about to be truncated."""
        if not self.lease.held:
            raise RuntimeError("compact outside a JournalStore.transaction")
        t0 = time.perf_counter()
        gen = self._read_generation() + 1
        snapshot = {
            "generation": gen,
            "seq": self._seq,
            "token": self._max_token,
            "state": state_blob,
        }
        self._write_atomic(self.snapshot_path,
                           json.dumps(snapshot, sort_keys=True))
        self.wal.truncate(0)
        self._write_atomic(self.gen_path, str(gen))
        self._generation = gen
        self._offset = 0
        self.stats["compactions"] += 1
        if self._m_compact is not None:
            self._m_compact.observe(
                time.perf_counter() - t0, journal=self.name
            )

    # -- introspection ---------------------------------------------------------
    @property
    def wal_bytes(self) -> int:
        return self.wal.size()

    def status(self) -> Dict:
        return {
            "directory": self.directory,
            "name": self.name,
            "session": self.session,
            "generation": self._generation,
            "seq": self._seq,
            "wal_bytes": self.wal_bytes,
            **self.stats,
        }
