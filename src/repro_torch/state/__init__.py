"""Durable service state (DESIGN.md §12), a port of ``repro.state``.

Host code only (file locks, fsync, atomic renames): the journal format is
the reference's, so a state directory written by either package's service
is read by the other with the same observed counts, budgets and refusals.

The service tier's ground truth — the CRT privacy ledger and the calibration
observations — used to live in per-process memory: a restart forgot every
observation an attacker had already collected, and two replicas silently
doubled the real disclosure budget. This package makes that state durable and
shareable:

* :mod:`repro_torch.state.wal`    — append-only JSONL write-ahead log (fsync'd,
  torn-tail tolerant).
* :mod:`repro_torch.state.lease`  — file-locked leases + fencing tokens over a
  shared state directory (N replicas, one global budget).
* :mod:`repro_torch.state.store`  — snapshot + WAL + lease composed into a
  replicated journal (`JournalStore`) with tail-sync and compaction.
* :mod:`repro_torch.state.calibration` — persisted already-revealed intermediate
  sizes keyed by literal-masked subplan fingerprint, fed back into the
  planner's cost model (zero additional disclosure).
"""
from .calibration import CalibrationStore, calibration_key  # noqa: F401
from .lease import FileLease, StaleLeaseError  # noqa: F401
from .store import JournalStore, SyncResult  # noqa: F401
from .wal import WriteAheadLog  # noqa: F401

__all__ = [
    "CalibrationStore",
    "calibration_key",
    "FileLease",
    "StaleLeaseError",
    "JournalStore",
    "SyncResult",
    "WriteAheadLog",
]
