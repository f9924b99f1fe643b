"""Append-only JSONL write-ahead log.

One record per line, appended with flush + fsync *before* the caller acts on
the record — the intent->record protocol (DESIGN.md §12) relies on "if the
append returned, the line is durable; if the line is torn, the action never
started".

Torn tails: a crash mid-write can leave a final line without a newline (or
with truncated JSON). Readers stop at the last complete record; the next
appender truncates the torn bytes first (under the state lease), so the log
never accumulates garbage between records.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["WriteAheadLog"]


class WriteAheadLog:
    """JSONL log with offset-based incremental reads.

    ``fsync=False`` trades crash durability for latency (the persistence
    benchmark measures both); correctness under *process* crash still holds
    (the OS page cache survives), only power loss can then lose a tail.

    ``observer(phase, seconds)`` — optional latency callback fired after each
    ``append`` (phase ``"append"`` covers the whole call, ``"fsync"`` just
    the fsync) so the owning store can feed latency histograms without this
    module importing any metrics machinery.
    """

    def __init__(
        self,
        path: str,
        fsync: bool = True,
        observer: Optional[Callable[[str, float], None]] = None,
    ):
        self.path = path
        self.fsync = fsync
        self.observer = observer

    # -- writing ---------------------------------------------------------------
    def append(self, rec: Dict, good_offset: int | None = None) -> int:
        """Durably append one record; returns the end offset. When
        ``good_offset`` is given and the file is longer (a torn tail from a
        crashed writer), the torn bytes are truncated first — callers must
        hold the state lease, so no complete record is ever dropped."""
        line = (json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n").encode()
        t0 = time.perf_counter()
        with open(self.path, "ab") as f:
            if good_offset is not None and f.tell() > good_offset:
                f.truncate(good_offset)
                f.seek(good_offset)
            f.write(line)
            f.flush()
            if self.fsync:
                ts = time.perf_counter()
                os.fsync(f.fileno())
                if self.observer is not None:
                    self.observer("fsync", time.perf_counter() - ts)
            end = f.tell()
        if self.observer is not None:
            self.observer("append", time.perf_counter() - t0)
        return end

    def truncate(self, offset: int = 0) -> None:
        if os.path.exists(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(offset)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())

    # -- reading ---------------------------------------------------------------
    def read_from(self, offset: int) -> Tuple[List[Dict], int]:
        """All complete records at/after ``offset`` plus the offset of the
        first incomplete byte (== EOF when the tail is clean). A torn final
        line — no newline, or unparsable JSON — is excluded and its start
        offset returned, so a later ``append(good_offset=...)`` heals it."""
        if not os.path.exists(self.path):
            return [], 0
        records: List[Dict] = []
        with open(self.path, "rb") as f:
            f.seek(offset)
            good = offset
            for line in f:
                end = good + len(line)
                if not line.endswith(b"\n"):
                    break  # torn tail: mid-line crash
                try:
                    records.append(json.loads(line))
                except ValueError:
                    break  # torn tail: interleaved partial write
                good = end
        return records, good

    def size(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0
