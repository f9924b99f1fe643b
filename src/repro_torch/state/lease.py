"""File-locked leases + fencing tokens over a shared state directory.

Mutual exclusion between replicas is an ``fcntl.flock`` on a lock file —
per open-file-description, so two :class:`FileLease` objects exclude each
other even inside one process (the two-services-one-dir tests), and the lock
is released automatically if the holder dies.

Every acquisition also mints a **fencing token**: a monotonically increasing
counter persisted next to the lock. Writers stamp their token into every WAL
record; the store rejects an append whose token is older than one it has
already seen (:class:`StaleLeaseError`). flock alone cannot be stolen from a
live holder, so fencing is belt-and-braces — it catches the classic paused-
writer bug class (a holder that kept a token across a release/re-acquire by
someone else) instead of silently interleaving its stale writes.
"""
from __future__ import annotations

import contextlib
import fcntl
import os
from typing import Iterator, Optional

from ..errors import LeaseFenced

__all__ = ["FileLease", "StaleLeaseError"]

# The fencing error lives in the typed taxonomy (repro_torch.errors); the
# reference's old name stays importable here. LeaseFenced subclasses
# RuntimeError.
StaleLeaseError = LeaseFenced


class FileLease:
    """Exclusive lease on ``<dir>/<name>.lock`` with fencing tokens in
    ``<dir>/<name>.fence``. Re-entrant within one object (compaction runs
    inside a sync transaction)."""

    def __init__(self, directory: str, name: str = "state"):
        self.lock_path = os.path.join(directory, f"{name}.lock")
        self.fence_path = os.path.join(directory, f"{name}.fence")
        self._fh = None
        self._depth = 0
        self._token: Optional[int] = None

    # -- token plumbing --------------------------------------------------------
    def _read_fence(self) -> int:
        try:
            with open(self.fence_path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _write_fence(self, token: int) -> None:
        tmp = self.fence_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(token))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.fence_path)

    # -- acquire / release -----------------------------------------------------
    def acquire(self) -> int:
        """Block until the lease is held; returns this acquisition's fencing
        token (strictly greater than every earlier acquisition's, across all
        replicas of the directory)."""
        if self._depth > 0:
            self._depth += 1
            return self._token  # re-entrant: same token, deeper hold
        self._fh = open(self.lock_path, "a+")
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        self._token = self._read_fence() + 1
        self._write_fence(self._token)
        self._depth = 1
        return self._token

    def bump_to(self, token: int) -> int:
        """Advance the fence while holding the lease — used by the store when
        replayed records carry tokens newer than the fence file (a crash
        recovery into a directory whose fence was lost or copied stale).
        Returns the new current token."""
        if self._depth == 0:
            raise RuntimeError("bump_to requires the lease to be held")
        if token > self._token:
            self._token = token
            self._write_fence(token)
        return self._token

    def release(self) -> None:
        if self._depth == 0:
            return
        self._depth -= 1
        if self._depth == 0:
            fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
            self._fh.close()
            self._fh = None

    @contextlib.contextmanager
    def hold(self) -> Iterator[int]:
        token = self.acquire()
        try:
            yield token
        finally:
            self.release()

    @property
    def held(self) -> bool:
        return self._depth > 0
