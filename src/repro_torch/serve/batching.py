"""Bucketed continuous batching — the Resizer's reveal-and-trim bucketing
reused on plaintext serving shapes (DESIGN.md §5). A port of
``repro.serve.batching``: lots are numpy arrays, as in the reference.

Incoming requests of ragged lengths are padded up to bucket boundaries
(powers of two by default) so the number of compiled (batch, len) shapes is
bounded — the same disclosure/performance dial as the MPC engine's bucketed
trim, minus the privacy semantics."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["BucketedBatcher", "next_bucket"]


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray


class BucketedBatcher:
    """Groups pending requests into (bucket_len, batch) lots."""

    def __init__(
        self,
        len_buckets: Sequence[int] = (128, 256, 512, 1024, 2048, 4096),
        batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
        pad_id: int = 0,
    ):
        self.len_buckets = tuple(len_buckets)
        self.batch_buckets = tuple(batch_buckets)
        self.pad_id = pad_id
        self.pending: List[Request] = []
        self._next_rid = 0

    def submit(self, tokens: np.ndarray) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.pending.append(Request(rid, np.asarray(tokens)))
        return rid

    def next_batch(self, max_batch: int = 32) -> Tuple[Dict, List[int]]:
        """Pops up to max_batch requests sharing a length bucket; returns the
        padded batch dict and the request ids (order preserved)."""
        if not self.pending:
            return {}, []
        # group by bucket; serve the fullest bucket first
        by_bucket: Dict[int, List[Request]] = {}
        for r in self.pending:
            b = next_bucket(len(r.tokens), self.len_buckets)
            by_bucket.setdefault(b, []).append(r)
        bucket, reqs = max(by_bucket.items(), key=lambda kv: len(kv[1]))
        reqs = reqs[:max_batch]
        batch_n = next_bucket(len(reqs), self.batch_buckets)
        ids = {r.rid for r in reqs}
        self.pending = [r for r in self.pending if r.rid not in ids]

        toks = np.full((batch_n, bucket), self.pad_id, np.int32)
        mask = np.zeros((batch_n, bucket), np.int32)
        for i, r in enumerate(reqs):
            toks[i, : len(r.tokens)] = r.tokens
            mask[i, : len(r.tokens)] = 1
        batch = {"tokens": toks, "mask": mask}
        return batch, [r.rid for r in reqs]

    @property
    def n_pending(self) -> int:
        return len(self.pending)
