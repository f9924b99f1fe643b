"""Deterministic, resumable, shard-aware synthetic token pipeline.

A port of ``repro.data.pipeline`` (numpy only, as there): every batch is a
pure function of (seed, step, dp_rank), so a restarted run resumes
bit-identically from the checkpointed step with no persisted reader state,
and each data-parallel shard generates exactly its slice. The batches equal
the reference's bit for bit; the caller moves them onto its device."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dp_rank: int = 0
    dp_size: int = 1
    d_model: Optional[int] = None  # for embedding-mode archs
    mode: str = "tokens"  # tokens | embeddings
    n_prefix: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.dp_size:
            raise ValueError(f"global batch {self.global_batch} is not a multiple of dp_size {self.dp_size}")
        return self.global_batch // self.dp_size

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Markov-ish synthetic tokens: learnable structure (next token
        depends on current), so training loss visibly decreases."""
        rng = np.random.default_rng(
            np.uint64(self.seed) * np.uint64(1_000_003)
            + np.uint64(step) * np.uint64(9_176)
            + np.uint64(self.dp_rank)
        )
        b, s, v = self.local_batch, self.seq_len, self.vocab_size
        base = rng.integers(0, v, (b, 1))
        steps = rng.integers(1, 7, (b, s))
        toks = (base + np.cumsum(steps, axis=1)) % v  # drifting sequences
        tokens = toks.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1  # no target for the last position
        if self.mode == "embeddings":
            emb = rng.standard_normal((b, self.n_prefix or s, self.d_model)).astype(np.float32) * 0.02
            if self.n_prefix:
                return {
                    "embeds": emb,
                    "tokens": tokens[:, : s - self.n_prefix],
                    "labels": labels[:, : s - self.n_prefix],
                }
            return {"embeds": emb, "labels": labels}
        return {"tokens": tokens, "labels": labels}
