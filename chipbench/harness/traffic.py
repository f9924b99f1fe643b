"""The one general traffic generator: a mix's JSON file and a seed give
the sequence of rounds a closed loop runs.

A mix names a ``block``: each query and how often it comes in one block.
Every block holds exactly that multiset, in an order drawn from the seed,
so every seed sends the same work in another order, and the window runs
whole blocks. A round is one query: one client runs it, or (with several
``clients``) every client enqueues it and one drain answers them all.

The generator runs closed loops only (``"loop": "closed"``): a client
sends its next query once its last is answered. A mix that asks for
anything else, or sets a key that nothing reads, is refused.
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np

__all__ = ["blocks", "check", "queries"]

_ORDER_STREAM = 1  # the seed's stream for the order (the data takes the seed itself)
# every key a mix may set: the harness reads each
KEYS = {"name", "loop", "clients", "block", "sql", "trace_seconds"}


def check(traffic: Dict) -> Dict:
    """``traffic`` itself, once it asks only for what the generator does."""
    unknown = sorted(set(traffic) - KEYS)
    if unknown:
        raise ValueError(f"mix {traffic.get('name')!r}: no part of the harness reads {unknown}")
    if traffic.get("loop") != "closed":
        raise ValueError(f"mix {traffic.get('name')!r}: the generator runs closed loops only, "
                         f"not {traffic.get('loop')!r}")
    return traffic


def queries(traffic: Dict) -> List[str]:
    """The mix's queries, in the order of its file."""
    return list(traffic["block"])


def blocks(traffic: Dict, seed: int) -> Iterator[List[str]]:
    """Endless blocks of rounds, each a query name."""
    rng = np.random.default_rng([seed % (1 << 64), _ORDER_STREAM])
    block = [q for q, k in traffic["block"].items() for _ in range(int(k))]
    while True:
        yield [block[i] for i in rng.permutation(len(block))]
