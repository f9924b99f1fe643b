"""The comparison that decides ``correct``: every answer of the window
against the plain reference's, exactly.

The program's revealed rows are put into the reference's canonical form
(its ``REVEALED_COLUMNS``, each row as often as it was revealed, sorted;
an ORDER BY answer must also come in its order). The numbers compared are
the answers that differ from the reference's, the answers that never came
(an error, a refusal, a slot left out), and the answers revealed from
shares in another ring than the one the configuration states (its
``guarantees.ring_bits``: a narrower ring gives the same small pids and
counts, so only this number holds a run to the stated ring); the limit of
each is 0.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

from .record import Answer

__all__ = ["canonical", "judge", "LIMITS"]

LIMITS = {"wrong_answers": 0, "missing_answers": 0, "wrong_ring_answers": 0}


def canonical(reference, query: str, rows: Dict[str, np.ndarray]):
    """The revealed ``rows`` in the reference's form, or ``None`` where they
    cannot be (a column missing, an ORDER BY out of order)."""
    cols = reference.REVEALED_COLUMNS[query]
    if any(c not in rows for c in cols):
        return None
    ordered = getattr(reference, "ORDERED_BY", {}).get(query)
    if ordered is not None:
        v = np.asarray(rows[ordered]).astype(np.int64)
        if np.any(v[1:] > v[:-1]):
            return None
    columns = [np.asarray(rows[c]).astype(np.int64).tolist() for c in cols]
    return sorted(zip(*columns))


def judge(answers: List[Answer], reference, expected: Callable[[str], list], ring_bits: int) -> Dict[str, int]:
    """Set each answer's ``ok`` and count the three kinds of failure.
    ``expected(query)`` gives the reference's answer; ``ring_bits`` is the
    stated ring's word, which every answer's shares must have."""
    want: Dict[str, list] = {}
    wrong = missing = wrong_ring = 0
    for a in answers:
        if a.rows is None:
            a.ok = False
            missing += 1
            continue
        if a.query not in want:
            want[a.query] = expected(a.query)
        in_ring = a.ring_bits == ring_bits
        right = canonical(reference, a.query, a.rows) == want[a.query]
        a.ok = in_ring and right
        wrong += not right
        wrong_ring += not in_ring
    return {"wrong_answers": wrong, "missing_answers": missing, "wrong_ring_answers": wrong_ring}
