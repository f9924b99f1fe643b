"""Controls: the plain reference put in the program's place, one step worse.

A control shows that the comparison which decides ``correct`` can fail: its
answers go through the same judge as the program's, and a sound comparison
rejects them. Each breaks what a later change might be tempted to give up:

* ``ring16`` computes every answer in Z_2^16, the nearest ring below the
  configuration's Z_2^32: sums and counts wrap at 65,536, and its answers
  come from 16-bit words, which the judge holds against the stated ring.
* ``distinct_dropped`` leaves out the duplicate elimination of ``DISTINCT``
  and ``COUNT(DISTINCT ...)`` (the costliest step of the join queries), so a
  patient with several matching record pairs counts once for each pair.
"""
from __future__ import annotations

import numpy as np

from . import healthlnk
from .healthlnk import DOSAGE_325MG, ICD9_CIRCULATORY, ICD9_HEART_414, MED_ASPIRIN

__all__ = ["CONTROLS", "CONTROL_RING_BITS", "control_answer"]


def _join_pairs(d_pid, m_pid, keep=None):
    """The pids of every (diagnosis, medication) pair with equal pid (and
    ``keep(d_index, m_index)`` true), one per pair."""
    order = np.argsort(m_pid, kind="stable")
    sorted_m = m_pid[order]
    lo = np.searchsorted(sorted_m, d_pid, "left")
    hi = np.searchsorted(sorted_m, d_pid, "right")
    out = []
    for i, (a, b) in enumerate(zip(lo, hi)):
        for j in order[a:b]:
            if keep is None or keep(i, j):
                out.append(int(d_pid[i]))
    return out


def _distinct_dropped(query, plain):
    d, m = plain["diagnoses"], plain["medications"]
    aspirin = m["med"] == MED_ASPIRIN
    if query == "dosage_study":
        dsel = d["icd9"] == ICD9_CIRCULATORY
        msel = aspirin & (m["dosage"] == DOSAGE_325MG)
        return sorted((p,) for p in _join_pairs(d["pid"][dsel], m["pid"][msel]))
    if query == "aspirin_count":
        dsel = d["icd9"] == ICD9_HEART_414
        dt, mt = d["time"][dsel], m["time"][aspirin]
        pairs = _join_pairs(d["pid"][dsel], m["pid"][aspirin], keep=lambda i, j: dt[i] <= mt[j])
        return [(len(pairs) & 0xFFFFFFFF,)]
    return healthlnk.answer(query, plain)


CONTROLS = {
    "ring16": lambda query, plain: healthlnk.answer(query, plain, ring_bits=16),
    "distinct_dropped": _distinct_dropped,
}


# the word each control computes its answers in
CONTROL_RING_BITS = {"ring16": 16, "distinct_dropped": 32}


def control_answer(name: str, query: str, plain):
    return CONTROLS[name](query, plain)
