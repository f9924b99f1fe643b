"""The HealthLNK deployment's plain reference: its tables and its answers.

A frozen NumPy copy of the port's synthetic HealthLNK generator (the
SMCQL clinical schema of the paper's evaluation: the same columns, the
same fractions and the same draws from ``numpy.random.default_rng(seed)``),
and a plain answer for each query the benchmark's cells run. It imports
nothing of the program: the benchmark hands the same plaintext tables to the
program, which shares them, and to :func:`answer`, which reads them.

Tables (column -> meaning):
  diagnoses     pid, icd9, diag, time, major_icd9
  medications   pid, med, dosage, time
  demographics  pid, zip

Answers are exact and in one canonical form per query, so that the
program's revealed rows (put into the same form by the harness's judge)
compare with ``==``: a list of rows, each a tuple of ints, sorted, with
every row as often as the query's semantics give it (a duplicate a query
must not return is a difference, not a detail). ``ring_bits`` is the word
size the answer is computed in: 32, the configuration's ring Z_2^32, or a
smaller ring for a lower-precision control, whose sums and counts wrap.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

__all__ = ["make_tables", "answer", "QUERIES", "REVEALED_COLUMNS", "ORDERED_BY"]

ICD9_CIRCULATORY = 390
ICD9_HEART_414 = 414
MED_ASPIRIN = 1
DOSAGE_325MG = 325
DIAG_HEART_DISEASE = 7

# every key of a configuration's ``data`` (the generator reads each)
DATA_KEYS = {"rows", "patients", "aspirin_frac", "icd_heart_frac", "layout_seed"}

Plain = Dict[str, Dict[str, np.ndarray]]
Rows = List[Tuple[int, ...]]


def _draw(data: Dict, seed: int) -> Plain:
    """The generator: ``rows`` diagnoses and medications over ``patients``
    patients with ``aspirin_frac`` and ``icd_heart_frac``, ``uint32``
    columns, drawn in its order from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n, patients = int(data["rows"]), int(data["patients"])
    aspirin_frac, icd_heart_frac = float(data["aspirin_frac"]), float(data["icd_heart_frac"])
    diag = {
        "pid": rng.integers(0, patients, n).astype(np.uint32),
        "icd9": np.where(
            rng.random(n) < icd_heart_frac,
            ICD9_HEART_414,
            rng.choice([ICD9_CIRCULATORY, 401, 250, 486], n),
        ).astype(np.uint32),
        "diag": np.where(
            rng.random(n) < icd_heart_frac, DIAG_HEART_DISEASE, rng.integers(0, 6, n)
        ).astype(np.uint32),
        "time": rng.integers(0, 1000, n).astype(np.uint32),
    }
    diag["major_icd9"] = (diag["icd9"] // 100).astype(np.uint32)
    meds = {
        "pid": rng.integers(0, patients, n).astype(np.uint32),
        "med": np.where(
            rng.random(n) < aspirin_frac, MED_ASPIRIN, rng.integers(2, 12, n)
        ).astype(np.uint32),
        "dosage": rng.choice([81, 100, DOSAGE_325MG, 500], n).astype(np.uint32),
        "time": rng.integers(0, 1000, n).astype(np.uint32),
    }
    demo = {
        "pid": np.arange(patients, dtype=np.uint32),
        "zip": rng.integers(10000, 99999, patients).astype(np.uint32),
    }
    return {"diagnoses": diag, "medications": meds, "demographics": demo}


def make_tables(data: Dict, seed: int) -> Plain:
    """A configuration's tables for ``seed``.

    Without ``data["layout_seed"]`` they are the generator's draws from
    ``seed``. With it, the columns that set the sizes of the oblivious
    operators' results (which rows pass each filter: ``icd9`` and so
    ``major_icd9``, ``med``, and whether ``dosage`` is 325) are the draws
    from ``layout_seed``, and every other value (``pid``, ``time``,
    ``diag``, the other dosages, ``zip``) is drawn from ``seed``. Every seed
    then gives its queries other answers over filters, groups and Resizes
    of the same sizes. A negative seed is taken modulo 2^64. A key of
    ``data`` that the generator does not read is refused."""
    unknown = sorted(set(data) - DATA_KEYS)
    if unknown:
        raise ValueError(f"the HealthLNK generator reads {sorted(DATA_KEYS)}, not {unknown}")
    seed %= 1 << 64
    if "layout_seed" not in data:
        return _draw(data, seed)
    fixed, plain = _draw(data, int(data["layout_seed"])), _draw(data, seed)
    d, m = plain["diagnoses"], plain["medications"]
    for col in ("icd9", "major_icd9"):
        d[col] = fixed["diagnoses"][col]
    m["med"] = fixed["medications"]["med"]
    other = np.random.default_rng([seed % (1 << 64), 2]).choice([81, 100, 500], len(m["dosage"]))
    m["dosage"] = np.where(fixed["medications"]["dosage"] == DOSAGE_325MG, DOSAGE_325MG, other).astype(np.uint32)
    return plain


def _wrap(values: np.ndarray, ring_bits: int) -> np.ndarray:
    return values.astype(np.int64) & ((1 << ring_bits) - 1)


def _groups(keys: List[np.ndarray], vals: np.ndarray, ring_bits: int) -> Rows:
    """One row per distinct key: the key's columns, the rows' count and the
    sum of ``vals`` (both in the ring)."""
    stacked = np.stack([k.astype(np.int64) for k in keys], axis=1)
    uniq, inv = np.unique(stacked, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    cnt = np.bincount(inv, minlength=len(uniq))
    tot = np.bincount(inv, weights=vals.astype(np.float64), minlength=len(uniq)).astype(np.int64)
    return [(*(int(x) for x in u), int(_wrap(np.array([c]), ring_bits)[0]), int(_wrap(np.array([t]), ring_bits)[0]))
            for u, c, t in zip(uniq, cnt, tot)]


def _theta_pids(d_pid, d_time, m_pid, m_time) -> np.ndarray:
    """Patients with a diagnosis row and a medication row of theirs where
    d.time <= m.time: their earliest such diagnosis against their latest
    medication."""
    if not len(d_pid) or not len(m_pid):
        return np.zeros(0, dtype=np.int64)
    size = int(max(d_pid.max(), m_pid.max())) + 1
    first_d = np.full(size, np.iinfo(np.int64).max)
    np.minimum.at(first_d, d_pid.astype(np.int64), d_time.astype(np.int64))
    last_m = np.full(size, -1, dtype=np.int64)
    np.maximum.at(last_m, m_pid.astype(np.int64), m_time.astype(np.int64))
    return np.nonzero(first_d <= last_m)[0]


def answer(query: str, plain: Plain, ring_bits: int = 32) -> Rows:
    """The exact answer of ``query`` over ``plain`` in canonical form."""
    d, m = plain["diagnoses"], plain["medications"]
    aspirin = m["med"] == MED_ASPIRIN
    one = (lambda v: [(int(_wrap(np.array([v]), ring_bits)[0]),)])
    if query == "dosage_study":
        # SELECT DISTINCT d.pid ... WHERE d.pid = m.pid AND icd9 = 390 AND
        # med = aspirin AND dosage = 325: each such patient once
        dp = d["pid"][d["icd9"] == ICD9_CIRCULATORY]
        mp = m["pid"][aspirin & (m["dosage"] == DOSAGE_325MG)]
        return [(int(p),) for p in np.intersect1d(dp, mp)]
    if query == "aspirin_count":
        # COUNT(DISTINCT pid) of 414 diagnoses no later than an aspirin record
        heart = d["icd9"] == ICD9_HEART_414
        return one(len(_theta_pids(d["pid"][heart], d["time"][heart], m["pid"][aspirin], m["time"][aspirin])))
    if query == "comorbidity":
        # GROUP BY major_icd9 ORDER BY COUNT(*) DESC LIMIT 10
        groups = [(k, c) for k, c, _ in _groups([d["major_icd9"]], d["major_icd9"], ring_bits)]
        return sorted(sorted(groups, key=lambda r: (-r[1], r[0]))[:10])
    if query == "diag_breakdown":
        return sorted((a, b, c) for a, b, c, _ in _groups([d["major_icd9"], d["diag"]], d["diag"], ring_bits))
    if query == "med_dosage_sum":
        return sorted((k, t) for k, _, t in _groups([m["med"]], m["dosage"], ring_bits))
    if query == "dosage_avg":
        # revealed as (sum, count) and the quotient the client derives
        total = int(_wrap(np.array([m["dosage"][aspirin].astype(np.int64).sum()]), ring_bits)[0])
        cnt = int(_wrap(np.array([int(aspirin.sum())]), ring_bits)[0])
        return [(total, cnt, total // max(cnt, 1))]
    if query == "heart_or_circulatory":
        return one(int(((d["icd9"] == ICD9_HEART_414) | (d["icd9"] == ICD9_CIRCULATORY)).sum()))
    if query == "repeat_diagnoses":
        # GROUP BY major_icd9 HAVING COUNT(*) >= 2
        return sorted((k, c) for k, c, _ in _groups([d["major_icd9"]], d["major_icd9"], ring_bits) if c >= 2)
    raise ValueError(f"no reference answer for {query!r}")


# the program's revealed columns that make up each answer's rows, in order
REVEALED_COLUMNS = {
    "dosage_study": ("pid",),
    "aspirin_count": ("cnt",),
    "comorbidity": ("major_icd9", "cnt"),
    "diag_breakdown": ("major_icd9", "diag", "cnt"),
    "med_dosage_sum": ("med", "total"),
    "dosage_avg": ("avg_dosage_sum", "avg_dosage_cnt", "avg_dosage"),
    "heart_or_circulatory": ("cnt",),
    "repeat_diagnoses": ("major_icd9", "cnt"),
}
# ORDER BY queries: the revealed column whose values must not increase
ORDERED_BY = {"comorbidity": "cnt"}

QUERIES = ("dosage_study", "aspirin_count", "comorbidity", "diag_breakdown", "med_dosage_sum", "dosage_avg",
           "heart_or_circulatory", "repeat_diagnoses")
