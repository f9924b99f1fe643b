"""Synthetic HealthLnK-like clinical tables (the paper's §5.3 workload).

The same numpy generator as ``repro.data.healthlnk`` — same seed, same
draws, same plaintext — shared with the port's threefry keys, so the shares
match the reference's bit for bit.

Tables (column -> meaning):
  diagnoses     pid, icd9, diag, time, major_icd9
  medications   pid, med, dosage, time
  demographics  pid, zip
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..core import threefry
from ..ops.table import SecretTable
from ..plan.nodes import PlanNode
from ..plan.registry import lookup

__all__ = ["generate_healthlnk", "plaintext_oracle", "revealed_answer"]

ICD9_CIRCULATORY = 390
ICD9_HEART_414 = 414
MED_ASPIRIN = 1
DOSAGE_325MG = 325
DIAG_HEART_DISEASE = 7


def generate_healthlnk(
    n: int = 128,
    key: Optional[torch.Tensor] = None,
    seed: int = 0,
    n_patients: Optional[int] = None,
    aspirin_frac: float = 0.2,
    icd_heart_frac: float = 0.15,
    device=None,
) -> Tuple[Dict[str, SecretTable], Dict[str, Dict[str, np.ndarray]]]:
    """Returns ({table -> SecretTable on ``device``}, {table -> plaintext
    columns}). ``device`` defaults to ``"cuda"`` and raises without a card
    unless ``"cpu"`` is asked for."""
    dev = resolve_device(device)
    key = key if key is not None else threefry.PRNGKey(11)
    rng = np.random.default_rng(seed)
    n_patients = n_patients or max(n // 4, 4)

    diag = {
        "pid": rng.integers(0, n_patients, n).astype(np.uint32),
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
        "pid": rng.integers(0, n_patients, n).astype(np.uint32),
        "med": np.where(
            rng.random(n) < aspirin_frac, MED_ASPIRIN, rng.integers(2, 12, n)
        ).astype(np.uint32),
        "dosage": rng.choice([81, 100, DOSAGE_325MG, 500], n).astype(np.uint32),
        "time": rng.integers(0, 1000, n).astype(np.uint32),
    }

    demo = {
        "pid": np.arange(n_patients, dtype=np.uint32),
        "zip": rng.integers(10000, 99999, n_patients).astype(np.uint32),
    }

    plain = {"diagnoses": diag, "medications": meds, "demographics": demo}
    keys = threefry.split(key, 3)
    shared = {
        name: SecretTable.from_plaintext(cols, k, device=dev)
        for (name, cols), k in zip(plain.items(), keys)
    }
    return shared, plain


def _theta_pids(d_pid, d_time, m_pid, m_time) -> np.ndarray:
    """Patients with some (diagnosis, medication) pair of theirs where
    d.time <= m.time: the earliest such diagnosis against the latest such
    medication, per patient (vectorised; no pairwise loop)."""
    if not len(d_pid) or not len(m_pid):
        return np.zeros(0, dtype=np.int64)
    size = int(max(d_pid.max(), m_pid.max())) + 1
    first_d = np.full(size, np.iinfo(np.int64).max)
    np.minimum.at(first_d, d_pid.astype(np.int64), d_time.astype(np.int64))
    last_m = np.full(size, -1, dtype=np.int64)
    np.maximum.at(last_m, m_pid.astype(np.int64), m_time.astype(np.int64))
    return np.nonzero(first_d <= last_m)[0]


def _group_counts(*cols: np.ndarray) -> Dict:
    """{key: row count} over one column or a composite key of several."""
    keys, counts = np.unique(np.stack(cols, axis=1), axis=0, return_counts=True)
    as_key = (lambda k: int(k[0])) if len(cols) == 1 else (lambda k: tuple(int(v) for v in k))
    return {as_key(k): int(c) for k, c in zip(keys, counts)}


def _group_sums(key: np.ndarray, vals: np.ndarray) -> Tuple[Dict[int, int], Dict[int, int]]:
    """({key: sum of vals}, {key: row count})."""
    keys, inv, counts = np.unique(key, return_inverse=True, return_counts=True)
    sums = np.zeros(len(keys), dtype=np.int64)
    np.add.at(sums, inv, vals.astype(np.int64))
    return ({int(k): int(v) for k, v in zip(keys, sums)}, {int(k): int(c) for k, c in zip(keys, counts)})


def plaintext_oracle(query: str, plain: Dict[str, Dict[str, np.ndarray]]):
    """Plaintext answer of each of the fourteen goldens, with the semantics
    and the result form of ``repro.data.healthlnk.plaintext_oracle``,
    vectorised with numpy."""
    d, m = plain["diagnoses"], plain["medications"]
    aspirin = m["med"] == MED_ASPIRIN
    if query == "comorbidity":
        # the ten largest groups, ties broken by the smaller key
        top = sorted(((c, v) for v, c in _group_counts(d["major_icd9"]).items()), key=lambda t: (-t[0], t[1]))
        return {v: c for c, v in top[:10]}
    if query == "dosage_study":
        # patients with a circulatory diagnosis AND a 325 mg aspirin record
        dp = d["pid"][d["icd9"] == ICD9_CIRCULATORY]
        mp = m["pid"][aspirin & (m["dosage"] == DOSAGE_325MG)]
        return [int(p) for p in np.intersect1d(dp, mp)]
    if query == "aspirin_count":
        # COUNT(DISTINCT pid): a 414 diagnosis no later than an aspirin record
        heart = d["icd9"] == ICD9_HEART_414
        return int(len(_theta_pids(d["pid"][heart], d["time"][heart], m["pid"][aspirin], m["time"][aspirin])))
    if query == "three_join":
        # as aspirin_count on diag = heart disease, for patients in demographics
        heart = d["diag"] == DIAG_HEART_DISEASE
        pids = _theta_pids(d["pid"][heart], d["time"][heart], m["pid"][aspirin], m["time"][aspirin])
        return int(np.isin(pids, plain["demographics"]["pid"].astype(np.int64)).sum())
    if query == "projection_join":
        # distinct (pid, dosage) of aspirin records whose patient has a diagnosis
        mp, md = m["pid"][aspirin], m["dosage"][aspirin]
        hit = np.isin(mp, d["pid"])
        pairs = np.unique(np.stack([mp[hit], md[hit]], axis=1), axis=0)
        return [(int(p), int(v)) for p, v in pairs]
    if query == "dosage_sum":
        return int(m["dosage"][aspirin].astype(np.int64).sum())
    if query == "dosage_avg":
        total, cnt = int(m["dosage"][aspirin].astype(np.int64).sum()), int(aspirin.sum())
        return {"sum": total, "cnt": cnt, "avg": total // max(cnt, 1)}
    if query in ("dosage_min", "dosage_max"):
        vals = m["dosage"][aspirin]
        if len(vals) == 0:
            return None  # empty selection: the engine reveals zero rows
        return int(vals.min() if query == "dosage_min" else vals.max())
    if query == "heart_or_circulatory":
        return int(((d["icd9"] == ICD9_HEART_414) | (d["icd9"] == ICD9_CIRCULATORY)).sum())
    if query == "diag_breakdown":
        return _group_counts(d["major_icd9"], d["diag"])
    if query in ("med_dosage_sum", "med_dosage_avg"):
        sums, cnts = _group_sums(m["med"], m["dosage"])
        if query == "med_dosage_sum":
            return sums
        return {k: {"sum": sums[k], "cnt": cnts[k], "avg": sums[k] // cnts[k]} for k in sums}
    if query == "repeat_diagnoses":
        return {v: c for v, c in _group_counts(d["major_icd9"]).items() if c >= 2}
    raise ValueError(query)


def revealed_answer(query: str, plan: PlanNode, out: SecretTable):
    """A golden's answer in :func:`plaintext_oracle`'s form from the output
    table of ``Engine.execute(plan)``: its true rows revealed, then the
    root operator's ``post_reveal`` (AVG's quotient) applied."""
    raw = out.reveal_true_rows()
    post = lookup(type(plan)).post_reveal
    rows = raw if post is None else {**raw, **post(plan, raw)}
    col = {k: [int(x) for x in v] for k, v in rows.items()}
    if query == "dosage_study":
        return sorted(set(col["pid"]))
    if query in ("aspirin_count", "three_join", "heart_or_circulatory"):
        return col["cnt"][0]
    if query in ("comorbidity", "repeat_diagnoses"):
        return dict(zip(col["major_icd9"], col["cnt"]))
    if query == "projection_join":
        return sorted(set(zip(col["pid"], col["dosage"])))
    if query == "dosage_sum":
        return col["total"][0]
    if query == "dosage_avg":
        return {"sum": col["avg_dosage_sum"][0], "cnt": col["avg_dosage_cnt"][0], "avg": col["avg_dosage"][0]}
    if query in ("dosage_min", "dosage_max"):
        vals = col["lo" if query == "dosage_min" else "hi"]
        return vals[0] if vals else None
    if query == "diag_breakdown":
        return dict(zip(zip(col["major_icd9"], col["diag"]), col["cnt"]))
    if query == "med_dosage_sum":
        return dict(zip(col["med"], col["total"]))
    if query == "med_dosage_avg":
        return {
            k: {"sum": s_, "cnt": c, "avg": a}
            for k, s_, c, a in zip(col["med"], col["mean_sum"], col["mean_cnt"], col["mean"])
        }
    raise ValueError(query)
