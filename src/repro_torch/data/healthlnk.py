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

__all__ = ["generate_healthlnk", "plaintext_oracle"]

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


def plaintext_oracle(query: str, plain: Dict[str, Dict[str, np.ndarray]]):
    """Plaintext answer of a port query: ``dosage_study`` (sorted pids),
    ``aspirin_count`` and ``three_join`` (counts), with the semantics of
    ``repro.data.healthlnk.plaintext_oracle``, vectorised with numpy."""
    d, m = plain["diagnoses"], plain["medications"]
    if query == "dosage_study":
        # patients with a circulatory diagnosis AND a 325 mg aspirin record
        dp = d["pid"][d["icd9"] == ICD9_CIRCULATORY]
        mp = m["pid"][(m["med"] == MED_ASPIRIN) & (m["dosage"] == DOSAGE_325MG)]
        return [int(p) for p in np.intersect1d(dp, mp)]
    aspirin = m["med"] == MED_ASPIRIN
    if query == "aspirin_count":
        # COUNT(DISTINCT pid): a 414 diagnosis no later than an aspirin record
        heart = d["icd9"] == ICD9_HEART_414
        return int(len(_theta_pids(d["pid"][heart], d["time"][heart], m["pid"][aspirin], m["time"][aspirin])))
    if query == "three_join":
        # as aspirin_count on diag = heart disease, for patients in demographics
        heart = d["diag"] == DIAG_HEART_DISEASE
        pids = _theta_pids(d["pid"][heart], d["time"][heart], m["pid"][aspirin], m["time"][aspirin])
        return int(np.isin(pids, plain["demographics"]["pid"].astype(np.int64)).sum())
    raise ValueError(query)
