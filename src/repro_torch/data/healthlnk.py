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


def plaintext_oracle(query: str, plain: Dict[str, Dict[str, np.ndarray]]):
    """Plaintext answer of a slice query (``dosage_study`` only)."""
    d, m = plain["diagnoses"], plain["medications"]
    if query == "dosage_study":
        # patients with a circulatory diagnosis AND a 325 mg aspirin record
        dp = d["pid"][d["icd9"] == ICD9_CIRCULATORY]
        mp = m["pid"][(m["med"] == MED_ASPIRIN) & (m["dosage"] == DOSAGE_325MG)]
        return [int(p) for p in np.intersect1d(dp, mp)]
    raise ValueError(query)
