"""The frozen HealthLNK reference: its answers on tiny tables worked out by
hand, its generator against the port's, and the judge's canonical form."""
import numpy as np
import pytest

from chipbench.harness.judge import canonical, judge
from chipbench.harness.record import Answer
from chipbench.reference import controls, healthlnk

U = np.uint32


def _tiny():
    """Three patients. Diagnoses (pid, icd9, diag, time); medications (pid,
    med, dosage, time)."""
    d = np.array([
        [0, 414, 7, 10],
        [0, 390, 1, 20],
        [1, 390, 7, 30],
        [1, 390, 2, 5],
        [2, 250, 3, 40],
        [2, 414, 0, 50],
    ])
    m = np.array([
        [0, 1, 325, 15],   # aspirin 325, after patient 0's 414 (time 10)
        [0, 1, 81, 5],     # aspirin, before it
        [1, 1, 325, 1],    # aspirin 325 for patient 1
        [1, 1, 325, 2],    # and again: patient 1 has two matching pairs
        [2, 1, 500, 45],   # aspirin before patient 2's 414 (time 50)
        [2, 4, 100, 60],
    ])
    diag = {"pid": d[:, 0], "icd9": d[:, 1], "diag": d[:, 2], "time": d[:, 3]}
    diag = {k: v.astype(U) for k, v in diag.items()}
    diag["major_icd9"] = (diag["icd9"] // 100).astype(U)
    meds = {k: m[:, i].astype(U) for i, k in enumerate(("pid", "med", "dosage", "time"))}
    demo = {"pid": np.arange(3, dtype=U), "zip": np.array([10001, 10002, 10003], dtype=U)}
    return {"diagnoses": diag, "medications": meds, "demographics": demo}


HAND = {
    # patients with a 390 diagnosis and an aspirin 325 record: 0 and 1, once each
    "dosage_study": [(0,), (1,)],
    # a 414 diagnosis no later than an aspirin record: patient 0 (10 <= 15);
    # patient 2's aspirin (45) comes before its 414 (50)
    "aspirin_count": [(1,)],
    # major_icd9: 4 (414 twice), 3 (390 three times), 2 (250 once)
    "comorbidity": [(2, 1), (3, 3), (4, 2)],
    "diag_breakdown": [(2, 3, 1), (3, 1, 1), (3, 2, 1), (3, 7, 1), (4, 0, 1), (4, 7, 1)],
    "med_dosage_sum": [(1, 325 + 81 + 325 + 325 + 500), (4, 100)],
    # five aspirin records, 1,556 mg in all
    "dosage_avg": [(1556, 5, 311)],
    "heart_or_circulatory": [(5,)],
    "repeat_diagnoses": [(3, 3), (4, 2)],
}


@pytest.mark.parametrize("query", sorted(HAND))
def test_answer_by_hand(query):
    assert healthlnk.answer(query, _tiny()) == HAND[query]


def test_distinct_dropped_control_counts_every_pair():
    plain = _tiny()
    # patient 0: one 390 diagnosis x one aspirin 325 record; patient 1: two x two
    assert controls.control_answer("distinct_dropped", "dosage_study", plain) == [(0,)] + [(1,)] * 4
    assert controls.control_answer("distinct_dropped", "aspirin_count", plain) == [(1,)]
    assert controls.control_answer("distinct_dropped", "comorbidity", plain) == HAND["comorbidity"]


def test_ring16_control_wraps_sums():
    plain = _tiny()
    plain["medications"]["dosage"] = np.array([40000, 40000, 1, 1, 1, 1], dtype=U)
    assert healthlnk.answer("med_dosage_sum", plain) == [(1, 80003), (4, 1)]
    assert controls.control_answer("ring16", "med_dosage_sum", plain) == [(1, 80003 - 65536), (4, 1)]


def test_generator_copy_matches_the_port():
    from repro_torch.data import generate_healthlnk

    data = {"rows": 64, "patients": 16, "aspirin_frac": 0.2, "icd_heart_frac": 0.15}
    mine = healthlnk.make_tables(data, 2**31 + 77)  # no layout_seed: the generator itself
    _, theirs = generate_healthlnk(n=64, seed=2**31 + 77, n_patients=16, device="cpu")
    assert mine.keys() == theirs.keys()
    for t in mine:
        assert mine[t].keys() == theirs[t].keys()
        for c in mine[t]:
            assert mine[t][c].dtype == np.uint32 and np.array_equal(mine[t][c], theirs[t][c])


def test_judge_counts_rows_as_often_as_revealed_and_orders():
    ref = healthlnk
    rows = {"pid": np.array([1, 0, 1], dtype=U)}
    assert canonical(ref, "dosage_study", rows) == [(0,), (1,), (1,)]
    out_of_order = {"major_icd9": np.array([2, 3], dtype=U), "cnt": np.array([1, 3], dtype=U)}
    assert canonical(ref, "comorbidity", out_of_order) is None
    want = {"dosage_study": [(0,), (1,)]}
    answers = [Answer("dosage_study", "a", 0, 1, rows={"pid": np.array([1, 0], dtype=U)}, ring_bits=32),
               Answer("dosage_study", "b", 0, 1, rows=rows, ring_bits=32),
               Answer("dosage_study", "c", 0, 1, error="refused"),
               Answer("dosage_study", "d", 0, 1, rows={"pid": np.array([0, 1], dtype=U)}, ring_bits=16)]
    assert judge(answers, ref, want.__getitem__, 32) == {"wrong_answers": 1, "missing_answers": 1,
                                                         "wrong_ring_answers": 1}
    assert [a.ok for a in answers] == [True, False, False, False]


def test_layout_seed_fixes_which_rows_pass_and_the_seed_the_rest():
    data = {"rows": 512, "patients": 128, "aspirin_frac": 0.2, "icd_heart_frac": 0.15, "layout_seed": 9}
    a, b = healthlnk.make_tables(data, 2**31 + 1), healthlnk.make_tables(data, 2**31 + 2)
    da, db, ma, mb = a["diagnoses"], b["diagnoses"], a["medications"], b["medications"]
    assert np.array_equal(da["icd9"], db["icd9"]) and np.array_equal(ma["med"], mb["med"])
    assert np.array_equal(ma["dosage"] == 325, mb["dosage"] == 325)
    assert not np.array_equal(da["pid"], db["pid"]) and not np.array_equal(ma["time"], mb["time"])
    assert not np.array_equal(ma["dosage"], mb["dosage"])
    assert set(np.unique(ma["dosage"])) <= {81, 100, 325, 500}
    assert healthlnk.answer("aspirin_count", a) != healthlnk.answer("aspirin_count", b) or \
        healthlnk.answer("dosage_study", a) != healthlnk.answer("dosage_study", b)
