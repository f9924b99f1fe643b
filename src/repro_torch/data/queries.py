"""Hand-compiled plans of the port (paper Table 2). Filters are pushed below
joins; Resizer placement is applied separately with
:func:`repro_torch.plan.policies.insert_resizers`."""
from __future__ import annotations

from ..ops.filter import Predicate
from ..plan.nodes import CountDistinct, Distinct, Filter, Join, PlanNode, Scan
from .healthlnk import (
    DIAG_HEART_DISEASE,
    DOSAGE_325MG,
    ICD9_CIRCULATORY,
    ICD9_HEART_414,
    MED_ASPIRIN,
)

__all__ = ["dosage_study_plan", "aspirin_count_plan", "three_join_plan"]


def dosage_study_plan() -> PlanNode:
    """SELECT DISTINCT d.pid FROM diagnoses d, medications m WHERE
    d.pid = m.pid AND med='aspirin' AND icd9='circulatory' AND dosage='325mg'."""
    d = Filter(Scan("diagnoses"), [Predicate("icd9", "eq", ICD9_CIRCULATORY)])
    m = Filter(
        Scan("medications"),
        [Predicate("med", "eq", MED_ASPIRIN), Predicate("dosage", "eq", DOSAGE_325MG)],
    )
    return Distinct(Join(d, m, ("pid", "pid")), "pid")


def aspirin_count_plan() -> PlanNode:
    """SELECT COUNT(DISTINCT d.pid) FROM diagnoses d JOIN medications m ON
    d.pid = m.pid WHERE med='aspirin' AND icd9='414' AND d.time <= m.time."""
    d = Filter(Scan("diagnoses"), [Predicate("icd9", "eq", ICD9_HEART_414)])
    m = Filter(Scan("medications"), [Predicate("med", "eq", MED_ASPIRIN)])
    return CountDistinct(Join(d, m, ("pid", "pid"), theta=("time", "le", "time")), "pid")


def three_join_plan() -> PlanNode:
    """SELECT COUNT(DISTINCT pid) FROM diagnosis d JOIN medication m ON pid
    JOIN demographics demo ON pid JOIN demographics demo2 ON pid WHERE
    d.diag='heart disease' AND m.med='aspirin' AND d.time <= m.time."""
    d = Filter(Scan("diagnoses"), [Predicate("diag", "eq", DIAG_HEART_DISEASE)])
    m = Filter(Scan("medications"), [Predicate("med", "eq", MED_ASPIRIN)])
    j1 = Join(d, m, ("pid", "pid"), theta=("time", "le", "time"))
    j2 = Join(j1, Scan("demographics"), ("pid", "pid"))
    j3 = Join(j2, Scan("demographics"), ("pid", "pid"))
    return CountDistinct(j3, "pid")
