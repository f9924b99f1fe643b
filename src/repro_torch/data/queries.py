"""Hand-compiled plans of the slice (paper Table 2). Filters are pushed below
joins; Resizer placement is applied separately with
:func:`repro_torch.plan.policies.insert_resizers`."""
from __future__ import annotations

from ..ops.filter import Predicate
from ..plan.nodes import Distinct, Filter, Join, PlanNode, Scan
from .healthlnk import DOSAGE_325MG, ICD9_CIRCULATORY, MED_ASPIRIN

__all__ = ["dosage_study_plan"]


def dosage_study_plan() -> PlanNode:
    """SELECT DISTINCT d.pid FROM diagnoses d, medications m WHERE
    d.pid = m.pid AND med='aspirin' AND icd9='circulatory' AND dosage='325mg'."""
    d = Filter(Scan("diagnoses"), [Predicate("icd9", "eq", ICD9_CIRCULATORY)])
    m = Filter(
        Scan("medications"),
        [Predicate("med", "eq", MED_ASPIRIN), Predicate("dosage", "eq", DOSAGE_325MG)],
    )
    return Distinct(Join(d, m, ("pid", "pid")), "pid")
