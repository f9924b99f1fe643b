"""Hand-compiled plans of the port: the fourteen HealthLNK goldens of
``repro.data.queries`` (paper Table 2 and the dialect goldens), with the
reference's names, and their SQL forms (``QUERY_SQL``), each of which
:func:`repro_torch.sql.compile_logical` must compile to its hand plan.
Filters are pushed below joins; Resizer placement is applied separately
with :func:`repro_torch.plan.policies.insert_resizers`."""
from __future__ import annotations

from typing import Dict

from ..ops.filter import Or, Predicate
from ..plan.nodes import (
    Avg,
    CountDistinct,
    CountValid,
    Distinct,
    Filter,
    GroupByAvg,
    GroupByCount,
    GroupBySum,
    Having,
    Join,
    Max,
    Min,
    OrderBy,
    PlanNode,
    Project,
    Scan,
    Sum,
)
from .healthlnk import (
    DIAG_HEART_DISEASE,
    DOSAGE_325MG,
    ICD9_CIRCULATORY,
    ICD9_HEART_414,
    MED_ASPIRIN,
)

__all__ = [
    "comorbidity_plan",
    "dosage_study_plan",
    "aspirin_count_plan",
    "three_join_plan",
    "projection_join_plan",
    "dosage_sum_plan",
    "dosage_avg_plan",
    "dosage_min_plan",
    "dosage_max_plan",
    "heart_or_circulatory_plan",
    "diag_breakdown_plan",
    "med_dosage_sum_plan",
    "med_dosage_avg_plan",
    "repeat_diagnoses_plan",
    "all_query_plans",
    "QUERY_SQL",
    "DIALECT_QUERIES",
    "all_query_sql",
]


def comorbidity_plan() -> PlanNode:
    """SELECT major_icd9, COUNT(*) FROM diagnoses GROUP BY major_icd9
    ORDER BY COUNT(*) DESC LIMIT 10."""
    return OrderBy(GroupByCount(Scan("diagnoses"), "major_icd9"), col="cnt", descending=True, limit=10)


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


def _aspirin() -> PlanNode:
    return Filter(Scan("medications"), [Predicate("med", "eq", MED_ASPIRIN)])


def projection_join_plan() -> PlanNode:
    """SELECT d.pid, m.dosage FROM diagnoses d JOIN medications m ON
    d.pid = m.pid WHERE m.med='aspirin'."""
    return Project(Join(Scan("diagnoses"), _aspirin(), ("pid", "pid")), ("pid", "dosage"))


def dosage_sum_plan() -> PlanNode:
    """SELECT SUM(dosage) AS total FROM medications WHERE med='aspirin'."""
    return Sum(_aspirin(), "dosage", name="total")


def dosage_avg_plan() -> PlanNode:
    """SELECT AVG(dosage) AS avg_dosage FROM medications WHERE med='aspirin'
    (revealed as (sum, cnt))."""
    return Avg(_aspirin(), "dosage", name="avg_dosage")


def dosage_min_plan() -> PlanNode:
    """SELECT MIN(dosage) AS lo FROM medications WHERE med='aspirin'."""
    return Min(_aspirin(), "dosage", name="lo")


def dosage_max_plan() -> PlanNode:
    """SELECT MAX(dosage) AS hi FROM medications WHERE med='aspirin'."""
    return Max(_aspirin(), "dosage", name="hi")


def heart_or_circulatory_plan() -> PlanNode:
    """SELECT COUNT(*) FROM diagnoses WHERE icd9='414' OR icd9='circulatory'."""
    return CountValid(
        Filter(
            Scan("diagnoses"),
            Or((Predicate("icd9", "eq", ICD9_HEART_414), Predicate("icd9", "eq", ICD9_CIRCULATORY))),
        )
    )


def diag_breakdown_plan() -> PlanNode:
    """SELECT major_icd9, diag, COUNT(*) FROM diagnoses GROUP BY
    major_icd9, diag (a composite key)."""
    return GroupByCount(Scan("diagnoses"), ("major_icd9", "diag"))


def med_dosage_sum_plan() -> PlanNode:
    """SELECT med, SUM(dosage) AS total FROM medications GROUP BY med."""
    return GroupBySum(Scan("medications"), "med", "dosage", name="total")


def med_dosage_avg_plan() -> PlanNode:
    """SELECT med, AVG(dosage) AS mean FROM medications GROUP BY med
    (revealed as per-group (sum, cnt))."""
    return GroupByAvg(Scan("medications"), "med", "dosage", name="mean")


def repeat_diagnoses_plan() -> PlanNode:
    """SELECT major_icd9, COUNT(*) AS cnt FROM diagnoses GROUP BY major_icd9
    HAVING COUNT(*) >= 2 (on the integers: cnt > 1)."""
    return Having(GroupByCount(Scan("diagnoses"), "major_icd9"), [Predicate("cnt", "gt", 1)])


def all_query_plans() -> Dict[str, PlanNode]:
    return {
        "comorbidity": comorbidity_plan(),
        "dosage_study": dosage_study_plan(),
        "aspirin_count": aspirin_count_plan(),
        "three_join": three_join_plan(),
        "projection_join": projection_join_plan(),
        "dosage_sum": dosage_sum_plan(),
        "dosage_avg": dosage_avg_plan(),
        "dosage_min": dosage_min_plan(),
        "dosage_max": dosage_max_plan(),
        "heart_or_circulatory": heart_or_circulatory_plan(),
        "diag_breakdown": diag_breakdown_plan(),
        "med_dosage_sum": med_dosage_sum_plan(),
        "med_dosage_avg": med_dosage_avg_plan(),
        "repeat_diagnoses": repeat_diagnoses_plan(),
    }


# The SQL forms of the goldens. Comma-FROM pools go through cost-based join
# reordering; explicit JOIN chains are honored as written, which is how
# three_join pins the paper's join order.
QUERY_SQL = {
    "comorbidity": (
        "SELECT major_icd9, COUNT(*) AS cnt FROM diagnoses "
        "GROUP BY major_icd9 ORDER BY COUNT(*) DESC LIMIT 10"
    ),
    "dosage_study": (
        "SELECT DISTINCT d.pid FROM diagnoses d, medications m "
        f"WHERE d.pid = m.pid AND d.icd9 = {ICD9_CIRCULATORY} "
        f"AND m.med = {MED_ASPIRIN} AND m.dosage = {DOSAGE_325MG}"
    ),
    "aspirin_count": (
        "SELECT COUNT(DISTINCT d.pid) FROM diagnoses d "
        "JOIN medications m ON d.pid = m.pid AND d.time <= m.time "
        f"WHERE d.icd9 = {ICD9_HEART_414} AND m.med = {MED_ASPIRIN}"
    ),
    "three_join": (
        "SELECT COUNT(DISTINCT d.pid) FROM diagnoses d "
        "JOIN medications m ON d.pid = m.pid AND d.time <= m.time "
        "JOIN demographics demo ON d.pid = demo.pid "
        "JOIN demographics demo2 ON d.pid = demo2.pid "
        f"WHERE d.diag = {DIAG_HEART_DISEASE} AND m.med = {MED_ASPIRIN}"
    ),
    "projection_join": (
        "SELECT d.pid, m.dosage FROM diagnoses d "
        "JOIN medications m ON d.pid = m.pid "
        f"WHERE m.med = {MED_ASPIRIN}"
    ),
    "dosage_sum": (
        f"SELECT SUM(dosage) AS total FROM medications WHERE med = {MED_ASPIRIN}"
    ),
    "dosage_avg": (
        "SELECT AVG(dosage) AS avg_dosage FROM medications "
        f"WHERE med = {MED_ASPIRIN}"
    ),
    "dosage_min": (
        f"SELECT MIN(dosage) AS lo FROM medications WHERE med = {MED_ASPIRIN}"
    ),
    "dosage_max": (
        f"SELECT MAX(dosage) AS hi FROM medications WHERE med = {MED_ASPIRIN}"
    ),
    "heart_or_circulatory": (
        "SELECT COUNT(*) FROM diagnoses "
        f"WHERE icd9 = {ICD9_HEART_414} OR icd9 = {ICD9_CIRCULATORY}"
    ),
    "diag_breakdown": (
        "SELECT major_icd9, diag, COUNT(*) AS cnt FROM diagnoses "
        "GROUP BY major_icd9, diag"
    ),
    "med_dosage_sum": (
        "SELECT med, SUM(dosage) AS total FROM medications GROUP BY med"
    ),
    "med_dosage_avg": (
        "SELECT med, AVG(dosage) AS mean FROM medications GROUP BY med"
    ),
    "repeat_diagnoses": (
        "SELECT major_icd9, COUNT(*) AS cnt FROM diagnoses "
        "GROUP BY major_icd9 HAVING COUNT(*) >= 2"
    ),
}

# The dialect-feature goldens (the execution half of
# ``python -m repro_torch.sql --check``).
DIALECT_QUERIES = (
    "projection_join",
    "dosage_sum",
    "dosage_avg",
    "dosage_min",
    "dosage_max",
    "heart_or_circulatory",
    "diag_breakdown",
    "med_dosage_sum",
    "med_dosage_avg",
    "repeat_diagnoses",
)


def all_query_sql() -> Dict[str, str]:
    return dict(QUERY_SQL)
