from .healthlnk import (
    DIAG_HEART_DISEASE,
    DOSAGE_325MG,
    ICD9_CIRCULATORY,
    ICD9_HEART_414,
    MED_ASPIRIN,
    generate_healthlnk,
    plaintext_oracle,
    revealed_answer,
)
from .pipeline import TokenPipeline
from .queries import (
    DIALECT_QUERIES,
    QUERY_SQL,
    all_query_plans,
    all_query_sql,
    aspirin_count_plan,
    comorbidity_plan,
    dosage_study_plan,
    three_join_plan,
)

__all__ = [
    "DIAG_HEART_DISEASE",
    "DOSAGE_325MG",
    "ICD9_CIRCULATORY",
    "ICD9_HEART_414",
    "MED_ASPIRIN",
    "DIALECT_QUERIES",
    "QUERY_SQL",
    "TokenPipeline",
    "generate_healthlnk",
    "plaintext_oracle",
    "revealed_answer",
    "all_query_plans",
    "all_query_sql",
    "aspirin_count_plan",
    "comorbidity_plan",
    "dosage_study_plan",
    "three_join_plan",
]
