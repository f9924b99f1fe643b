from .healthlnk import generate_healthlnk, plaintext_oracle, revealed_answer
from .queries import all_query_plans, aspirin_count_plan, comorbidity_plan, dosage_study_plan, three_join_plan

__all__ = [
    "generate_healthlnk",
    "plaintext_oracle",
    "revealed_answer",
    "all_query_plans",
    "aspirin_count_plan",
    "comorbidity_plan",
    "dosage_study_plan",
    "three_join_plan",
]
