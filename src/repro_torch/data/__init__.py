from .healthlnk import generate_healthlnk, plaintext_oracle
from .queries import aspirin_count_plan, dosage_study_plan, three_join_plan

__all__ = [
    "generate_healthlnk",
    "plaintext_oracle",
    "aspirin_count_plan",
    "dosage_study_plan",
    "three_join_plan",
]
