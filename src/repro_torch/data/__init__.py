from .healthlnk import generate_healthlnk, plaintext_oracle
from .queries import dosage_study_plan

__all__ = ["generate_healthlnk", "plaintext_oracle", "dosage_study_plan"]
