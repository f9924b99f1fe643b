from .nodes import CountDistinct, CountValid, Distinct, Filter, Join, PlanNode, Resize, Scan
from .policies import insert_resizers

__all__ = [
    "CountDistinct",
    "CountValid",
    "Distinct",
    "Filter",
    "Join",
    "PlanNode",
    "Resize",
    "Scan",
    "insert_resizers",
]
