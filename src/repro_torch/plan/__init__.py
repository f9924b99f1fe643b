from .nodes import Distinct, Filter, Join, PlanNode, Resize, Scan
from .policies import insert_resizers

__all__ = ["Distinct", "Filter", "Join", "PlanNode", "Resize", "Scan", "insert_resizers"]
