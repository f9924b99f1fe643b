from .ops import (
    GatherPlan,
    gather_direct,
    gather_hop,
    gather_plan,
    gather_plan_plain,
    gather_two_pass,
    gather_two_pass_plain,
    shuffle_gather,
    shuffle_gather_plain,
    uses_two_pass,
)

__all__ = [
    "GatherPlan",
    "gather_direct",
    "gather_hop",
    "gather_plan",
    "gather_plan_plain",
    "gather_two_pass",
    "gather_two_pass_plain",
    "shuffle_gather",
    "shuffle_gather_plain",
    "uses_two_pass",
]
