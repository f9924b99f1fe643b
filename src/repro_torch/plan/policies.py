"""Resizer placement (§5.3): wrap operators with Resize nodes by policy."""
from __future__ import annotations

from typing import Callable, Optional

from ..core.resizer import ResizerConfig
from .nodes import PlanNode, Resize
from .registry import lookup

__all__ = ["insert_resizers"]


def insert_resizers(
    plan: PlanNode,
    cfg_factory: Callable[[PlanNode], Optional[ResizerConfig]],
    placement: str = "all_internal",
) -> PlanNode:
    """Rewrite the plan, wrapping operators with Resize nodes.

    placement:
      * ``none``          — fully oblivious (no resizers)
      * ``all_internal``  — after every non-root operator whose registry hint
                            is ``internal`` (Filter, Join, GroupBy and
                            Having: the paper's setup)
      * ``after_joins``   — only after the ``internal`` operators that balloon
                            (Join, the product)

    (The reference's ``cost_based`` placement is not ported yet.)
    """
    if placement not in ("none", "all_internal", "after_joins"):
        raise ValueError(f"unsupported placement {placement!r}")
    if placement == "none":
        return plan

    def rewrite(node: PlanNode, is_root: bool) -> PlanNode:
        node = node.replace_children([rewrite(c, False) for c in node.children()])
        d = lookup(type(node))
        if is_root or d.resizer != "internal":
            return node
        if placement == "after_joins" and not d.balloons:
            return node
        cfg = cfg_factory(node)
        return node if cfg is None else Resize(node, cfg)

    return rewrite(plan, True)
