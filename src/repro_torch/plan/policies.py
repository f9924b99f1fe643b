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
                            is ``internal`` (Filter / Join: the paper's setup)

    (The reference's ``after_joins`` and ``cost_based`` placements are not
    ported yet.)
    """
    if placement not in ("none", "all_internal"):
        raise ValueError(f"unsupported placement {placement!r}")
    if placement == "none":
        return plan

    def rewrite(node: PlanNode, is_root: bool) -> PlanNode:
        node = node.replace_children([rewrite(c, False) for c in node.children()])
        if is_root or lookup(type(node)).resizer != "internal":
            return node
        cfg = cfg_factory(node)
        return node if cfg is None else Resize(node, cfg)

    return rewrite(plan, True)
