"""Plan rewrites of the planner (§5.3), a port of ``repro.plan.policies``:
Resizer placement, and the physical join algorithm's selection.

Which operators are Resizer candidates comes from the registry: each
:class:`~.registry.OperatorDef` carries a ``resizer`` hint (``internal``:
the operator balloons or keeps dead tuples; ``skip``: never wrapped).
"""
from __future__ import annotations

from typing import Callable, Optional

from ..config import current_config
from ..core.resizer import ResizerConfig
from .nodes import Filter, Join, JoinSortMerge, PlanNode, Project, Resize, Scan
from .registry import lookup

__all__ = ["insert_resizers", "select_join_algorithms"]


def insert_resizers(
    plan: PlanNode,
    cfg_factory: Callable[[PlanNode], Optional[ResizerConfig]],
    placement: str = "all_internal",
    cost_model=None,
) -> PlanNode:
    """Rewrite the plan, wrapping operators with Resize nodes.

    placement:
      * ``none``          — fully oblivious (no resizers)
      * ``all_internal``  — after every non-root operator whose registry hint
                            is ``internal`` (Filter, the joins, GroupBy and
                            Having: the paper's setup)
      * ``after_joins``   — only after the ``internal`` operators that
                            balloon (the joins)
      * ``cost_based``    — only where ``cost_model``
                            (:class:`~.cost.CostModel`) predicts a win; with
                            no model, everywhere ``all_internal`` would
    """
    if placement not in ("none", "all_internal", "after_joins", "cost_based"):
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
        if placement == "cost_based" and cost_model is not None and not cost_model.resizer_profitable(node):
            return node
        cfg = cfg_factory(node)
        return node if cfg is None else Resize(node, cfg)

    return rewrite(plan, True)


def _key_multiplicity(node: PlanNode, col: str, catalog) -> Optional[int]:
    """Public bound on the duplicates of ``col`` at this subplan's output,
    from the catalog's declared per-table bounds. Only rewrites that cannot
    raise multiplicity pass the bound on; anything else is unbounded
    (None)."""
    if catalog is None:
        return None
    if isinstance(node, Scan):
        return catalog.key_multiplicity(node.table, col)
    if isinstance(node, (Filter, Resize)):
        return _key_multiplicity(node.children()[0], col, catalog)
    if isinstance(node, Project) and col in node.cols:
        return _key_multiplicity(node.children()[0], col, catalog)
    return None


def select_join_algorithms(
    plan: PlanNode,
    cost_model=None,
    catalog=None,
    mode: Optional[str] = None,
) -> PlanNode:
    """Rewrite logical :class:`Join` nodes to :class:`JoinSortMerge` where
    the sort-merge join applies (a finite catalog bound on at least one
    input's join key) and, in ``auto`` mode, the cost model prices it below
    the product join.

    mode (``RuntimeConfig.join_algo``; ``None``: :func:`current_config`'s):
      * ``product``   — never rewrite
      * ``sortmerge`` — rewrite every join that applies
      * ``auto``      — rewrite where it applies and its bytes are fewer

    The rewrite is physical only: ``JoinSortMerge.describe()`` is Join's,
    so fingerprints and rendered SQL do not move across the flip.
    """
    if mode is None:
        mode = current_config().join_algo
    if mode not in ("auto", "product", "sortmerge"):
        raise ValueError(f"join algo mode {mode!r} (expected auto|product|sortmerge)")
    if mode == "product":
        return plan

    def rewrite(node: PlanNode) -> PlanNode:
        node = node.replace_children([rewrite(c) for c in node.children()])
        if type(node) is not Join:
            return node
        lb = _key_multiplicity(node.left, node.on[0], catalog)
        rb = _key_multiplicity(node.right, node.on[1], catalog)
        if lb is None and rb is None:
            return node  # no public fanout bound: sort-merge does not apply
        # build on the side with the smaller finite bound (fewer match slots)
        if rb is None or (lb is not None and lb <= rb):
            fanout, build = lb, "left"
        else:
            fanout, build = rb, "right"
        sm = JoinSortMerge(node.left, node.right, node.on, node.theta, fanout=max(int(fanout), 1), build=build)
        if mode == "sortmerge":
            return sm
        if cost_model is None:
            return node
        own = lambda est, kids: est["bytes"] - sum(k["bytes"] for k in kids)
        kids = [cost_model.estimate(c) for c in node.children()]
        d_prod = lookup(Join).estimate(node, kids, cost_model)
        d_sm = lookup(JoinSortMerge).estimate(sm, kids, cost_model)
        if getattr(cost_model, "calibration", None) is not None:
            d_prod = cost_model.calibration.refine(node, d_prod, cost_model.noise)
            d_sm = cost_model.calibration.refine(sm, d_sm, cost_model.noise)
        return sm if own(d_sm, kids) < own(d_prod, kids) else node

    return rewrite(plan)
