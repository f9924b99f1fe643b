"""RandomnessPlanner: derive a plan template's randomness manifest (a port
of ``repro.offline.manifest``).

The manifest answers "how much correlated randomness will one execution of
this template draw, per node?" — counted at the **eager call-site
granularity** the ambient :mod:`repro_torch.core.material` hook intercepts:
``PRFSetup.fold`` / ``draw`` / ``draw_uniform``, ``zero_share_add/xor``,
and shuffle-hop permutations. (Gate-internal zero-sharings that live
inside jitted whole-level payloads compile into the program and are
neither intercepted nor counted — see DESIGN.md §15.1.)

Counts are a pure function of the template and its pow2-bucketed shapes.
For the operators whose derivation stream is simple enough to enumerate
statically (Scan/Project/Filter/Having/Count/Sum/Avg/Resize) the counts
are **exact** and cross-checked against recorded event streams in
``tests/test_offline.py`` (the reference) and ``tests/test_torch_offline.py``; for the sort- and join-based operators they
are sizing estimates, flagged ``exact=False``.

The provisioner uses manifest totals to prioritize refill work and the
service exports them per template through EXPLAIN and the
``reflex_offline_*`` metrics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from ..core.noise import NoTrim
from ..ops.filter import And, Or, Pred, Predicate, pred_leaves

__all__ = ["NodeManifest", "RandomnessManifest", "RandomnessPlanner"]

# Eager fold counts of the conversion circuits (core/circuits.py): a2b does
# fold(31), fold(32) plus one fold(11) inside each of its two ks_add calls;
# bit2a does fold(21), fold(22).
A2B_FOLDS = 4
BIT2A_FOLDS = 2
SHUFFLE_HOPS = 3


def _bucket_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


@dataclasses.dataclass(frozen=True)
class NodeManifest:
    """Per-node randomness demand for one execution of the template."""

    label: str
    op: str
    bucket: int  # pow2-bucketed estimated row count
    folds: int  # PRF fold invocations
    draws: int  # replicated draws (prf.draw / draw_uniform)
    zero_shares: int  # eager zero-sharing derivations
    perms: int  # shuffle-hop control permutations
    conversions: int  # a2b / bit2a conversion call sites
    resize_counters: int  # Resizer noise-counter reservations
    exact: bool  # counts are exact (vs sizing estimate)

    def total_events(self) -> int:
        return self.folds + self.draws + self.zero_shares + self.perms


@dataclasses.dataclass(frozen=True)
class RandomnessManifest:
    """The full manifest of one plan template at one shape bucket."""

    template: str  # fingerprint hash of the literal-masked plan
    nodes: Tuple[NodeManifest, ...]

    def totals(self) -> Dict[str, int]:
        out = {
            "folds": 0,
            "draws": 0,
            "zero_shares": 0,
            "perms": 0,
            "conversions": 0,
            "resize_counters": 0,
            "events": 0,
        }
        for nm in self.nodes:
            out["folds"] += nm.folds
            out["draws"] += nm.draws
            out["zero_shares"] += nm.zero_shares
            out["perms"] += nm.perms
            out["conversions"] += nm.conversions
            out["resize_counters"] += nm.resize_counters
            out["events"] += nm.total_events()
        return out

    @property
    def exact(self) -> bool:
        return all(nm.exact for nm in self.nodes)

    def resizes(self) -> int:
        return sum(nm.resize_counters for nm in self.nodes)


class RandomnessPlanner:
    """Walk a compiled plan template and derive its randomness manifest."""

    def __init__(self, catalog=None, cost_model=None):
        self.catalog = catalog
        self.cost_model = cost_model

    def manifest(self, plan) -> "RandomnessManifest":
        from ..sql.compile import template_fingerprint
        from ..obs.redact import fingerprint_hash

        nodes = []
        self._walk(plan, nodes)
        return RandomnessManifest(
            template=fingerprint_hash(template_fingerprint(plan)),
            nodes=tuple(nodes),
        )

    # -- internals -----------------------------------------------------------

    def _walk(self, node, out: list) -> None:
        for c in node.children():
            self._walk(c, out)
        out.append(self._node_manifest(node))

    def _rows(self, node) -> int:
        if self.cost_model is not None:
            try:
                return int(self.cost_model.estimate(node).get("n", 1))
            except Exception:
                return 1
        return 1

    def _schema(self, node):
        if self.catalog is None:
            return None
        try:
            from ..plan.registry import infer_schema

            return infer_schema(node, self.catalog)
        except Exception:
            return None

    def _node_manifest(self, node) -> NodeManifest:
        name = type(node).__name__
        bucket = _bucket_pow2(self._rows(node))
        zero = dict(
            label=node.label,
            op=name,
            bucket=bucket,
            folds=0,
            draws=0,
            zero_shares=0,
            perms=0,
            conversions=0,
            resize_counters=0,
            exact=True,
        )
        handler = getattr(self, f"_count_{name}", None)
        if handler is not None:
            zero.update(handler(node))
        elif name not in ("Scan", "Project", "Limit"):
            # unmodeled operator: unknown demand, flagged inexact
            zero.update(dict(exact=False))
        return NodeManifest(**zero)

    # predicate evaluation: one fold per leaf tag, two per combining gate
    # (430/470 then the gate ordinal), one for the valid-AND (449); leaves
    # over arithmetic-share columns a2b-convert first (4 folds each), and
    # secret-secret lt/le leaves fold once more for the generate AND.
    def _pred_counts(self, pred: Pred, child) -> Dict[str, int]:
        leaves = pred_leaves(pred)
        gates = self._gate_count(pred)
        schema = self._schema(child)
        folds = len(leaves) + 2 * gates + 1
        conversions = 0
        exact = True
        converted = set()

        def col_kind(name: str) -> Optional[str]:
            if schema is None:
                return None
            return schema.cols.get(name)

        for leaf in leaves:
            cols = [leaf.column]
            secret_pair = isinstance(leaf.value, str) and str(leaf.value).startswith(
                "col:"
            )
            if secret_pair:
                cols.append(str(leaf.value)[4:])
                if leaf.op in ("lt", "le"):
                    folds += 1  # the eager generate-AND fold(7) in lt()
            for col in cols:
                kind = col_kind(col)
                if kind is None:
                    exact = schema is not None and exact
                    if schema is None:
                        exact = False
                elif kind == "a" and col not in converted:
                    converted.add(col)
                    folds += A2B_FOLDS
                    conversions += 1
        return dict(folds=folds, conversions=conversions, exact=exact)

    @staticmethod
    def _gate_count(pred: Pred) -> int:
        if isinstance(pred, Predicate):
            return 0
        count = len(pred.terms) - 1
        for t in pred.terms:
            count += RandomnessPlanner._gate_count(t)
        return count

    def _count_Filter(self, node) -> Dict[str, int]:
        return self._pred_counts(node.pred, node.child)

    def _count_Having(self, node) -> Dict[str, int]:
        return self._pred_counts(node.pred, node.child)

    def _count_GroupByCount(self, node) -> Dict[str, int]:
        # sort-based: keys ride the bitonic network (stage folds), payload
        # gathered once via shuffle-apply (6 hop perms). Sizing estimate.
        k = max(1, int(math.log2(max(2, _bucket_pow2(self._rows(node))))))
        stages = k * (k + 1) // 2
        return dict(
            folds=2 * stages + 12,
            perms=2 * SHUFFLE_HOPS,
            conversions=2,
            exact=False,
        )

    _count_GroupBySum = _count_GroupByCount
    _count_GroupByAvg = _count_GroupByCount
    _count_OrderBy = _count_GroupByCount
    _count_Distinct = _count_GroupByCount
    _count_Min = _count_GroupByCount
    _count_Max = _count_GroupByCount

    def _count_Count(self, node) -> Dict[str, int]:
        # aggregate.py: bit2a(valid, fold(701)) -> 1 + BIT2A_FOLDS
        return dict(folds=1 + BIT2A_FOLDS, conversions=1, exact=True)

    def _count_Sum(self, node) -> Dict[str, int]:
        # b2a(col, fold(711)) -> 1 + BIT2A_FOLDS; bit2a(valid, fold(712)) ->
        # 1 + BIT2A_FOLDS; mul(fold(713)) -> 1
        return dict(folds=2 * (1 + BIT2A_FOLDS) + 1, conversions=2, exact=True)

    _count_Avg = _count_Sum

    def _count_Join(self, node) -> Dict[str, int]:
        return dict(folds=8, exact=False)

    def _count_JoinSortMerge(self, node) -> Dict[str, int]:
        k = max(1, int(math.log2(max(2, _bucket_pow2(self._rows(node))))))
        stages = k * (k + 1) // 2
        return dict(
            folds=2 * stages + 24,
            perms=2 * SHUFFLE_HOPS,
            conversions=2,
            exact=False,
        )

    def _count_Resize(self, node) -> Dict[str, int]:
        cfg = node.cfg
        counts = dict(resize_counters=1, folds=1)  # the counter-root fold
        if isinstance(cfg.noise, NoTrim):
            return counts  # Resizer returns before any further derivation
        schema = self._schema(node.child)
        if schema is None or getattr(cfg, "use_sort", False):
            counts["exact"] = False
        cols = dict(schema.cols) if schema is not None else {}
        ncols = len(cols)
        a_cols = sum(1 for kind in cols.values() if kind == "a")
        folds, zero, perms, conv = counts["folds"], 0, 0, 0
        if cfg.addition == "parallel":
            # fold(801) + a2b + fold(802) + lt_public(eager folds: 0) +
            # or_bit(fold(803))
            folds += 1 + A2B_FOLDS + 1 + 1
            conv += 1
        else:  # sequential
            # bit2a(fold(811)) + a2b(fold(812)) + lt_public(fold(813)) +
            # or_bit(fold(814))
            folds += (1 + BIT2A_FOLDS) + (1 + A2B_FOLDS) + 1 + 1
            conv += 2
        folds += a_cols * A2B_FOLDS  # bshare_col of arithmetic payload cols
        conv += a_cols
        # secure_shuffle under fold(821): hop folds + hop perms + one
        # re-randomize (fold + zero-share) per column per hop; the shuffled
        # set is the payload plus the __k / __valid control columns
        shuffled_cols = ncols + 2
        folds += 1 + SHUFFLE_HOPS * (1 + shuffled_cols)
        perms += SHUFFLE_HOPS
        zero += SHUFFLE_HOPS * shuffled_cols
        counts.update(
            folds=folds, zero_shares=zero, perms=perms, conversions=conv
        )
        # a join below can carry lazy payload views through the deferred
        # gather path, which re-derives hop perms and re-randomizes per
        # lazy column — demand we cannot see from the template alone
        if self._has_join_below(node):
            counts["exact"] = False
        return counts

    @staticmethod
    def _has_join_below(node) -> bool:
        for c in node.children():
            if type(c).__name__ in ("Join", "JoinSortMerge"):
                return True
            if RandomnessPlanner._has_join_below(c):
                return True
        return False
